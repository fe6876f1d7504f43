"""Selective scan — the SSM recurrence of a Mamba block with the state
kept on chip for the whole sequence.

Replaces ``repro/kernels/mamba_scan/scan.py::selective_scan``.  The
reference walks a grid (B, Di/bdi), holds one (bdi, Ds) state block in
VMEM scratch and loops over T with ``fori_loop``, so only x/dt/B/C
stream in and y streams out: device-memory traffic O(T·(Di + Ds))
where the ``lax.scan`` twin round-trips the (Di x Ds) state every step.
It is the Conv1-style logic-only end of the library: no MXU.

The kernel (``selective_scan_kernel<S, SAVE>`` in ``csrc/scan_kernels.cu``)
computes the same function for any d_state on the plan of
``lane_plan``: a thread owns S states of one channel (b, di) in
registers, L lanes a channel, and, past 128 states, several passes
over the sequence; every step computes ``dt·x`` once, then per state
``exp(dt·A)`` with ``expf``, the h update and the y product on CUDA
cores, and y in the order of ``scan_tree_sum`` (in registers, the
lanes' sums added once a chunk through shared memory).  Chunks of x, dt
(for the CTA's channels) and of Bp, Cp are staged by ``cp.async`` while
the previous chunk computes.  ``selective_scan_plain`` takes every
operation in the kernel's order, so the two agree bitwise.
``block_di`` is the reference's VMEM block hint (``bdi = min(block_di,
Di)``): validated, priced by ``footprint``, it does not shape the
launch, so results never depend on it.

The backward (``selective_scan_bwd``; no TPU kernel: the reference
takes ``jax.grad`` of its ``lax.scan``) runs ``selective_scan_bwd_kernel``
on the plan of ``bwd_plan``: the forward, asked by ``SelectiveScan``,
also saves h every ``BWD_CHUNK`` steps; the backward stages each chunk
in shared memory, recomputes it from its saved state keeping h and
``exp(dt·A)`` in registers, then walks it backwards with the state's
gradient in a register.  Its sums run in a fixed order (no atomics):
over states as the forward's y, over a CTA's channels by a halving tree
in registers after each chunk, over the CTAs by ``scan_bwd_reduce_bc_kernel``'s
halving tree.  ``selective_scan_bwd_plain`` takes every operation in its
order, so the two agree bitwise.

Each wrapper runs its kernel on CUDA tensors, its plain version on CPU
tensors, and on ``meta`` tensors (``launch/dryrun.py``'s traced steps)
returns outputs of the right shapes and dtypes without looping: shape
propagation, not a fallback.  Any other device raises.  On every branch
the kernel's work goes to ``cuda.kernel_work``: the bytes read once and
written once and the FP32 operations of its bound (``fwd_work``,
``bwd_work``; the exponentials are not FLOPs), so a call counts the same
on the card as on ``meta``; the operand casts around the kernel are
ordinary ops.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.resources import (Footprint, cost_cycles,
                                        vpu_op_cycles)
from repro_torch.kernels import cuda
from repro_torch.kernels.conv2d.inner import check_block

MAX_STATES = 16            # states a thread (16, 8, 4, 2 or 1)
MAX_THREADS = 256          # threads a CTA
MAX_LANES = 8              # lanes a channel
PASS_STATES = 128          # states a pass
WARP = 32
SMEM_BYTES = 48 * 1024     # shared memory a CTA
MAX_CHUNK = 32             # steps a staged chunk
# threads an SM the plan aims for (16 warps) before it splits a
# channel's states over more lanes
TARGET_THREADS_PER_SM = 512
BWD_THREADS = 128          # threads a CTA of the backward
BWD_CHUNK = 16             # steps between the states the forward saves
BWD_STATES = 4             # states a thread of the backward
BWD_SMEM_BYTES = 227 * 1024   # shared memory a CTA of the backward may ask
# scan_bwd_reduce_bc_kernel trees at most REDUCE_ROWS x REDUCE_SPAN CTA
# partials (their count padded to a power of two) a column
REDUCE_ROWS = 256
REDUCE_SPAN = 64
# FP32 operations a (t, di, s) of the forward (dt·x once a step aside:
# dt·A, the h update's two products and sum, the y product and its sum)
# and of the backward (the chunk's recompute of h, the g update, the
# terms of dx, ddt, dB, dC and dA and their sums); one exponential each
FWD_FP32_OPS = 6
BWD_FP32_OPS = 19


class ScanPlan(NamedTuple):
    """How ``selective_scan_kernel`` cuts one scan: each thread keeps
    ``states`` states of a channel in registers, ``lanes`` lanes a
    channel, ``passes`` passes over the sequence (states x lanes x
    passes = Ds padded to a power of two, ``tree_shape``), CTAs of
    ``ch`` channels of one batch row (``ch * lanes`` threads), chunks of
    ``tc`` steps staged at a time."""
    states: int
    lanes: int
    passes: int
    ch: int
    tc: int

    def smem_bytes(self, save: bool = False) -> int:
        """The kernel's shared memory (``smem_floats`` of
        ``csrc/scan_kernels.cu``): x and dt, two buffers of tc x ch; Bp
        and Cp, two of tc x lanes*states; the lanes' partials; saving
        states, one saved state of ch rows of lanes*states + 1."""
        ls = self.lanes * self.states
        parts = self.lanes * self.ch if self.lanes > 1 else 0
        saved = self.ch * (ls + 1) if save else 0
        return 4 * (self.tc * (4 * self.ch + 4 * ls + parts) + saved)


def tree_shape(ds: int):
    """(P, Q): Ds padded to the next power of two P, taken in Q passes of
    at most ``PASS_STATES`` states."""
    p = 1 << (ds - 1).bit_length()
    return p, max(1, p // PASS_STATES)


def lane_plan(b: int, di: int, ds: int, sms: int,
              save: bool = False) -> ScanPlan:
    """The launch plan for (B, Di, Ds) on a card of ``sms`` SMs
    (``cuda.sm_count``): a pass's P / Q states (see ``tree_shape``) go
    16 (or all, if fewer) to a thread; then, while the card would hold
    fewer than ``TARGET_THREADS_PER_SM`` threads an SM (B * Di * lanes
    in all), a thread takes half as many (not below 4) on twice the
    lanes (at most 8).  Every Ds >= 1 gets a plan; the
    y sum's order does not depend on it.  With ``save`` (the forward
    that saves states for the backward) a chunk is the largest power of
    two of steps that fits, at most ``BWD_CHUNK`` (so it divides
    ``BWD_CHUNK`` and every saved state ends a chunk), and shared memory
    also holds one saved state."""
    if min(b, di, ds) < 1:
        raise ValueError(f"lane_plan takes B, Di, Ds >= 1, got "
                         f"{(b, di, ds)}")
    p, q = tree_shape(ds)
    s = min(MAX_STATES, p // q)
    while (s > 4 and p // (q * s) < MAX_LANES
           and b * di * p // (q * s) < sms * TARGET_THREADS_PER_SM):
        s //= 2
    lanes = p // (q * s)
    ch = min(WARP * (MAX_LANES // lanes), -(-di // WARP) * WARP)
    plan = ScanPlan(s, lanes, q, ch, 1)
    per_step = plan.smem_bytes()
    if not save:
        return plan._replace(tc=max(1, min(MAX_CHUNK,
                                           SMEM_BYTES // per_step)))
    room = SMEM_BYTES - (plan.smem_bytes(save=True) - per_step)
    tc = max(1, min(BWD_CHUNK, room // per_step))
    return plan._replace(tc=1 << (tc.bit_length() - 1))


def _check(x, dt, bp, cp, a) -> None:
    if x.dim() != 3 or dt.shape != x.shape:
        raise ValueError(f"selective_scan takes x and dt (B, T, Di); got "
                         f"{tuple(x.shape)} and {tuple(dt.shape)}")
    b, t, di = x.shape
    if a.dim() != 2 or a.shape[0] != di:
        raise ValueError(f"A must be (Di, Ds) = ({di}, Ds); got "
                         f"{tuple(a.shape)}")
    want = (b, t, a.shape[1])
    for name, v in (("Bp", bp), ("Cp", cp)):
        if tuple(v.shape) != want:
            raise ValueError(f"{name} must be (B, T, Ds) = {want}; got "
                             f"{tuple(v.shape)}")


def scan_tree_sum(p: torch.Tensor, passes: int) -> torch.Tensor:
    """The kernel's y sum over the last axis of ``p`` (P products, P a
    power of two): pass q holds the products j * passes + q; within a
    pass a halving tree over j (j + n/2 onto j, then halve n); then the
    passes' sums in order."""
    n = p.shape[-1] // passes
    p = p.reshape(*p.shape[:-1], n, passes)
    while n > 1:
        n //= 2
        p = p[..., :n, :] + p[..., n:, :]
    y = p[..., 0, 0]
    for q in range(1, passes):
        y = y + p[..., 0, q]
    return y


def _plain_scan(x, dt, bp, cp, a, keep: bool):
    _check(x, dt, bp, cp, a)
    b, t, di = x.shape
    ds = a.shape[1]
    f32 = torch.float32
    x, dt, bp, cp, a = (v.to(f32) for v in (x, dt, bp, cp, a))
    p2, passes = tree_shape(ds)
    pad = (0, p2 - ds)
    bp, cp, a = (torch.nn.functional.pad(v, pad) for v in (bp, cp, a))
    h = torch.zeros((b, di, p2), dtype=f32, device=x.device)
    y = torch.empty((b, t, di), dtype=f32, device=x.device)
    kept = []
    for i in range(t):
        dt_t = dt[:, i]
        d_a = torch.exp(dt_t[..., None] * a[None])
        d_bx = (dt_t * x[:, i])[..., None] * bp[:, i, None, :]
        h = d_a * h + d_bx
        y[:, i] = scan_tree_sum(h * cp[:, i, None, :], passes)
        if keep and (i + 1) % BWD_CHUNK == 0 and i + 1 < t:
            kept.append(h[..., :ds])
    h = h[..., :ds].contiguous()
    if not keep:
        return y, h
    states = (torch.stack(kept, 1) if kept else
              torch.empty((b, 0, di, ds), dtype=f32, device=x.device))
    return y, h, states


def selective_scan_plain(x: torch.Tensor, dt: torch.Tensor, bp: torch.Tensor,
                         cp: torch.Tensor, a: torch.Tensor):
    """The kernel's function in plain PyTorch, in its order: the
    oracle's recurrence step by step (``selective_scan_ref``) on A, Bp
    and Cp padded with zero states to a power of two, y summed by
    ``scan_tree_sum``; the padding's final states are dropped."""
    return _plain_scan(x, dt, bp, cp, a, keep=False)


def _device(x) -> torch.device:
    """``x``'s device, where a wrapper runs (cuda: the kernel, cpu: the
    plain version, meta: shapes); another raises."""
    if x.device.type not in ("cuda", "cpu", "meta"):
        raise ValueError(f"selective_scan runs on cuda (the kernel), cpu "
                         f"(its plain version) or meta (shapes); got "
                         f"{x.device}")
    return x.device


def _cast(x, dt, bp, cp, a):
    """The operands as contiguous f32, on one device (CUDA tensors
    checked for the kernel)."""
    ops = [v.to(torch.float32).contiguous() for v in (x, dt, bp, cp, a)]
    for name, v in zip(("x", "dt", "Bp", "Cp", "A"), ops):
        if v.is_cuda:
            cuda.require(v, name)
        if v.device != x.device:
            raise ValueError(f"x and {name} lie on {x.device} and "
                             f"{v.device}")
    return ops


def n_saved(t: int) -> int:
    """States the forward saves for the backward, a batch row: h after
    steps ``BWD_CHUNK - 1``, ``2 * BWD_CHUNK - 1``, .. short of the
    last."""
    return max(0, -(-t // BWD_CHUNK) - 1)


def fwd_work(b: int, t: int, di: int, ds: int, save: bool):
    """(FP32 operations, bytes) of a forward over (B, T, Di, Ds): x,
    dt, Bp, Cp and A read once, y and h (and the saved states) written
    once, all f32."""
    n = b * t * di * ds
    nbytes = 4 * (2 * b * t * di + 2 * b * t * ds + di * ds
                  + b * t * di + b * di * ds
                  + (b * n_saved(t) * di * ds if save else 0))
    return FWD_FP32_OPS * n, nbytes


def bwd_work(b: int, t: int, di: int, ds: int, dh: bool):
    """(FP32 operations, bytes) of a backward: the forward's operands,
    the saved states, dy (and dh) read once, dx, ddt, dBp, dCp and dA
    written once, all f32."""
    n = b * t * di * ds
    read = (2 * b * t * di + 2 * b * t * ds + di * ds
            + b * n_saved(t) * di * ds + b * t * di
            + (b * di * ds if dh else 0))
    written = 2 * b * t * di + 2 * b * t * ds + di * ds
    return BWD_FP32_OPS * n, 4 * (read + written)


def _forward(x, dt, bp, cp, a, save: bool):
    """The forward on ``x``'s device: (y, h, states | None) — the
    kernel on CUDA, the plain version on the CPU, shapes on meta."""
    b, t, di = x.shape
    ds = a.shape[1]
    dev = _device(x)
    ops = _cast(x, dt, bp, cp, a)
    with cuda.kernel_work("selective_scan", *fwd_work(b, t, di, ds, save),
                          dev):
        if dev.type == "cpu":
            out = _plain_scan(*ops, keep=save)
            return out if save else (*out, None)
        y = torch.empty((b, t, di), dtype=torch.float32, device=dev)
        h = torch.empty((b, di, ds), dtype=torch.float32, device=dev)
        states = (torch.empty((b, n_saved(t), di, ds), dtype=torch.float32,
                              device=dev) if save else None)
        if h.numel() == 0 or dev.type == "meta":
            return y, h, states
        plan = lane_plan(b, di, ds, cuda.sm_count(dev), save=save)
        cuda.launch("selective_scan", "scan_selective", dev,
                    *(v.data_ptr() for v in ops), y.data_ptr(), h.data_ptr(),
                    states.data_ptr() if save and states.numel() else None,
                    b, t, di, ds, BWD_CHUNK, *plan)
    return y, h, states


def selective_scan(x: torch.Tensor, dt: torch.Tensor, bp: torch.Tensor,
                   cp: torch.Tensor, a: torch.Tensor, *,
                   block_di: int = 256):
    """x/dt: (B,T,Di); bp/cp: (B,T,Ds); a: (Di,Ds) -> (y (B,T,Di), h
    (B,Di,Ds)), both f32; inputs are cast to f32.  CUDA tensors launch
    the kernel once; CPU tensors run ``selective_scan_plain``; meta
    tensors give the outputs' shapes.  Where an operand needs a gradient
    (grad mode on), the call runs through ``SelectiveScan`` (the same
    forward, which then also keeps its states for
    ``selective_scan_bwd``)."""
    _check(x, dt, bp, cp, a)
    check_block("block_di", block_di)
    if torch.is_grad_enabled() and any(
            v.requires_grad for v in (x, dt, bp, cp, a)):
        return SelectiveScan.apply(*(v.to(torch.float32)
                                     for v in (x, dt, bp, cp, a)))
    return _forward(x, dt, bp, cp, a, save=False)[:2]


def selective_scan_fwd(x, dt, bp, cp, a):
    """``selective_scan`` that also returns the states its backward
    restarts from: (y, h, states (B, ``n_saved(T)``, Di, Ds)).  CUDA
    tensors launch the forward kernel once (counted as
    ``selective_scan``); CPU tensors run the plain version; meta
    tensors give the shapes."""
    _check(x, dt, bp, cp, a)
    return _forward(x, dt, bp, cp, a, save=True)


# ---------------------------------------------------------------------------
# The backward
# ---------------------------------------------------------------------------
def _check_grads(x, a, dy, dh) -> None:
    want = tuple(x.shape)
    if tuple(dy.shape) != want:
        raise ValueError(f"dy must be (B, T, Di) = {want}; got "
                         f"{tuple(dy.shape)}")
    want = (x.shape[0], x.shape[2], a.shape[1])
    if dh is not None and tuple(dh.shape) != want:
        raise ValueError(f"dh must be (B, Di, Ds) = {want}; got "
                         f"{tuple(dh.shape)}")


class BwdPlan(NamedTuple):
    """How ``selective_scan_bwd_kernel`` cuts a backward: each thread
    owns ``states`` states of a channel (``min(P, BWD_STATES)``, Ds
    padded to a power of two P), ``lanes`` lanes a channel (the rest of
    P, at most 8), ``passes = P / (states * lanes)`` passes over the
    sequence; lane l's k-th state of pass q is (k * lanes + l) * passes
    + q, the forward's cut, so the sums over states are
    ``scan_tree_sum``'s.  CTAs of ``ch = BWD_THREADS / lanes`` channels
    of one batch row, chunks of ``ck`` steps between saved states."""
    states: int
    lanes: int
    passes: int
    ch: int
    ck: int

    def smem_bytes(self) -> int:
        """The kernel's shared memory (``bwd_smem_floats`` of
        ``csrc/scan_kernels.cu``): two staged chunks (dt, x, dy; Bp, Cp;
        the saved state), the dB and dC terms of a chunk (rows padded by
        ``pq % 32``) and each lane's two sums over its states."""
        pq = self.states * self.lanes
        stage = 3 * self.ck * self.ch + 2 * self.ck * pq + self.ch * pq
        row = self.ch * pq + pq % 32
        threads = self.ch * self.lanes
        return 4 * (2 * stage + 2 * self.ck * row + 2 * self.ck * threads)


def bwd_plan(ds: int) -> BwdPlan:
    if ds < 1:
        raise ValueError(f"bwd_plan takes Ds >= 1, got {ds}")
    p = 1 << (ds - 1).bit_length()
    s = min(p, BWD_STATES)
    lanes = min(p // s, MAX_LANES)
    return BwdPlan(s, lanes, p // (s * lanes), BWD_THREADS // lanes,
                   BWD_CHUNK)


def bwd_grid(b: int, di: int, ds: int):
    """(``bwd_plan(ds)``, NB CTAs a batch row) of a backward over (B, Di,
    Ds), or a ``ValueError`` where the kernels cannot take it:
    ``scan_bwd_reduce_bc_kernel`` sums at most REDUCE_ROWS x
    REDUCE_SPAN partials a column (at most that many times ``ch``
    channels), the grid's second axis holds at most 65535 batch rows,
    and a CTA asks for at most ``BWD_SMEM_BYTES`` of shared memory."""
    plan = bwd_plan(ds)
    nb = -(-di // plan.ch)
    if nb > REDUCE_ROWS * REDUCE_SPAN:
        raise ValueError(f"selective_scan_bwd takes at most "
                         f"{REDUCE_ROWS * REDUCE_SPAN * plan.ch} channels "
                         f"at d_state {ds}, got Di = {di}")
    if b > 65535:
        raise ValueError(f"selective_scan_bwd takes at most 65535 batch "
                         f"rows, got {b}")
    if plan.smem_bytes() > BWD_SMEM_BYTES:
        raise ValueError(f"selective_scan_bwd's plan {tuple(plan)} asks "
                         f"for {plan.smem_bytes()} bytes of shared memory "
                         f"a CTA, over {BWD_SMEM_BYTES}")
    return plan, nb


def halving_tree(p: torch.Tensor, dim: int) -> torch.Tensor:
    """Sum over ``dim`` by a halving tree (j + n/2 onto j, then halve n),
    the axis zero-padded to a power of two: ``scan_tree_sum`` in one
    pass, the kernel's order for the sums it splits across channels and
    CTAs."""
    p = p.movedim(dim, -1)
    n = p.shape[-1]
    p2 = 1 << max(n - 1, 0).bit_length()
    return scan_tree_sum(torch.nn.functional.pad(p, (0, p2 - n)), 1)


def _channel_partials(v: torch.Tensor, plan: BwdPlan) -> torch.Tensor:
    """(B, Di, P) terms -> (B, NB, P): each CTA's halving tree over its
    ``ch`` channels (Di zero-padded to NB * ch), the kernel's
    ``htree``."""
    b, di, p = v.shape
    nb = -(-di // plan.ch)
    v = torch.nn.functional.pad(v, (0, 0, 0, nb * plan.ch - di))
    return halving_tree(v.reshape(b, nb, plan.ch, p), 2)


def selective_scan_bwd_plain(x, dt, bp, cp, a, dy, dh=None):
    """The backward's function in plain PyTorch, in the kernel's order:
    the forward's recurrence (zero-padded states) keeping every h, then
    a walk backwards with g in the order of ``selective_scan_bwd_kernel``;
    the sums over states by ``scan_tree_sum``, over channels by
    ``_channel_partials`` then a halving tree over the CTAs (what
    ``scan_bwd_reduce_bc_kernel`` computes), dA a sum over t as walked, then
    over b in order.  Returns (dx, ddt, dBp, dCp,
    dA), f32; ``dh=None`` is a zero final-state gradient."""
    _check(x, dt, bp, cp, a)
    _check_grads(x, a, dy, dh)
    b, t, di = x.shape
    ds = a.shape[1]
    f32 = torch.float32
    plan = bwd_plan(ds)
    p2 = plan.states * plan.lanes * plan.passes
    pad = (0, p2 - ds)
    x, dt, dy = (v.to(f32) for v in (x, dt, dy))
    bp, cp, a = (torch.nn.functional.pad(v.to(f32), pad)
                 for v in (bp, cp, a))
    dev = x.device
    hs = []
    h = torch.zeros((b, di, p2), dtype=f32, device=dev)
    for i in range(t):
        dt_i = dt[:, i]
        h = (torch.exp(dt_i[..., None] * a[None]) * h
             + (dt_i * x[:, i])[..., None] * bp[:, i, None, :])
        hs.append(h)
    g = (torch.zeros((b, di, p2), dtype=f32, device=dev) if dh is None
         else torch.nn.functional.pad(dh.to(f32), pad))
    anext = torch.ones((), dtype=f32, device=dev)
    dacc = torch.zeros((b, di, p2), dtype=f32, device=dev)
    dx = torch.empty((b, t, di), dtype=f32, device=dev)
    ddt = torch.empty((b, t, di), dtype=f32, device=dev)
    # the dB terms, step-major; the channel sums run once after the walk
    # (each step's slice summed as the kernel's CTAs sum it)
    tbs = torch.empty((t, b, di, p2), dtype=f32, device=dev)
    nb = -(-di // plan.ch)
    dxv = dt * x
    zero = torch.zeros((b, di, p2), dtype=f32, device=dev)
    for i in reversed(range(t)):
        dt_i, x_i, dy_i = dt[:, i], x[:, i], dy[:, i]
        hprev = hs[i - 1] if i > 0 else zero
        at = torch.exp(dt_i[..., None] * a[None])
        g = dy_i[..., None] * cp[:, i, None, :] + anext * g
        qa = (g * hprev) * at
        dacc = dacc + qa * dt_i[..., None]
        anext = at
        torch.mul(g, dxv[:, i, :, None], out=tbs[i])
        sgb = scan_tree_sum(g * bp[:, i, None, :], plan.passes)
        sq = scan_tree_sum(qa * a[None], plan.passes)
        dx[:, i] = dt_i * sgb
        ddt[:, i] = x_i * sgb + sq
    hs = torch.stack(hs) if hs else tbs
    tcs = hs * dy.transpose(0, 1)[..., None]
    del hs

    def channel_sums(terms):
        """(T, B, Di, P) terms -> (B, T, Ds): per CTA, then over CTAs."""
        parts = _channel_partials(terms.reshape(t * b, di, p2), plan)
        return halving_tree(parts.reshape(t, b, nb, p2), 2).transpose(
            0, 1)[..., :ds].contiguous()
    dbp = channel_sums(tbs)
    del tbs
    dcp = channel_sums(tcs)
    da = dacc[0]
    for r in range(1, b):
        da = da + dacc[r]
    return dx, ddt, dbp, dcp, da[:, :ds].contiguous()


def selective_scan_bwd(x, dt, bp, cp, a, states, dy, dh=None):
    """The scan's gradient: (dx, ddt, dBp, dCp, dA), f32, from the
    forward's operands, its saved ``states`` (``selective_scan_fwd``),
    the output gradient ``dy`` (B, T, Di) and the final-state gradient
    ``dh`` (B, Di, Ds; ``None`` = zero).  CUDA tensors launch
    ``selective_scan_bwd_kernel`` and its two reductions once (counted
    as ``selective_scan_bwd``); CPU tensors run
    ``selective_scan_bwd_plain`` (which recomputes the states); meta
    tensors give the shapes."""
    _check(x, dt, bp, cp, a)
    b, t, di = x.shape
    ds = a.shape[1]
    dev = _device(x)
    work = bwd_work(b, t, di, ds, dh is not None)
    _check_grads(x, a, dy, dh)
    ops = _cast(x, dt, bp, cp, a)
    dy = dy.to(torch.float32).contiguous()
    if dh is not None:
        dh = dh.to(torch.float32).contiguous()
    if dev.type == "cpu":
        with cuda.kernel_work("selective_scan_bwd", *work, dev):
            return selective_scan_bwd_plain(*ops, dy, dh)
    for name, v in (("dy", dy), ("dh", dh), ("states", states)):
        if v is not None and v.device != dev:
            raise ValueError(f"x and {name} lie on {dev} and {v.device}")
    if tuple(states.shape) != (b, n_saved(t), di, ds):
        raise ValueError(f"states must be (B, n_saved(T), Di, Ds) = "
                         f"{(b, n_saved(t), di, ds)}; got "
                         f"{tuple(states.shape)}")
    states = states.contiguous()
    if dev.type == "cuda":
        cuda.require(dy, "dy")
        if dh is not None:
            cuda.require(dh, "dh")
        cuda.require(states, "states", (torch.float32,))
    elif states.dtype != torch.float32:
        raise TypeError(f"states dtype {states.dtype} is not float32")
    f32 = dict(dtype=torch.float32, device=dev)
    with cuda.kernel_work("selective_scan_bwd", *work, dev):
        dx = torch.empty((b, t, di), **f32)
        ddt = torch.empty((b, t, di), **f32)
        dbp = torch.empty((b, t, ds), **f32)
        dcp = torch.empty((b, t, ds), **f32)
        da = torch.empty((di, ds), **f32)
        if t == 0:
            return dx, ddt, dbp, dcp, da.zero_()
        plan, nb = bwd_grid(b, di, ds)
        wb = torch.empty((b, nb, t, ds), **f32)
        wc = torch.empty((b, nb, t, ds), **f32)
        wa = torch.empty((b, di, ds), **f32)
        if dev.type == "cuda":
            cuda.launch("selective_scan_bwd", "scan_selective_bwd", dev,
                        *(v.data_ptr() for v in ops),
                        states.data_ptr() if states.numel() else None,
                        dy.data_ptr(),
                        dh.data_ptr() if dh is not None else None,
                        *(v.data_ptr() for v in (dx, ddt, dbp, dcp, da, wb,
                                                 wc, wa)),
                        b, t, di, ds, plan.states, plan.lanes, plan.passes,
                        plan.ch, plan.ck)
    return dx, ddt, dbp, dcp, da


class SelectiveScan(torch.autograd.Function):
    """``selective_scan`` with its gradient: the forward keeps the
    operands and the states it saved; the backward is
    ``selective_scan_bwd`` (the kernel on CUDA tensors, the plain
    version on CPU tensors).  A gradient of y or h left undefined is
    zero (``dh=None`` reaches the kernel as a null pointer).  Under
    ``torch.utils.checkpoint`` the forward runs again in the recompute,
    and launches again."""

    @staticmethod
    def forward(ctx, x, dt, bp, cp, a):
        ctx.set_materialize_grads(False)
        y, h, states = selective_scan_fwd(x, dt, bp, cp, a)
        ctx.save_for_backward(x, dt, bp, cp, a, states)
        return y, h

    @staticmethod
    def backward(ctx, dy, dh):
        x, dt, bp, cp, a, states = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros_like(x, dtype=torch.float32)
        return selective_scan_bwd(x, dt, bp, cp, a, states, dy, dh)


def footprint(b, t, di, ds, *, block_di: int = 256) -> Footprint:
    bdi = min(block_di, di)
    vmem = (2 * t * bdi + 2 * t * ds + bdi * ds * 2 + t * bdi) * 4
    hbm = (2 * b * t * di + 2 * b * t * ds + di * ds
           + b * t * di + b * di * ds) * 4
    vpu = b * t * di * ds * 6       # dA, dBx, h update, y reduce
    return Footprint(vmem_bytes=int(vmem), hbm_bytes=int(hbm), mxu_passes=0,
                     vpu_ops=int(vpu),
                     est_cycles=cost_cycles(vpu_op_cycles(vpu), hbm),
                     outputs_per_pass=1, max_operand_bits=32)
