"""Selective scan — the SSM recurrence of a Mamba block with the state
kept on chip for the whole sequence.

Replaces ``repro/kernels/mamba_scan/scan.py::selective_scan``.  The
reference walks a grid (B, Di/bdi), holds one (bdi, Ds) state block in
VMEM scratch and loops over T with ``fori_loop``, so only x/dt/B/C
stream in and y streams out: device-memory traffic O(T·(Di + Ds))
where the ``lax.scan`` twin round-trips the (Di x Ds) state every step.
It is the Conv1-style logic-only end of the library: no MXU.

The kernel (``selective_scan_kernel<S>`` in ``csrc/scan_kernels.cu``)
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

    def smem_bytes(self) -> int:
        """The kernel's shared memory (``smem_floats`` of
        ``csrc/scan_kernels.cu``): x and dt, two buffers of tc x ch; Bp
        and Cp, two of tc x lanes*states; the lanes' partials."""
        ls = self.lanes * self.states
        parts = self.lanes * self.ch if self.lanes > 1 else 0
        return 4 * self.tc * (4 * self.ch + 4 * ls + parts)


def tree_shape(ds: int):
    """(P, Q): Ds padded to the next power of two P, taken in Q passes of
    at most ``PASS_STATES`` states."""
    p = 1 << (ds - 1).bit_length()
    return p, max(1, p // PASS_STATES)


def lane_plan(b: int, di: int, ds: int, sms: int) -> ScanPlan:
    """The launch plan for (B, Di, Ds) on a card of ``sms`` SMs
    (``cuda.sm_count``): a pass's P / Q states (see ``tree_shape``) go
    16 (or all, if fewer) to a thread; then, while the card would hold
    fewer than ``TARGET_THREADS_PER_SM`` threads an SM (B * Di * lanes
    in all), a thread takes half as many (not below 4) on twice the
    lanes (at most 8).  Every Ds >= 1 gets a plan; the
    y sum's order does not depend on it."""
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
    return plan._replace(tc=max(1, min(MAX_CHUNK, SMEM_BYTES // per_step)))


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


def selective_scan_plain(x: torch.Tensor, dt: torch.Tensor, bp: torch.Tensor,
                         cp: torch.Tensor, a: torch.Tensor):
    """The kernel's function in plain PyTorch, in its order: the
    oracle's recurrence step by step (``selective_scan_ref``) on A, Bp
    and Cp padded with zero states to a power of two, y summed by
    ``scan_tree_sum``; the padding's final states are dropped."""
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
    for i in range(t):
        dt_t = dt[:, i]
        d_a = torch.exp(dt_t[..., None] * a[None])
        d_bx = (dt_t * x[:, i])[..., None] * bp[:, i, None, :]
        h = d_a * h + d_bx
        y[:, i] = scan_tree_sum(h * cp[:, i, None, :], passes)
    return y, h[..., :ds].contiguous()


def selective_scan(x: torch.Tensor, dt: torch.Tensor, bp: torch.Tensor,
                   cp: torch.Tensor, a: torch.Tensor, *,
                   block_di: int = 256):
    """x/dt: (B,T,Di); bp/cp: (B,T,Ds); a: (Di,Ds) -> (y (B,T,Di), h
    (B,Di,Ds)), both f32; inputs are cast to f32.  CUDA tensors launch
    the kernel once; CPU tensors run ``selective_scan_plain``."""
    _check(x, dt, bp, cp, a)
    check_block("block_di", block_di)
    if not x.is_cuda:
        return selective_scan_plain(x, dt, bp, cp, a)
    b, t, di = x.shape
    ds = a.shape[1]
    ops = [v.to(torch.float32).contiguous() for v in (x, dt, bp, cp, a)]
    for name, v in zip(("x", "dt", "Bp", "Cp", "A"), ops):
        cuda.require(v, name)
        if v.device != x.device:
            raise ValueError(f"x and {name} lie on {x.device} and "
                             f"{v.device}")
    y = torch.empty((b, t, di), dtype=torch.float32, device=x.device)
    h = torch.empty((b, di, ds), dtype=torch.float32, device=x.device)
    if h.numel() == 0:
        return y, h
    plan = lane_plan(b, di, ds, cuda.sm_count(x.device))
    cuda.launch("selective_scan", "scan_selective", x.device,
                *(v.data_ptr() for v in ops), y.data_ptr(), h.data_ptr(),
                b, t, di, ds, *plan)
    return y, h


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
