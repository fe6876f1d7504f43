"""The port's ssm_scan family (``repro_torch.kernels.mamba_scan`` and its
library registration) against the reference (``repro``).

On a CPU tensor the port's ``selective_scan`` runs its plain PyTorch
version, the function the CUDA kernel is checked against on the card by
``chip_smoke.py``.  The reference's Pallas kernel does not run on the
installed JAX (``pl.load`` is gone: ROADMAP queue 3), so the port is
held against its oracle, ``selective_scan_ref``, as queue 2 item 16
says.  Inputs are made with numpy from a seed, as the reference test's
``_data`` draws them; the bound is the reference test's own
(``rtol=1e-5, atol=1e-6``): both sides run the same f32 recurrence, the
y sum over Ds in another order.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import library as j_library
from repro.core import plan as j_plan
from repro.core.ip import SiteSpec as JSpec
from repro.kernels.mamba_scan import scan as j_scan
from repro.kernels.mamba_scan.ref import selective_scan_ref as j_ref
from repro_torch.core import library as t_library
from repro_torch.core import plan as t_plan
from repro_torch.core.ip import SiteSpec as TSpec
from repro_torch.kernels import cuda
from repro_torch.kernels.mamba_scan import scan as t_scan
from repro_torch.kernels.mamba_scan.ref import selective_scan_ref
from repro_torch.kernels.mamba_scan.scan import (selective_scan,
                                                 selective_scan_plain)

TOL = dict(rtol=1e-5, atol=1e-6)
# the reference's tests/test_kernels_mamba_scan.py::CASES (B, T, Di, Ds,
# block_di), a case at d_state 16 with Di no multiple of the block, and
# d_state 1 and 32 (the kernel takes any d_state)
CASES = [(1, 8, 16, 4, 16), (2, 16, 32, 8, 16), (2, 12, 24, 4, 8),
         (2, 64, 48, 16, 32), (1, 8, 16, 1, 16), (2, 16, 24, 32, 8)]
FOOTPRINT_GRID = [(1, 2048, 16384, 16), (8, 4096, 4096, 16),
                  (4, 512, 16384, 16), (2, 12, 24, 4), (1, 64, 100, 8)]


def _data(rng, b, t, di, ds):
    """The reference test's distribution (``_data``), as numpy."""
    return (rng.normal(size=(b, t, di)).astype(np.float32),
            (0.1 * np.abs(rng.normal(size=(b, t, di)))).astype(np.float32),
            rng.normal(size=(b, t, ds)).astype(np.float32),
            rng.normal(size=(b, t, ds)).astype(np.float32),
            (-np.abs(rng.normal(size=(di, ds)))).astype(np.float32))


def _reference(ops):
    y, h = j_ref(*(jnp.asarray(a) for a in ops))
    return np.asarray(y), np.asarray(h)


@pytest.mark.parametrize("fn", ["plain", "wrapper"])
@pytest.mark.parametrize("case", CASES, ids=lambda c: "x".join(map(str, c)))
def test_selective_scan_matches_reference(case, fn):
    b, t, di, ds, bdi = case
    ops = _data(np.random.default_rng(0), b, t, di, ds)
    want_y, want_h = _reference(ops)
    tops = [torch.from_numpy(a) for a in ops]
    if fn == "plain":
        y, h = selective_scan_plain(*tops)
    else:
        y, h = selective_scan(*tops, block_di=bdi)
    assert y.dtype == h.dtype == torch.float32
    assert tuple(y.shape) == (b, t, di) and tuple(h.shape) == (b, di, ds)
    np.testing.assert_allclose(y.numpy(), want_y, **TOL)
    np.testing.assert_allclose(h.numpy(), want_h, **TOL)


def test_block_hint_does_not_change_results():
    ops = [torch.from_numpy(a)
           for a in _data(np.random.default_rng(1), 2, 40, 48, 8)]
    y0, h0 = selective_scan(*ops)
    for bdi in (1, 8, 48, 1024):
        y, h = selective_scan(*ops, block_di=bdi)
        assert torch.equal(y, y0) and torch.equal(h, h0)


def test_bf16_inputs_give_the_reference_f32_outputs():
    ops = _data(np.random.default_rng(2), 2, 16, 32, 8)
    j_ops = [jnp.asarray(a, jnp.bfloat16) for a in ops]
    want_y, want_h = (np.asarray(v) for v in j_ref(*j_ops))
    t_ops = [torch.from_numpy(a).to(torch.bfloat16) for a in ops]
    # both sides see the same bf16 values
    for j, t in zip(j_ops, t_ops):
        np.testing.assert_array_equal(np.asarray(j, np.float32),
                                      t.to(torch.float32).numpy())
    y, h = selective_scan(*t_ops)
    assert y.dtype == h.dtype == torch.float32
    np.testing.assert_allclose(y.numpy(), want_y, **TOL)
    np.testing.assert_allclose(h.numpy(), want_h, **TOL)


def test_empty_sequence_returns_zero_state():
    ops = [torch.from_numpy(a)
           for a in _data(np.random.default_rng(3), 2, 0, 8, 4)]
    y, h = selective_scan(*ops)
    assert tuple(y.shape) == (2, 0, 8)
    assert torch.equal(h, torch.zeros(2, 8, 4))


def test_bad_operands_raise_named_errors():
    x, dt, bp, cp, a = (torch.from_numpy(v) for v in
                        _data(np.random.default_rng(4), 1, 4, 8, 4))
    with pytest.raises(ValueError, match=r"x and dt \(B, T, Di\)"):
        selective_scan(x, dt[:, :3], bp, cp, a)
    with pytest.raises(ValueError, match=r"A must be \(Di, Ds\)"):
        selective_scan(x, dt, bp, cp, a[:4])
    with pytest.raises(ValueError, match=r"Cp must be \(B, T, Ds\)"):
        selective_scan(x, dt, bp, cp[..., :2], a)
    with pytest.raises(ValueError, match="block_di must be >= 1"):
        selective_scan(x, dt, bp, cp, a, block_di=0)


def test_cpu_calls_count_no_launch():
    ops = [torch.from_numpy(a)
           for a in _data(np.random.default_rng(5), 1, 8, 16, 4)]
    cuda.reset_launches()
    selective_scan(*ops)
    t_library.get_family("ssm_scan")["ssm_scan.selective_vmem"](*ops)
    assert cuda.launch_counts() == {}
    # a d_state that is no power of two runs the plain version too
    ops5 = [torch.from_numpy(a)
            for a in _data(np.random.default_rng(5), 1, 8, 16, 5)]
    selective_scan(*ops5)
    assert cuda.launch_counts() == {}


# (B, Di, Ds): the served site, four batch rows, d_state 32 at full
# width, every small d_state of SCAN_SMALL_CASES and chip_smoke's
# d_state 1, 5, 17 and 300 (two passes past 128 states), a lone channel
PLAN_CASES = [(1, 16384, 16), (4, 16384, 16), (1, 16384, 32), (1, 16, 4),
              (2, 32, 8), (1, 72, 4), (1, 16, 1), (2, 33, 5), (1, 50, 17),
              (1, 40, 300), (1, 1, 16), (8, 4096, 128)]


@pytest.mark.parametrize("sms", [132, 114], ids=["h100_sxm", "h100_pcie"])
@pytest.mark.parametrize("b,di,ds", PLAN_CASES,
                         ids=lambda c: str(c))
def test_lane_plan(b, di, ds, sms):
    """The kernel's launch plan on a card of ``sms`` SMs (an H100 SXM's
    or PCIe's count): a thread's states, the lanes and the passes cover
    Ds padded to a power of two (``tree_shape``), a CTA fits 256 threads
    and the shared memory, the CTAs cover every channel, and the lanes
    split a channel until the card holds its target of threads an SM or
    a thread keeps 4 states; then the kernel's tree over the plan's
    (state, lane, pass) cut is bitwise ``scan_tree_sum``."""
    plan = t_scan.lane_plan(b, di, ds, sms)
    p2, passes = t_scan.tree_shape(ds)
    assert p2 >= ds > p2 // 2 and passes == max(1, p2 // 128)
    assert plan.states in (1, 2, 4, 8, 16) and plan.lanes <= 8
    assert plan.states * plan.lanes * plan.passes == p2
    assert plan.passes == passes
    assert plan.ch % 32 == 0 and plan.ch * plan.lanes <= t_scan.MAX_THREADS
    assert plan.ch < di + 32
    assert 1 <= plan.tc <= t_scan.MAX_CHUNK
    assert plan.smem_bytes() <= t_scan.SMEM_BYTES
    threads = b * di * plan.lanes
    if plan.states > 4 and plan.lanes < 8:
        assert threads >= sms * t_scan.TARGET_THREADS_PER_SM
    if (b, di, ds) == (1, 16384, 16):
        assert tuple(plan) == (4, 4, 1, 64, 21)
    # the forward that saves states: the same cut, chunks that divide
    # BWD_CHUNK (every saved state ends a chunk), and the saved state's
    # buffer fits beside them
    saving = t_scan.lane_plan(b, di, ds, sms, save=True)
    assert saving[:4] == plan[:4]
    assert 1 <= saving.tc <= min(plan.tc, t_scan.BWD_CHUNK)
    assert t_scan.BWD_CHUNK % saving.tc == 0
    assert saving.smem_bytes(save=True) <= t_scan.SMEM_BYTES
    if (b, di, ds) == (1, 16384, 16):
        assert saving.tc == 16
    # the kernel's order on the plan: lane l's register k holds product
    # (k * lanes + l) * passes + q; a halving tree over the registers,
    # then over the lanes, then the passes in order
    prods = torch.from_numpy(np.random.default_rng(ds).normal(
        size=(3, p2)).astype(np.float32))
    s, lanes = plan.states, plan.lanes
    y = None
    for q in range(plan.passes):
        lane_sums = []
        for lane in range(lanes):
            v = [prods[:, (k * lanes + lane) * plan.passes + q]
                 for k in range(s)]
            while len(v) > 1:
                v = [a + b for a, b in zip(v[:len(v) // 2],
                                           v[len(v) // 2:])]
            lane_sums.append(v[0])
        while len(lane_sums) > 1:
            half = len(lane_sums) // 2
            lane_sums = [a + b for a, b in zip(lane_sums[:half],
                                               lane_sums[half:])]
        y = lane_sums[0] if y is None else y + lane_sums[0]
    assert torch.equal(y, t_scan.scan_tree_sum(prods, plan.passes))
    np.testing.assert_allclose(y.numpy(), prods.sum(-1).numpy(),
                               rtol=1e-5, atol=1e-5)


def test_plain_version_pads_and_keeps_the_oracles_recurrence():
    """The plain version (the kernel's order) is the oracle's recurrence
    with the y sum re-ordered: h bitwise, y within the reference bound;
    zero-padded states change neither."""
    for ds in (5, 16, 32):
        ops = [torch.from_numpy(a) for a in
               _data(np.random.default_rng(ds), 2, 24, 40, ds)]
        y, h = selective_scan_plain(*ops)
        want_y, want_h = selective_scan_ref(*ops)
        assert torch.equal(h, want_h)
        np.testing.assert_allclose(y.numpy(), want_y.numpy(), **TOL)


@pytest.mark.parametrize("shape", FOOTPRINT_GRID,
                         ids=lambda s: "x".join(map(str, s)))
def test_footprint_equals_reference(shape):
    for kw in ({}, dict(block_di=64), dict(block_di=100000)):
        assert dataclasses.asdict(t_scan.footprint(*shape, **kw)) == \
            dataclasses.asdict(j_scan.footprint(*shape, **kw))


def test_footprint_hbm_advantage():
    """The reference test's assertions on the port's footprint."""
    b, t, di, ds = 8, 4096, 4096, 16
    fp = t_scan.footprint(b, t, di, ds)
    scan_twin_state_traffic = 2 * b * t * di * ds * 4
    assert fp.hbm_bytes * 4 < scan_twin_state_traffic
    assert fp.mxu_passes == 0


def test_library_registers_ssm_scan_as_the_reference_does():
    assert list(t_library.FAMILIES) == list(j_library.FAMILIES)
    t_fam, j_fam = t_library.SSM_SCAN, j_library.SSM_SCAN
    assert t_library.get_family("ssm_scan") is t_fam
    assert t_fam.quantizable is j_fam.quantizable is False
    assert t_fam.reference is selective_scan_ref
    assert t_fam.site_adapter is None and j_fam.site_adapter is None
    assert t_fam.names() == j_fam.names() == ["ssm_scan.selective_vmem"]
    t_ip, j_ip = t_fam["selective_vmem"], j_fam["selective_vmem"]
    for field in ("name", "family", "uses_mxu", "max_operand_bits",
                  "outputs_per_pass", "supports_dtypes", "tags",
                  "description"):
        assert getattr(t_ip, field) == getattr(j_ip, field), field
    assert t_library.get_ip("ssm_scan.selective_vmem").impl is selective_scan
    assert dataclasses.asdict(t_ip.footprint(1, 2048, 16384, 16)) == \
        dataclasses.asdict(j_ip.footprint(1, 2048, 16384, 16))


@pytest.mark.parametrize("name", ["rwkv_scan", "ssm_scan.nope", "conv3d.x"])
def test_unknown_names_raise_key_error_as_the_reference(name):
    for lib in (t_library, j_library):
        with pytest.raises(KeyError):
            lib.get_ip(name)
        with pytest.raises(KeyError):
            lib.get_family(name.partition(".")[0] + "_family")


def test_planning_an_ssm_site_raises_the_reference_message():
    shapes = ((1, 8, 16), (1, 8, 4))
    with pytest.raises(NotImplementedError) as want:
        j_plan.plan_network([JSpec.make("s", "ssm_scan", shapes)])
    with pytest.raises(NotImplementedError) as got:
        t_plan.plan_network([TSpec.make("s", "ssm_scan", shapes)])
    assert str(got.value) == str(want.value)
    with pytest.raises(NotImplementedError) as want:
        j_plan.select_ip("ssm_scan", JSpec.make("s", "ssm_scan", shapes))
    with pytest.raises(NotImplementedError) as got:
        t_plan.select_ip("ssm_scan", TSpec.make("s", "ssm_scan", shapes))
    assert str(got.value) == str(want.value)
    assert "has no site adapter registered" in str(got.value)


# ---------------------------------------------------------------------------
# The backward (SelectiveScan, selective_scan_bwd, its plain version)
# ---------------------------------------------------------------------------
# (B, T, Di, Ds): the reference test's CASES, and d_state 1, 5, 32 and
# 300 (padded to 512: sixteen passes of 32 lanes), T no multiple of the
# backward's chunk of 16 steps
BWD_CASES = [(1, 8, 16, 4), (2, 16, 32, 8), (2, 12, 24, 4), (1, 8, 16, 1),
             (2, 40, 33, 5), (1, 30, 70, 32), (1, 9, 40, 300),
             (2, 45, 100, 16)]
# against jax.grad of the oracle: the same f32 recurrence, its sums in
# another order; errors are at most 3e-6 of each gradient's RMS
BWD_RTOL = 1e-5
BWD_ATOL_RMS = 1e-5


def _grads_of_reference(ops, dy, dh):
    def loss(*o):
        y, h = j_ref(*o)
        out = jnp.sum(y * dy)
        return out + jnp.sum(h * dh) if dh is not None else out
    return [np.asarray(g) for g in jax.grad(loss, argnums=range(5))(
        *(jnp.asarray(a) for a in ops))]


def _close_rms(got, want, rtol, atol_rms, what):
    rms = float(np.sqrt(np.mean(np.square(want.astype(np.float64)))))
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol_rms * rms,
                               err_msg=what)


@pytest.mark.parametrize("with_dh", [True, False], ids=["dh", "no_dh"])
@pytest.mark.parametrize("case", BWD_CASES,
                         ids=lambda c: "x".join(map(str, c)))
def test_backward_plain_matches_jax_grad_of_the_oracle(case, with_dh):
    rng = np.random.default_rng(sum(case))
    ops = _data(rng, *case)
    b, t, di, ds = case
    dy = rng.normal(size=(b, t, di)).astype(np.float32)
    dh = rng.normal(size=(b, di, ds)).astype(np.float32) if with_dh else None
    want = _grads_of_reference(ops, dy, dh)
    got = t_scan.selective_scan_bwd_plain(
        *(torch.from_numpy(a) for a in ops), torch.from_numpy(dy),
        None if dh is None else torch.from_numpy(dh))
    for name, g, w in zip(("dx", "ddt", "dBp", "dCp", "dA"), got, want):
        assert g.dtype == torch.float32 and tuple(g.shape) == w.shape
        _close_rms(g.numpy(), w, BWD_RTOL, BWD_ATOL_RMS, name)
    # the CPU wrapper is the plain version, whatever states it is given
    cuda.reset_launches()
    again = t_scan.selective_scan_bwd(
        *(torch.from_numpy(a) for a in ops), None, torch.from_numpy(dy),
        None if dh is None else torch.from_numpy(dh))
    assert cuda.launch_counts() == {}
    assert all(torch.equal(a, c) for a, c in zip(again, got))


@pytest.mark.parametrize("case", BWD_CASES[:4] + BWD_CASES[6:7],
                         ids=lambda c: "x".join(map(str, c)))
def test_function_grads_match_autograd_through_the_plain_version(case):
    """``selective_scan`` with operands that need a gradient runs
    ``SelectiveScan``; its grads equal autograd's through
    ``selective_scan_plain`` (the same f32 math; sums in another order)
    for a loss of y alone (``dh`` undefined) and of y and h."""
    rng = np.random.default_rng(7)
    ops = _data(rng, *case)
    wy = torch.from_numpy(rng.normal(size=case[:3]).astype(np.float32))
    for use_h in (False, True):
        grads = []
        for fn in (selective_scan, selective_scan_plain):
            leaves = [torch.from_numpy(a).requires_grad_(True) for a in ops]
            y, h = fn(*leaves)
            loss = (y * wy).sum() + ((h * h).sum() if use_h else 0)
            grads.append(torch.autograd.grad(loss, leaves))
        for g, w in zip(*grads):
            _close_rms(g.numpy(), w.numpy(), BWD_RTOL, BWD_ATOL_RMS, "")


def test_function_runs_under_checkpoint():
    """Under ``torch.utils.checkpoint`` the forward runs again in the
    recompute; the grads are those of a plain run bitwise."""
    from torch.utils.checkpoint import checkpoint
    ops = [torch.from_numpy(a) for a in
           _data(np.random.default_rng(8), 2, 20, 24, 8)]

    def grads(remat):
        leaves = [o.clone().requires_grad_(True) for o in ops]
        fn = (lambda *o: selective_scan(*o)[0].square().sum())
        loss = (checkpoint(fn, *leaves, use_reentrant=False) if remat
                else fn(*leaves))
        return torch.autograd.grad(loss, leaves)
    assert all(torch.equal(a, b) for a, b in zip(grads(True), grads(False)))


def test_forward_states_are_the_recurrences_at_chunk_ends():
    ops = [torch.from_numpy(a) for a in
           _data(np.random.default_rng(9), 2, 50, 16, 5)]
    y, h, states = t_scan.selective_scan_fwd(*ops)
    want_y, want_h = selective_scan_plain(*ops)
    assert torch.equal(y, want_y) and torch.equal(h, want_h)
    ck = t_scan.BWD_CHUNK
    assert tuple(states.shape) == (2, t_scan.n_saved(50), 16, 5) == \
        (2, 3, 16, 5)
    for k in range(states.shape[1]):
        _, hk = selective_scan_plain(*(o[:, :(k + 1) * ck] if o.dim() == 3
                                       else o for o in ops))
        assert torch.equal(states[:, k], hk)
    assert [t_scan.n_saved(t) for t in (0, 1, 16, 17, 32, 33)] == \
        [0, 0, 0, 1, 1, 2]


@pytest.mark.parametrize("ds", [1, 2, 5, 16, 32, 33, 300])
def test_backward_plan_covers_the_states(ds):
    """A thread's states, the lanes and the passes cover Ds padded to a
    power of two; a pass holds min(P, 32) states (one pass up to 32
    states, as scan_tree_sum's passes for the sums over states); a CTA
    is BWD_THREADS threads and its shared memory fits the card."""
    plan = t_scan.bwd_plan(ds)
    p2 = 1 << (ds - 1).bit_length()
    assert plan.states == min(p2, t_scan.BWD_STATES)
    assert plan.lanes == min(p2 // plan.states, t_scan.MAX_LANES)
    assert plan.states * plan.lanes * plan.passes == p2
    assert plan.states * plan.lanes == min(p2, 32)
    assert plan.ch * plan.lanes == t_scan.BWD_THREADS
    assert plan.ck == t_scan.BWD_CHUNK
    assert plan.smem_bytes() <= t_scan.BWD_SMEM_BYTES
    if ds == 16:
        assert tuple(plan) == (4, 4, 1, 32, 16)
        assert 2 * plan.smem_bytes() <= t_scan.BWD_SMEM_BYTES


def test_halving_tree_is_the_kernels_order():
    """``halving_tree`` pairs j with j + n/2 over the axis zero-padded to
    a power of two, as the kernel's shuffles and shared-memory trees
    do."""
    v = torch.from_numpy(np.random.default_rng(10).normal(
        size=(3, 11)).astype(np.float32))
    p = list(torch.nn.functional.pad(v, (0, 5)).unbind(-1))
    while len(p) > 1:
        half = len(p) // 2
        p = [a + b for a, b in zip(p[:half], p[half:])]
    assert torch.equal(t_scan.halving_tree(v, 1), p[0])
    assert torch.equal(t_scan.halving_tree(v.T, 0), p[0])
    np.testing.assert_allclose(t_scan.halving_tree(v, 1).numpy(),
                               v.sum(1).numpy(), rtol=1e-5, atol=1e-6)


def _halving(vals):
    """The halving tree over a list (j + n/2 onto j), zero-padded to a
    power of two, level by level."""
    vals = list(vals)
    n = 1 << max(len(vals) - 1, 0).bit_length()
    vals += [torch.zeros_like(vals[0])] * (n - len(vals))
    while len(vals) > 1:
        half = len(vals) // 2
        vals = [a + b for a, b in zip(vals[:half], vals[half:])]
    return vals[0]


def _even_odd(vals):
    """The kernels' recursion for the same tree (``htree``,
    ``strided_tree`` in ``csrc/scan_kernels.cu``): the tree over the
    even elements plus the tree over the odd ones."""
    if len(vals) == 1:
        return vals[0]
    return _even_odd(vals[0::2]) + _even_odd(vals[1::2])


@pytest.mark.parametrize("b,di,ds", [(1, 100, 16), (2, 70, 5), (1, 2000, 4),
                                     (3, 40, 300), (1, 4200, 300)],
                         ids=lambda c: str(c))
def test_cross_channel_and_cross_cta_sums_are_the_kernels_order(b, di, ds):
    """The dB / dC sums over channels as the kernels cut them: each CTA's
    ``htree`` over its ch channels (Di zero-padded to nb * ch), then
    ``scan_bwd_reduce_bc_kernel`` over the nb partials (zero-padded to
    np2, a power of two; rows = min(np2, 256): each row j first sums j,
    j + rows, .. by ``strided_tree``, then the rows' halving tree level
    by level in shared memory) equal ``_channel_partials`` and
    ``halving_tree`` bitwise, and the level-by-level tree."""
    plan = t_scan.bwd_plan(ds)
    ch = plan.ch
    terms = torch.from_numpy(np.random.default_rng(di).normal(
        size=(b, di, 3)).astype(np.float32))
    want = t_scan.halving_tree(t_scan._channel_partials(terms, plan), 1)
    nb = -(-di // ch)
    padded = torch.nn.functional.pad(terms, (0, 0, 0, nb * ch - di))
    parts = [_even_odd([padded[:, cta * ch + c] for c in range(ch)])
             for cta in range(nb)]
    np2 = 1 << max(nb - 1, 0).bit_length()
    rows = min(np2, t_scan.REDUCE_ROWS)
    assert np2 // rows <= t_scan.REDUCE_SPAN
    zero = torch.zeros_like(parts[0])
    row_sums = [_even_odd([parts[j + i * rows] if j + i * rows < nb
                           else zero for i in range(np2 // rows)])
                for j in range(rows)]
    assert torch.equal(_halving(row_sums), want)
    assert torch.equal(_halving([_halving(
        [padded[:, cta * ch + c] for c in range(ch)])
        for cta in range(nb)]), want)
    np.testing.assert_allclose(want.numpy(), terms.sum(1).numpy(),
                               rtol=1e-5, atol=1e-5)


def test_backward_bad_operands_raise_named_errors():
    x, dt, bp, cp, a = (torch.from_numpy(v) for v in
                        _data(np.random.default_rng(11), 1, 4, 8, 4))
    dy = torch.zeros(1, 4, 8)
    with pytest.raises(ValueError, match=r"dy must be \(B, T, Di\)"):
        t_scan.selective_scan_bwd_plain(x, dt, bp, cp, a, dy[:, :3])
    with pytest.raises(ValueError, match=r"dh must be \(B, Di, Ds\)"):
        t_scan.selective_scan_bwd(x, dt, bp, cp, a, None, dy,
                                  torch.zeros(1, 8, 3))
    with pytest.raises(ValueError, match="bwd_plan takes Ds >= 1"):
        t_scan.bwd_plan(0)
    ch = t_scan.bwd_plan(16).ch
    most = t_scan.REDUCE_ROWS * t_scan.REDUCE_SPAN * ch
    assert t_scan.bwd_grid(1, most, 16)[1] == t_scan.REDUCE_ROWS * \
        t_scan.REDUCE_SPAN
    with pytest.raises(ValueError, match=f"at most {most} channels at "
                                         f"d_state 16, got Di = {most + 1}"):
        t_scan.bwd_grid(1, most + 1, 16)
    with pytest.raises(ValueError, match="at most 65535 batch rows"):
        t_scan.bwd_grid(65536, 8, 4)
