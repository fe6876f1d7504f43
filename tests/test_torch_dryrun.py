"""The port's dry-run (``repro_torch.launch.{analysis,dryrun,report}``)
against the reference's (``repro.launch``).

One subprocess of the reference, with its 512 placeholder host devices,
evaluates the shapes and specs of every cell (nothing is compiled):
static bytes a device, skip reasons, ``model_flops``, ``ideal_traffic``
and ``deployed_traffic``.  The port's side traces ``meta`` tensors on
the CPU.
"""
import dataclasses
import io
import json
import os
import subprocess
import sys
import textwrap
from contextlib import redirect_stdout
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import (ARCH_NAMES, SHAPES, ShapeConfig,
                                 get_config, shape_applicable)
from repro_torch.distributed import collectives, shard_train
from repro_torch.distributed.sharding import (ShardingPolicy, param_spec,
                                              state_pspecs, to_shardings,
                                              tree_map_with_path)
from repro_torch.launch import analysis, dryrun as dr, report
from repro_torch.launch.mesh import (Mesh, make_host_mesh,
                                     make_production_mesh)
from repro_torch.models import api
from repro_torch.models.frontends import input_specs, make_inputs
from repro_torch.optim.adamw import AdamWConfig, tree_leaves

REPO = Path(__file__).resolve().parent.parent
GRID = {False: (16, 16, 256), True: (32, 16, 512)}     # (dp, tp, chips)
PERF_CELLS = (("olmo-1b", "train_4k"), ("grok-1-314b", "train_4k"),
              ("llava-next-34b", "prefill_32k"))
TINY_SHAPES = {"train_4k": (64, 8), "decode_32k": (128, 8)}   # (seq, batch)
V5E = dict(peak_flops=197e12, hbm_bw=819e9, link_bw=50e9, links=4)

REFERENCE = """
import json
import repro.launch.dryrun as dr          # 512 placeholder host devices
import dataclasses
import jax
from repro.configs import ARCH_NAMES, SHAPES, get_config, shape_applicable
from repro.launch.analysis import deployed_traffic, ideal_traffic, model_flops
from repro.launch.mesh import make_production_mesh

GRID = {False: (16, 16, 256), True: (32, 16, 512)}
out = {"cells": {}, "analysis": {}, "perf": {}, "tiny": {}}
meshes = {m: make_production_mesh(multi_pod=m) for m in (False, True)}
for arch in ARCH_NAMES:
    cfg = get_config(arch)
    pol = dr.ShardingPolicy(fsdp=cfg.fsdp)
    for sh in SHAPES:
        ok, why = shape_applicable(cfg, SHAPES[sh])
        for multi in (False, True):
            key = f"{arch}|{sh}|{multi}"
            if not ok:
                out["cells"][key] = {"status": "skipped", "reason": why}
                continue
            static = dr.build_cell(cfg, sh, meshes[multi], pol)[3]
            out["cells"][key] = {"status": "ok", "static": static}
            dp, tp, chips = GRID[multi]
            out["analysis"][key] = {
                "model_flops": model_flops(cfg, SHAPES[sh]),
                "ideal": list(ideal_traffic(cfg, SHAPES[sh], dp, tp, chips,
                                            fsdp=cfg.fsdp)),
                "deployed": deployed_traffic(cfg, SHAPES[sh], dp, tp, chips,
                                             fsdp=cfg.fsdp)}
for arch, sh in PERF_CELLS:
    cfg = get_config(arch)
    if cfg.n_heads % 16 or cfg.n_kv_heads % 16:
        cfg = dataclasses.replace(cfg, n_heads=-(-cfg.n_heads // 16) * 16,
                                  n_kv_heads=16)
    out["perf"][f"{arch}|{sh}"] = deployed_traffic(
        cfg, SHAPES[sh], dp=16, tp=16, chips=256, fsdp=cfg.fsdp)
# the tiny-mesh setup of tests/test_distributed.py::test_dryrun_cells_tiny_mesh
cfg = get_config("olmo-1b")
for sh, (seq, batch) in TINY_SHAPES.items():
    SHAPES[sh] = dataclasses.replace(SHAPES[sh], seq_len=seq,
                                     global_batch=batch)
    for multi in (False, True):
        mesh = jax.make_mesh((2, 2, 2) if multi else (4, 2),
                             ("pod", "data", "model") if multi
                             else ("data", "model"))
        out["tiny"][f"{sh}|{multi}"] = dr.build_cell(
            cfg, sh, mesh, dr.ShardingPolicy())[3]
print("JSON" + json.dumps(out))
"""


@pytest.fixture(scope="module")
def ref():
    code = (f"PERF_CELLS = {PERF_CELLS!r}\nTINY_SHAPES = {TINY_SHAPES!r}\n"
            + textwrap.dedent(REFERENCE))
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=str(REPO / "src") + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, env=env)
    assert out.returncode == 0, out.stderr[-3000:]
    line = [ln for ln in out.stdout.splitlines() if ln.startswith("JSON")]
    return json.loads(line[-1][4:])


@pytest.fixture(scope="module")
def meta_meshes():
    return {m: make_production_mesh(multi_pod=m,
                                    devices=["meta"] * GRID[m][2])
            for m in (False, True)}


# ---------------------------------------------------------------------------
# Cells: static bytes and skips, the formulas
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_static_bytes_and_skips_equal_the_reference(arch, ref, meta_meshes):
    cfg = get_config(arch)
    pol = ShardingPolicy(fsdp=cfg.fsdp)
    for sh in SHAPES:
        ok, why = shape_applicable(cfg, SHAPES[sh])
        for multi in (False, True):
            want = ref["cells"][f"{arch}|{sh}|{multi}"]
            if not ok:
                assert want == {"status": "skipped", "reason": why}
                continue
            assert want["status"] == "ok"
            static = dr.build_cell(cfg, sh, meta_meshes[multi], pol)[3]
            assert static == want["static"], (sh, multi)


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_analysis_formulas_equal_the_reference(arch, ref):
    cfg = get_config(arch)
    for sh in SHAPES:
        for multi in (False, True):
            want = ref["analysis"].get(f"{arch}|{sh}|{multi}")
            if want is None:
                continue
            dp, tp, chips = GRID[multi]
            assert analysis.model_flops(cfg, SHAPES[sh]) == \
                want["model_flops"]
            assert list(analysis.ideal_traffic(
                cfg, SHAPES[sh], dp, tp, chips, fsdp=cfg.fsdp)) == \
                want["ideal"]
            assert analysis.deployed_traffic(
                cfg, SHAPES[sh], dp, tp, chips, fsdp=cfg.fsdp) == \
                want["deployed"]
    for a, sh in (c for c in PERF_CELLS if c[0] == arch):
        c = cfg
        if c.n_heads % 16 or c.n_kv_heads % 16:
            c = dataclasses.replace(c, n_heads=-(-c.n_heads // 16) * 16,
                                    n_kv_heads=16)
        assert analysis.deployed_traffic(
            c, SHAPES[sh], dp=16, tp=16, chips=256, fsdp=c.fsdp) == \
            ref["perf"][f"{a}|{sh}"]


def test_itemsize_reads_torch_dtype_names():
    assert [analysis.itemsize(n) for n in
            ("float32", "bfloat16", "int8", "float64")] == [4, 2, 1, 8]
    with pytest.raises(ValueError, match="names no torch dtype"):
        analysis.itemsize("not_a_dtype")


# ---------------------------------------------------------------------------
# The reference's three analysis tests, against the port
# ---------------------------------------------------------------------------
def test_collective_parser():
    ev = collectives.CollectiveEvent
    events = [ev("all-reduce", 128 * 256 * 4, 4, 0),
              ev("all-gather", 8 * 64 * 4, 4, 0),
              ev("reduce-scatter", 16 * 16 * 2, 4, 0),
              ev("collective-permute", 4 * 4, 2, 0)]
    out = analysis.collective_bytes(events)
    assert out["all-reduce"] == 128 * 256 * 4
    assert out["all-gather"] == 8 * 64 * 4 / 4      # result / group 4
    assert out["reduce-scatter"] == 16 * 16 * 2 * 4  # result * group 4
    assert out["collective-permute"] == 16
    assert out["total"] == sum(out[k] for k in
                               ("all-gather", "all-reduce", "reduce-scatter",
                                "all-to-all", "collective-permute"))
    assert out["counts"] == {"all-gather": 1, "all-reduce": 1,
                             "reduce-scatter": 1, "all-to-all": 0,
                             "collective-permute": 1}
    with pytest.raises(ValueError, match="unknown collective kind"):
        analysis.collective_bytes([ev("broadcast", 4, 2, 0)])


def test_roofline_terms():
    r = analysis.Roofline(flops=197e12 * 256, hbm_bytes=819e9 * 256,
                          coll_bytes=50e9 * 4 * 256, chips=256,
                          model_flops=197e12 * 256 * 0.5,
                          min_hbm_bytes=819e9 * 256 * 0.25,
                          min_coll_bytes=0, **V5E)
    assert abs(r.t_compute - 1.0) < 1e-9
    assert abs(r.t_memory - 1.0) < 1e-9
    assert abs(r.t_collective - 1.0) < 1e-9
    assert r.dominant in ("compute", "memory", "collective")
    assert 0 < r.roofline_fraction <= 1.0


def test_ideal_traffic_sane():
    for arch in ("olmo-1b", "dbrx-132b", "rwkv6-3b"):
        cfg = get_config(arch)
        for shape in ("train_4k", "decode_32k"):
            hbm, coll = analysis.ideal_traffic(cfg, SHAPES[shape], dp=16,
                                               tp=16, chips=256,
                                               fsdp=cfg.fsdp)
            assert hbm > 0 and coll >= 0
            assert analysis.model_flops(cfg, SHAPES[shape]) > 0


def test_h100_defaults():
    r = analysis.Roofline(flops=989e12, hbm_bytes=3.35e12,
                          coll_bytes=18 * 25e9, chips=1)
    assert (r.peak_flops, r.hbm_bw, r.link_bw, r.links) == \
        (989e12, 3.35e12, 25e9, 18)
    assert r.t_compute == r.t_memory == r.t_collective == 1.0
    assert analysis.H100_HBM_BYTES == 80 * 2**30


def test_op_histogram_names():
    buckets = {"transpose": 3, "copy": 2, "convert": 1}
    assert analysis.op_histogram(buckets) == {
        "transpose": 3, "reshape": 0, "copy": 2, "convert": 1, "fusion": 0,
        "while": 0}
    assert analysis.histogram_name("_to_copy", True) == "convert"
    assert analysis.histogram_name("_to_copy", False) == "copy"
    assert analysis.histogram_name("permute") == "transpose"
    assert analysis.histogram_name("view") == "reshape"
    assert analysis.histogram_name("mm") is None


# ---------------------------------------------------------------------------
# Counting on a tiny config
# ---------------------------------------------------------------------------
def _tiny(layers=1, **kw):
    """A narrow dense config: one head group, SwiGLU, no remat."""
    base = dict(n_layers=layers, d_model=32, n_heads=4, n_kv_heads=4,
                head_dim=8, d_ff=64, vocab_size=96, remat="none",
                tie_embeddings=False, compute_dtype="float32")
    base.update(kw)
    return dataclasses.replace(get_config("llama3.2-1b", smoke=True), **base)


def _train_on(cfg, mesh, batch, seq, device):
    """The sharded train step's arguments on ``mesh``: (state, batch)."""
    opt = AdamWConfig(moment_dtype=cfg.moment_dtype)
    shape = ShapeConfig("t", seq, batch, "train")
    if device == "meta":
        state = api.init_train_state_abstract(cfg, opt)
        data = input_specs(cfg, shape)
    else:
        state = api.init_train_state(cfg, opt, 0, device=device)
        data = make_inputs(cfg, shape, seed=0, abstract=False, device=device)
    spec = state_pspecs(cfg, mesh, state, ShardingPolicy(fsdp=cfg.fsdp))
    placed = dr.place((state, data), (to_shardings(mesh, spec), None), mesh)
    return lambda s, b: shard_train.train_step(cfg, opt, s, b), placed


def test_flops_equal_a_hand_count_of_the_products():
    """Forward: q/k/v/o, the scores and their product with v, the three
    FFN products, the LM head; the backward takes two products of the
    same size for each (both operands need a gradient)."""
    B, S = 2, 16
    for layers in (1, 2):
        cfg = _tiny(layers)
        D, F, V = cfg.d_model, cfg.d_ff, cfg.vocab_size
        H, Dh = cfg.n_heads, cfg.head_dim
        per_layer = (2 * B * S * D * 3 * H * Dh + 2 * B * S * H * Dh * D
                     + 2 * (2 * B * H * S * S * Dh) + 3 * 2 * B * S * D * F)
        fwd = layers * per_layer + 2 * B * S * D * V
        mesh = make_host_mesh(1, 1, devices=["meta"])
        fn, placed = _train_on(cfg, mesh, B, S, "meta")
        counts = dr.count_step(fn, *placed)
        assert counts.summary(0)["flops"] == 3 * fwd
        # the counter's per-op formulas are FlopCounterMode's
        fn, placed = _train_on(cfg, mesh, B, S, "meta")
        with FlopCounterMode(display=False) as fc:
            fn(*placed)
        assert fc.get_total_flops() == 3 * fwd


def test_extrapolated_equals_full_on_a_tiny_config(monkeypatch):
    cfg = _tiny(4, remat="block")
    monkeypatch.setitem(dr.SHAPES, "train_4k",
                        ShapeConfig("train_4k", 32, 4, "train"))
    mesh = make_host_mesh(2, 2, devices=["meta"] * 4)
    pol = ShardingPolicy()
    full = dr.totals(dr._measure(cfg, "train_4k", mesh, pol))
    c1, c2, groups = dr._calibration_cfgs(cfg)
    assert (c1.n_layers, c2.n_layers, groups) == (1, 2, 4)
    m1, m2 = (dr.totals(dr._measure(c, "train_4k", mesh, pol))
              for c in (c1, c2))
    ext = dr._extrapolate(m1, m2, groups)
    assert dr.calibration_check(full, ext) is None
    assert (ext["flops"], ext["collectives"]) == (full["flops"],
                                                  full["collectives"])
    # each model block's gradient is updated whole, so AdamW copies no
    # slice of it: bytes are linear from one group on (2 and 3 groups
    # extrapolate exactly too)
    m3 = dr.totals(dr._measure(dataclasses.replace(c2, n_layers=3),
                               "train_4k", mesh, pol))
    assert dr._extrapolate(m2, m3, groups - 1) == full
    assert ext["bytes_accessed"] == full["bytes_accessed"]


def test_collective_bytes_equal_a_hand_count_on_a_2x2_mesh():
    """(data 2, model 2): every leaf of the tiny config's attention, FFN
    and vocabulary splits over "model", so no rank gathers a param.
    Each model rank all-reduces its (B/dp, S, D) f32 activations: the
    embedding's, the attention's and the FFN's outputs forward, the
    attention's, the FFN's and the head's inputs' gradients backward,
    and the loss's max, sum of exponentials and target logit ((B/dp, S)
    f32).  The second data rank's gradient blocks go to their holders
    (the first data rank's positions, model blocks of the split leaves
    to coordinate 1, the rest to 0); each block's square sum at
    coordinate 1 goes to the first rank."""
    cfg = _tiny(2)
    B, S = 4, 16
    mesh = make_host_mesh(2, 2, devices=["meta"] * 4)
    fn, placed = _train_on(cfg, mesh, B, S, "meta")
    counts = dr.count_step(fn, *placed)
    params = api.init_params_abstract(cfg)
    split = whole = n_split = 0
    for leaf, spec in zip(tree_leaves(params), tree_leaves(tree_map_with_path(
            lambda p, x: param_spec(cfg, mesh, p, tuple(x.shape)), params))):
        n = leaf.numel() * leaf.dtype.itemsize
        if any(e is not None for e in spec):
            split += n
            n_split += 1
        else:
            whole += n
    act = B // 2 * S * cfg.d_model * 4
    reduced = cfg.n_layers * 4 * act + 2 * act + 3 * (B // 2 * S * 4)
    by_rank = counts.collective_bytes_by_rank()
    assert by_rank == {"0": reduced + split / 2 + whole + 4 * n_split,
                       "1": reduced + split / 2, "2": reduced,
                       "3": reduced}
    ev = [(e.kind, e.rank, e.group) for e in counts.counter.events]
    assert {k for k, _, _ in ev} == {"all-reduce", "collective-permute"}
    assert all(g == 2 for k, _, g in ev if k == "all-reduce")
    assert ev.count(("collective-permute", 0, 2)) == \
        len(tree_leaves(params)) + n_split


@pytest.mark.parametrize("arch", ("llama3.2-1b", "jamba-1.5-large-398b"))
def test_meta_counts_equal_a_cpu_mesh(arch):
    """The counts of the same step on ``meta`` and on CPU logical devices
    of a (2, 2) mesh (the scan's plain version reports the kernel's
    work), rank by rank."""
    cfg = get_config(arch, smoke=True)
    got = {}
    for dev in ("meta", "cpu"):
        mesh = make_host_mesh(2, 2, devices=[dev] * 4)
        fn, placed = _train_on(cfg, mesh, 8, 32, dev)
        got[dev] = dr.count_step(fn, *placed)
    for r in range(4):
        a, b = got["meta"].summary(r), got["cpu"].summary(r)
        assert (a["flops"], a["bytes_accessed"], a["collectives"],
                a["kernels"]) == (b["flops"], b["bytes_accessed"],
                                  b["collectives"], b["kernels"]), r
    if arch.startswith("jamba"):
        assert got["meta"].summary(0)["kernels"] == {
            "selective_scan": 4, "selective_scan_bwd": 2}


@pytest.mark.parametrize("shape,remat", [((4, 2), "none"),
                                         ((2, 4), "none"),
                                         ((2, 4), "block")])
def test_reused_work_counts_as_traced_work(shape, remat):
    """Reusing a data rank's pass and the blocks' updates, and replaying
    the model ranks between a split sublayer's first and last (tp 4;
    under remat too, where the last rank's recompute stops before its
    final product), on ``meta``, gives every rank the counts of tracing
    each."""
    cfg = _tiny(2, remat=remat)
    dp, tpd = shape
    mesh = make_host_mesh(dp, tpd, devices=["meta"] * (dp * tpd))
    got = {}
    for reuse in (False, True):
        fn, placed = _train_on(cfg, mesh, 8, 16, "meta")
        got[reuse] = dr.count_step(fn, *placed, reuse_passes=reuse)
    assert got[True].counter.reused_ranks
    # data rank 1's whole pass is data rank 0's, its sections with it
    assert got[True].counter.replayed == (set() if tpd < 3 else {1, 2})
    for r in range(dp * tpd):
        a, b = got[False].summary(r), got[True].summary(r)
        assert (a["flops"], a["bytes_accessed"], a["collectives"],
                a["aten_ops"], a["kernels"]) == \
            (b["flops"], b["bytes_accessed"], b["collectives"],
             b["aten_ops"], b["kernels"]), r
    assert got[False].counter.peak[0] == got[True].counter.peak[0]
    cpu_mesh = make_host_mesh(1, 2, devices=["cpu"] * 2)
    fn, placed = _train_on(cfg, cpu_mesh, 2, 16, "cpu")
    with pytest.raises(ValueError, match="reused only on meta"):
        dr.count_step(fn, *placed, reuse_passes=True)


def test_scan_reports_its_work_on_meta():
    from repro_torch.kernels.mamba_scan import scan
    b, t, di, ds = 2, 40, 8, 4
    ops = [torch.empty(s, device="meta") for s in
           ((b, t, di), (b, t, di), (b, t, ds), (b, t, ds), (di, ds))]
    counts = dr.count_step(lambda: scan.selective_scan_fwd(*ops))
    y, h, states = counts.outputs
    assert (y.shape, h.shape, states.shape) == (
        (b, t, di), (b, di, ds), (b, scan.n_saved(t), di, ds))
    flops, nbytes = scan.fwd_work(b, t, di, ds, save=True)
    s = counts.summary(0)
    assert (s["flops"], s["bytes_accessed"], s["kernels"]) == (
        flops, nbytes, {"selective_scan": 1})
    dy = torch.empty((b, t, di), device="meta")
    counts = dr.count_step(lambda: scan.selective_scan_bwd(
        *ops, states, dy, None))
    assert [tuple(g.shape) for g in counts.outputs] == [
        (b, t, di), (b, t, di), (b, t, ds), (b, t, ds), (di, ds)]
    assert counts.summary(0)["flops"] == scan.bwd_work(b, t, di, ds,
                                                       False)[0]


# ---------------------------------------------------------------------------
# run_cell, report, the CLI
# ---------------------------------------------------------------------------
def _tiny_mesh(multi_pod=False, devices=None):
    """The reference test's production meshes cut to (4, 2) and
    (2, 2, 2)."""
    shape = (2, 2, 2) if multi_pod else (4, 2)
    grid = np.empty(8, dtype=object)
    grid[:] = list(devices)[:8]
    return Mesh(grid.reshape(shape), ("pod", "data", "model") if multi_pod
                else ("data", "model"))


def test_run_cell_on_the_tiny_meshes_and_report(ref, tmp_path, monkeypatch):
    monkeypatch.setattr(dr, "make_production_mesh", _tiny_mesh)
    for sh, (seq, batch) in TINY_SHAPES.items():
        monkeypatch.setitem(dr.SHAPES, sh, dataclasses.replace(
            dr.SHAPES[sh], seq_len=seq, global_batch=batch))
    for sh in TINY_SHAPES:
        for multi in (False, True):
            rec = dr.run_cell("olmo-1b", sh, multi, tmp_path, force=True,
                              calibrate=False)
            assert rec["status"] == "ok", rec.get("error")
            assert rec["static_bytes_per_device"] == \
                ref["tiny"][f"{sh}|{multi}"]
            assert rec["busiest_device"]["index"] == 0
            assert rec["memory"]["temp_size_in_bytes"] > 0
            assert rec["roofline"]["bound_time_s"] > 0
    skipped = dr.run_cell("olmo-1b", "long_500k", False, tmp_path,
                          force=True, calibrate=False)
    assert skipped["status"] == "skipped"
    buf = io.StringIO()
    with redirect_stdout(buf):
        report.main(["--dir", str(tmp_path)])
    text = buf.getvalue()
    assert "ERROR" not in text and "SKIP" in text
    assert text.count("| olmo-1b | train_4k | ok |") == 2
    assert "## Memory of the busiest device" in text


def test_variants_apply_and_an_ignored_field_raises(monkeypatch):
    for arch in ARCH_NAMES:
        for v in dr.VARIANTS:
            dr.apply_variant(get_config(arch), v)
    monkeypatch.setitem(dr.VARIANTS, "budget", lambda cfg: dataclasses.replace(
        cfg, ip_budget="int8"))
    with pytest.raises(dr.VariantIgnoredError, match="ip_budget"):
        dr.apply_variant(get_config("olmo-1b"), "budget")


def test_default_out_is_not_the_reference_directory():
    args = dr.parser().parse_args([])
    assert args.out == "experiments/dryrun_torch"
    assert Path(args.out) != Path("experiments/dryrun")
    assert (args.mesh, args.arch, args.shape) == ("both", "all", "all")


def test_chip_smoke_pins_the_reference_static_bytes(ref):
    """``chip_smoke.py``'s "dryrun" (a) holds its cells to these values."""
    sys.path.insert(0, str(REPO))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(REPO))
    for arch, shape, mesh, _ in chip_smoke.DRYRUN_CELLS:
        want = ref["cells"][f"{arch}|{shape}|{mesh == 'multi'}"]
        assert chip_smoke.DRYRUN_STATIC[arch, shape] == want["static"]
