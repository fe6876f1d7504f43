"""The port's single-controller mesh execution
(``repro_torch.distributed``) against the reference's ``shard_map``
execution (``repro.distributed``).

* The collectives (``all_gather``, ``psum``, ``ring_all_reduce``,
  ``bucketed_psum``) against a plain concatenation and sum over per-rank
  lists of tensors; ``ring_all_reduce`` bitwise equal to the reference's
  ring (``repro.distributed.collectives.ring_all_reduce`` under
  ``shard_map``) on the same per-rank partials.
* The reference's execution cases of ``tests/test_shard_exec.py`` with
  the port on 2 CPU logical devices: an f32 batch split bitwise equal to
  the replicated walk, a channel split (psum and ring) within
  ``rtol=1e-5, atol=1e-5`` of it and ring within that of psum, a fused
  chain bitwise, and the lowered-plan refusal word for word.
* One subprocess with ``XLA_FLAGS=--xla_force_host_platform_device_count``
  (the reference's own tests run its multi-device paths so; the flag
  must not leak into this process) runs the reference's
  ``apply_plan_sharded`` and ring on numpy inputs from a seed; the
  port's outputs on the same inputs are compared with them: the batch
  and channel splits within ``rtol=1e-5, atol=1e-5`` (the packages' conv
  members agree to that tolerance, not bitwise), the ring bitwise.
"""
import dataclasses
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core.ip import SiteSpec
from repro_torch.core.plan import plan_network
from repro_torch.core.resources import MeshSpec, ResourceBudget
from repro_torch.core.shard import force_shard_decisions
from repro_torch.distributed import (all_gather, apply_plan_replicated,
                                     apply_plan_sharded, bucketed_psum,
                                     mesh_devices, psum, ring_all_reduce)
from repro_torch.kernels.conv2d.ops import conv2d, reduce_partials
from repro_torch.models.blocks import cnn_block_site_specs
from repro_torch.runtime.faults import INJECTOR, FaultSpec

REPO = Path(__file__).resolve().parent.parent
MESH2 = MeshSpec(devices=2)
TOL = dict(rtol=1e-5, atol=1e-5)


def _rng_parts(n, shape, seed=0):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.normal(size=shape).astype(np.float32))
            for _ in range(n)]


# --------------------------------------------------------------------------
# Collectives over per-rank lists
# --------------------------------------------------------------------------
@pytest.mark.parametrize("n", [1, 2, 3, 4])
@pytest.mark.parametrize("shape", [(7,), (4, 5), (2, 3, 5, 6)])
def test_collectives_against_plain_sum_and_cat(n, shape):
    parts = _rng_parts(n, shape, seed=n)
    want = parts[0].clone()
    for p in parts[1:]:
        want = want + p
    for fn in (psum, ring_all_reduce, lambda ps: reduce_partials(ps, "psum"),
               lambda ps: reduce_partials(ps, "ring")):
        out = fn(parts)
        assert len(out) == n
        for o in out:
            assert o.shape == parts[0].shape and o.dtype == torch.float32
            torch.testing.assert_close(o, want, rtol=1e-6, atol=1e-6)
    # psum sums in rank order: bitwise the left fold on every rank
    assert all(torch.equal(o, want) for o in psum(parts))
    # each rank's copy is its own tensor
    if n > 1:
        out = psum(parts)
        assert out[0].data_ptr() != out[1].data_ptr()
    dim = len(shape) - 1
    for o in all_gather(parts, dim):
        assert torch.equal(o, torch.cat(parts, dim=dim))
    for o in all_gather(parts, 0):
        assert torch.equal(o, torch.cat(parts, dim=0))


def test_ring_on_equal_partials_is_n_times_the_partial():
    for n in (2, 4):
        p = _rng_parts(1, (3, 10))[0]
        for o in ring_all_reduce([p.clone() for _ in range(n)]):
            assert torch.equal(o, p * n)      # exact: n a power of two


def test_bucketed_psum_reduces_every_leaf():
    rng = np.random.default_rng(3)

    def tree():
        return {"w": torch.from_numpy(rng.normal(size=(4, 6))
                                      .astype(np.float32)),
                "b": [torch.from_numpy(rng.normal(size=(3,))
                                       .astype(np.float32)),
                      (torch.from_numpy(rng.normal(size=(2, 2))
                                        .astype(np.float32)),)],
                "s": torch.tensor(1.5)}

    trees = [tree() for _ in range(3)]
    out = bucketed_psum(trees, n_buckets=2)
    assert len(out) == 3
    for o in out:
        assert torch.equal(o["w"], trees[0]["w"] + trees[1]["w"]
                           + trees[2]["w"])
        assert torch.equal(o["b"][1][0], trees[0]["b"][1][0]
                           + trees[1]["b"][1][0] + trees[2]["b"][1][0])
        assert isinstance(o["b"], list) and isinstance(o["b"][1], tuple)
        assert torch.equal(o["s"], torch.tensor(4.5))
    with pytest.raises(ValueError, match="differ in structure"):
        bucketed_psum([{"a": torch.ones(1)}, {"b": torch.ones(1)}])


def test_collectives_refuse_mismatched_ranks():
    with pytest.raises(ValueError, match="rank 1 holds"):
        psum([torch.ones(2), torch.ones(3)])
    with pytest.raises(ValueError, match="one tensor per rank"):
        ring_all_reduce([])


def test_conv2d_reduce_names_are_the_references():
    x = torch.zeros(1, 5, 5, 4)
    w = torch.zeros(3, 3, 4, 2)
    with pytest.raises(ValueError, match=r"unknown reduce 'tree'; have "
                                         r"\('psum', 'ring'\)"):
        conv2d(x, w, ip="ip1_vpu", reduce_axis="shard", reduce="tree")
    # no reduce axis: the name is not read, as in the reference
    assert conv2d(x, w, ip="ip1_vpu", reduce="tree").shape == (1, 3, 3, 2)
    with pytest.raises(ValueError, match="unknown reduce"):
        reduce_partials([x, x], "tree")


# --------------------------------------------------------------------------
# The reference's execution cases, on 2 CPU logical devices
# --------------------------------------------------------------------------
def _conv_case(seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(8, 16, 16, 32)).astype(np.float32)
    w = rng.normal(0, (9 * 32) ** -0.5, (3, 3, 32, 128)).astype(np.float32)
    return x, w


def _forced_chan(p2):
    sites = tuple(dataclasses.replace(s, shard_axis="chan", shard_degree=2)
                  for s in p2.sites)
    return dataclasses.replace(p2, sites=sites, mesh=MESH2)


def test_sharded_execution_matches_replicated():
    xn, wn = _conv_case()
    x, w = torch.from_numpy(xn), torch.from_numpy(wn)
    spec = SiteSpec.make("conv", "conv2d", (x.shape, w.shape), "float32",
                         dual=False)
    p2 = plan_network((spec,), ResourceBudget(mxu_passes_budget=7),
                      mesh=MESH2)
    assert p2.sites[0].shard_axis == "batch"
    y_rep = apply_plan_replicated(p2, x, {"conv": w})
    y_shd = apply_plan_sharded(p2, x, {"conv": w})
    assert torch.equal(y_rep, y_shd)
    force_shard_decisions((spec,), MESH2, axis="chan")   # legality
    forced = _forced_chan(p2)
    y_chan = apply_plan_sharded(forced, x, {"conv": w})
    torch.testing.assert_close(y_chan, y_rep, **TOL)
    y_ring = apply_plan_sharded(forced, x, {"conv": w}, use_ring=True)
    torch.testing.assert_close(y_ring, y_chan, **TOL)


def test_sharded_fused_chain_matches_replicated():
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.normal(size=(4, 16, 16, 8)).astype(np.float32))
    w = torch.from_numpy(rng.normal(0, (9 * 8) ** -0.5, (3, 3, 8, 16))
                         .astype(np.float32))
    specs, _ = cnn_block_site_specs(x.shape, w.shape, x_dtype="float32",
                                    site="blk")
    pf = plan_network(tuple(specs), ResourceBudget())
    assert [s.spec.family for s in pf.sites] == ["cnn_fused"]
    force_shard_decisions(tuple(s.spec for s in pf.sites), MESH2,
                          axis="batch")
    sites = tuple(dataclasses.replace(s, shard_axis="batch", shard_degree=2)
                  for s in pf.sites)
    pff = dataclasses.replace(pf, sites=sites, mesh=MESH2)
    weights = {"blk.fused": w}
    assert torch.equal(apply_plan_replicated(pf, x, weights),
                       apply_plan_sharded(pff, x, weights))


def test_mixed_chain_relays_layouts():
    """An unfused block whose conv splits its channels and whose pool and
    activation split the batch: the psum leaves the conv replicated, the
    pool slices its batch block, the output is gathered back."""
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.normal(size=(4, 12, 12, 8)).astype(np.float32))
    w = torch.from_numpy(rng.normal(0, 0.2, (3, 3, 8, 16))
                         .astype(np.float32))
    specs, _ = cnn_block_site_specs(x.shape, w.shape, x_dtype="float32",
                                    site="mix")
    plan = plan_network(tuple(specs), ResourceBudget(), fuse=False)
    axes = ("chan", "batch", "chan")
    sites = tuple(dataclasses.replace(s, shard_axis=a, shard_degree=2)
                  for s, a in zip(plan.sites, axes))
    mixed = dataclasses.replace(plan, sites=sites, mesh=MESH2)
    weights = {specs[0].name: w}
    want = apply_plan_replicated(plan, x, weights)
    for ring in (False, True):
        torch.testing.assert_close(
            apply_plan_sharded(mixed, x, weights, use_ring=ring), want,
            **TOL)


def test_sharded_execution_refuses_lowered_plans():
    spec = SiteSpec.make("lo", "conv2d", ((2, 8, 8, 4), (3, 3, 4, 8)),
                         "float32", ladder=(16, 8), dual=False)
    plan = plan_network((spec,), ResourceBudget(vmem_bytes=3 * 1024))
    assert plan.sites[0].lowered
    with pytest.raises(ValueError, match="float-only") as e:
        apply_plan_sharded(plan, None)
    from repro.core.ip import SiteSpec as JSiteSpec
    from repro.core.plan import plan_network as j_plan_network
    from repro.core.resources import ResourceBudget as JBudget
    from repro.distributed.shard_exec import apply_plan_sharded as j_apply
    jspec = JSiteSpec.make("lo", "conv2d", ((2, 8, 8, 4), (3, 3, 4, 8)),
                           "float32", ladder=(16, 8), dual=False)
    with pytest.raises(ValueError) as want:
        j_apply(j_plan_network((jspec,), JBudget(vmem_bytes=3 * 1024)),
                None)
    assert str(e.value) == str(want.value)
    attn = SiteSpec.make("a", "attention", ((1, 4, 64, 8), (1, 2, 64, 8)),
                         "float32")
    with pytest.raises(ValueError, match="is not part of a conv/pool/act "
                                         "chain"):
        apply_plan_sharded(plan_network((attn,)), None)


def test_mesh_devices_never_stand_in_for_a_missing_card(monkeypatch):
    x = torch.zeros(1)
    assert mesh_devices(3, x) == [torch.device("cpu")] * 3
    assert mesh_devices(2, x, ["cpu", "cpu", "cpu"]) == \
        [torch.device("cpu")] * 2
    with pytest.raises(ValueError, match="plan wants 2 devices but only 1 "
                                         "are available"):
        mesh_devices(2, x, ["cpu"])

    class Cuda:
        is_cuda = True
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="plan wants 2 devices but only 1"):
        mesh_devices(2, Cuda())
    assert mesh_devices(2, Cuda(), ["cuda:0", "cuda:0"]) == \
        [torch.device("cuda", 0)] * 2


def test_collective_seam_perturbs_the_gathered_result():
    rng = np.random.default_rng(6)
    x = torch.from_numpy(rng.normal(size=(4, 8, 8, 8)).astype(np.float32))
    w = torch.from_numpy(rng.normal(0, 0.2, (3, 3, 8, 16))
                         .astype(np.float32))
    spec = SiteSpec.make("conv", "conv2d", (x.shape, w.shape), "float32",
                         dual=False)
    plan = plan_network((spec,), ResourceBudget())
    p2 = dataclasses.replace(plan, mesh=MESH2, sites=tuple(
        dataclasses.replace(s, shard_axis="batch", shard_degree=2)
        for s in plan.sites))
    clean = apply_plan_sharded(p2, x, {"conv": w})
    with INJECTOR.armed([FaultSpec("collective_corrupt", step=0)], seed=0):
        bad = apply_plan_sharded(p2, x, {"conv": w})
    assert not torch.isfinite(bad).all()
    assert torch.isfinite(clean).all()
    assert torch.equal(apply_plan_sharded(p2, x, {"conv": w}), clean)


# --------------------------------------------------------------------------
# Against the reference's shard_map execution (subprocess: host devices)
# --------------------------------------------------------------------------
def _run_reference(body: str, n_dev: int, timeout: int = 420) -> None:
    code = textwrap.dedent(f"""
        import os
        os.environ["XLA_FLAGS"] = (
            "--xla_force_host_platform_device_count={n_dev}")
        import dataclasses
        import jax
        import jax.numpy as jnp
        import numpy as np
    """) + textwrap.dedent(body)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=str(REPO / "src") + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=timeout, env=env)
    assert out.returncode == 0, f"STDOUT:\n{out.stdout}\nSTDERR:\n{out.stderr}"


def test_port_matches_the_references_shard_map(tmp_path):
    xn, wn = _conv_case(seed=5)
    parts = np.stack([p.numpy() for p in _rng_parts(4, (3, 37), seed=9)])
    np.savez(tmp_path / "in.npz", x=xn, w=wn, parts=parts)
    _run_reference(f"""
        from jax.experimental.shard_map import shard_map
        from jax.sharding import Mesh, PartitionSpec as P
        from repro.core.ip import SiteSpec
        from repro.core.plan import plan_network
        from repro.core.resources import MeshSpec, ResourceBudget
        from repro.distributed.collectives import ring_all_reduce
        from repro.distributed.shard_exec import apply_plan_sharded
        d = np.load({str(tmp_path / 'in.npz')!r})
        x, w = jnp.asarray(d["x"]), jnp.asarray(d["w"])
        spec = SiteSpec.make("conv", "conv2d", (x.shape, w.shape),
                             "float32", dual=False)
        mesh = MeshSpec(devices=2)
        p2 = plan_network((spec,), ResourceBudget(mxu_passes_budget=7),
                          mesh=mesh)
        sites = tuple(dataclasses.replace(s, shard_axis="chan",
                                          shard_degree=2) for s in p2.sites)
        forced = dataclasses.replace(p2, sites=sites, mesh=mesh)
        devs = jax.devices()
        y_batch = apply_plan_sharded(p2, x, {{"conv": w}}, devices=devs[:2])
        y_chan = apply_plan_sharded(forced, x, {{"conv": w}},
                                    devices=devs[:2])
        y_ring = apply_plan_sharded(forced, x, {{"conv": w}}, use_ring=True,
                                    devices=devs[:2])
        ring = shard_map(lambda v: ring_all_reduce(v, "i"),
                         mesh=Mesh(np.array(devs[:4]), ("i",)),
                         in_specs=P("i"), out_specs=P("i"), check_rep=False)
        parts = jnp.asarray(d["parts"])[:, None]
        np.savez({str(tmp_path / 'out.npz')!r}, batch=np.asarray(y_batch),
                 chan=np.asarray(y_chan), ring=np.asarray(y_ring),
                 allreduce=np.asarray(ring(parts))[:, 0])
    """, n_dev=4)
    want = np.load(tmp_path / "out.npz")
    x, w = torch.from_numpy(xn), torch.from_numpy(wn)
    spec = SiteSpec.make("conv", "conv2d", (x.shape, w.shape), "float32",
                         dual=False)
    p2 = plan_network((spec,), ResourceBudget(mxu_passes_budget=7),
                      mesh=MESH2)
    forced = _forced_chan(p2)
    # across the packages the conv members agree within the f32
    # tolerance (the port's plain versions are not the reference's Pallas
    # bodies); within the port the batch split is bitwise its replicated
    # walk (test_sharded_execution_matches_replicated)
    np.testing.assert_allclose(apply_plan_sharded(p2, x, {"conv": w})
                               .numpy(), want["batch"], **TOL)
    np.testing.assert_allclose(apply_plan_sharded(forced, x, {"conv": w})
                               .numpy(), want["chan"], **TOL)
    np.testing.assert_allclose(
        apply_plan_sharded(forced, x, {"conv": w}, use_ring=True).numpy(),
        want["ring"], **TOL)
    ring = ring_all_reduce([torch.from_numpy(p) for p in parts])
    for r, o in enumerate(ring):
        np.testing.assert_array_equal(o.numpy(), want["allreduce"][r])
