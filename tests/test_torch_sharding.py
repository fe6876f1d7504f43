"""The port's sharding rules (``repro_torch.distributed.sharding``) and
mesh builders (``repro_torch.launch.mesh``) against the reference's.

Spec trees: every ``configs.ARCH_NAMES`` config at full size (abstract
states: ``meta`` tensors in the port, ``eval_shape`` in the reference),
``fsdp`` off and on, at a (4, 2) ("data", "model") mesh and a (2, 2, 2)
("pod", "data", "model") mesh: params, the ``TrainState``, train
batches at batch 8 and 1, decode caches at batch 8 and 1 (batch 1 does
not divide dp: the sequence-sharded case).  The reference's specs need
8 JAX devices, so they are computed once a mesh in an 8-device
subprocess (as ``tests/test_distributed.py`` runs its cases) and
compared as tuples, leaf by leaf in the reference's order.  Then the
placement: ``device_put`` blocks, storage shared by a replicated leaf's
logical devices, ``gather`` back bitwise.
"""
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from repro import configs as j_configs
from repro.launch import mesh as j_mesh
from repro_torch import configs as t_configs
from repro_torch.configs.base import ShapeConfig
from repro_torch.distributed.sharding import (NamedSharding, P,
                                              PartitionSpec, ShardedTensor,
                                              ShardingPolicy, batch_pspecs,
                                              cache_pspecs, device_put, gather,
                                              param_spec, params_pspecs,
                                              state_pspecs, to_shardings)
from repro_torch.launch import mesh as t_mesh
from repro_torch.models import api as t_api
from repro_torch.models import frontends as t_front
from repro_torch.optim.adamw import AdamWConfig, tree_leaves

REPO = Path(__file__).resolve().parent.parent
MESHES = {"4x2": ((4, 2), ("data", "model")),
          "2x2x2": ((2, 2, 2), ("pod", "data", "model"))}
CACHE_LEN = 4096
TRAIN_LEN = 4096

_REFERENCE = """
import json
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax
from jax.sharding import PartitionSpec as P
from repro.configs import ARCH_NAMES, get_config
from repro.configs.base import ShapeConfig
from repro.distributed.sharding import (ShardingPolicy, batch_pspecs,
                                        cache_pspecs, params_pspecs,
                                        state_pspecs)
from repro.models import api
from repro.models.frontends import input_specs
from repro.optim.adamw import AdamWConfig

mesh = jax.make_mesh({shape}, {axes})

def enc(tree):
    leaves = jax.tree.leaves(tree, is_leaf=lambda x: isinstance(x, P))
    return [[list(e) if isinstance(e, tuple) else e for e in s]
            for s in leaves]

out = {{}}
for arch in ARCH_NAMES:
    cfg = get_config(arch)
    state = api.init_train_state_abstract(cfg, AdamWConfig())
    for fsdp in (False, True):
        pol = ShardingPolicy(fsdp=fsdp)
        out[f"{{arch}}|{{fsdp}}|params"] = enc(
            params_pspecs(cfg, mesh, state.params, pol))
        out[f"{{arch}}|{{fsdp}}|state"] = enc(
            state_pspecs(cfg, mesh, state, pol))
    for b in (8, 1):
        out[f"{{arch}}|{{b}}|batch"] = enc(batch_pspecs(
            cfg, mesh, input_specs(cfg, ShapeConfig("t", {train_len}, b,
                                                    "train"))))
        caches = jax.eval_shape(
            lambda: api.init_decode_caches(cfg, b, {cache_len}))
        out[f"{{arch}}|{{b}}|caches"] = enc(
            cache_pspecs(cfg, mesh, caches, ShardingPolicy()))
print("SPECS" + json.dumps(out))
"""


def _launch(mesh_name):
    shape, axes = MESHES[mesh_name]
    code = textwrap.dedent(_REFERENCE).format(
        shape=shape, axes=axes, train_len=TRAIN_LEN, cache_len=CACHE_LEN)
    env = dict(os.environ, PYTHONPATH=str(REPO / "src") + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    return subprocess.Popen([sys.executable, "-c", code], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


@pytest.fixture(scope="module")
def reference_specs():
    """{mesh name: {key: [spec as lists]}} from one 8-device reference
    subprocess a mesh, both run at once."""
    procs = {name: _launch(name) for name in MESHES}
    out = {}
    for name, proc in procs.items():
        stdout, stderr = proc.communicate(timeout=420)
        assert proc.returncode == 0, f"STDOUT:\n{stdout}\nSTDERR:\n{stderr}"
        line = [ln for ln in stdout.splitlines() if ln.startswith("SPECS")]
        out[name] = json.loads(line[-1][len("SPECS"):])
    return out


def _port_mesh(name):
    shape, axes = MESHES[name]
    return t_mesh.Mesh(np.array(["cpu"] * 8, dtype=object).reshape(shape),
                       axes)


def _enc(tree):
    return [[list(e) if isinstance(e, tuple) else e for e in s]
            for s in tree_leaves(tree)]


OPT = AdamWConfig()


@pytest.mark.parametrize("fsdp", [False, True])
@pytest.mark.parametrize("arch", j_configs.ARCH_NAMES)
@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_param_and_state_specs_equal_the_references(reference_specs,
                                                    mesh_name, arch, fsdp):
    want = reference_specs[mesh_name]
    cfg = t_configs.get_config(arch)
    mesh = _port_mesh(mesh_name)
    state = t_api.init_train_state_abstract(cfg, OPT)
    pol = ShardingPolicy(fsdp=fsdp)
    got_p = _enc(params_pspecs(cfg, mesh, state.params, pol))
    got_s = _enc(state_pspecs(cfg, mesh, state, pol))
    assert got_p == want[f"{arch}|{fsdp}|params"]
    assert got_s == want[f"{arch}|{fsdp}|state"]
    assert got_s[-1] == []          # the step counter: P()
    assert len(got_s) == 3 * len(got_p) + 1


@pytest.mark.parametrize("batch", [8, 1])
@pytest.mark.parametrize("arch", j_configs.ARCH_NAMES)
@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_batch_and_cache_specs_equal_the_references(reference_specs,
                                                    mesh_name, arch, batch):
    want = reference_specs[mesh_name]
    cfg = t_configs.get_config(arch)
    mesh = _port_mesh(mesh_name)
    inputs = t_front.input_specs(cfg, ShapeConfig("t", TRAIN_LEN, batch,
                                                  "train"))
    caches = t_api.init_decode_caches(cfg, batch, CACHE_LEN, device="meta")
    got_b = _enc(batch_pspecs(cfg, mesh, inputs))
    got_c = _enc(cache_pspecs(cfg, mesh, caches, ShardingPolicy()))
    assert got_b == want[f"{arch}|{batch}|batch"]
    assert got_c == want[f"{arch}|{batch}|caches"]


def test_batch_one_caches_shard_the_sequence(reference_specs):
    """The SP case: batch 1 does not divide dp, so attention caches split
    their sequence over the dp axes (both meshes, every config with an
    attention cache)."""
    for name, (_, axes) in MESHES.items():
        dpx = [a for a in axes if a != "model"]
        seen = 0
        for arch in j_configs.ARCH_NAMES:
            cfg = t_configs.get_config(arch)
            caches = t_api.init_decode_caches(cfg, 1, CACHE_LEN,
                                              device="meta")
            specs = cache_pspecs(cfg, _port_mesh(name), caches)
            for path, spec in _paths(specs):
                if path.rsplit("/", 1)[-1] in ("k", "v"):
                    seq = spec[2]
                    seq = [seq] if isinstance(seq, str) else list(seq)
                    assert seq[:len(dpx)] == dpx, (name, arch, path, spec)
                    assert spec[1] is None
                    seen += 1
        assert seen


def _paths(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _paths(v, f"{prefix}/{k}")
    else:
        yield prefix, tree


def test_chatglm_embed_is_split_over_model_at_4x2():
    """The leaf whose reference gather fails under ``jit`` (``jnp.take``
    on a model-sharded embedding): split over "model" here too."""
    cfg = t_configs.get_config("chatglm3-6b")
    spec = param_spec(cfg, _port_mesh("4x2"), "embed",
                      (cfg.vocab_size, cfg.d_model))
    assert spec == P("model", None)


def test_partition_spec_is_a_tree_leaf_and_compares_as_a_tuple():
    s = P(("pod", "data"), None, "model")
    assert tuple(s) == (("pod", "data"), None, "model") and len(s) == 3
    assert s == (("pod", "data"), None, "model") and s == PartitionSpec(
        ("pod", "data"), None, "model")
    assert tree_leaves({"a": s, "b": [P()]}) == [s, P()]
    with pytest.raises(TypeError):
        P(3)


# ---------------------------------------------------------------------------
# mesh builders
# ---------------------------------------------------------------------------
def test_host_mesh_clamps_as_the_reference():
    for n in range(1, 9):
        for data in (1, 2, 3, 4, 8, 16):
            for model in (1, 2, 4):
                m = t_mesh.make_host_mesh(data, model, devices=["cpu"] * n)
                d = min(data, n)
                assert m.devices.shape == (d, min(model, max(n // d, 1)))
                assert m.axis_names == ("data", "model")
                assert dict(m.shape) == t_mesh.mesh_axis_sizes(m)


def test_production_mesh_shapes_and_axes():
    m = t_mesh.make_production_mesh(devices=["cpu"] * 256)
    assert m.devices.shape == (16, 16) and t_mesh.dp_axes(m) == ("data",)
    m = t_mesh.make_production_mesh(multi_pod=True, devices=["cpu"] * 512)
    assert m.axis_names == ("pod", "data", "model")
    assert t_mesh.dp_axes(m) == j_mesh.dp_axes(m) == ("pod", "data")
    with pytest.raises(ValueError, match="must be >="):
        t_mesh.make_production_mesh(devices=["cpu"] * 8)


def test_meshes_never_fill_in_missing_cards(monkeypatch):
    """Default pool: the CUDA cards.  Without one a mesh raises; it is
    never filled with CPU devices or a repeated cuda:0."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(ValueError, match="no device"):
        t_mesh.make_host_mesh()
    with pytest.raises(ValueError, match="must be >="):
        t_mesh.make_production_mesh()
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    m = t_mesh.make_host_mesh(4, 1)
    assert [str(d) for d in m.devices.flat] == ["cuda:0", "cuda:1"]
    m = t_mesh.make_host_mesh(2, 2, devices=["cuda:0"] * 4)
    assert m.devices.shape == (2, 2)


# ---------------------------------------------------------------------------
# placement
# ---------------------------------------------------------------------------
def _tree(rng):
    return {"embed": torch.from_numpy(rng.normal(size=(8, 6)).astype(
                np.float32)),
            "norm": torch.from_numpy(rng.normal(size=(6,)).astype(
                np.float32)),
            "w": torch.from_numpy(rng.normal(size=(4, 8, 6)).astype(
                np.float32)).to(torch.bfloat16)}


def test_device_put_places_blocks_and_gathers_back_bitwise():
    mesh = _port_mesh("2x2x2")
    tree = _tree(np.random.default_rng(0))
    specs = {"embed": P("model", None), "norm": P(),
             "w": P(None, ("pod", "data"), "model")}
    placed = device_put(tree, to_shardings(mesh, specs))
    for k, t in tree.items():
        st = placed[k]
        assert isinstance(st, ShardedTensor) and st.dtype == t.dtype
        assert torch.equal(st.full(), t)
        for sl, blk in zip(st.index, st.shards):
            assert torch.equal(blk, t[sl]) and blk.is_contiguous()
    # distinct storages: 2 model blocks; 1 shared; 4 x 2 blocks
    assert [len(placed[k].blocks()) for k in ("embed", "norm", "w")] == \
        [2, 1, 8]
    assert all(b is placed["norm"].shards[0] for b in placed["norm"].shards)
    # new storage unless asked to alias
    assert placed["norm"].shards[0].data_ptr() != tree["norm"].data_ptr()
    aliased = device_put(tree, to_shardings(mesh, specs), may_alias=True)
    assert aliased["norm"].shards[0] is tree["norm"]
    back = gather(placed)
    assert all(torch.equal(back[k], tree[k]) for k in tree)
    assert gather(aliased)["norm"] is tree["norm"]


def test_device_put_refuses_specs_that_do_not_divide():
    mesh = _port_mesh("4x2")
    with pytest.raises(ValueError, match="does not split"):
        device_put(torch.zeros(6, 3), NamedSharding(mesh, P("data")))
    with pytest.raises(ValueError, match="names axis"):
        device_put(torch.zeros(8), NamedSharding(mesh, P("pipe")))
