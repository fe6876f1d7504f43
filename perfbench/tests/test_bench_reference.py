"""The plain reference on the CPU: independent of the program, equal to
the port's plain versions on every rung the cells run, and its control
one rung lower clearly apart."""
from __future__ import annotations

import ast
from pathlib import Path

import pytest
import torch
from conftest import ROOT

from perfbench.harness.spec import load_module
from perfbench.systems.adaptive_cnn_server import make_params

REF = ROOT / "perfbench" / "reference" / "cnn_frontend.py"
ref = load_module(REF, "bench_reference")
TENANT = {"channels": [3, 16, 32], "k": 3, "d_model": 64}


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            yield node.module or ""


def test_reference_imports_nothing_of_the_program():
    tops = {m.split(".")[0] for m in _imports(REF)}
    assert tops <= {"__future__", "contextlib", "typing", "torch"}, tops


def _site(member, bits):
    return {"member": member, "bits": bits}


FUSED = {"fused_f32": [{"fused": _site("fused_vpu", 32)},
                       {"fused": _site("fused_mxu", 32)}],
         "fused_int8": [{"fused": _site("fused_mxu", 8)},
                        {"fused": _site("fused_mxu", 8)}],
         "fused_mixed": [{"fused": _site("fused_vpu", 32)},
                         {"fused": _site("fused_mxu", 16)}]}
CHAIN = {"chain_f32": [{"conv": _site("ip1_vpu", 32),
                        "pool": _site("pool_vpu", 32),
                        "act": _site("act_vpu", 32)}] * 2,
         "chain_ladder": [{"conv": _site("ip1_vpu", 8),
                           "pool": _site("pool_vpu", 8),
                           "act": _site("act_lut", 8)},
                          {"conv": _site("ip2_mxu", 8),
                           "pool": _site("pool_vpu", 8),
                           "act": _site("act_lut", 8)}],
         "chain_16": [{"conv": _site("ip1_vpu", 16),
                       "pool": _site("pool_vpu", 8),
                       "act": _site("act_vpu", 16)},
                      {"conv": _site("ip2_mxu", 8),
                       "pool": _site("pool_vpu", 8),
                       "act": _site("act_lut", 8)}]}


def _port_plan(plan, shape):
    """The same rungs as a plan the port executes (its planner's sites,
    re-pointed at the members and widths asked for)."""
    import dataclasses

    from repro_torch.core.library import get_ip
    from repro_torch.core.plan import plan_network
    from repro_torch.core.resources import ResourceBudget
    from repro_torch.models.frontends import cnn_frontend_site_specs
    params = make_params(TENANT, 0, "cpu")
    specs = cnn_frontend_site_specs(params, shape, "float32",
                                    activation="tanh", ladder=(16, 8))
    net = plan_network(specs, ResourceBudget(), fuse="fused" in plan[0])
    sites = []
    for s in net.sites:
        block, part = s.spec.name.rsplit(".", 1)
        want = plan[int(block[-1])][part]
        family = s.ip.name.split(".")[0]
        sites.append(dataclasses.replace(
            s, ip=get_ip(f"{family}.{want['member']}"),
            precision_bits=want["bits"]))
    return dataclasses.replace(net, sites=tuple(sites))


@pytest.mark.parametrize("name", sorted({**FUSED, **CHAIN}))
def test_reference_matches_the_ports_plain_path(name):
    from repro_torch.models.frontends import apply_cnn_frontend
    plan = {**FUSED, **CHAIN}[name]
    x = torch.randn((3, 26, 26, 3), generator=torch.Generator().manual_seed(5))
    params = make_params(TENANT, 0, "cpu")
    kind = "tanh"
    net = _port_plan(plan, tuple(x.shape))
    got = apply_cnn_frontend(params, x, network=net, activation=kind,
                             ladder=(16, 8), fuse="fused" in plan[0])
    want = ref.frontend(params, x, plan, kind=kind)
    gap = float((got - want).norm() / want.norm())
    assert gap < 1e-5, gap
    low = ref.frontend(params, x, plan, kind=kind, control=True)
    if any(s["bits"] < 32 for b in plan for s in b.values()):
        assert float((low - want).norm() / want.norm()) > 1e-3


def test_integer_rungs_are_exact():
    """Int8 codes accumulate exactly: the conv of codes equals the
    integer sum of products."""
    g = torch.Generator().manual_seed(1)
    x = torch.randint(-127, 128, (2, 6, 6, 16), generator=g).float()
    w = torch.randint(-127, 128, (3, 3, 16, 4), generator=g).float()
    y = ref.conv(x, w)
    want = torch.zeros(2, 4, 4, 4, dtype=torch.int64)
    xi, wi = x.long(), w.long()
    for i in range(3):
        for j in range(3):
            want += torch.einsum("nhwc,co->nhwo", xi[:, i:i + 4, j:j + 4],
                                 wi[i, j])
    assert torch.equal(y.long(), want)


def test_quantizer_rules():
    x = torch.tensor([[-2.0, 0.5, 1.0, 2.0]])
    q, s = ref.quant_acts(x, 8)
    assert float(s) == pytest.approx(2.0 / 127)
    assert q.tolist() == [[-127.0, 32.0, 64.0, 127.0]]
    w = torch.tensor([[1.0, -4.0], [0.5, 2.0]])
    qw, sw = ref.quant_weights(w, 8)
    assert sw.flatten().tolist() == pytest.approx([1.0 / 127, 4.0 / 127])
    assert qw[:, 1].tolist() == [-127.0, 64.0]
