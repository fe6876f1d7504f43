"""The system under test for the CNN serving configurations: the port's
``AdaptiveServer`` with one tenant a configured CNN frontend.

The benchmark makes every input here from the seed: each tenant's
weights in one draw on the device, and each tenant's image pool in one
draw on the device, handed to the server as host tensors, as a client's
images arrive.  From the program it takes the server, its spans and
counters, and the plan each batch ran, which the reference follows rung
by rung (see ``PERF.md``).
"""
from __future__ import annotations

from typing import Dict, List, NamedTuple

import torch


class Batch(NamedTuple):
    """One executed batch: its tenant, request ids, results and flags."""

    tenant: str
    rids: List[int]
    results: list
    ok: List[bool]


def _generator(seed: int, device: torch.device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(int(seed))


def make_params(tenant: dict, seed: int, device) -> Dict:
    """The frontend's weights, N(0, 1/fan_in), in one draw on ``device``:
    ``{"blocks": [{"w": (k, k, cin, cout)}], "proj": (C, d_model)}``."""
    ch, k, d = tenant["channels"], tenant["k"], tenant["d_model"]
    pairs = list(zip(ch[:-1], ch[1:]))
    sizes = [k * k * cin * cout for cin, cout in pairs] + [ch[-1] * d]
    flat = torch.randn(sum(sizes), generator=_generator(seed, device),
                       device=device)
    blocks, off = [], 0
    for (cin, cout), n in zip(pairs, sizes):
        w = flat[off:off + n].view(k, k, cin, cout) * (k * k * cin) ** -0.5
        blocks.append({"w": w})
        off += n
    proj = flat[off:].view(ch[-1], d) * ch[-1] ** -0.5
    return {"blocks": blocks, "proj": proj}


def make_pool(image, n: int, seed: int, device) -> torch.Tensor:
    """``n`` N(0, 1) float32 images drawn on ``device`` in one call, handed
    back as one host tensor (the clients' images)."""
    x = torch.randn((n,) + tuple(image), generator=_generator(seed, device),
                    device=device)
    return x.cpu()


class System:
    """The configured server, its tenants and their inputs."""

    def __init__(self, config: dict, seed: int, device):
        from repro_torch.core.plan import clear_plan_cache
        from repro_torch.core.resources import ResourceBudget
        from repro_torch.runtime.server import AdaptiveServer
        self.config = config
        self.device = torch.device(device)
        self.image = tuple(config["image"])
        clear_plan_cache()
        budget = ResourceBudget(vmem_bytes=config["vmem_bytes"],
                                vpu_ops_budget=config["vpu_ops_budget"])
        self.server = AdaptiveServer(budget, policy=config["policy"],
                                     max_batch=config["max_batch"],
                                     fuse=config["fuse"], device=self.device)
        self.tenants = {t["name"]: t for t in config["tenants"]}
        self.params = {}
        for name, t in self.tenants.items():
            p = make_params(t, seed + t["seed_offset"], self.device)
            self.params[name] = p
            self.server.register(name, p, self.image,
                                 pool_window=tuple(t["pool_window"]),
                                 activation=t["activation"],
                                 ladder=tuple(t["ladder"]),
                                 measure_quant=t["measure_quant"])

    def pools(self, n: int, seed: int) -> Dict[str, torch.Tensor]:
        """Each tenant's pool of ``n`` images, from its own seed."""
        return {name: make_pool(self.image, n, seed + 1000 + t["seed_offset"],
                                self.device)
                for name, t in self.tenants.items()}

    def submit(self, tenant: str, x) -> int:
        return self.server.submit(tenant, x)

    def step(self) -> List[Batch]:
        """One serving round; its completions grouped by batch (a batch's
        completions are consecutive and carry its size)."""
        done = self.server.step()
        out, i = [], 0
        while i < len(done):
            n = done[i].batch_size
            part = done[i:i + n]
            out.append(Batch(part[0].tenant, [c.rid for c in part],
                             [c.result for c in part],
                             [c.ok for c in part]))
            i += n
        return out

    def grants(self) -> Dict[str, float]:
        """The device fraction each tenant's batches ran under in the
        last round."""
        return {n: t.granted for n, t in self.server.tenants.items()}

    def plan(self, tenant: str, batch_size: int, grant: float) -> List[dict]:
        """The plan the server runs for a batch of ``batch_size`` of
        ``tenant`` under ``grant``, one entry a block, each site its
        member and rung."""
        from repro_torch.core.plan import replan
        from repro_torch.models.frontends import cnn_frontend_site_specs
        t = self.tenants[tenant]
        specs = tuple(cnn_frontend_site_specs(
            self.params[tenant], (batch_size,) + self.image, "float32",
            pool_window=tuple(t["pool_window"]), activation=t["activation"],
            ladder=tuple(t["ladder"])))
        net = replan(specs, self.server.budget.scaled(grant),
                     fuse=self.server.fuse)
        blocks: Dict[str, dict] = {}
        for s in net.sites:
            block, part = s.spec.name.rsplit(".", 1)
            blocks.setdefault(block, {})[part] = {
                "member": s.ip.name.split(".")[-1],
                "bits": int(s.precision_bits)}
        return [blocks[k] for k in sorted(blocks)]

    def counters(self) -> dict:
        """The program's counters: kernel launches, plan-cache lookups,
        and per tenant the batches, their fill and the re-plans."""
        from repro_torch.core.plan import STATS
        from repro_torch.kernels import cuda
        tel = {n: {"batches": t.telemetry.batches,
                   "occupancy_sum": t.telemetry.occupancy_sum,
                   "replans": t.telemetry.replans,
                   "requests": t.telemetry.requests}
               for n, t in self.server.tenants.items()}
        return {"launches": dict(cuda.LAUNCHES),
                "plan_hits": STATS.plan_hits,
                "plan_misses": STATS.plan_misses,
                "tenants": tel}

    def tracer(self):
        from repro_torch.obs.trace import TRACER
        return TRACER

    def close(self) -> None:
        """Drop the server, its plans and its weights' references."""
        from repro_torch.core.plan import clear_plan_cache
        self.server = None
        clear_plan_cache()
