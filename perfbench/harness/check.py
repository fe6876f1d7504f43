"""The comparison that decides ``correct``.

Once the window has closed and the program's state is freed, the plain
reference recomputes every batch of the sampled rounds from the same
weights and images, at the rungs the configuration pins for that tenant
and batch size (``rungs``: one string a block, one word a site,
``<site>@<bits>``, with ``lut`` for the activation's table member, as
in ``"conv@8 pool@8 lut@8"``).  The program's own plan decides nothing
the reference computes; it is only held against the pin.  Numbers:

* ``<tenant>_err``: the largest relative L2 gap ``|y - ref| / |ref|`` of
  one answer of that tenant in the sample;
* ``<tenant>_err_median``: the median answer's gap.  Where an int8 site
  follows a float32 one, the two sides' float32 roundings can put an
  element on either side of a quantizer's half step, so a few answers of
  a sound run read above float32 rounding; a lower precision moves every
  answer, the median too;
* ``missing``: requests sent in the window that never got an answer;
* ``rungs``: sampled batches whose plan ran other rungs than the pin, or
  a batch size the pin does not name.  The members that compute a rung
  may change freely.

Each is held against its limit in the configuration's ``limits``.
"""
from __future__ import annotations

import math
from typing import Dict, List

import torch

BIG = 1e30      # stands for a gap that is not a finite number


def _gaps(y: torch.Tensor, ref: torch.Tensor) -> List[float]:
    """Each answer's relative L2 gap; one that is not finite reads BIG."""
    y = y.to(torch.float64).reshape(y.shape[0], -1)
    ref = ref.to(torch.float64).reshape(ref.shape[0], -1)
    gaps = (torch.linalg.vector_norm(y - ref, dim=1)
            / torch.linalg.vector_norm(ref, dim=1).clamp_min(1e-30))
    return [g if math.isfinite(g) else BIG for g in gaps.tolist()]


def rung_words(plan: List[dict]) -> List[str]:
    """The program's plan as the pin writes it: one string a block."""
    def word(part: str, site: dict) -> str:
        lut = part == "act" and site["member"].endswith("act_lut")
        return f"{'lut' if lut else part}@{int(site['bits'])}"
    return [" ".join(word(p, s) for p, s in block.items()) for block in plan]


def pinned_plan(words: List[str]) -> List[dict]:
    """The plan the reference follows, from the pin's strings."""
    out = []
    for block in words:
        sites = {}
        for w in block.split():
            part, bits = w.split("@")
            member = "act_lut" if part == "lut" else part
            sites["act" if part == "lut" else part] = {
                "member": member, "bits": int(bits)}
        out.append(sites)
    return out


def compare(system, reference, kept, pools, config: dict, plans: Dict, *,
            control: bool = False) -> Dict[str, float]:
    """The numbers of the sampled rounds; ``plans`` maps ``(tenant,
    batch size, grant)`` to the program's plan.  With ``control`` the
    reference one rung lower stands in the program's place."""
    tenants = {t["name"]: t for t in config["tenants"]}
    gaps: Dict[str, List[float]] = {name: [] for name in tenants}
    bad_rungs = 0
    for step in kept:
        for b in step.batches:
            if not all(b.ok):
                continue
            t = tenants[b.tenant]
            ran = rung_words(plans[(b.tenant, len(b.rids),
                                    step.grants[b.tenant])])
            pin = config["rungs"][b.tenant].get(str(len(b.rids)))
            bad_rungs += pin != ran
            plan = pinned_plan(pin if pin is not None else ran)
            x = torch.stack([pools[b.tenant][step.images[r][1]]
                             for r in b.rids]).to(system.device)
            kw = dict(window=tuple(t["pool_window"]), kind=t["activation"])
            params = system.params[b.tenant]
            ref = reference.frontend(params, x, plan, **kw)
            if control:
                got = reference.frontend(params, x, plan, control=True, **kw)
            else:
                shapes_ok = all(tuple(r.shape) == tuple(ref.shape[1:])
                                for r in b.results)
                got = (torch.stack(b.results) if shapes_ok
                       else torch.full_like(ref, float("nan")))
            gaps[b.tenant].extend(_gaps(got, ref))
    out = {}
    for n, g in gaps.items():
        g = sorted(g)
        out[f"{n}_err"] = g[-1] if g else BIG
        out[f"{n}_err_median"] = g[(len(g) - 1) // 2] if g else BIG
    out["rungs"] = float(bad_rungs)
    return out


def judge(numbers: Dict[str, float], limits: Dict[str, float]):
    """``(correct, [[name, value, limit], ...])``; a number without a
    limit fails."""
    rows = [[n, v, limits.get(n)] for n, v in numbers.items()]
    correct = all(lim is not None and v <= lim for _, v, lim in rows)
    return correct, rows
