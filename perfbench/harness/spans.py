"""Shared arithmetic of the metrics' readers: program spans outside the
profiled slice, the device's idle share, and a kernel's roofline share
over the slice's launches."""
from __future__ import annotations

from typing import List, Optional, Sequence

from perfbench.roofline import bound_s, conv2d_work, fused_cnn_work, pooled


def durations_out_of_slice(run, name: str) -> List[float]:
    """Durations (us) of the program's ``name`` spans recorded in the
    window, leaving out those that overlap the profiled slice."""
    sl = run.window.slice
    lo = hi = None
    if sl is not None and sl.t_start is not None:
        t0 = run.clock.t0 * 1e6
        lo, hi = t0 + sl.t_start * 1e6, t0 + sl.t_stop * 1e6
    out = []
    for e in run.spans:
        if e.get("name") != name or e.get("ph") != "X":
            continue
        if lo is not None and e["ts"] + e["dur"] >= lo and e["ts"] <= hi:
            continue
        out.append(e["dur"])
    return out


def idle_share(run) -> Optional[float]:
    """Share of the profiled slice with nothing of the process running
    on the card."""
    if run.trace is None or run.trace["window_s"] <= 0:
        return None
    return 1.0 - run.trace["busy_s"] / run.trace["window_s"]


def _launches(run, kind: str, members: Sequence[str]):
    """(operations, bytes, rate) of every launch of ``kind`` ("fused" or
    "conv" by ``members``) that the slice's batches made, in order."""
    tenants = {t["name"]: t for t in run.cell.config["tenants"]}
    out = []
    for tenant, n, plan in run.slice_plans:
        t = tenants[tenant]
        h, w, cin = run.cell.config["image"]
        k, window = t["k"], tuple(t["pool_window"])
        for block, cout in zip(plan, t["channels"][1:]):
            if kind == "fused" and "fused" in block:
                out.append(fused_cnn_work(n, h, w, cin, k, cout, window,
                                          block["fused"]["bits"]))
            elif kind == "conv" and "conv" in block \
                    and block["conv"]["member"] in members:
                out.append(conv2d_work(n, h, w, cin, k, cout,
                                       block["conv"]["bits"]))
            h, w = pooled(h, w, k, window)
            cin = cout
    return out


def roofline(run, kernel: str, kind: str,
             members: Sequence[str] = ()) -> Optional[float]:
    """Sum of the launches' bounds over the sum of their device times,
    in %.  Nothing to read (no launch, or a count of kernels in the
    trace that does not match the launches the batches made) gives
    None."""
    if run.trace is None:
        return None
    times = [s for name, s in run.trace["kernels"] if kernel in name]
    work = _launches(run, kind, members)
    if not times or len(times) != len(work):
        if times or work:
            run.notes.append(f"{kernel}: {len(times)} kernels in the trace, "
                             f"{len(work)} launches planned; not read")
        return None
    peaks = run.peaks()
    bound = sum(bound_s(peaks, ops, nbytes, rate)
                for ops, nbytes, rate in work)
    return 100.0 * bound / sum(times)
