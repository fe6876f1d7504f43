"""Render dry-run records into tables (``repro/launch/report.py``).

    PYTHONPATH=src python -m repro_torch.launch.report \\
        [--dir experiments/dryrun_torch]

Reads the port's records (``launch/dryrun.py``: ``trace_s``, ``step``)
and the reference's alike (``compile_s``, ``scan_graph``).  Times are at
the NVIDIA H100 SXM's rates (``launch/analysis.py``); the diagnoses
speak of the port's step: eager score chunks, the whole-tree ZeRO-3
gather of a data rank's blocks (ROADMAP item 43), and the sublayers the
model axis does not split yet — MoE experts, RWKV, sequence-sharded
decode caches (items 40-42) — which run whole on the first model rank.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
from pathlib import Path

from repro_torch.launch.analysis import H100_HBM_BW, H100_HBM_BYTES


def load(dir_: Path, mesh: str, tag: str = "baseline"):
    recs = []
    for f in sorted(dir_.glob(f"*__{mesh}*.json")):
        r = json.loads(f.read_text())
        if r.get("tag", "baseline") == tag and r["mesh"] == mesh:
            recs.append(r)
    return recs


def fmt_bytes(b):
    if b is None:
        return "-"
    return f"{b/2**30:.2f}"


def _step(r) -> dict:
    """The measured step of a record, either package's."""
    return r["step"] if "step" in r else r["scan_graph"]


def _time_s(r) -> float:
    return r["trace_s"] if "trace_s" in r else r["compile_s"]


def dryrun_table(recs):
    lines = ["| arch | shape | status | trace s | bytes/dev GiB | "
             "GFLOPs/dev | coll GiB/dev | collective schedule |",
             "|---|---|---|---|---|---|---|---|"]
    for r in sorted(recs, key=lambda r: (r["arch"], r["shape"])):
        if r["status"] == "skipped":
            lines.append(f"| {r['arch']} | {r['shape']} | SKIP | - | - | - "
                         f"| - | {r['reason'][:60]} |")
            continue
        if r["status"] == "error":
            lines.append(f"| {r['arch']} | {r['shape']} | ERROR | - | - | - "
                         f"| - | {r['error'][:60]} |")
            continue
        sg = _step(r)
        counts = sg["collective_counts"]
        sched = " ".join(f"{k.split('-')[0][:2]}{k.split('-')[-1][:3]}:{v}"
                         for k, v in counts.items() if v)
        tot = r.get("totals_per_device", sg)
        lines.append(
            f"| {r['arch']} | {r['shape']} | ok | {_time_s(r):.0f} "
            f"| {fmt_bytes(r['static_bytes_per_device'])} "
            f"| {tot['flops']/1e9:.0f} "
            f"| {tot['collectives']['total']/2**30:.2f} "
            f"| {sched or 'none'} |")
    return "\n".join(lines)


def memory_table(recs, device_bytes: float = H100_HBM_BYTES):
    """Static and temp bytes of the busiest device against the card's
    memory: which cells fit."""
    lines = ["| arch | shape | static GiB | temp GiB | static + temp GiB "
             "| fits 80 GiB | busiest device |", "|---|---|---|---|---|---|---|"]
    for r in sorted(recs, key=lambda r: (r["arch"], r["shape"])):
        if r["status"] != "ok" or "temp_size_in_bytes" not in r.get(
                "memory", {}):
            continue
        m = r["memory"]
        total = m["argument_size_in_bytes"] + m["temp_size_in_bytes"]
        where = r.get("busiest_device", {}).get("coords", {})
        lines.append(
            f"| {r['arch']} | {r['shape']} "
            f"| {fmt_bytes(m['argument_size_in_bytes'])} "
            f"| {fmt_bytes(m['temp_size_in_bytes'])} | {fmt_bytes(total)} "
            f"| {'yes' if total <= device_bytes else 'no'} "
            f"| {', '.join(f'{a} {c}' for a, c in where.items()) or '-'} |")
    return "\n".join(lines)


def roofline_table(recs):
    lines = ["| arch | shape | t_comp ms | t_mem ms | t_coll ms | dominant "
             "| 6ND/counted | frac | one-line diagnosis |",
             "|---|---|---|---|---|---|---|---|---|"]
    for r in sorted(recs, key=lambda r: (r["arch"], r["shape"])):
        if r["status"] != "ok":
            continue
        ro = r["roofline"]
        diag = diagnose(r)
        lines.append(
            f"| {r['arch']} | {r['shape']} | {ro['t_compute_s']*1e3:.1f} "
            f"| {ro['t_memory_s']*1e3:.1f} | {ro['t_collective_s']*1e3:.1f} "
            f"| **{ro['dominant']}** | {ro['useful_flops_ratio']:.2f} "
            f"| {ro['roofline_fraction']:.3f} | {diag} |")
    return "\n".join(lines)


def diagnose(r) -> str:
    ro = r["roofline"]
    dom = ro["dominant"]
    if dom == "memory":
        ratio = ro["hbm_bytes"] / max(ro["min_hbm_bytes"], 1)
        if r["shape"].startswith("decode") or r["shape"].startswith("long"):
            return (f"{ratio:.0f}x min traffic: unsplit sublayers' params "
                    "gathered and read on the first model rank, decode "
                    "caches copied; fix: items 40-42")
        return (f"{ratio:.0f}x min traffic: eager score chunks, remat "
                "recompute and the ZeRO-3 gather's copies; fix: a flash "
                "kernel on the train path + per-layer gathers (item 43)")
    if dom == "collective":
        return ("move bound: each data rank's gradient blocks go to their "
                "holders point to point; fix: reduce-scatter")
    return ("compute-bound on the first model rank: the unsplit sublayers "
            "(MoE, RWKV) run there whole (items 41-42)")


def perf_table(d: Path):
    """§Perf: baseline vs variants for the three hillclimb cells, plus
    the deployed memory model (attention scores kept on chip, every op
    output crossing device memory once, the model axis splitting every
    sublayer's compute), which the port's eager step is not: it
    materializes score chunks and runs MoE and RWKV whole."""
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.launch.analysis import deployed_traffic
    cells = [("olmo-1b", "train_4k"),
             ("grok-1-314b", "train_4k"),
             ("llava-next-34b", "prefill_32k")]
    lines = ["| cell | variant | t_mem s | t_comp s | t_coll s | frac | Δ vs base |",
             "|---|---|---|---|---|---|---|"]
    for arch, shape in cells:
        recs = [json.loads(f.read_text())
                for f in sorted(d.glob(f"{arch}__{shape}__single*.json"))]
        recs = [r for r in recs if r["status"] == "ok"]
        base_frac = None
        for r in recs:
            if r.get("tag", "baseline") == "baseline":
                base_frac = r["roofline"]["roofline_fraction"]
        for r in recs:
            ro = r["roofline"]
            tag = r.get("tag", "baseline")
            delta = (f"{ro['roofline_fraction']/base_frac:.2f}x"
                     if base_frac else "-")
            lines.append(
                f"| {arch}/{shape} | {tag} | {ro['t_memory_s']:.1f} "
                f"| {ro['t_compute_s']:.1f} | {ro['t_collective_s']:.1f} "
                f"| {ro['roofline_fraction']:.4f} | {delta} |")
        by_tag = {r.get("tag", "baseline"): r for r in recs}
        src = by_tag.get("opt", by_tag.get("baseline"))
        if src is None or not base_frac:
            continue
        cfg = get_config(arch)
        if cfg.n_heads % 16 or cfg.n_kv_heads % 16:   # padheads applied
            cfg = dataclasses.replace(cfg, n_heads=-(-cfg.n_heads // 16) * 16,
                                      n_kv_heads=16)
        dep = deployed_traffic(cfg, SHAPES[shape], dp=16, tp=16, chips=256,
                               fsdp=cfg.fsdp)
        ro = src["roofline"]
        t_mem_dep = dep / (256 * H100_HBM_BW)
        bound = max(ro["t_compute_s"], t_mem_dep, ro["t_collective_s"])
        frac_dep = min(ro["ideal_time_s"] / max(bound, 1e-12), 1.0)
        dom = ("compute" if bound == ro["t_compute_s"] else
               "memory" if bound == t_mem_dep else "collective")
        lines.append(
            f"| {arch}/{shape} | **deployed model (scores on chip, ops once, "
            f"{src.get('tag', 'baseline')}'s compute and moves)** "
            f"| {t_mem_dep:.1f} | {ro['t_compute_s']:.1f} "
            f"| {ro['t_collective_s']:.1f} | {frac_dep:.4f} "
            f"| {frac_dep/base_frac:.1f}x ({dom}-bound) |")
    return "\n".join(lines)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default="experiments/dryrun_torch")
    ap.add_argument("--tag", default="baseline")
    args = ap.parse_args(argv)
    d = Path(args.dir)

    single = load(d, "single", args.tag)
    multi = load(d, "multi", args.tag)
    print("## Dry-run — single pod 16x16 (256 devices)\n")
    print(dryrun_table(single))
    print("\n## Dry-run — multi-pod 2x16x16 (512 devices)\n")
    print(dryrun_table(multi))
    others = sorted({json.loads(f.read_text())["mesh"]
                     for f in d.glob("*.json")} - {"single", "multi"})
    rest = []
    for mesh in others:   # records of other meshes (e.g. a card's)
        recs = load(d, mesh, args.tag)
        rest += recs
        print(f"\n## Dry-run — mesh {mesh}\n")
        print(dryrun_table(recs))
    print("\n## Memory of the busiest device (H100, 80 GiB)\n")
    print(memory_table(single + multi + rest))
    print("\n## Roofline (single-pod, H100 rates)\n")
    print(roofline_table(single))
    ok = [r for r in single if r["status"] == "ok"]
    if ok:
        fr = [r["roofline"]["roofline_fraction"] for r in ok]
        print(f"\nmean baseline fraction: {sum(fr)/len(fr):.3f} | "
              f"min {min(fr):.3f} | max {max(fr):.3f}")
        worst = sorted(ok, key=lambda r: r["roofline"]["roofline_fraction"])
        print("worst cells:", [(r["cell"],
                                round(r["roofline"]["roofline_fraction"], 3))
                               for r in worst[:5]])
        collb = sorted(ok, key=lambda r: -r["roofline"]["t_collective_s"]
                       / max(r["roofline"]["bound_time_s"], 1e-12))
        print("most collective-heavy:",
              [(r["cell"], round(r["roofline"]["t_collective_s"]
                                 / max(r["roofline"]["bound_time_s"],
                                       1e-12), 3))
               for r in collb[:5]])
    print("\n## §Perf hillclimb cells (all recorded variants)\n")
    print(perf_table(d))


if __name__ == "__main__":
    main()
