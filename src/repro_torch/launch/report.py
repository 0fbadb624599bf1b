"""Markdown tables over the dry run's records (the port's counterpart of
``repro.launch.report``): the single-mesh roofline, the multi-pod
summary, and a before / after comparison of two artifact directories.

  PYTHONPATH=src python -m repro_torch.launch.report
  PYTHONPATH=src python -m repro_torch.launch.report --compare OLD NEW

The reference splices its tables into ``EXPERIMENTS.md``; the port prints
them (``--out`` writes them to a file).  Every time is analytic, at the
H100's data-sheet peaks (``launch.roofline``).
"""
from __future__ import annotations

import argparse
import json
import pathlib

from .roofline import (ART, HBM_BW, LINK_BW, PEAK_FLOPS, PEAKS_NOTE,
                       load_cells, roofline_row)


def fmt_s(x: float) -> str:
    if x == 0:
        return "0"
    if x >= 0.1:
        return f"{x:.2f}"
    if x >= 1e-3:
        return f"{x * 1e3:.2f}m"
    return f"{x * 1e6:.1f}u"


def _hint(r) -> str:
    if r["arch"].startswith("gp:"):
        return ("map-bound: the psi/reg_stats kernels" if
                r["dominant"] != "collective" else "one all_reduce a step")
    if r["shape"].startswith("decode") or r["shape"].startswith("long"):
        return "bandwidth-bound by nature; int8 KV next"
    if r["dominant"] == "collective":
        return "overlap/quantise the dominant collective"
    if r["dominant"] == "memory":
        return "fuse the unfused ops' traffic"
    return "near-roofline; tune block shapes"


def roofline_table(mesh: str, root=ART) -> str:
    rows = [roofline_row(c) for c in load_cells(mesh, root=root)]
    rows.sort(key=lambda r: (r["arch"].startswith("gp:"), r["arch"],
                             r["shape"], r["variant"]))
    out = ["| arch | shape | variant | compute [s] | memory [s] | "
           "collective [s] | dominant | MODEL/counted flops | roofline frac "
           "| one-line next step |",
           "|---|---|---|---|---|---|---|---|---|---|"]
    for r in rows:
        out.append(
            f"| {r['arch']} | {r['shape']} | {r['variant']} "
            f"| {fmt_s(r['compute_s'])} | {fmt_s(r['memory_s'])} "
            f"| {fmt_s(r['collective_s'])} | {r['dominant']} "
            f"| {r['model_over_counted']:.2f} "
            f"| {r['roofline_frac']:.3f} | {_hint(r)} |")
    return "\n".join(out)


def multi_pod_summary(root=ART) -> str:
    rows = [roofline_row(c) for c in load_cells("multi", root=root)]
    rows.sort(key=lambda r: (r["arch"].startswith("gp:"), r["arch"],
                             r["shape"]))
    out = ["| arch | shape | collective [s] (512 ranks) | dominant | "
           "mem args [GB/rank] |",
           "|---|---|---|---|---|"]
    for r in rows:
        out.append(f"| {r['arch']} | {r['shape']} "
                   f"| {fmt_s(r['collective_s'])} | {r['dominant']} "
                   f"| {r['mem_args_GB']:.2f} |")
    return "\n".join(out)


def perf_compare(before, after, mesh: str = "single") -> str:
    """Each cell in both artifact directories, its three bounds before and
    after."""
    dirs = {"before": pathlib.Path(before) / mesh,
            "after": pathlib.Path(after) / mesh}
    names = sorted({fp.stem for d in dirs.values() for fp in d.glob("*.json")})
    out = ["| cell | artifacts | compute [s] | memory [s] | collective [s] "
           "| dominant |",
           "|---|---|---|---|---|---|"]
    for name in names:
        for tag, d in dirs.items():
            fp = d / f"{name}.json"
            if not fp.exists():
                continue
            c = json.loads(fp.read_text())
            t_c = c["flops"] / PEAK_FLOPS
            t_m = c["bytes"]["total"] / HBM_BW
            t_l = c["collectives"]["total"] / LINK_BW
            dom = max(("compute", t_c), ("memory", t_m),
                      ("collective", t_l), key=lambda kv: kv[1])[0]
            out.append(f"| {name} | {tag} | {fmt_s(t_c)} | {fmt_s(t_m)} "
                       f"| {fmt_s(t_l)} | {dom} |")
    return "\n".join(out)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default=str(ART), help="the dry run's --out")
    ap.add_argument("--compare", nargs=2, metavar=("BEFORE", "AFTER"),
                    help="two artifact directories to compare")
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    parts = [f"({PEAKS_NOTE})"]
    if args.compare:
        parts += ["### Before / after (single mesh)",
                  perf_compare(*args.compare)]
    else:
        parts += ["### Single mesh (16 x 16 = 256 ranks), per-rank terms",
                  roofline_table("single", args.dir),
                  "### Multi-pod (2 x 16 x 16 = 512 ranks)",
                  multi_pod_summary(args.dir)]
    text = "\n\n".join(parts) + "\n"
    if args.out:
        pathlib.Path(args.out).write_text(text)
    print(text)


if __name__ == "__main__":
    main()
