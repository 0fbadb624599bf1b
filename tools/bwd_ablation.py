"""Where the reg_stats backward kernel's time goes: ablations on the card,
beside the previous design's kernel.

    python3 tools/bwd_ablation.py [--parent FILE | --parent-rev REV]

Builds variants of ``src/repro_torch/csrc/reg_stats_bwd.cu``, each the
source with one part removed by text substitution (``VARIANTS``: the
epilogue, skipped at run time; the build of the own knm tile; the DMMA /
FMA product; the copies of the other blocks' slabs through distributed
shared memory; S's rows after the first step; build and product
both; all but the products), with ``nvcc`` and the repo's flags
into a temporary directory outside the checkout, all started together.
The previous design's source (``--parent FILE``, or ``git show
REV:src/repro_torch/csrc/reg_stats_bwd.cu``, default ``HEAD~``) is built
beside them and timed on its own launch arguments (one block a slice of
128-row tiles, as many slices as the card's block slots).  Each bare
launch (``kernel.reg_stats_bwd`` on the arguments ``ops.bwd_launch_args``
makes once) is timed at ``sgpr-synth-1m`` (n 1e6, m 512, q 8, d 4; the
SGPR's gradients: hyper-parameters and z), f64 and f32, by CUDA events
(median of 10), in turns: the parent and the whole kernel first and last.
A variant without a part computes wrong gradients; only its time is read.
The parent's gradients are held against the new kernel's (f64 normwise
1e-8).  Prints one JSON line a dtype, and the card's name and power
limit.
"""
import argparse
import ctypes
import json
import pathlib
import statistics
import subprocess
import sys
import tempfile
from unittest import mock

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.reg_stats import kernel as rs_k  # noqa: E402
from repro_torch.kernels.reg_stats import ops as rs_ops  # noqa: E402

SOURCE = "src/repro_torch/csrc/reg_stats_bwd.cu"
_SKIP = "      if (b >= nts) continue;\n"
VARIANTS = {
    "full": [],
    # the epilogue skipped at run time (flags is never negative), the
    # products' sums kept live; with its code removed instead, ptxas drops
    # the products whose sums nothing reads
    "no_epilogue": [(_SKIP, "      if (b >= nts || flags >= 0) {\n        if (acc[0] == "
                     "T(-1.25e30)) part_sf2[blk] += 1.0;\n        continue;\n      }\n")],
    "no_build": [("        if (tk < nts) build(row0, tk);\n", "")],
    "no_product": [("              product(acc, as, srow + c % SS * KS * LDS, kgrp, h, tid);\n",
                    "")],
    "no_dsmem": [("              if (remote) load_slab(rv, pn, h);\n", ""),
                 ("              if (remote) store_slab(an, rv, h);\n", "")],
    # S's rows never loaded after the first step (the products read stale
    # rows): the k-loop without its L2 traffic
    "no_s_rows": [("            if (next) fetch_s(srow + (c + 1) % SS * KS * LDS, gp0 + pn, b0);\n",
                   "")],
}
VARIANTS["epilogue_only"] = VARIANTS["no_build"] + VARIANTS["no_product"]
# the k-loop's products and barriers alone
VARIANTS["product_only"] = (VARIANTS["no_epilogue"] + VARIANTS["no_build"]
                            + VARIANTS["no_dsmem"] + VARIANTS["no_s_rows"])
PARENT_ROWS = 128   # the previous design's row tile


def build_variants(parent_src: str, out: pathlib.Path) -> dict:
    """Each variant's library and the parent's, compiled in parallel."""
    src = (ROOT / SOURCE).read_text()
    texts = {}
    for name, subs in VARIANTS.items():
        text = src
        for old, new in subs:
            if old not in text:
                raise SystemExit(f"variant {name}: {old!r} not in the source")
            text = text.replace(old, new)
        texts[name] = text
    texts["parent"] = parent_src
    jobs = {}
    for name, text in texts.items():
        (out / f"{name}.cu").write_text(text)
        jobs[name] = subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(out / f"lib{name}.so"),
             str(out / f"{name}.cu")], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed for {name}:\n{log}")
        libs[name] = ctypes.CDLL(str(out / f"lib{name}.so"))
    return libs


def parent_launch(lib, args, dtype):
    """The previous design's launch on the new arguments' operands: its
    own plan (128-row tiles, one block a slice, the card's block slots)
    and scratch; returns (launch, its outputs)."""
    (x, y, w, zp, sp, gcp, hp, m, *_rest) = args
    n, q = x.shape
    mp, d = zp.shape[0], y.shape[1]
    f64, dev = torch.float64, x.device
    slots = _build.sm_count(dev) * rs_k.BWD_BLOCKS_PER_SM[dtype]
    row_tiles = -(-n // PARENT_ROWS)
    per = max(1, -(-row_tiles // max(1, min(row_tiles, slots))))
    n_slices = max(1, -(-row_tiles // per))
    scratch = [torch.empty(sh, dtype=f64, device=dev)
               for sh in ((n_slices, mp, q), (n_slices, q), (n_slices,))]
    outs = [torch.empty(sh, dtype=f64, device=dev) for sh in ((m, q), (q,), ())]
    rows = [torch.empty((0,), dtype=dtype, device=dev) for _ in range(3)]
    fn = getattr(lib, "reg_stats_bwd_" + ("f64" if dtype == f64 else "f32"))
    fn.argtypes = [*([ctypes.c_void_p] * 7), *([ctypes.c_int] * 8),
                   *([ctypes.c_void_p] * 10)]
    fn.restype = ctypes.c_int
    ptrs = [t.data_ptr() for t in (x, y, w, zp, sp, gcp, hp)]

    def launch():
        err = fn(*ptrs, n, m, q, d, mp, n_slices, per, 0,
                 *(t.data_ptr() for t in (*scratch, *outs, *rows)),
                 _build.stream_handle(dev))
        _build.check("parent reg_stats_bwd", err)
    return launch, outs


def time_ms(fn, reps=10) -> float:
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def parent_source(args) -> str:
    if args.parent:
        return pathlib.Path(args.parent).read_text()
    return subprocess.run(["git", "show", f"{args.parent_rev}:{SOURCE}"],
                          cwd=ROOT, check=True, capture_output=True,
                          text=True).stdout


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", help="the previous design's source file")
    ap.add_argument("--parent-rev", default="HEAD~",
                    help="git revision of the previous design (no --parent)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("bwd_ablation: no CUDA device", file=sys.stderr)
        return 2
    out = pathlib.Path(tempfile.mkdtemp(prefix="bwd_ablation_"))
    libs = build_variants(parent_source(args), out)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True).stdout.strip()
    print(smi, flush=True)
    n, m, q, d = 1_000_000, 512, 8, 4
    rng = np.random.default_rng(0)
    dev = torch.device("cuda")

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float64), device=dev)
    ins = [t(0.3), t(np.full(q, 0.5 * np.log(q))), t(rng.uniform(-2, 2, (m, q))),
           t(rng.uniform(-2, 2, (n, q))), t(rng.standard_normal((n, d))),
           torch.ones(n, dtype=torch.float64, device=dev)]
    cts = [t(rng.standard_normal(sh)) for sh in ((), (m, d), (m, m))]
    order = ["parent", "full", *(v for v in VARIANTS if v != "full"), "full",
             "parent"]
    for dtype in (torch.float64, torch.float32):
        kin = ins[:2] + [v.to(dtype) for v in ins[2:]]
        kargs = rs_ops.bwd_launch_args(
            *kin, *(c.to(dtype) for c in cts), 0,
            rs_k.bwd_slots(dtype, m, q, dev))
        parent, parent_out = parent_launch(libs["parent"], kargs, dtype)
        times = {}
        for name in order:
            if name == "parent":
                ms = time_ms(parent)
            else:
                with mock.patch.object(_build, "load",
                                       lambda _, lib=libs[name]: lib):
                    ms = time_ms(lambda: rs_k.reg_stats_bwd(*kargs))
            times.setdefault(name, []).append(ms)
        with mock.patch.object(_build, "load", lambda _: libs["full"]):
            rs_k.reg_stats_bwd(*kargs)
        parent()
        torch.cuda.synchronize()
        rel = [float(torch.linalg.vector_norm(a - b)
                     / torch.linalg.vector_norm(b).clamp_min(1e-300))
               for a, b in zip(kargs[-9:-6], parent_out)]
        if dtype == torch.float64 and max(rel) > 1e-8:
            raise SystemExit(f"the new kernel and the parent differ: {rel}")
        print(json.dumps({"dtype": str(dtype), "shape": dict(n=n, m=m, q=q, d=d),
                          "ms": times, "rel_to_parent": rel}), flush=True)
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
