"""Where the reg_stats backward kernel's time goes: ablations on the card.

    python3 tools/bwd_ablation.py

Builds variants of ``src/repro_torch/csrc/reg_stats_bwd.cu``, each the
source with one part removed by text substitution (``VARIANTS``: the
epilogue after the k-loop or one of its two passes, skipped at run time;
the slab build inside the k-loop, the DMMA / FMA product, both, the
exps), with ``nvcc`` and the
repo's flags into ``build/ablation/``, all started together, and times each variant's bare
launch (``kernel.reg_stats_bwd`` on the arguments ``ops.bwd_launch_args``
makes once) at ``sgpr-synth-1m`` (n 1e6, m 512, q 8, d 4; the SGPR's
gradients: hyper-parameters and z), f64 and f32, by CUDA events (median of
10), in turns: the whole kernel first and last.  A variant without a part
computes wrong gradients; only its time is read.  Prints one JSON line a
dtype, and the card's name and power limit.
"""
import ctypes
import json
import pathlib
import statistics
import subprocess
import sys
from unittest import mock

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.reg_stats import kernel as rs_k  # noqa: E402
from repro_torch.kernels.reg_stats import ops as rs_ops  # noqa: E402

_EPILOGUE = "      __syncthreads();  // every product done: the buffers take the E tile\n"
VARIANTS = {
    "full": [],
    # the epilogue skipped at run time (flags is never negative); with its
    # code removed instead, ptxas drops the products whose sums nothing reads
    "no_epilogue": [(_EPILOGUE, _EPILOGUE + "      if (flags >= 0) {\n        if (acc[0] == "
                     "T(-1.25e30)) part_sf2[slice] += 1.0;\n        continue;\n      }\n")],
    "no_build": [("          if (c + 1 < nk) build(nxt, znx, row0, (c + 1) * KS, g);\n",
                  "")],
    "no_product": [("          product(acc, as, bs, g, warp, lane);\n", "")],
    "no_exp": [("  double x = -0.5 * e;", "  return sf2 * (1.0 - 0.5 * e);\n  double x = -0.5 * e;"),
               ('  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));',
                "  r = 1.0f + v;")],
    # the epilogue's parts skipped at run time (flags is never negative)
    "no_entry_pass": [("      {\n        const int i = tid % BR, h = tid / BR, row = row0 + i;",
                       "      if (flags < 0) {\n        const int i = tid % BR, h = tid / BR, row = row0 + i;")],
    "no_column_pass": [("Thread: column j, rows of half h.\n      {",
                        "Thread: column j, rows of half h.\n      if (flags < 0) {")],
}
VARIANTS["epilogue_only"] = VARIANTS["no_build"] + VARIANTS["no_product"]


def build_variants() -> dict:
    """Each variant's library, compiled in parallel."""
    src = (ROOT / "src/repro_torch/csrc/reg_stats_bwd.cu").read_text()
    out = ROOT / "build" / "ablation"
    out.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for name, subs in VARIANTS.items():
        text = src
        for old, new in subs:
            if old not in text:
                raise SystemExit(f"variant {name}: {old!r} not in the source")
            text = text.replace(old, new)
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


def main() -> int:
    if not torch.cuda.is_available():
        print("bwd_ablation: no CUDA device", file=sys.stderr)
        return 2
    libs = build_variants()
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
    order = list(VARIANTS) + ["full"]
    for dtype in (torch.float64, torch.float32):
        kin = ins[:2] + [v.to(dtype) for v in ins[2:]]
        args = rs_ops.bwd_launch_args(*kin, *(c.to(dtype) for c in cts), 0,
                                      _build.sm_count(dev))
        times = {}
        for name in order:
            with mock.patch.object(_build, "load", lambda _, lib=libs[name]: lib):
                ms = time_ms(lambda: rs_k.reg_stats_bwd(*args))
            times.setdefault(name, []).append(ms)
        print(json.dumps({"dtype": str(dtype), "shape": dict(n=n, m=m, q=q, d=d),
                          "ms": times}), flush=True)
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
