#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA card.  It

1. builds every kernel of ``src/repro_torch/csrc`` with ``nvcc`` (in
   parallel, into ``build/kernels/``) and prints the card's name and power
   limit;
2. holds each kernel against its plain PyTorch version on the card, at the
   main paths' full-width shapes and at one ragged shape, in both dtypes,
   and times both with CUDA events (psi2 and psi1 at the ``gplvm-usps``
   and ``gplvm-synth-100k`` shapes; f64 reg_stats at q = 40 and at d = 64,
   predict at m = 2048 and f64 psi at q = 160, past one 16-feature chunk or
   one block's slab, f32 reg_stats at m = 23,200 (past the old gridDim.y
   limit) and f64 at m = 2,048 (more units than SMs), checked untimed;
   f64 psi2 and psi1 at m = 63, 65 and 151 (psi2's patch and tile edges)
   and psi2 where its centred exponent's terms are largest against their
   sum, D exactly symmetric and bitwise the same on a second run; the
   backward alone (reg_stats_vjp at sgpr-synth-1m, psi2_vjp and psi1_vjp
   at gplvm-usps), timed; flash attention, bf16 and f32, at the
   ``llama3.2-1b`` prefill shape, one long shape and the sweep of
   ``tests/test_kernels_pallas.py``, beside ``scaled_dot_product_attention``
   as a yardstick; and cuBLAS's f64 ``K^T (w K)`` and f64 and f32 ``K g``
   over a materialised K, printed as yardsticks of the reg_stats and
   predict kernels' product loops);
3a. trains and serves the SGPR at ``sgpr-synth-1m`` (n = 1e6, q = 8,
   d = 4, m = 512): ``SGPR`` -> value and gradient of the bound against the
   plain f64 path -> ``fit`` (3 SCG iterations; the bound must rise) ->
   ``log_bound`` -> ``predictive_state`` -> ``save_state`` / ``load_state``
   -> ``PredictEngine`` answering query batches, checked against the same
   path computed by the plain versions in f64 on the card;
3d. runs the distributed Map-Reduce (``DistributedGP`` through
   ``make_gp_train_step``): in a world of one over NCCL at
   ``sgpr-synth-1m``, value and gradient against ``SGPR._neg_vg`` (1e-9 /
   1e-8 relative), a 3-iteration SCG fit (the bound must rise) and
   ``predictive_state`` against the model's (1e-10), the NCCL all_reduce's
   bytes and time; the latent map at ``gplvm-usps`` against
   ``BayesianGPLVM._neg_vg`` (the gradient within the plain path's own
   spread, 3.42e-7); then 4 ranks spawned on the one card over gloo, each
   holding n / 4 rows: fmasks (1,1,1,1) drop, (1,0,1,1) drop and rescale
   against one process with the same masked weights (1e-9 / 1e-8), and 3
   SCG iterations under ``FailureSimulator(4, 0.01, seed=3)`` with every
   rank's bounds bitwise equal, and the ranks' ``StepTimer`` summary;
3b. trains and serves the Bayesian GPLVM at ``gplvm-usps`` (n = 4649,
   d = 256, q = 10, m = 150): value and gradient against the plain f64
   path -> ``fit`` (10 SCG iterations; the bound must rise) ->
   ``predictive_state`` -> ``PredictEngine`` answering the 4649 training
   latents, checked against the plain f64 path;
3c. serves ``llama3.2-1b`` at full width (random weights from a seed):
   ``init_params`` -> ``make_prefill_step`` over 4 prompts of 2048 tokens
   (twice, cold and warm) -> the caches copied into a cache with room for
   16 more -> 16 greedy ``make_serve_step`` tokens -> the same weights
   prefilled at f32 compute; checked against the same model with the plain
   attention, and by teacher-forced decode against the prefill.

Every launch counter is set to 0 just before each of 3a, 3d, 3b and 3c
and read just after; each kernel of a path must have launched in it (3d's
ranks count their own launches and report them).

It prints one JSON line describing the kernels of the main path, then
``{"ok": true, "device": {...}}`` as its last line.  Any failed check
raises, so the exit code is non-zero and no result line is printed.  It
exits with code 2, printing nothing on stdout, where there is no CUDA device
or no ``src/repro_torch`` beside it.  It imports nothing of JAX.
"""
from __future__ import annotations

import json
import math
import pathlib
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent
SEED = 0
# Forward-error bounds |kernel - plain| <= rtol*|plain| + atol_abs * (plain
# on |operands|), by the kernel's dtype.  f32: the f32 tier of
# tests/test_reg_stats_pallas.py.  f64: far above f64 rounding over 1e6
# rows, far below one f32 rounding of the slab, so a double instantiation
# that computes partly in f32 fails.
TIERS = {torch.float32: (2e-4, 1e-5), torch.float64: (1e-10, 1e-11)}
# Serving budgets (tests/test_serving_quant.py): mean RMSE / std(y),
# var RMSE / sf2, against the plain f64 path.
MEAN_BUDGET, VAR_BUDGET = 2e-2, 5e-3
# Published dense peaks (NVIDIA H100 data sheet), by the product name
# nvidia-smi reports: (f32 FLOP/s on the CUDA cores, f64 FLOP/s on the FP64
# tensor cores -- the card's highest f64 rate, bytes/s, bf16 FLOP/s on the
# tensor cores).
PEAKS = {"PCIe": (51.2e12, 51.2e12, 2.0e12, 756e12),
         "NVL": (60e12, 60e12, 3.9e12, 835e12),
         "SXM": (67e12, 67e12, 3.35e12, 989e12)}
TIMED_REPS = 10
PLAIN_ROWS = 65_536   # rows per chunk of the plain reg_stats (its (rows, m, q) diff)
GRAD_ROWS = 32_768    # rows per checkpointed chunk of the plain SGPR gradient
PSI_ELEMS = 1 << 25   # elements of the plain psi2's (rows, m, m, q) chunk
# Cost of one exp, in f32 flops' worth of time at the f32 peak: f32 exps
# run on the SFU (MUFU.EX2, 16 a clock per SM against 128 FP32 FMAs, i.e.
# 256 flops); an f64 exp is assumed to be the ~16 DFMAs of libdevice's
# __nv_exp (range reduction, a degree-11 polynomial, scaling), each at
# the CUDA cores' 64 DFMAs a clock per SM.
EXP_COST = {torch.float32: 256 / 16, torch.float64: 16 * 256 / 64}
SGPR_FIT_ITERS, GPLVM_FIT_ITERS = 3, 10
GRAD_RTOL = 1e-8      # value and gradient against the plain f64 path
# Flash attention against its plain version in f64: |err| <= tol (1 +
# |plain|), the tiers of tests/test_kernels_pallas.py.
FA_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
FA_PLAIN_ELEMS = 1 << 27   # scores per query-row chunk of the plain version
# llama3.2-1b logits against the same model with the plain attention, and
# teacher-forced decode against the prefill: relative RMS at bf16 compute
# (the repo's bf16 tolerance, tests/test_models_smoke.py) and at f32 compute
# (only the attention's summation order differs).
LOGIT_RTOL = {"bfloat16": 2e-2, "float32": 1e-4}
LM_BATCH, LM_PROMPT, LM_NEW = 4, 2048, 16
DEV = "cuda"


def card_peaks(name: str):
    for key in ("PCIe", "NVL"):
        if key in name:
            return PEAKS[key]
    return PEAKS["SXM"]


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout
    return out.strip().splitlines()[0]


def time_ms(fn, reps: int = TIMED_REPS) -> float:
    """Median CUDA-event time of ``fn`` after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def graph_ms(fn, launches: int = 20) -> float:
    """Device time of one call of ``fn`` without its host work: ``launches``
    calls captured in one CUDA graph, the replay timed by ``time_ms``, per
    call.  For kernels shorter than their own launch's host work, where
    ``time_ms`` of a bare launch measures the host."""
    fn()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            fn()
    return time_ms(graph.replay) / launches


def t64(a, device=None):
    """An f64 tensor of ``a`` on ``device`` (default DEV)."""
    return torch.as_tensor(np.asarray(a, np.float64),
                           device=DEV if device is None else device)


def make_regression(rng, n, q, d, noise=0.1):
    """The formula of tests/conftest.py::make_regression."""
    x = rng.uniform(-2.0, 2.0, size=(n, q))
    w = rng.standard_normal((q, d))
    f = np.sin(x @ w) + 0.5 * np.cos(2.0 * (x @ w[:, ::-1]))
    return x, f + noise * rng.standard_normal((n, d))


def check_close(name, got, plain, plain_abs) -> tuple[float, float]:
    """Forward-error check at ``got``'s dtype tier; returns (max abs error,
    max error / bound)."""
    rtol, atol_abs = TIERS[got.dtype]
    err = (got.double() - plain).abs()
    bound = rtol * plain.abs() + atol_abs * plain_abs.abs()
    worst = float((err / bound.clamp_min(1e-300)).max())
    if not bool(torch.isfinite(got).all()) or worst > 1.0:
        raise AssertionError(f"{name}: max |err|/bound = {worst:.3e} "
                             f"(max |err| {float(err.max()):.3e})")
    return float(err.max()), worst


# -- phase 2: kernels against their plain versions ---------------------------

def plain_reg_stats(ref, hyp, z, x, y, w):
    """The plain version over row chunks (its (rows, m, q) broadcast would be
    32 GB at n = 1e6 in one piece), summed in f64."""
    b = c = d_stat = 0.0
    for lo in range(0, x.shape[0], PLAIN_ROWS):
        sl = slice(lo, lo + PLAIN_ROWS)
        bb, cc, dd = ref.reg_stats_ref(hyp["log_sf2"], hyp["log_ell"], z,
                                       x[sl], y[sl], w[sl])
        b, c, d_stat = b + bb, c + cc, d_stat + dd
    return b, c, d_stat


def reg_stats_flops(n, m, q, d) -> float:
    # slab n*m*(3q+2); D upper half n*m(m+1)/2 FMAs; C n*m*d FMAs; b n adds
    return n * m * (3 * q + 2) + n * m * (m + 1) + 2 * n * m * d + n


def reg_stats_bound(n, m, q, d, dtype, peaks) -> tuple[float, str]:
    """Least time: the flops at the type's peak (f32 on the CUDA cores, f64
    on the FP64 tensor cores) plus the slab's n*m exps at their
    ``EXP_COST`` on the CUDA cores, or the bytes read and written once."""
    item, peak = (4, peaks[0]) if dtype == torch.float32 else (8, peaks[1])
    nbytes = item * (n * (q + d + 1) + m * q + m * m + m * d + 1)
    t_ops = (reg_stats_flops(n, m, q, d) / peak
             + n * m * EXP_COST[dtype] / peaks[0])
    t_bytes = nbytes / peaks[2]
    return 1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def cublas_d_product_ms(n, m, rows=65_536) -> float:
    """Yardstick for the f64 DMMA loop, never called by the port: the time
    of ``torch.matmul`` for K^T (w K) over a materialised f64 K of
    ``rows`` x m (cuBLAS on the FP64 tensor cores), scaled to n rows."""
    gen = torch.Generator(device=DEV).manual_seed(SEED)
    k = torch.rand((rows, m), dtype=torch.float64, device=DEV, generator=gen)
    wk = torch.rand((rows, 1), dtype=torch.float64, device=DEV,
                    generator=gen) * k
    kt = k.T
    return time_ms(lambda: torch.matmul(kt, wk)) * n / rows


def predict_flops(t, m, q, d) -> float:
    # slab t*m*(3q+2); quad over the symmetric g t*m(m+1)/2 pair products;
    # mean t*m*d FMAs
    return t * m * (3 * q + 2) + t * m * (m + 1) + 2 * t * m * d


def predict_bound(t, m, q, d, dtype, peaks) -> tuple[float, str]:
    """Least time: the flops at the type's peak (f32 on the CUDA cores, f64
    on the FP64 tensor cores) plus the slab's t*m exps at their
    ``EXP_COST`` on the CUDA cores, or the bytes read and written once."""
    item, peak = (4, peaks[0]) if dtype == torch.float32 else (8, peaks[1])
    nbytes = item * (t * q + m * q + m * d + m * m + q + 1 + t * d + t)
    t_ops = (predict_flops(t, m, q, d) / peak
             + t * m * EXP_COST[dtype] / peaks[0])
    t_bytes = nbytes / peaks[2]
    return 1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def cublas_quad_product_ms(t, m, dtype=torch.float64) -> float:
    """Yardstick for the predict kernels' product loops, never called by
    the port: the time of ``torch.matmul`` for K g over a materialised K of
    t x m (cuBLAS: f64 on the FP64 tensor cores, f32 in IEEE f32 on the
    CUDA cores with TF32 off; the full m x m product, no slab, no exps)."""
    gen = torch.Generator(device=DEV).manual_seed(SEED)
    k = torch.rand((t, m), dtype=dtype, device=DEV, generator=gen)
    g = torch.rand((m, m), dtype=dtype, device=DEV, generator=gen)
    return time_ms(lambda: torch.matmul(k, g))


def check_reg_stats(rs_ops, rs_ref, peaks, n, m, q, d, dtype, masked, timed):
    rng = np.random.default_rng(SEED + n + m)
    dev = DEV
    f64 = torch.float64

    def t64(a):
        return torch.from_numpy(np.asarray(a, np.float64)).to(dev)

    x, y = make_regression(rng, n, q, d)
    z = t64(rng.uniform(-2.0, 2.0, (m, q)))
    x, y = t64(x), t64(y)
    w = (t64(rng.uniform(size=n) > 0.15) if masked
         else torch.ones(n, dtype=f64, device=dev))
    hyp = {"log_sf2": t64(float(np.log(float(y.var())))),
           "log_ell": t64(np.full(q, 0.5 * np.log(q)))}
    xk, yk, wk, zk = (v.to(dtype) for v in (x, y, w, z))
    # The plain version runs in f64 on exactly the values the kernel sees.
    xs, ys, ws, zs = (v.to(f64) for v in (xk, yk, wk, zk))
    b, c, dd = rs_ops.reg_stats(hyp, zk, xk, yk, wk)
    pb, pc, pd = plain_reg_stats(rs_ref, hyp, zs, xs, ys, ws)
    _, pc_abs, _ = plain_reg_stats(rs_ref, hyp, zs, xs, ys.abs(), ws)
    torch.cuda.synchronize()
    if c.shape != (m, d) or dd.shape != (m, m):
        raise AssertionError(f"reg_stats shapes {tuple(c.shape)}, {tuple(dd.shape)}")
    err_b, _ = check_close("reg_stats b", b, pb, pb)
    err_c, worst_c = check_close("reg_stats C", c, pc, pc_abs)
    err_d, worst_d = check_close("reg_stats D", dd, pd, pd)
    if not torch.equal(dd, dd.T):
        raise AssertionError("reg_stats D is not exactly symmetric")
    out = {"shape": dict(n=n, m=m, q=q, d=d), "dtype": str(dtype),
           "max_abs_err": max(err_b, err_c, err_d),
           "max_err_over_bound": max(worst_c, worst_d)}
    if timed:
        out["ms"] = time_ms(lambda: rs_ops.reg_stats(hyp, zk, xk, yk, wk))
        out["plain_ms"] = time_ms(
            lambda: plain_reg_stats(rs_ref, hyp, zs, xs, ys, ws), reps=3)
        out["bound_ms"], out["bound_by"] = reg_stats_bound(n, m, q, d, dtype,
                                                           peaks)
    print(f"reg_stats {out}", flush=True)
    return out


def predict_launch_only(hyp, z, a_mean, g, x):
    """The bare ctypes launch of the predict kernels (pair tiles and
    hyper-parameters, then the walk) on operands prepared once: their
    device time without the wrapper's casts and allocations (the wrapper's
    time is ``ms``)."""
    from repro_torch.kernels.predict import kernel as p_k

    (t, q), (m, d) = x.shape, a_mean.shape
    log_sf2, log_ell = (hyp[k].to(x.dtype).contiguous()
                        for k in ("log_sf2", "log_ell"))
    h, kscr = p_k.scratch(t, m, q, x.dtype, DEV)
    mean = torch.empty((t, d), dtype=x.dtype, device=DEV)
    quad = torch.empty((t,), dtype=x.dtype, device=DEV)
    return lambda: p_k.predict(x, z, log_sf2, log_ell, a_mean, g, h, kscr,
                               mean, quad)


def check_predict(p_ops, p_ref, peaks, t, m, q, d, dtype, timed):
    rng = np.random.default_rng(SEED + t + m)
    dev = DEV

    def tt(a):
        return torch.from_numpy(np.asarray(a, np.float64)).to(dev, dtype)

    z = tt(rng.uniform(-2.0, 2.0, (m, q)))
    a_mean = tt(rng.standard_normal((m, d)))
    g = rng.standard_normal((m, m))
    g = tt(g + g.T)                       # symmetric like the real g
    x = tt(rng.uniform(-2.0, 2.0, (t, q)))
    hyp = {"log_sf2": tt(rng.uniform(-0.5, 0.8)),
           "log_ell": tt(np.full(q, 0.5 * np.log(q)))}
    f64 = torch.float64
    ops64 = [v.to(f64) for v in (z, a_mean, g, x)]
    hyp64 = {k: v.to(f64) for k, v in hyp.items()}
    mean, quad = p_ops.predict_stats(hyp, z, a_mean, g, x)
    pm, pq = p_ref.predict_ref(hyp64["log_sf2"], hyp64["log_ell"], *ops64)
    pm_abs, pq_abs = p_ref.predict_ref(hyp64["log_sf2"], hyp64["log_ell"],
                                       ops64[0], ops64[1].abs(), ops64[2].abs(),
                                       ops64[3])
    torch.cuda.synchronize()
    if mean.shape != (t, d) or quad.shape != (t,):
        raise AssertionError(f"predict shapes {tuple(mean.shape)}, {tuple(quad.shape)}")
    err_m, worst_m = check_close("predict mean", mean, pm, pm_abs)
    err_q, worst_q = check_close("predict quad", quad, pq, pq_abs)
    out = {"shape": dict(t=t, m=m, q=q, d=d), "dtype": str(dtype),
           "max_abs_err": max(err_m, err_q),
           "max_err_over_bound": max(worst_m, worst_q)}
    if timed:
        out["ms"] = time_ms(lambda: p_ops.predict_stats(hyp, z, a_mean, g, x))
        bare = predict_launch_only(hyp, z, a_mean, g, x)
        out["launch_only_ms"] = time_ms(bare)
        out["device_ms"] = graph_ms(bare)
        out["plain_ms"] = time_ms(
            lambda: p_ref.predict_ref(hyp["log_sf2"], hyp["log_ell"],
                                             z, a_mean, g, x))
        out["bound_ms"], out["bound_by"] = predict_bound(t, m, q, d, dtype,
                                                         peaks)
    print(f"predict {out}", flush=True)
    return out


def psi_rows(m, q) -> int:
    return max(1, PSI_ELEMS // (m * m * q))


def psi_bound(kind, n_eff, n, m, q, dtype, peaks) -> tuple[float, str]:
    """Least time for psi2 (the upper half of D's pairs, over the rows with
    nonzero weight: zero-weight rows are skipped) or psi1, each (row, pair
    or point) at the least work its kernel's form needs, plus one exp at
    its ``EXP_COST``; or the bytes read once, written once.  psi2's
    centred exponent costs 2q + 5 flops a pair (per q one FMA of
    u_a (z_b - mu)/(2c); the two alphas, the weighted exp's FMA), psi1's
    direct one 4q + 3 (per q a subtraction, a product and an FMA)."""
    item = 4 if dtype == torch.float32 else 8
    peak = peaks[0] if dtype == torch.float32 else peaks[1]
    if kind == "psi2":
        entries = n_eff * m * (m + 1) / 2
        flops = 2 * q + 5
        nbytes = item * (n * (2 * q + 1) + m * q + 2 * q + 1) + 8 * m * m
    else:
        entries = n * m
        flops = 4 * q + 3
        nbytes = item * (2 * n * q + m * q + 2 * q + 1 + n * m)
    t_ops = entries * flops / peak + entries * EXP_COST[dtype] / peaks[0]
    t_bytes = nbytes / peaks[2]
    return 1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def psi_launch_only(kind, hyp, z, mu, s, w):
    """The bare ctypes launch of a psi kernel on operands prepared once:
    the kernel's device time without the wrapper's casts, autograd
    Function and allocations (the wrapper's time is ``ms``)."""
    from repro_torch.kernels.psi_stats import kernel as ps_k

    n, m, q = mu.shape[0], z.shape[0], z.shape[1]
    log_sf2, log_ell = (hyp[k].to(mu.dtype).contiguous()
                        for k in ("log_sf2", "log_ell"))
    if kind == "psi1":
        out = torch.empty((n, m), dtype=mu.dtype, device=DEV)
        return lambda: ps_k.psi1(mu, s, z, log_sf2, log_ell, out)
    n_slices, rows, scratch = ps_k.psi2_scratch(n, m, q, mu.dtype, mu.device)
    d_out = torch.empty((m, m), dtype=torch.float64, device=DEV)
    return lambda: ps_k.psi2(mu, s, w, z, log_sf2, log_ell, n_slices, rows,
                             scratch, d_out)


def check_psi(ps_ops, ps_ref, peaks, n, m, q, dtype, masked, timed):
    """psi2 and psi1 against their plain versions in f64 on the kernel's
    values; returns ``{"psi2": {...}, "psi1": {...}}``."""
    rng = np.random.default_rng(SEED + n + m + q)
    f64 = torch.float64

    def tt(a):
        return torch.from_numpy(np.asarray(a, np.float64)).to(DEV, dtype)

    hyp = {"log_sf2": torch.tensor(rng.uniform(-0.5, 0.8), dtype=f64,
                                   device=DEV),
           "log_ell": torch.full((q,), 0.5 * math.log(q), dtype=f64,
                                 device=DEV)}
    z, mu = tt(rng.standard_normal((m, q))), tt(rng.standard_normal((n, q)))
    s = tt(rng.uniform(0.05, 1.0, (n, q)))
    w = tt((rng.uniform(size=n) > 0.15) if masked else np.ones(n))
    h64 = (hyp["log_sf2"], hyp["log_ell"])
    z64, mu64, s64, w64 = (v.to(f64) for v in (z, mu, s, w))
    rows = psi_rows(m, q)
    out = {}
    d_stat = ps_ops.psi2(hyp, z, mu, s, w)
    again = ps_ops.psi2(hyp, z, mu, s, w)
    plain = ps_ref.psi2_ref(*h64, z64, mu64, s64, w64, chunk=rows)
    torch.cuda.synchronize()
    if d_stat.shape != (m, m) or not torch.equal(d_stat, d_stat.T):
        raise AssertionError("psi2: D has the wrong shape or is not exactly "
                             "symmetric")
    if not torch.equal(d_stat, again):
        raise AssertionError("psi2: two runs on the same inputs differ")
    err, worst = check_close("psi2", d_stat, plain, plain)
    out["psi2"] = {"max_abs_err": err, "max_err_over_bound": worst}
    p1 = ps_ops.psi1(hyp, z, mu, s)
    plain1 = ps_ref.psi1_ref(*h64, z64, mu64, s64, chunk=rows * m)
    torch.cuda.synchronize()
    if p1.shape != (n, m):
        raise AssertionError(f"psi1 shape {tuple(p1.shape)}")
    err, worst = check_close("psi1", p1, plain1, plain1)
    out["psi1"] = {"max_abs_err": err, "max_err_over_bound": worst}
    if timed:
        n_eff = int((w != 0).sum())
        for kind, fn, plain_fn in (
                ("psi2", lambda: ps_ops.psi2(hyp, z, mu, s, w),
                 lambda: ps_ref.psi2_ref(*h64, z64, mu64, s64, w64,
                                         chunk=rows)),
                ("psi1", lambda: ps_ops.psi1(hyp, z, mu, s),
                 lambda: ps_ref.psi1_ref(*h64, z64, mu64, s64,
                                         chunk=rows * m))):
            out[kind]["ms"] = time_ms(fn)
            out[kind]["plain_ms"] = time_ms(plain_fn, reps=3)
            bare = psi_launch_only(kind, hyp, z, mu, s, w)
            out[kind]["launch_only_ms"] = time_ms(bare)
            out[kind]["device_ms"] = graph_ms(bare)
            out[kind]["bound_ms"], out[kind]["bound_by"] = psi_bound(
                kind, n_eff, n, m, q, dtype, peaks)
    for kind in ("psi2", "psi1"):
        print(f"{kind} ", dict(shape=dict(n=n, m=m, q=q), dtype=str(dtype),
                               masked=masked, **out[kind]), flush=True)
    return out


def check_psi2_midway(ps_ops, ps_ref, n, m, q):
    """f64 psi2 where the centred exponent's terms are largest against their
    sum: pairs of inducing points at +-70 d_j (d_j unit vectors, l^2 = q),
    the rows' means near 0, midway between them.  Each term alpha ~ 120
    while mu - zbar ~ 0; D holds exp(static) ~ exp(-490) there."""
    rng = np.random.default_rng(SEED + 7)
    f64 = torch.float64
    d = rng.standard_normal((m // 2, q))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    z = np.concatenate([70.0 * d, -70.0 * d])
    mu = 1e-3 * rng.standard_normal((n, q))
    s = rng.uniform(0.05, 1.0, (n, q))
    w = (rng.uniform(size=n) > 0.15).astype(np.float64)
    hyp = {"log_sf2": torch.tensor(0.3, dtype=f64, device=DEV),
           "log_ell": torch.full((q,), 0.5 * math.log(q), dtype=f64,
                                 device=DEV)}
    z, mu, s, w = (torch.from_numpy(a).to(DEV) for a in (z, mu, s, w))
    got = ps_ops.psi2(hyp, z, mu, s, w)
    plain = ps_ref.psi2_ref(hyp["log_sf2"], hyp["log_ell"], z, mu, s, w)
    torch.cuda.synchronize()
    if not torch.equal(got, got.T):
        raise AssertionError("psi2 midway: D is not exactly symmetric")
    err, worst = check_close("psi2 midway", got, plain, plain)
    print("psi2 midway ", dict(shape=dict(n=n, m=m, q=q), dtype=str(f64),
                               max_abs_err=err, max_err_over_bound=worst,
                               min_plain=float(plain.min())), flush=True)


def time_backward(label, vjp, primals, cotangents, needs, reps=5) -> float:
    """CUDA-event median of one call of a kernel's backward (the plain
    version recomputed in row chunks, ``kernels._vjp``) on the card, with
    the inputs the training path differentiates; printed on its own line."""
    ms = time_ms(lambda: vjp(*primals, *cotangents, needs), reps=reps)
    print(f"backward {label}: {ms:.4f} ms (median of {reps})", flush=True)
    return ms


def time_backwards(rs_ops, ps_ops, sgpr, usps) -> None:
    """The backward alone, beside the forward timed above: ``reg_stats_vjp``
    at sgpr-synth-1m (gradients of the hyper-parameters and z, as the
    SGPR's bound takes them), ``psi2_vjp`` and ``psi1_vjp`` at gplvm-usps
    (the hyper-parameters, z, mu and s, as the GPLVM's)."""
    f64 = torch.float64
    rng = np.random.default_rng(SEED + 3)
    n, m, q, d = sgpr.n, sgpr.m, sgpr.q, sgpr.d
    x, y = make_regression(rng, n, q, d)
    hyp = [t64(float(np.log(float(np.var(y))))), t64(np.full(q, 0.5 * np.log(q)))]
    primals = [*hyp, t64(rng.uniform(-2.0, 2.0, (m, q))), t64(x), t64(y),
               torch.ones(n, dtype=f64, device=DEV)]
    cts = [t64(rng.standard_normal(sh)) for sh in ((), (m, d), (m, m))]
    time_backward("reg_stats_vjp f64 sgpr-synth-1m", rs_ops.reg_stats_vjp,
                  primals, cts, [True, True, True, False, False, False])
    del primals, cts, x, y
    n, m, q = usps.n, usps.m, usps.q
    primals = [t64(rng.uniform(-0.5, 0.8)), t64(np.full(q, 0.5 * np.log(q))),
               t64(rng.standard_normal((m, q))), t64(rng.standard_normal((n, q))),
               t64(rng.uniform(0.05, 1.0, (n, q))),
               torch.ones(n, dtype=f64, device=DEV)]
    time_backward("psi2_vjp f64 gplvm-usps", ps_ops.psi2_vjp, primals,
                  [t64(rng.standard_normal((m, m)))], [True] * 5 + [False])
    time_backward("psi1_vjp f64 gplvm-usps", ps_ops.psi1_vjp, primals[:5],
                  [t64(rng.standard_normal((n, m)))], [True] * 5)


def reset_counts(*counts):
    for c in counts:
        for k in c:
            c[k] = 0


def timed_step(steps):
    """``step(name, fn)``: run ``fn`` between synchronisations and record
    its host time in ``steps[name]``."""
    def step(name, fn):
        torch.cuda.synchronize()
        s = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        steps[name] = time.perf_counter() - s
        return out
    return step


def rel_diff(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def check_value_and_grad(label, model, plain_neg, step, report,
                         reordered=()):
    """The model's ``_neg_vg`` (kernels forward, chunked plain recompute
    backward) against the value and gradient of ``plain_neg`` by plain
    autograd, at the model's params: relative difference (normwise for the
    gradient) <= GRAD_RTOL.

    ``reordered``: the same plain path with its row sums taken in other
    orders.  Where the bound's cancellation amplifies last-digit
    differences of the statistics past GRAD_RTOL, the plain path disagrees
    with itself by that much; the gradient limit is then that spread: the
    kernel path must lie no further from the plain path than the plain
    path's own reorderings do."""
    from repro_torch.core.flat import Flat

    v, g = step(f"{label}_value_and_grad_s", model._neg_vg)
    flat = Flat(model.params)
    x = flat.ravel(model.params)
    vp, gp = flat.value_and_grad(plain_neg, x)
    dv, dg = abs(v - vp) / abs(vp), rel_diff(g, gp)
    spread = max([rel_diff(flat.value_and_grad(neg, x)[1], gp)
                  for neg in reordered], default=0.0)
    limit = max(GRAD_RTOL, spread)
    report[f"{label}_value_rel_diff"] = dv
    report[f"{label}_grad_rel_diff"] = dg
    if reordered:
        report[f"{label}_plain_reordered_grad_rel_diff"] = spread
    if not (dv <= GRAD_RTOL and dg <= limit):
        raise AssertionError(f"{label}: value {dv:.3e} / gradient {dg:.3e} "
                             f"relative difference to the plain f64 path "
                             f"above {GRAD_RTOL} / {limit:.3e}")


def check_fit(label, model, iters, step, report, **kw):
    """``fit(max_iters=iters)`` must not lower the bound."""
    b0 = model.log_bound()
    res = step(f"{label}_fit_{iters}_iters_s",
               lambda: model.fit(max_iters=iters, **kw))
    b1 = model.log_bound()
    report[f"{label}_fit"] = {"bound_before": b0, "bound_after": b1,
                              "iters": res.n_iters, "evals": res.n_evals}
    if not (math.isfinite(b1) and b1 >= b0):
        raise AssertionError(f"{label}: fit moved the bound {b0} -> {b1}")


# -- phase 3a: SGPR training and serving at sgpr-synth-1m ---------------------

def plain_sgpr_neg(model):
    """The SGPR's negative bound through the plain f64 path on the card:
    the plain reg_stats over checkpointed row chunks (the graph of one
    chunk alive at a time), then the bound."""
    from torch.utils.checkpoint import checkpoint

    from repro_torch.core import bound as bound_mod
    from repro_torch.core import stats as stats_mod
    from repro_torch.kernels.reg_stats import ref as rs_ref

    x, y = model.x, model.y
    w = torch.ones(x.shape[0], dtype=x.dtype, device=x.device)

    def neg(params):
        hyp, z = params["hyp"], params["z"]
        b = c = d_stat = 0.0
        for lo in range(0, x.shape[0], GRAD_ROWS):
            sl = slice(lo, lo + GRAD_ROWS)
            bb, cc, dd = checkpoint(rs_ref.reg_stats_ref, hyp["log_sf2"],
                                    hyp["log_ell"], z, x[sl], y[sl], w[sl],
                                    use_reentrant=False)
            b, c, d_stat = b + bb, c + cc, d_stat + dd
        st = stats_mod.Stats(A=(y * y).sum(), B=b, C=c, D=d_stat,
                             KL=torch.zeros((), dtype=x.dtype, device=x.device),
                             n=w.sum())
        return -bound_mod.collapsed_bound(hyp, z, st, y.shape[1],
                                          jitter=model.jitter)
    return neg

def plain_serving(hyp, z, x, y, queries):
    """The same path computed by the plain versions, in f64 on the card."""
    from repro_torch.core import bound as bound_mod
    from repro_torch.core import stats as stats_mod
    from repro_torch.kernels.predict import ref as p_ref
    from repro_torch.kernels.reg_stats import ref as rs_ref
    from repro_torch.serve import posterior

    w = torch.ones(x.shape[0], dtype=x.dtype, device=x.device)
    b, c, d_stat = plain_reg_stats(rs_ref, hyp, z, x, y, w)
    st = stats_mod.Stats(A=(y * y).sum(), B=b, C=c, D=d_stat,
                         KL=torch.zeros((), dtype=x.dtype, device=x.device),
                         n=w.sum())
    lb = float(bound_mod.collapsed_bound(hyp, z, st, y.shape[1]))
    state = posterior.extract_state(hyp, z, st, device=DEV)
    noise = torch.exp(-hyp["log_beta"])
    preds = []
    for xq in queries:
        mean, quad = p_ref.predict_ref(hyp["log_sf2"], hyp["log_ell"], z,
                                       state.a_mean, state.g, xq)
        preds.append((mean, torch.exp(hyp["log_sf2"]) - quad + noise))
    return lb, preds


def rmse(a, b) -> float:
    return float(torch.sqrt(torch.mean((a.double() - b.double()) ** 2)))


def sgpr_inputs(n, q, d, m):
    """The SGPR's data, Z (k-means on the first 8,192 rows) and
    hyper-parameters (``default_hyp_for``), from SEED."""
    from repro_torch.core import covariance, init_utils

    x, y = make_regression(np.random.default_rng(SEED), n, q, d)
    z = init_utils.kmeans(x[:8192], m, iters=5, seed=SEED)
    return x, y, z, init_utils.default_hyp_for(covariance.SE_ARD, y, q)


def serving_path(rt, cfg) -> dict:
    from repro_torch.kernels.predict import ops as p_ops
    from repro_torch.kernels.psi_stats import ops as ps_ops
    from repro_torch.kernels.reg_stats import ops as rs_ops

    t0 = time.perf_counter()
    x, y, z, hyp = sgpr_inputs(cfg.n, cfg.q, cfg.d, cfg.m)
    qrng = np.random.default_rng(SEED + 1)
    sizes = (1, 1_000, 65_536)
    queries = [qrng.uniform(-2.0, 2.0, (t, cfg.q)) for t in sizes]
    x_full = qrng.uniform(-2.0, 2.0, (256, cfg.q))
    steps = {"host_data_s": time.perf_counter() - t0}
    step = timed_step(steps)
    report = {}

    # Every launch counter to 0 just before the path, read just after.
    reset_counts(rs_ops.LAUNCHES, p_ops.LAUNCHES, ps_ops.LAUNCHES)
    model = step("sgpr_init_s", lambda: rt.SGPR(x, y, hyp=hyp, z=z,
                                                device=DEV))
    check_value_and_grad("sgpr", model, plain_sgpr_neg(model), step, report)
    check_fit("sgpr", model, SGPR_FIT_ITERS, step, report)
    lb = step("log_bound_s", model.log_bound)
    state = step("predictive_state_s", model.predictive_state)
    with tempfile.TemporaryDirectory() as tmp:
        step("save_state_s", lambda: rt.save_state(pathlib.Path(tmp) / "st",
                                                   state))
        loaded, _ = step("load_state_s",
                         lambda: rt.load_state(pathlib.Path(tmp) / "st",
                                               device=DEV))
    eng = rt.PredictEngine(loaded, block_size=256, device=DEV)
    answers = [step(f"predict_t{t}_s",
                    lambda xq=xq: eng.predict(xq, include_noise=True))
               for t, xq in zip(sizes, queries)]
    full_mean, full_cov = step(
        "predict_full_cov_t256_s",
        lambda: eng.predict_full_cov(x_full, include_noise=True))
    # The same state served at f32 width (the f32 instantiation).
    eng32 = rt.PredictEngine(loaded, block_size=256, device=DEV,
                           compute_dtype=torch.float32)
    ans32 = step("predict_f32_t65536_s",
                 lambda: eng32.predict(queries[-1], include_noise=True))
    launches = {"reg_stats_f64": rs_ops.LAUNCHES["float64"],
                "predict_f64": p_ops.LAUNCHES["float64"],
                "predict_f32": p_ops.LAUNCHES["float32"]}
    print(f"sgpr path steps (s): {json.dumps(steps)}", flush=True)
    print(f"sgpr path launches: {json.dumps(launches)} (reg_stats_f32: "
          f"{rs_ops.LAUNCHES['float32']}, not on the path)", flush=True)
    for name, count in launches.items():
        if count < 1:
            raise AssertionError(f"kernel {name} was not launched on the main path")

    # -- check against the plain f64 path -------------------------------------
    f64 = torch.float64
    plain_lb, plain = plain_serving(
        model.params["hyp"], model.params["z"], model.x, model.y,
        [torch.from_numpy(q).to(DEV, f64)
         for q in list(queries) + [x_full, queries[-1]]])
    ystd = float(np.std(y))
    sf2 = float(torch.exp(model.params["hyp"]["log_sf2"]))
    report.update({"log_bound": lb, "plain_log_bound": plain_lb,
                   "log_bound_rel_diff": abs(lb - plain_lb) / abs(plain_lb)})
    if not math.isfinite(lb):
        raise AssertionError(f"log_bound is not finite: {lb}")
    served = list(answers) + [(full_mean, torch.diagonal(full_cov)), ans32]
    labels = [f"t{t}" for t in sizes] + ["full_cov_t256", "f32_engine_t65536"]
    for label, (mean, var), (pm, pv) in zip(labels, served, plain):
        n_rows = pm.shape[0]
        if mean.shape != (n_rows, cfg.d) or var.shape != (n_rows,) \
                or not bool(torch.isfinite(mean).all()) \
                or not bool(torch.isfinite(var).all()):
            raise AssertionError(f"request {label}: bad output shapes/values")
        mr, vr = rmse(mean, pm) / ystd, rmse(var, pv) / sf2
        report[label] = {"mean_rmse_over_std_y": mr, "var_rmse_over_sf2": vr}
        if mr > MEAN_BUDGET or vr > VAR_BUDGET:
            raise AssertionError(f"request {label}: mean {mr:.3e} / var "
                                 f"{vr:.3e} outside the serving budgets")
    if not torch.allclose(full_cov, full_cov.T, rtol=0, atol=1e-9 * sf2):
        raise AssertionError("predict_full_cov is not symmetric")
    print(f"sgpr path vs plain f64: {json.dumps(report)}", flush=True)
    return launches


# -- phase 3b: the Bayesian GPLVM at gplvm-usps -------------------------------

def plain_latent_stats(hyp, z, y, mu, s, rows=None):
    """The latent map step through the plain versions in f64 on the card;
    psi2 over checkpointed chunks of ``rows`` rows (the graph of one chunk
    alive at a time) so its gradient fits at full width."""
    from torch.utils.checkpoint import checkpoint

    from repro_torch.core import stats as stats_mod
    from repro_torch.kernels.psi_stats import ref as ps_ref

    n, q = mu.shape
    m = z.shape[0]
    w = torch.ones(n, dtype=mu.dtype, device=mu.device)
    rows = rows or psi_rows(m, q)
    d_stat = 0.0
    for lo in range(0, n, rows):
        sl = slice(lo, lo + rows)
        d_stat = d_stat + checkpoint(ps_ref.psi2_ref, hyp["log_sf2"],
                                     hyp["log_ell"], z, mu[sl], s[sl], w[sl],
                                     use_reentrant=False)
    p1 = ps_ref.psi1_ref(hyp["log_sf2"], hyp["log_ell"], z, mu, s)
    return stats_mod.Stats(
        A=(y * y).sum(), B=torch.exp(hyp["log_sf2"]) * w.sum(), C=p1.T @ y,
        D=d_stat, KL=0.5 * (s + mu * mu - torch.log(s) - 1.0).sum(),
        n=w.sum())


def plain_gplvm_neg(model, rows=None):
    from repro_torch.core import bound as bound_mod

    def neg(params):
        st = plain_latent_stats(params["hyp"], params["z"], model.y,
                                params["mu"], torch.exp(params["log_s"]),
                                rows)
        return -bound_mod.collapsed_bound(params["hyp"], params["z"], st,
                                          model.d, jitter=model.jitter)
    return neg


def gplvm_path(rt, cfg) -> dict:
    from repro_torch.data import usps_like
    from repro_torch.kernels.predict import ops as p_ops
    from repro_torch.kernels.predict import ref as p_ref
    from repro_torch.kernels.psi_stats import ops as ps_ops
    from repro_torch.kernels.reg_stats import ops as rs_ops

    t0 = time.perf_counter()
    y, _ = usps_like(np.random.default_rng(SEED), cfg.n)
    steps = {"host_data_s": time.perf_counter() - t0}
    step = timed_step(steps)
    report = {}

    reset_counts(rs_ops.LAUNCHES, p_ops.LAUNCHES, ps_ops.LAUNCHES)
    model = step("gplvm_init_s", lambda: rt.BayesianGPLVM(
        y, q=cfg.q, num_inducing=cfg.m, device=DEV))
    rows = psi_rows(cfg.m, cfg.q)
    check_value_and_grad("gplvm", model, plain_gplvm_neg(model), step, report,
                         reordered=[plain_gplvm_neg(model, r) for r in
                                    (rows // 3 + 1, rows // 2 + 1,
                                     2 * rows + 1)])
    check_fit("gplvm", model, GPLVM_FIT_ITERS, step, report)
    state = step("gplvm_predictive_state_s", model.predictive_state)
    eng = rt.PredictEngine(state, block_size=256, device=DEV)
    mean, var = step(f"gplvm_predict_t{cfg.n}_s", lambda: eng.predict(
        model.params["mu"], include_noise=True))
    launches = {"psi2_f64": ps_ops.LAUNCHES["psi2_float64"],
                "psi1_f64": ps_ops.LAUNCHES["psi1_float64"],
                "predict_f64": p_ops.LAUNCHES["float64"]}
    print(f"gplvm path steps (s): {json.dumps(steps)}", flush=True)
    print(f"gplvm path launches: {json.dumps(launches)}", flush=True)
    for name, count in launches.items():
        if count < 1:
            raise AssertionError(f"kernel {name} was not launched on the GPLVM path")

    # -- the served latents against the plain f64 path ------------------------
    p = model.params
    with torch.no_grad():
        st = plain_latent_stats(p["hyp"], p["z"], model.y, p["mu"],
                                torch.exp(p["log_s"]))
        pstate = rt.extract_state(p["hyp"], p["z"], st, jitter=model.jitter,
                                  device=DEV)
        pm, pq = p_ref.predict_ref(p["hyp"]["log_sf2"], p["hyp"]["log_ell"],
                                   p["z"], pstate.a_mean, pstate.g, p["mu"])
    sf2 = torch.exp(p["hyp"]["log_sf2"])
    pv = sf2 - pq + torch.exp(-p["hyp"]["log_beta"])
    if mean.shape != (cfg.n, cfg.d) or var.shape != (cfg.n,) \
            or not bool(torch.isfinite(mean).all()) \
            or not bool(torch.isfinite(var).all()):
        raise AssertionError("gplvm served latents: bad output shapes/values")
    mr, vr = rmse(mean, pm) / float(np.std(y)), rmse(var, pv) / float(sf2)
    report["served_latents"] = {"mean_rmse_over_std_y": mr,
                                "var_rmse_over_sf2": vr}
    if mr > MEAN_BUDGET or vr > VAR_BUDGET:
        raise AssertionError(f"gplvm served latents: mean {mr:.3e} / var "
                             f"{vr:.3e} outside the serving budgets")
    print(f"gplvm path vs plain f64: {json.dumps(report)}", flush=True)
    return launches


# -- phase 3d: the distributed Map-Reduce (core.distributed) ------------------

DIST_WORLD = 4          # ranks sharing the one card, over gloo
# (fmask, failure mode) of the four-rank run's checks
DIST_FMASKS = (((1.0, 1.0, 1.0, 1.0), "drop"), ((1.0, 0.0, 1.0, 1.0), "drop"),
               ((1.0, 0.0, 1.0, 1.0), "rescale"))
DIST_DEADLINE_S = 600   # for the spawned ranks, all together
DIST_GROUP_TIMEOUT_S = 120
STATE_RTOL = 1e-10      # predictive_state against the model's
# The GPLVM gradient's limit: the plain path's own spread at the
# gplvm-usps init (ROADMAP Queue 3 item 3).
GPLVM_GRAD_SPREAD = 3.42e-7
STATE_FIELDS = ("chol_kmm", "chol_sigma", "c2", "a_mean", "g")


def flat_step(vg, flat, data, w, fmask, n_full, record=None):
    """SCG's ``fg`` over a distributed SGPR step: the flat point -> (value,
    flat gradient); ``record(value, seconds)`` sees each evaluation."""
    def fg(xf):
        p = flat.unravel(xf)
        if w.is_cuda:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        v, (gh, gz) = vg(p["hyp"], p["z"], data["mu"], None, data["y"], w,
                         fmask() if callable(fmask) else fmask, n_full)
        g = flat.ravel({"hyp": gh, "z": gz})
        if record is not None:
            record(float(v), time.perf_counter() - t0)
        return float(v), g
    return fg


def masked_neg_vg(x, y, w, z, hyp, n_full, mode):
    """One process on the card: the negative bound and its flat gradient
    over all rows with per-row weights ``w``, under the failure mode's n
    handling (the reference of the four-rank run)."""
    from repro_torch.core import bound as bound_mod
    from repro_torch.core.flat import Flat
    from repro_torch.core.stats import Stats, partial_stats

    params = {"hyp": {k: t64(v) for k, v in hyp.items()}, "z": t64(z)}
    nf = t64(n_full)

    def neg(p):
        st = partial_stats(p["hyp"], p["z"], y, x, weights=w)
        if mode == "rescale":
            live = st.n / nf
            st = Stats(A=st.A / live, B=st.B / live, C=st.C / live,
                       D=st.D / live, KL=st.KL / live, n=nf)
        else:
            st = st._replace(n=nf)
        return -bound_mod.collapsed_bound(p["hyp"], p["z"], st, y.shape[1])
    flat = Flat(params)
    return flat.value_and_grad(neg, flat.ravel(params))


def dist_rank(rank, world, store_path, out_dir, shape, device):
    """One rank of phase 3d's gloo run (a spawned process): its n / world
    rows of the SGPR data, the value and gradient under each of
    DIST_FMASKS, then SGPR_FIT_ITERS SCG iterations under
    FailureSimulator(world, 0.01, seed=3); writes ``rank<k>.npz``."""
    import datetime

    sys.path.insert(0, str(ROOT / "src"))
    import torch.distributed as dist

    from repro_torch.core.flat import Flat
    from repro_torch.core.scg import scg
    from repro_torch.distributed import FailureSimulator
    from repro_torch.kernels.reg_stats import ops as rs_ops
    from repro_torch.launch import make_data_group
    from repro_torch.train.steps import make_gp_train_step

    torch.backends.cuda.matmul.allow_tf32 = False
    group = make_data_group(device, backend="gloo",
                            store=dist.FileStore(store_path, world),
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(
                                seconds=DIST_GROUP_TIMEOUT_S))
    n, q, d, m = shape
    x, y, z, hyp = sgpr_inputs(n, q, d, m)
    params = {"hyp": {k: t64(v, device) for k, v in hyp.items()},
              "z": t64(z, device)}
    flat = Flat(params)
    x0 = flat.ravel(params)
    reset_counts(rs_ops.LAUNCHES)
    out, data = {}, None
    for i, (fmask, mode) in enumerate(DIST_FMASKS):
        eng, vg = make_gp_train_step(group, d, failure_mode=mode,
                                     device=device)
        if data is None:
            data, w = eng.put_data(y=y, mu=x)
        v, g = flat_step(vg, flat, data, w, np.asarray(fmask), float(n))(x0)
        out[f"value{i}"], out[f"grad{i}"] = v, g
    sim = FailureSimulator(world, rate=0.01, seed=3)
    bounds, times, masks = [], [], []

    def draw():
        masks.append(sim.mask())
        return masks[-1]

    def record(v, sec):
        bounds.append(-v)
        times.append(sec)
    scg(flat_step(vg, flat, data, w, draw, float(n), record), x0,
        max_iters=SGPR_FIT_ITERS)
    np.savez(pathlib.Path(out_dir) / f"rank{rank}.npz", bounds=bounds,
             masks=np.array(masks), times=times,
             launches=rs_ops.LAUNCHES["float64"], **out)
    dist.destroy_process_group()


def spawn_ranks(world, shape, device) -> list[dict]:
    """Run ``dist_rank`` in ``world`` spawned processes; every one must exit
    0 before DIST_DEADLINE_S.  Returns their results; kills what is left
    running."""
    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory() as tmp:
        procs = [ctx.Process(target=dist_rank, args=(
            r, world, f"{tmp}/store", tmp, shape, device))
            for r in range(world)]
        t0 = time.perf_counter()
        try:
            for p in procs:
                p.start()
            for p in procs:
                p.join(max(0.0, DIST_DEADLINE_S - (time.perf_counter() - t0)))
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join()
        codes = [p.exitcode for p in procs]
        if codes != [0] * world:
            raise AssertionError(f"phase 3d: rank exit codes {codes} "
                                 f"after {time.perf_counter() - t0:.1f} s")
        return [dict(np.load(f"{tmp}/rank{r}.npz")) for r in range(world)]


def four_ranks(cfg, report) -> int:
    """DIST_WORLD gloo ranks on the one card, each holding n / DIST_WORLD
    rows of the SGPR data: value and gradient under each fmask against one
    process with the same masked weights, and bitwise-equal bounds on every
    rank through the SCG steps.  Returns the ranks' reg_stats launches."""
    from repro_torch.core.distributed import pad_and_shard
    from repro_torch.distributed import StepTimer

    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    res = spawn_ranks(DIST_WORLD, (cfg.n, cfg.q, cfg.d, cfg.m),
                      str(torch.device(DEV, 0)))
    report["four_ranks_wall_s"] = time.perf_counter() - t0
    for r, rr in enumerate(res[1:], 1):
        for k in res[0]:
            if k not in ("times", "launches") and \
                    rr[k].tobytes() != res[0][k].tobytes():
                raise AssertionError(f"phase 3d: rank {r}'s {k} differs "
                                     "from rank 0's")
    x, y, z, hyp = sgpr_inputs(cfg.n, cfg.q, cfg.d, cfg.m)
    padded, w = pad_and_shard({"y": y, "mu": x}, DIST_WORLD)
    xt, yt = t64(padded["mu"]), t64(padded["y"])
    rows = w.shape[0] // DIST_WORLD
    for i, (fmask, mode) in enumerate(DIST_FMASKS):
        wt = t64(w * np.repeat(fmask, rows))
        vp, gp = masked_neg_vg(xt, yt, wt, z, hyp, float(cfg.n), mode)
        dv = abs(float(res[0][f"value{i}"]) - vp) / abs(vp)
        dg = rel_diff(res[0][f"grad{i}"], gp)
        report[f"fmask{''.join(str(int(f)) for f in fmask)}_{mode}"] = {
            "value_rel_diff": dv, "grad_rel_diff": dg}
        if not (dv <= 1e-9 and dg <= GRAD_RTOL):
            raise AssertionError(f"phase 3d fmask {fmask} {mode}: value "
                                 f"{dv:.3e} / gradient {dg:.3e} against one "
                                 f"process, above 1e-9 / {GRAD_RTOL}")
    # A NaN is a wild SCG step whose Cholesky failed, on every rank at once.
    bounds = res[0]["bounds"]
    if not (len(bounds) > SGPR_FIT_ITERS and np.isfinite(bounds[0])):
        raise AssertionError(f"phase 3d SCG bounds {bounds}")
    report["scg_under_failures"] = {
        "bounds": bounds.tolist(), "evals": len(bounds),
        "masks_with_a_failure": int((res[0]["masks"] < 1).any(1).sum()),
        "bitwise_equal_on_every_rank": True}
    timer = StepTimer()
    for i in range(len(bounds)):
        timer.record([float(rr["times"][i]) for rr in res])
    print(f"distributed path (3d) StepTimer over the {DIST_WORLD} ranks' "
          f"steps (s): {json.dumps(timer.summary())} -- the {DIST_WORLD} "
          "ranks share one card, so this is not the paper's Fig. 5 load "
          "balance", flush=True)
    return int(sum(int(rr["launches"]) for rr in res))


def distributed_path(rt, cfg, usps) -> dict:
    """Phase 3d: ``DistributedGP`` through ``make_gp_train_step`` in a world
    of one over NCCL at ``cfg`` (value and gradient against
    ``SGPR._neg_vg``, a 3-iteration SCG fit, ``predictive_state`` against
    the model's), the latent map at ``usps`` against
    ``BayesianGPLVM._neg_vg``, then DIST_WORLD ranks over gloo on the card
    (``four_ranks``)."""
    import torch.distributed as dist

    from repro_torch.core.flat import Flat
    from repro_torch.core.scg import scg
    from repro_torch.data import usps_like
    from repro_torch.kernels.predict import ops as p_ops
    from repro_torch.kernels.psi_stats import ops as ps_ops
    from repro_torch.kernels.reg_stats import ops as rs_ops
    from repro_torch.launch import make_data_group
    from repro_torch.train.steps import make_gp_train_step

    x, y, z, hyp = sgpr_inputs(cfg.n, cfg.q, cfg.d, cfg.m)
    yl, _ = usps_like(np.random.default_rng(SEED), usps.n)
    steps, report = {}, {}
    step = timed_step(steps)
    ones = np.ones(1)

    def counts():
        return {"reg_stats_f64": rs_ops.LAUNCHES["float64"],
                "psi2_f64": ps_ops.LAUNCHES["psi2_float64"],
                "psi1_f64": ps_ops.LAUNCHES["psi1_float64"]}

    # Only the engine's calls count: the references (SGPR, BayesianGPLVM)
    # launch the same kernels in between.
    launches = {k: 0 for k in counts()}
    last = {}

    def engine(fn):
        """``fn``, with the launches it makes added to ``launches``."""
        def run(*args):
            before = counts()
            out = fn(*args)
            last.clear()
            for k, c in counts().items():
                last[k] = c - before[k]
                launches[k] += last[k]
            return out
        return run

    reset_counts(rs_ops.LAUNCHES, p_ops.LAUNCHES, ps_ops.LAUNCHES)
    group = make_data_group(DEV)
    try:
        report["backend"] = dist.get_backend(group)
        eng, vg = make_gp_train_step(group, cfg.d, device=DEV)
        data, w = eng.put_data(y=y, mu=x)
        params = {"hyp": {k: t64(v) for k, v in hyp.items()}, "z": t64(z)}
        flat = Flat(params)
        x0 = flat.ravel(params)
        fg = engine(flat_step(vg, flat, data, w, ones, float(cfg.n)))
        fg(x0)                                       # first call: set-up
        v, g = step("dist_value_and_grad_s", lambda: fg(x0))
        report["reg_stats_launches_per_evaluation"] = last["reg_stats_f64"]
        if last["reg_stats_f64"] != 1:
            raise AssertionError(f"phase 3d: {last['reg_stats_f64']} "
                                 "reg_stats launches in one evaluation, not 1")
        model = rt.SGPR(x, y, hyp=hyp, z=z, device=DEV)
        model._neg_vg()
        vr, gr = step("sgpr_neg_vg_s", model._neg_vg)
        report["sgpr_value_rel_diff"] = dv = abs(v - vr) / abs(vr)
        report["sgpr_grad_rel_diff"] = dg = rel_diff(g, gr)
        if not (dv <= 1e-9 and dg <= GRAD_RTOL):
            raise AssertionError(f"phase 3d: value {dv:.3e} / gradient "
                                 f"{dg:.3e} against SGPR._neg_vg")
        res = step(f"dist_scg_{SGPR_FIT_ITERS}_iters_s",
                   lambda: scg(fg, x0, max_iters=SGPR_FIT_ITERS))
        report["scg"] = {"bound_before": -v, "bound_after": -res.f,
                         "evals": res.n_evals}
        if not (math.isfinite(res.f) and res.f < v):
            raise AssertionError(f"phase 3d: SCG moved the bound {-v} -> "
                                 f"{-res.f}")
        ps = step("dist_predictive_state_s", lambda: engine(
            eng.predictive_state)(params["hyp"], params["z"], data["y"],
                                  data["mu"], None, w))
        ms = model.predictive_state()
        for f in STATE_FIELDS:
            diff = rel_diff(getattr(ps, f).cpu(), getattr(ms, f).cpu())
            report[f"state_{f}_rel_diff"] = diff
            if not diff <= STATE_RTOL:
                raise AssertionError(f"phase 3d: predictive_state.{f} "
                                     f"{diff:.3e} from the model's")
        buf = torch.zeros(cfg.m * cfg.m + cfg.m * cfg.d + 4,
                          dtype=torch.float64, device=DEV)
        report["all_reduce"] = {"bytes": buf.numel() * 8,
                                "ms": time_ms(lambda: dist.all_reduce(buf))}
        report["world_of_one_launches"] = dict(launches)

        # -- the latent map at gplvm-usps ---------------------------------------
        gm = rt.BayesianGPLVM(yl, q=usps.q, num_inducing=usps.m, device=DEV)
        p = gm.params
        leng, lvg = make_gp_train_step(group, usps.d, latent=True,
                                       argnums=(0, 1, 2, 3), device=DEV)
        ldata, lw = leng.put_data(y=yl, mu=p["mu"].cpu().numpy(),
                                  s=torch.exp(p["log_s"]).cpu().numpy())
        lv, (gh, gz, gmu, gs) = step("dist_gplvm_value_and_grad_s", lambda:
                                     engine(lvg)(p["hyp"], p["z"],
                                                 ldata["mu"], ldata["s"],
                                                 ldata["y"], lw, ones,
                                                 float(usps.n)))
        report["psi_launches_per_evaluation"] = {
            k: last[k] for k in ("psi2_f64", "psi1_f64")}
        if min(last["psi2_f64"], last["psi1_f64"]) < 1:
            raise AssertionError("phase 3d latent: psi launches "
                                 f"{report['psi_launches_per_evaluation']}")
        gm._neg_vg()
        lvr, lgr = step("gplvm_neg_vg_s", gm._neg_vg)
        lg = Flat(p).ravel({"hyp": gh, "z": gz, "mu": gmu,
                            "log_s": gs * ldata["s"]})
        report["gplvm_value_rel_diff"] = dv = abs(float(lv) - lvr) / abs(lvr)
        report["gplvm_grad_rel_diff"] = dg = rel_diff(lg, lgr)
        if not (dv <= 1e-9 and dg <= GPLVM_GRAD_SPREAD):
            raise AssertionError(f"phase 3d latent: value {dv:.3e} / "
                                 f"gradient {dg:.3e} against "
                                 "BayesianGPLVM._neg_vg")
    finally:
        dist.destroy_process_group()
    print(f"distributed path (3d) steps (s): {json.dumps(steps)}", flush=True)
    print(f"distributed path (3d) world of one ({report['backend']}): "
          f"{json.dumps(report)}", flush=True)
    del model, gm, eng, leng, data, ldata
    ranks = {}
    rank_launches = four_ranks(cfg, ranks)
    ranks["reg_stats_launches"] = rank_launches
    launches["reg_stats_f64"] += rank_launches
    print(f"distributed path (3d) {DIST_WORLD} gloo ranks on one card: "
          f"{json.dumps(ranks)}", flush=True)
    print(f"distributed path (3d) launches: {json.dumps(launches)}",
          flush=True)
    for name, count in launches.items():
        if count < 1:
            raise AssertionError(f"kernel {name} was not launched on the "
                                 "distributed path")
    return launches


# -- phase 2: flash attention --------------------------------------------------

def visible_pairs(b, h, t, s, causal) -> int:
    """(query, key) pairs the mask lets through: row r sees keys
    <= r + (S - T) when causal."""
    if not causal:
        return b * h * t * s
    seen = np.clip(np.arange(t) + (s - t) + 1, 0, s)
    return b * h * int(seen.sum())


def flash_bound(pairs, b, h, hkv, t, s, dh, dtype, peaks) -> tuple[float, str]:
    """Least time: 4 Dh flops per visible pair at the type's peak (bf16 on
    the tensor cores, f32 on the CUDA cores), one exp per pair at its
    ``EXP_COST``, or the bytes of q, k, v and o once each."""
    item = 2 if dtype == torch.bfloat16 else 4
    peak = peaks[3] if dtype == torch.bfloat16 else peaks[0]
    t_ops = max(4 * dh * pairs / peak,
                pairs * EXP_COST[torch.float32] / peaks[0])
    t_bytes = item * (2 * b * h * t * dh + 2 * b * hkv * s * dh) / peaks[2]
    return 1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def plain_attention(fa_ref, q, k, v, causal=True):
    """The plain version over query-row chunks of ``FA_PLAIN_ELEMS`` scores
    (its (B, H, T, S) scores would not fit at T = S = 8192 in f64)."""
    b, h, _, _ = q.shape
    chunk = max(1, FA_PLAIN_ELEMS // (b * h * k.shape[2]))
    return fa_ref.attention_ref(q, k, v, causal=causal, chunk=chunk)


def library_attention(q, k, v):
    """``scaled_dot_product_attention`` on the same inputs (its is_causal
    aligns as the kernel does at T = S): GQA through ``enable_gqa``, or,
    where this torch lacks it, K/V expanded once outside the timed call."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    try:
        sdpa(q, k, v, is_causal=True, enable_gqa=True)
        return lambda: sdpa(q, k, v, is_causal=True, enable_gqa=True)
    except TypeError:
        g = q.shape[1] // k.shape[1]
        ke, ve = (x.repeat_interleave(g, dim=1) for x in (k, v))
        return lambda: sdpa(q, ke, ve, is_causal=True)


def flash_launch_only(q, k, v, causal):
    """The bare ctypes launch on a preallocated output: the kernel's device
    time without the wrapper's checks and allocation (``ms`` has them)."""
    from repro_torch.kernels.flash_attention import kernel as fa_k

    out = torch.empty_like(q)
    scale = q.shape[-1] ** -0.5
    return lambda: fa_k.flash_attention(q, k, v, out, causal, scale)


def check_flash(fa_ops, fa_ref, peaks, b, h, hkv, t, s, dh, causal, dtype,
                timed):
    rng = np.random.default_rng(SEED + b + h + t + s)
    q, k, v = (torch.from_numpy(rng.standard_normal(sh)).to(DEV, dtype)
               for sh in ((b, h, t, dh), (b, hkv, s, dh), (b, hkv, s, dh)))
    got = fa_ops.flash_attention(q, k, v, causal=causal)
    plain = plain_attention(fa_ref, q.double(), k.double(), v.double(),
                            causal)
    torch.cuda.synchronize()
    if got.shape != (b, h, t, dh) or got.dtype != dtype \
            or not bool(torch.isfinite(got).all()):
        raise AssertionError(f"flash_attention: bad output {tuple(got.shape)} "
                             f"{got.dtype}")
    err = (got.double() - plain).abs()
    worst = float((err / (FA_TOL[dtype] * (1 + plain.abs()))).max())
    if worst > 1.0:
        raise AssertionError(f"flash_attention {(b, h, hkv, t, s, dh)} "
                             f"{dtype}: max |err|/tol = {worst:.3e}")
    if causal and t > s and not bool((got[:, :, :t - s] == 0).all()):
        raise AssertionError("flash_attention: rows without context not 0")
    out = {"shape": dict(b=b, h=h, hkv=hkv, t=t, s=s, dh=dh, causal=causal),
           "dtype": str(dtype), "max_abs_err": float(err.max()),
           "max_err_over_tol": worst}
    if timed:
        pairs = visible_pairs(b, h, t, s, causal)
        out["ms"] = time_ms(lambda: fa_ops.flash_attention(q, k, v,
                                                           causal=causal))
        out["launch_only_ms"] = time_ms(flash_launch_only(q, k, v, causal))
        out["plain_ms"] = time_ms(
            lambda: plain_attention(fa_ref, q, k, v, causal), reps=3)
        lib = library_attention(q, k, v)
        out["library_ms"] = time_ms(lib)
        out["library_max_abs_err"] = float((lib().double() - plain).abs().max())
        out["visible_pairs"] = pairs
        out["bound_ms"], out["bound_by"] = flash_bound(
            pairs, b, h, hkv, t, s, dh, dtype, peaks)
    print(f"flash_attention {out}", flush=True)
    return out


# -- phase 3c: llama3.2-1b prefill and decode ----------------------------------

def grown_caches(tf, cfg, caches, batch, size):
    """Prefill caches (layers, B, T, ...) copied into slots 0..T-1 of empty
    caches with room for ``size`` positions: decoding straight into the
    prefill's T-long caches would overwrite token T-1 (ROADMAP Queue 3)."""
    grown = tf.init_decode_cache(cfg, batch, size, device=DEV)
    for g, c in caches.items():
        for name, a in c.items():
            grown[g][name][:, :, :a.shape[2]] = a
    return grown


def rel_rms(got, want) -> float:
    return float(torch.linalg.norm(got.double() - want.double())
                 / torch.linalg.norm(want.double()))


def lm_path(fa_ops, fa_ref) -> dict:
    import dataclasses
    from unittest import mock

    from repro_torch.configs import get_config
    from repro_torch.models import transformer as tf
    from repro_torch.train import steps as lm_steps

    cfg = get_config("llama3.2-1b")
    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    b, t, n_new = LM_BATCH, LM_PROMPT, LM_NEW
    tokens = torch.from_numpy(np.random.default_rng(SEED).integers(
        0, cfg.vocab_size, (b, t))).to(DEV)
    batch = {"tokens": tokens}
    steps = {}
    step = timed_step(steps)
    prefill, serve = lm_steps.make_prefill_step(cfg), lm_steps.make_serve_step(cfg)
    prefill32 = lm_steps.make_prefill_step(cfg32)
    counts = fa_ops.LAUNCHES

    def launched(name, fn, want):
        before = counts["bfloat16"] + counts["float32"]
        out = step(name, fn)
        got = counts["bfloat16"] + counts["float32"] - before
        if got != want:
            raise AssertionError(f"{name}: flash_attention launched {got} "
                                 f"times, expected {want}")
        return out

    # Every launch counter to 0 just before the path, read just after.
    t0 = time.perf_counter()
    reset_counts(counts)
    gen = torch.Generator(device=DEV).manual_seed(SEED)
    params = step("init_params_s", lambda: tf.init_params(cfg, gen, device=DEV))
    launched("prefill_cold_s", lambda: prefill(params, batch), cfg.num_layers)
    logits, caches = launched("prefill_s", lambda: prefill(params, batch),
                              cfg.num_layers)
    caches = step("grow_cache_s", lambda: grown_caches(tf, cfg, caches, b,
                                                       t + n_new))
    tok = logits.argmax(-1, keepdim=True)
    for i in range(n_new):
        pos = torch.full((b,), t + i, dtype=torch.int32, device=DEV)
        step_logits, caches = launched(
            f"decode_{i}_s", lambda: serve(params, caches, tok, pos), 0)
        if not bool(torch.isfinite(step_logits).all()):
            raise AssertionError(f"decode step {i}: logits not finite")
        tok = step_logits.argmax(-1, keepdim=True)
    logits32, _ = launched("prefill_f32_compute_s",
                           lambda: prefill32(params, batch), cfg.num_layers)
    steps["path_s"] = time.perf_counter() - t0
    launches = {"flash_attention_bf16": counts["bfloat16"],
                "flash_attention_f32": counts["float32"]}
    print(f"llama3.2-1b path steps (s): {json.dumps(steps)}", flush=True)
    print(f"llama3.2-1b path launches: {json.dumps(launches)}", flush=True)

    # -- checks ---------------------------------------------------------------
    report = {}
    for label, lg in (("bfloat16", logits), ("float32", logits32)):
        if lg.shape != (b, cfg.vocab_size) or not bool(torch.isfinite(lg).all()):
            raise AssertionError(f"prefill logits ({label}): bad shape/values")

    def plain(q, k, v, causal=True):
        return plain_attention(fa_ref, q, k, v, causal)

    with mock.patch.object(fa_ops, "flash_attention", plain):
        plain_logits = {"bfloat16": prefill(params, batch)[0],
                        "float32": prefill32(params, batch)[0]}
    for (label, c, lg) in (("bfloat16", cfg, logits),
                           ("float32", cfg32, logits32)):
        report[f"{label}_vs_plain_attention"] = rel_rms(lg, plain_logits[label])
        # teacher-forced decode: prefill T-1 tokens, decode token T-1
        _, c_short = lm_steps.make_prefill_step(c)(
            params, {"tokens": tokens[:, :-1]})
        grown = grown_caches(tf, c, c_short, b, t)
        forced, _ = lm_steps.make_serve_step(c)(
            params, grown, tokens[:, -1:],
            torch.full((b,), t - 1, dtype=torch.int32, device=DEV))
        report[f"{label}_teacher_forced_vs_prefill"] = rel_rms(forced, lg)
        for key in (f"{label}_vs_plain_attention",
                    f"{label}_teacher_forced_vs_prefill"):
            if not report[key] <= LOGIT_RTOL[label]:
                raise AssertionError(f"llama3.2-1b {key}: relative RMS "
                                     f"{report[key]:.3e} > {LOGIT_RTOL[label]}")
    print(f"llama3.2-1b logits (relative RMS): {json.dumps(report)}",
          flush=True)
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke: run from a checkout (src/repro_torch missing)",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import repro_torch as rt
    from repro_torch.configs import GP_CONFIGS
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention import ref as fa_ref
    from repro_torch.kernels.predict import ops as p_ops
    from repro_torch.kernels.predict import ref as p_ref
    from repro_torch.kernels.psi_stats import ops as ps_ops
    from repro_torch.kernels.psi_stats import ref as ps_ref
    from repro_torch.kernels.reg_stats import ops as rs_ops
    from repro_torch.kernels.reg_stats import ref as rs_ref

    # The plain versions' matmuls in full f32/f64, never TF32.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; "
          "allow_tf32 = False", flush=True)

    # -- phase 1: build ---------------------------------------------------------
    t0 = time.perf_counter()
    logs = _build.build_all()
    print(f"built {sorted(logs)} in {time.perf_counter() - t0:.1f} s", flush=True)
    for name, log in logs.items():
        for line in log.splitlines():
            if any(k in line for k in ("entry function", "registers",
                                       "spill")):
                print(f"  {name}: {line.strip()}", flush=True)
    smi = nvidia_smi()
    print(smi, flush=True)
    name = torch.cuda.get_device_name(0)
    peaks = card_peaks(name)

    # -- phase 2: each kernel against its plain version ------------------------
    cfg = GP_CONFIGS["sgpr-synth-1m"]
    rs_full, pr_full = {}, {}
    for dtype in (torch.float32, torch.float64):
        rs_full[dtype] = check_reg_stats(rs_ops, rs_ref, peaks, cfg.n, cfg.m,
                                         cfg.q, cfg.d, dtype, masked=False,
                                         timed=True)
        check_reg_stats(rs_ops, rs_ref, peaks, 1_000_003, 130, 3, 5, dtype,
                        masked=True, timed=False)
    # Past one 16-feature chunk, and a wide y: shared memory is fixed.
    for q, d in ((40, 1), (8, 64)):
        check_reg_stats(rs_ops, rs_ref, peaks, 100_003, 130, q, d,
                        torch.float64, masked=True, timed=False)
    # Past the old gridDim.y limit (66,066 upper 64-tiles), and more
    # (slice, tile) units than SMs in f64 (136, one block each).
    check_reg_stats(rs_ops, rs_ref, peaks, 1_003, 23_200, 3, 2,
                    torch.float32, masked=True, timed=False)
    check_reg_stats(rs_ops, rs_ref, peaks, 20_011, 2_048, 8, 4,
                    torch.float64, masked=True, timed=False)
    torch.cuda.empty_cache()
    print("cublas f64 K^T (w K), 65,536 x 512 scaled to n = 1e6 (yardstick "
          f"of the DMMA loop, not called by the port): "
          f"{cublas_d_product_ms(cfg.n, cfg.m):.4f} ms", flush=True)
    for dtype in (torch.float32, torch.float64):
        pr_full[dtype] = check_predict(p_ops, p_ref, peaks, 65_536,
                                       cfg.m, cfg.q, cfg.d, dtype, timed=True)
        check_predict(p_ops, p_ref, peaks, 1_000, 130, 3, 5, dtype,
                      timed=False)
        # m past a (t, m) slab per block: the pair tiles of g stream.
        check_predict(p_ops, p_ref, peaks, 4_096, 2_048, 8, 4, dtype,
                      timed=False)
    print("cublas f64 K g, 65,536 x 512 by 512 x 512 (yardstick of the "
          "predict kernel's DMMA loop, not called by the port): "
          f"{cublas_quad_product_ms(65_536, cfg.m):.4f} ms", flush=True)
    print("cublas f32 K g, 65,536 x 512 by 512 x 512, TF32 off (yardstick of "
          "the f32 predict kernel's FMA loop, not called by the port): "
          f"{cublas_quad_product_ms(65_536, cfg.m, torch.float32):.4f} ms",
          flush=True)
    usps, synth = GP_CONFIGS["gplvm-usps"], GP_CONFIGS["gplvm-synth-100k"]
    psi_full = {}
    for dtype in (torch.float32, torch.float64):
        psi_full[dtype] = check_psi(ps_ops, ps_ref, peaks, usps.n, usps.m,
                                    usps.q, dtype, masked=False, timed=True)
        check_psi(ps_ops, ps_ref, peaks, synth.n, synth.m, synth.q, dtype,
                  masked=False, timed=True)
        check_psi(ps_ops, ps_ref, peaks, 1003, 37, 3, dtype, masked=True,
                  timed=False)
    # Ten 16-feature chunks: shared memory is fixed.
    check_psi(ps_ops, ps_ref, peaks, 1003, 37, 160, torch.float64,
              masked=True, timed=False)
    # psi2's packed patches at the tile edges, and its centred exponent
    # where its terms are largest against their sum.
    for m in (63, 65, 151):
        check_psi(ps_ops, ps_ref, peaks, 1003, m, 10, torch.float64,
                  masked=True, timed=False)
    check_psi2_midway(ps_ops, ps_ref, 1003, 150, 10)
    time_backwards(rs_ops, ps_ops, cfg, usps)
    fa_full = {}
    for dtype in (torch.bfloat16, torch.float32):
        fa_full[dtype] = check_flash(fa_ops, fa_ref, peaks, LM_BATCH, 32, 8,
                                     LM_PROMPT, LM_PROMPT, 64, True, dtype,
                                     timed=True)
        for shape in ((1, 32, 8, 8192, 8192, 64, True),
                      (2, 4, 2, 64, 64, 64, True), (1, 8, 1, 70, 70, 64, True),
                      (1, 4, 4, 33, 90, 128, True),
                      (2, 2, 2, 96, 48, 64, False),
                      (1, 4, 2, 64, 64, 64, True), (1, 4, 4, 1, 57, 64, True),
                      (1, 2, 1, 96, 48, 64, True)):
            check_flash(fa_ops, fa_ref, peaks, *shape, dtype, timed=False)

    # -- phase 3: the main paths ------------------------------------------------
    sgpr_launches = serving_path(rt, cfg)
    dist_launches = distributed_path(rt, cfg, usps)
    gplvm_launches = gplvm_path(rt, usps)
    lm_launches = lm_path(fa_ops, fa_ref)
    launches = {**sgpr_launches, **gplvm_launches, **lm_launches,
                "predict_f64": sgpr_launches["predict_f64"]
                + gplvm_launches["predict_f64"]}
    for kname, count in dist_launches.items():
        launches[kname] += count

    def entry(kname, source, replaces, res):
        return {"name": kname, "route": "cuda", "source": source,
                "replaces": replaces, "launches": launches[kname],
                "max_abs_err": res["max_abs_err"], "ms": res["ms"],
                "plain_ms": res["plain_ms"], "bound_ms": res["bound_ms"],
                "bound_by": res["bound_by"],
                "library_ms": res.get("library_ms")}

    # The kernels the main paths run (reg_stats_f32 and the psi kernels' f32
    # instantiations are checked above but serve only f32 callers; the f64
    # models never reach them).  Times at the main paths' shapes.
    kernels = [
        entry("reg_stats_f64", "src/repro_torch/csrc/reg_stats.cu",
              "src/repro/kernels/reg_stats/kernel.py:99",
              rs_full[torch.float64]),
        entry("predict_f32", "src/repro_torch/csrc/predict.cu",
              "src/repro/kernels/predict/kernel.py:75", pr_full[torch.float32]),
        entry("predict_f64", "src/repro_torch/csrc/predict.cu",
              "src/repro/kernels/predict/kernel.py:75", pr_full[torch.float64]),
        entry("psi2_f64", "src/repro_torch/csrc/psi_stats.cu",
              "src/repro/kernels/psi_stats/kernel.py:76",
              psi_full[torch.float64]["psi2"]),
        entry("psi1_f64", "src/repro_torch/csrc/psi_stats.cu",
              "src/repro/kernels/psi_stats/kernel.py:125",
              psi_full[torch.float64]["psi1"]),
        entry("flash_attention_bf16", "src/repro_torch/csrc/flash_attention.cu",
              "src/repro/kernels/flash_attention/kernel.py:80",
              fa_full[torch.bfloat16]),
        entry("flash_attention_f32", "src/repro_torch/csrc/flash_attention.cu",
              "src/repro/kernels/flash_attention/kernel.py:80",
              fa_full[torch.float32]),
    ]
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
