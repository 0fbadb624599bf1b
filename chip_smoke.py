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
   and ``gplvm-synth-100k`` shapes, psi2's per-launch split from
   ``torch.profiler``; reg_stats' and the psi kernels' bare launch and
   device time; reg_stats at q = 40 and at d = 64, predict at m = 2048 and
   psi at q = 160, past one 16-feature chunk or one block's slab, and
   reg_stats at m = 2,048 (more units than SMs), in both dtypes, and the
   f64 reg_stats at phase 3e's blocks (n 2,048, m 64), timed; f32
   reg_stats at m = 127, 129 and 257 (the 128-tile edge) and at m = 46,400
   (past the old gridDim.y limit, its D held 2,048 rows at a time), checked
   untimed; psi2 and psi1 at m = 63, 65 and 151 (psi2's patch and tile
   edges) and psi2 where its centred exponent's terms are largest against
   their sum, D exactly symmetric and bitwise the same on a second run; the
   backward kernels of reg_stats and psi2, both dtypes, against the
   chunked recompute at sgpr-synth-1m, gplvm-usps and gplvm-synth-100k
   (f64 normwise 1e-8 per input, f32 at its tier over the closed form on
   absolute values; bitwise on a second call) and at ragged shapes with
   every input's gradient, each timed beside the recompute; psi1's
   backward kernel likewise at gplvm-usps, gplvm-synth-100k (both timed:
   the operator, the bare launch, the device time and its launches'
   split) and ragged shapes (m past 256, q past 16); flash attention, bf16 and f32, at the
   ``llama3.2-1b`` prefill shape, one long shape and the sweep of
   ``tests/test_kernels_pallas.py``, beside ``scaled_dot_product_attention``
   as a yardstick; and cuBLAS's f64 and f32 ``K^T (w K)`` and ``K g`` over
   a materialised K (TF32 off), printed as yardsticks of the reg_stats and
   predict kernels' product loops, and cuBLAS's f64 ``Knm S`` scaled to
   n = 1e6, the yardstick of the reg_stats backward's);
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
3e. runs the paper's 2M-row flight regression streamed from host
   (``examples/flight_scale.py``'s defaults, uncut: ``flight_like`` n =
   2,000,000, q = 8, d = 1, m = 64, 2,048-row blocks): ``DistributedGP``
   in a world of one over NCCL, ``put_data(stream=...)``, an exact
   ``streamed_bound``, 60 ``streamed_svi_value_and_grad`` Adam steps of 4
   chunks, the bound again (it must rise), ``streamed_predictive_state``
   and 40,960 ``flight_like(seed=99)`` queries through
   ``PredictEngine.predict_stream``; then, on the same rows in memory:
   ``streamed_stats``, the bound and the state bitwise, the streamed
   gradient and the full-batch streamed SVI step (value 1e-12) within
   1e-8, each streamed batch bitwise ``predict``'s and the served answers
   within the serving budgets of the plain f64 path; it prints the SVI's
   rows/s touched, an exact pass's time and its host reads' time;
   ``SGPR.fit_svi`` at ``sgpr-synth-1m`` and ``BayesianGPLVM.fit_svi`` at
   ``gplvm-usps`` (the exact bound must rise), ``DistributedGP(
   batch_blocks=4)`` against the SGPR's SVI objective on the same blocks;
   then 4 gloo ranks on the card streaming n = 262,144 rows, each reading
   n / 4, bitwise equal on every rank and within 1e-9 / 1e-8 of the world
   of one;
3b. trains and serves the Bayesian GPLVM at ``gplvm-usps`` (n = 4649,
   d = 256, q = 10, m = 150): value and gradient against the plain f64
   path -> ``fit`` (10 SCG iterations; the bound must rise) ->
   ``predictive_state`` -> ``PredictEngine`` answering the 4649 training
   latents, checked against the plain f64 path;
3f. serves and reconstructs on the models 3a and 3b fitted: at
   ``sgpr-synth-1m`` ``DistributedGP.predict_engine`` in a world of one
   over NCCL answers the 65,536 queries bitwise like ``PredictEngine``
   (both timed, and the all_gather); ``astype`` bf16, f16 and f32 states
   served through the f32 predict kernel, each at the f32 tier of the plain
   composition of its own values, the f32 state within the serving budgets
   of the plain f64 path, the 16-bit states' RMSE recorded, and every state
   within the budgets on ``tests/test_serving_quant.py``'s own problem
   fitted on the card; bf16 ``nbytes`` a quarter of f64's, f16 leaves
   bitwise numpy's rounding; ``AsyncCheckpointer`` steps 1-4 with
   ``keep=2``, ``latest``, the reloaded state served bitwise; 4 gloo ranks
   on the card, each computing its 16,384 rows in one launch, every rank's
   answer bitwise the world of one's.  At ``gplvm-usps``: the ``psi2_fn``
   hook (``psi2_fn_for_engine()``: the bound bitwise the default engine's;
   ``psi2_mxu`` and ``psi2_mxu_sym``: D within 1e-10, the bound within
   1e-8, the repo's limit on f64 bound parity), ``reconstruct`` of
   100 held-out ``usps_like`` digits with 34% of the pixels dropped (the
   missing pixels' mean absolute error below half the training mean's),
   and the ``gplvm_embedding`` example at its own size;
3g. online updates and the kernel zoo (after 3f): on 3a's fitted model,
   its cached Stats, its live engine and 3a's 65,536 queries,
   ``update`` of a fresh 2,048-row block (3a's generator, seed 1: one
   reg_stats f64 launch) against ``extract_state`` of the folded Stats,
   the rank-k sweep, the Woodbury correction and that extraction timed
   alone, the swapped engine's batch (one predict f64 launch);
   ``forget(-1)`` (no fallback, the Stats back within 1e-13, the answers
   back); an illegitimate forget through ``online.downdate_state``
   (fallback, nothing raised); ``PredictEngine.ingest``/``forget`` on a
   fresh engine; ``DistributedGP.update_stats_fn`` in an NCCL world of one
   bitwise ``update``'s Stats.  Each refresh is held to the reference's
   tolerance, or where the extraction itself is conditioned past it, to
   SPREAD_FACTOR times the extraction's own spread.  Then
   ``sgpr-zoo-trend`` uncut (n 100,000, q 4, d 2, m 128,
   ``Sum(SE dims 0-1, Linear dims 2-3)``): value and gradient against the
   CPU (within 1e-8 or SPREAD_FACTOR times the CPU path's own spread),
   ``fit`` (10 SCG iterations: the first 7 are rejected steps there), the 65,536 answers bitwise through ``save_state`` /
   ``load_state``, an update against re-extraction, all with no kernel
   launch; the same data under ``kernel="se"`` launches reg_stats;
3h. posterior sampling, the fleet engine and the async front-end (after
   3g, on 3a's fitted model and queries): ``PredictEngine.sample`` of
   4,096 queries (16 blocks of 256) with 256 draws, the same bits for the
   same seed and through ``sample_stream`` over four 1,024-row batches,
   ``_sample_from_normals`` on the card within 1e-10 of the CPU on the
   same normals, the draws' means within 5 standard errors of ``predict``
   and one block's covariance within 6 of ``predict_full_cov``,
   ``include_noise`` adding 1/beta, an f32 state sampling and a bf16 one
   refused; ``MultiPredictEngine`` over 3a's state and the states after
   1, 2 and 3 ``update``s of fresh 2,048-row blocks answering the 65,536
   queries, each model's rows bitwise its own ``PredictEngine``'s, 4
   predict launches a batch, ``predict_mixture`` within 1e-12 of the plain
   f64 mixture, ``swap_slot``, and ``DistributedGP.multi_predict_engine``
   (and a sharded engine's ``sample``) bitwise in an NCCL world of one;
   a ``Frontend`` over 3a's engine (``warmup``, a burst of 2,000 requests
   of 1-128 rows, ``max_batch_rows`` 8,192, ``max_wait_ms`` 2, a
   ``swap_state`` to the fleet's second state mid-burst), every response
   bitwise a direct ``predict`` under its generation's state, requests
   past their deadline failing with ``SLOExceeded`` and launching nothing,
   the predict launches equal to the flushes plus the warmup shapes; the
   same over the fleet engine; it prints the SLO summary and
   ``load_summary()``;
3i. the overlapped reduce, the barrier-free async engine and the
   front-end over a process group (after 3h, on 3a's data, init and fitted
   state): ``make_gp_train_step(chunk_size=65,536)`` in each
   ``reduce_mode`` (serial, overlap, overlap_eager) in a world of one over
   NCCL at ``sgpr-synth-1m`` (16 blocks), value and gradient bitwise
   across the modes and within 1e-9 / 1e-8 of ``SGPR._neg_vg``, 16 block
   all_reduces and the gradient's one a step against serial's 2, each
   mode's step time (median of 5); the latent map at ``gplvm-usps`` under
   ``overlap`` (gradient within 3.42e-7); ``AsyncEngine`` over 8 shards
   of 125,000 rows: all fresh against ``exact_value_and_grad`` (1e-12 /
   1e-9) and the serial step (1e-9 / 1e-8), the value on the exact value
   (1e-12) after 8 refresh-1 steps at fixed (hyp, z), 20 clipped SGD
   steps under ``FailureSimulator(8, 0.1, seed=3)`` raising the exact
   bound, each refresh's (1, 2, 4, 8) step time and reg_stats launches
   (2 a refreshed shard), the latent engine at ``gplvm-usps`` over 4
   shards against ``BayesianGPLVM._neg_vg``; then one spawn of 4 gloo
   ranks on the card: n 262,144 in blocks of 16,384 under (1,0,1,1)
   rescale, every rank's bits the same, ``overlap`` bitwise
   ``overlap_eager`` and within 1e-9 / 1e-8 of serial, 5 all_reduces a
   step against 2; and a ``Frontend`` on rank 0 over
   ``DistributedGP.predict_engine`` of 3a's state (500 of 3h's requests,
   a ``swap_state`` to 3a's state updated by a fresh block midway,
   ``close()``), ranks 1-3 in ``serve_follower``: every response bitwise
   a world of one's under its generation, every rank's predict launches
   the flushes plus the warmup shapes; it prints the p50 / p99 e2e, the
   per-flush ms and the broadcasts' bytes and ms;
3c. serves ``llama3.2-1b`` at full width (random weights from a seed):
   ``init_params`` -> ``make_prefill_step`` over 4 prompts of 2048 tokens
   (twice, cold and warm) -> the caches copied into a cache with room for
   16 more -> 16 greedy ``make_serve_step`` tokens -> the same weights
   prefilled at f32 compute; checked against the same model with the plain
   attention, and by teacher-forced decode against the prefill (the
   registered config trains and prefills through the query-chunked
   attention, as the JAX package's does: the flash kernel is asked for
   with ``dataclasses.replace(cfg, use_flash=True)``);
3j. trains LM configs (after 3c; no flash launch): (a) ``llama3.2-1b`` and
   ``starcoder2-3b`` reduced, f32 with TF32 off, ``forward_train``'s loss
   and every gradient leaf and one ``make_train_step`` state on the card
   against the CPU (relative RMS 1e-4); (b) ``llama3.2-1b`` at full width
   (f32 params, bf16 compute, remat; B 4, T 2048, ``train_4k`` cut to one
   card): at f32 compute the query-chunked attention and the chunked
   cross-entropy against one chunk each (loss and gradients within 1e-4),
   bf16 against f32 compute (loss and grad norm within 2e-2, the
   gradient's relative RMS printed by leaf), then 10 Adam steps on one
   repeated batch (the loss must fall), with the step time's median,
   tokens/s, the MFU (``launch.roofline.model_flops`` over the step time
   and the bf16 peak) and the peak memory; (c) 3 steps of ``qwen2-1.5b``
   at full width (``launch/train.py``'s default arch), timed;
   (d) ``launch.train.main`` at ``--reduced``: 8 steps straight against 4,
   a checkpoint and a resume to 8 (final losses within 1e-4, bitwise or
   not printed), and a ``--compress-grads`` run (finite, its last 4 losses
   below its first 4);
3k. serves the five architectures that are not dense GQA at full width
   (after 3j; random weights from a seed, bf16 compute, params in the
   config's dtype, B 4): ``mamba2-370m`` (48 SSD layers),
   ``whisper-medium`` (24 + 24 layers, 1,500 frame embeddings, the flash
   kernel in the encoder, non-causal, and the decoder's self-attention),
   ``recurrentgemma-9b`` (38 layers, a 3,072-token prompt: 1.5 windows),
   ``deepseek-v2-236b`` (its dense layer and 2 of its 59 MoE layers) and
   ``qwen3-moe-235b-a22b`` (4 of 94 layers, the flash kernel), depth cut
   only where one card forces it (``arch_config``); each: prefill of
   2,048 tokens (cold, warm), the caches grown, 16 greedy decode steps,
   an f32-compute prefill; logits finite, flash launches exactly one a
   flash layer a prefill (48 whisper, 4 qwen3-moe) and none a decode
   step, each flash call of the cold prefill within the kernel's tier of
   the plain version on its own q, k, v; at f32 compute flash against the
   plain attention and teacher-forced decode against the prefill within
   relative RMS 1e-4 end to end; at bf16 teacher-forced decode within 2e-2
   layer by layer (each layer's decode step fed the prefill's input to
   that layer, a MoE layer's top-k pinned to the prefill's), the bf16
   end-to-end values and the MoE configs' differing top-k choices printed
   (bf16 rounding grows through depth and flips routing past 2e-2,
   PERF.md); it prints the prefill s, the decode step's median ms,
   tokens/s and the peak memory beside the card's name and power limit;
   then each of the five ``reduced()`` configs, f32, ``forward_train``'s
   total, aux metrics and every gradient leaf on the card against the CPU
   (1e-4).  Phase 2 times the flash kernel at 3k's three new shapes;
3l. serves ``qwen3-moe-235b-a22b`` (after 3k; 4 of 94 layers at full
   width, bf16, the flash kernel) through the expert-parallel MoE on a
   (1, 4) ("data", "model") mesh of 4 ranks spawned on the card over gloo
   (``launch.make_compat_mesh``; each rank 32 of 128 experts a layer,
   ``train.steps.init_params_sharded``): (1) capacity factor 16 (no drop),
   B 1, top-k pinned to a dense one-process run of the same weights: each
   MoE layer's output and the last logits within 2e-2 relative RMS at
   bf16, the logits within 1e-4 at f32; (2) every rank's logits bitwise
   the same after each prefill and decode step; (3) the config's capacity
   factor 1.25, B 4 x 2,048 then 16 decode steps: each layer's kept
   (token, choice) pairs identical to the schedule's plain one-process
   re-computation on the same inputs (``plain_ep_moe``), its output within
   2e-2, the dropped share printed; (4) the int8 wire, each layer on the
   same inputs within ``tests/test_moe.py``'s bound scaled to the output;
   (5) the reduced config's f32 train step under the mesh, no drop: each
   gradient leaf of the cross-entropy within 1e-4 of the dense path's,
   the int8 backward's finite and nonzero.  Its attention and vocab are
   tensor-parallel over the same ``model`` axis (every leaf cut by the
   rules).  It prints prefill s and decode-step ms (native, int8), each
   MoE collective's bytes and ms a layer, peak memory and flash launches
   per rank, beside the card's name and power limit;
3m, 3n. serve ``TP_SERVE``'s configs tensor-parallel (after 3l; 3k's
   weights and prompts, full width, bf16, B 4) on 4 ranks spawned once on
   the card over gloo (``tp_rank``): 3m ``llama3.2-1b`` (8 of 16 layers,
   f32 params, the flash kernel, 2,048 tokens) at (1, 4) ("data",
   "model"), with a warm-up prefill of 128 tokens, 16 decode steps and the
   teacher-forced check, and at (2, 2) (FSDP over ``data``) with 4 decode
   steps; 3n ``mamba2-370m`` (24 of 48 SSD layers) at (1, 4) and (2, 2),
   ``whisper-medium`` (12 + 12 of its 24 + 24 layers, the flash kernel on
   a rank's 4 heads), ``recurrentgemma-9b`` (R, R, A, 3,072 tokens) and
   ``deepseek-v2-236b`` (its dense and 2 MoE layers, the MoE
   expert-parallel, top-k pinned to the one-process run of the same
   schedule, ``plain_ep_moe``) at (1, 4), 4 decode steps each; at (1, 4)
   also an f32-compute prefill.  Against one process on the card with the
   same weights (``tp_check``): the f32 logits within 1e-5; the bf16
   logits and decode steps within 2e-2 (every config but mamba2) and, for
   all, their error from the one-process f32 run within 1.5x the
   one-process bf16 run's; every rank of a ``model`` group bitwise; each
   flash config's launches a prefill on each rank's heads (llama 8,
   whisper 24); the collectives' calls and bytes a prefill and a decode
   step equal to ``tp_expected_collectives``' to the byte (from
   ``tp_layout``, which 3o's formula shares).  It prints times, per-rank
   params and peak memory beside the card's name and power limit;
3o. trains ``llama3.2-1b`` tensor-parallel (after 3n; 3j's step at 8 of
   16 layers: f32 params, remat, AdamW clipped by the whole gradient's
   norm, B 4 x 2,048) on 4 ranks spawned on the card over gloo at (1, 4)
   and (2, 2), a bf16- and an f32-compute step each, against 3j's
   one-process step on the same card, weights, depth and batch: the loss
   within 2e-2 (bf16) and 1e-5 (f32); at f32 each rank's gradient blocks within 1e-4, its params after
   the step within 1e-4 of the reference's (a leaf drawn nonzero) and
   within 1e-2 of the reference's update; every rank of a ``model`` group
   bitwise (loss, the leaves not cut over ``model``, their params after);
   the collectives' calls and bytes a step equal to
   ``train_tp_expected_collectives``' to the byte.  It prints step
   seconds, tokens/s, MFU and peak memory a rank.

Every launch counter is set to 0 just before each of 3a, 3d, 3e, 3b, 3f,
3g, 3h, 3i, 3c, 3j, 3k, 3l, 3m with 3n (one spawn), and 3o and read just
after; each kernel of a path must have launched in it (3d's, 3e's, 3f's,
3i's, 3l's, 3m's, 3n's and 3o's ranks count
their own launches and report them; 3d, 3e, 3f, 3g and 3h count only the port's own calls, not
the references run beside them, and 3e, 3f, 3g and 3h assert the counts
their calls imply: one reg_stats launch a block a pass, one predict launch
or more a served batch, one on each rank of a sharded batch, one in
``reconstruct``, none on the zoo's route or in sampling, one a model a
fleet batch and a front-end flush; 3j, which trains through the
query-chunked attention, must launch no kernel, nor may 3o).

It prints one JSON line describing the kernels of the main path, then
``{"ok": true, "device": {...}}`` as its last line.  Any failed check
raises, so the exit code is non-zero and no result line is printed.  It
exits with code 2, printing nothing on stdout, where there is no CUDA device
or no ``src/repro_torch`` beside it.  It imports nothing of JAX.
"""
from __future__ import annotations

import gc
import json
import math
import pathlib
import statistics
import subprocess
import sys
import tempfile
import time
from typing import NamedTuple

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


def ops_seconds(flops, exps, dtype, peaks) -> float:
    """Least time of ``flops`` at the type's peak (f32 on the CUDA cores, f64
    on the FP64 tensor cores) and ``exps`` at their ``EXP_COST``.  In f32
    the exps run on the SFU, which issues beside the FP32 pipe: the larger
    of the two.  In f64 the sum, as the f64 rows have always been bounded
    (whether the DFMAs of the exps overlap the DMMA product is unmeasured)."""
    f32 = dtype == torch.float32
    t_flops = flops / (peaks[0] if f32 else peaks[1])
    t_exps = exps * EXP_COST[dtype] / peaks[0]
    return max(t_flops, t_exps) if f32 else t_flops + t_exps


def reg_stats_bound(n, m, q, d, dtype, peaks) -> tuple[float, str]:
    """Least time: the flops and the slab's n*m exps (``ops_seconds``), or
    the bytes read and written once."""
    item = 4 if dtype == torch.float32 else 8
    nbytes = item * (n * (q + d + 1) + m * q + m * m + m * d + 1)
    t_ops = ops_seconds(reg_stats_flops(n, m, q, d), n * m, dtype, peaks)
    t_bytes = nbytes / peaks[2]
    return 1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def cublas_d_product_ms(n, m, rows=65_536, dtype=torch.float64) -> float:
    """Yardstick for the reg_stats kernels' product loops, never called by
    the port: the time of ``torch.matmul`` for K^T (w K) over a materialised
    K of ``rows`` x m (cuBLAS: f64 on the FP64 tensor cores, f32 in IEEE f32
    on the CUDA cores with TF32 off), scaled to n rows."""
    gen = torch.Generator(device=DEV).manual_seed(SEED)
    k = torch.rand((rows, m), dtype=dtype, device=DEV, generator=gen)
    wk = torch.rand((rows, 1), dtype=dtype, device=DEV, generator=gen) * k
    kt = k.T
    return time_ms(lambda: torch.matmul(kt, wk)) * n / rows


def predict_flops(t, m, q, d) -> float:
    # slab t*m*(3q+2); quad over the symmetric g t*m(m+1)/2 pair products;
    # mean t*m*d FMAs
    return t * m * (3 * q + 2) + t * m * (m + 1) + 2 * t * m * d


def predict_bound(t, m, q, d, dtype, peaks) -> tuple[float, str]:
    """Least time: the flops and the slab's t*m exps (``ops_seconds``), or
    the bytes read and written once."""
    item = 4 if dtype == torch.float32 else 8
    nbytes = item * (t * q + m * q + m * d + m * m + q + 1 + t * d + t)
    t_ops = ops_seconds(predict_flops(t, m, q, d), t * m, dtype, peaks)
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
    again = rs_ops.reg_stats(hyp, zk, xk, yk, wk)
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
    if not all(torch.equal(u, v) for u, v in zip((b, c, dd), again)):
        raise AssertionError("reg_stats: two runs on the same inputs differ")
    out = {"shape": dict(n=n, m=m, q=q, d=d), "dtype": str(dtype),
           "max_abs_err": max(err_b, err_c, err_d),
           "max_err_over_bound": max(worst_c, worst_d)}
    if timed:
        out["ms"] = time_ms(lambda: rs_ops.reg_stats(hyp, zk, xk, yk, wk))
        bare = reg_stats_launch_only(hyp, zk, xk, yk, wk)
        out["launch_only_ms"] = time_ms(bare)
        out["device_ms"] = graph_ms(bare, launches=2)
        out["plain_ms"] = time_ms(
            lambda: plain_reg_stats(rs_ref, hyp, zs, xs, ys, ws), reps=3)
        out["bound_ms"], out["bound_by"] = reg_stats_bound(n, m, q, d, dtype,
                                                           peaks)
    print(f"reg_stats {out}", flush=True)
    return out


def reg_stats_launch_only(hyp, z, x, y, w):
    """The bare ctypes launch of a reg_stats kernel (tile pass and reduce)
    on operands, scratch and outputs prepared once (``ops.launch_args``):
    its device time without the wrapper's casts, allocations and autograd
    Function (the wrapper's time is ``ms``)."""
    from repro_torch.kernels.reg_stats import kernel as rs_k
    from repro_torch.kernels.reg_stats import ops as rs_ops

    args = rs_ops.launch_args(hyp["log_sf2"], hyp["log_ell"], z, x, y, w)
    return lambda: rs_k.reg_stats(*args)


def check_reg_stats_rows(rs_ops, n, m, q, d, dtype, block=2048):
    """reg_stats at an m whose whole (m, m) plain version and error tensors
    do not fit the card beside the kernel's D: every row of D held against
    the plain version ``block`` rows at a time, C and b whole, at the
    dtype's tier, each block of rows exactly equal to the matching block of
    columns.  The plain version is ``ref.reg_stats_ref``'s SE-ARD slab K
    (n small, so K whole), D's block ``(K[:, blk] w)^T K``."""
    rng = np.random.default_rng(SEED + n + m)
    x, y = make_regression(rng, n, q, d)
    x, y = t64(x), t64(y)
    z = t64(rng.uniform(-2.0, 2.0, (m, q)))
    w = t64(rng.uniform(size=n) > 0.15)
    hyp = {"log_sf2": t64(float(np.log(float(y.var())))),
           "log_ell": t64(np.full(q, 0.5 * np.log(q)))}
    xk, yk, wk, zk = (v.to(dtype) for v in (x, y, w, z))
    xs, ys, ws, zs = (v.to(torch.float64) for v in (xk, yk, wk, zk))
    b, c, dd = rs_ops.reg_stats(hyp, zk, xk, yk, wk)
    torch.cuda.synchronize()
    ell, sf2 = torch.exp(hyp["log_ell"]), torch.exp(hyp["log_sf2"])
    diff = xs[:, None, :] / ell - zs[None, :, :] / ell
    knm = sf2 * torch.exp(-0.5 * (diff * diff).sum(-1))
    del diff
    wknm = knm * ws[:, None]
    pb = sf2 * ws.sum()
    err_b, _ = check_close("reg_stats b", b, pb, pb)
    err_c, worst_c = check_close("reg_stats C", c, wknm.T @ ys,
                                 wknm.T @ ys.abs())
    err_d = worst_d = 0.0
    for lo in range(0, m, block):
        blk = slice(lo, min(m, lo + block))
        pd = wknm[:, blk].T @ knm
        e, wst = check_close("reg_stats D rows", dd[blk], pd, pd)
        err_d, worst_d = max(err_d, e), max(worst_d, wst)
        if not torch.equal(dd[blk], dd[:, blk].T):
            raise AssertionError("reg_stats D is not exactly symmetric")
        del pd
    out = {"shape": dict(n=n, m=m, q=q, d=d), "dtype": str(dtype),
           "rows_checked": m, "max_abs_err": max(err_b, err_c, err_d),
           "max_err_over_bound": max(worst_c, worst_d)}
    print(f"reg_stats rows {out}", flush=True)
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
    or point) at the least work its kernel's form needs and one exp
    (``ops_seconds``); or the bytes read once, written once.  psi2's
    centred exponent costs 2q + 5 flops a pair (per q one FMA of
    u_a (z_b - mu)/(2c); the two alphas, the weighted exp's FMA), psi1's
    direct one 4q + 3 (per q a subtraction, a product and an FMA)."""
    item = 4 if dtype == torch.float32 else 8
    if kind == "psi2":
        entries = n_eff * m * (m + 1) / 2
        flops = 2 * q + 5
        nbytes = item * (n * (2 * q + 1) + m * q + 2 * q + 1) + 8 * m * m
    else:
        entries = n * m
        flops = 4 * q + 3
        nbytes = item * (2 * n * q + m * q + 2 * q + 1 + n * m)
    t_ops = ops_seconds(entries * flops, entries, dtype, peaks)
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


def kernel_split(fn, reps: int = 20) -> dict:
    """Device microseconds a call of ``fn`` spends in each kernel it
    launches, by kernel name (``torch.profiler``, CUDA activity, over
    ``reps`` calls after a warm-up): the split of a multi-launch call."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0.0))
        if us > 0:
            name = e.key.removeprefix("void ").replace(
                "(anonymous namespace)::", "")
            out[name.split("(")[0]] = us / reps
    return out


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
            if kind == "psi2":
                out[kind]["kernels_us"] = kernel_split(bare)
            out[kind]["bound_ms"], out[kind]["bound_by"] = psi_bound(
                kind, n_eff, n, m, q, dtype, peaks)
    for kind in ("psi2", "psi1"):
        print(f"{kind} ", dict(shape=dict(n=n, m=m, q=q), dtype=str(dtype),
                               masked=masked, **out[kind]), flush=True)
    return out


def check_psi2_midway(ps_ops, ps_ref, n, m, q, dtype=torch.float64,
                      scale=70.0):
    """psi2 where the centred exponent's terms are largest against their
    sum: pairs of inducing points at +-scale d_j (d_j unit vectors, l^2 =
    q), the rows' means near 0, midway between them.  At scale 70 (f64)
    each term alpha ~ 120 while mu - zbar ~ 0, and D holds exp(static) ~
    exp(-490); f32 takes scale 20 (alpha ~ 10, D ~ exp(-40)), so that D
    stays inside f32's range.  The plain version runs in f64 on the
    kernel's values."""
    rng = np.random.default_rng(SEED + 7)
    f64 = torch.float64
    d = rng.standard_normal((m // 2, q))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    z = np.concatenate([scale * d, -scale * d])
    mu = 1e-3 * rng.standard_normal((n, q))
    s = rng.uniform(0.05, 1.0, (n, q))
    w = (rng.uniform(size=n) > 0.15).astype(np.float64)
    hyp = {"log_sf2": torch.tensor(0.3, dtype=f64, device=DEV),
           "log_ell": torch.full((q,), 0.5 * math.log(q), dtype=f64,
                                 device=DEV)}
    z, mu, s, w = (torch.from_numpy(a).to(DEV, dtype) for a in (z, mu, s, w))
    got = ps_ops.psi2(hyp, z, mu, s, w)
    again = ps_ops.psi2(hyp, z, mu, s, w)
    plain = ps_ref.psi2_ref(hyp["log_sf2"], hyp["log_ell"],
                            *(v.to(f64) for v in (z, mu, s, w)))
    torch.cuda.synchronize()
    if not torch.equal(got, got.T):
        raise AssertionError("psi2 midway: D is not exactly symmetric")
    if not torch.equal(got, again):
        raise AssertionError("psi2 midway: two runs on the same inputs differ")
    err, worst = check_close("psi2 midway", got, plain, plain)
    print("psi2 midway ", dict(shape=dict(n=n, m=m, q=q), dtype=str(dtype),
                               max_abs_err=err, max_err_over_bound=worst,
                               min_plain=float(plain.min())), flush=True)


def time_operator_routes(rs_ops, ps_ops, sgpr, usps) -> dict:
    """Each GP kernel at its main path's shape (f64) through the wrapper
    (checks, the autograd Function, the operator ``torch.ops.repro_torch.*``)
    beside the same wrapper without the operator (the Function's forward
    calling the bare launch, the route before the operator existed),
    CUDA-event medians of TIMED_REPS in one call, in turns; printed on one
    line each."""
    from unittest import mock

    def launching(bare):
        def forward(ctx, *args):
            ctx.save_for_backward(*args)
            return bare(*args)
        return staticmethod(forward)
    rng = np.random.default_rng(SEED + 11)
    f64 = torch.float64

    def t(*shape, lo=None):
        a = rng.standard_normal(shape) if lo is None else rng.uniform(
            lo, 1.0, shape)
        return torch.from_numpy(a).to(DEV, f64)
    hyp = {"log_sf2": torch.zeros((), dtype=f64, device=DEV)}
    out = {}
    for name, c in (("reg_stats", sgpr), ("psi2", usps), ("psi1", usps)):
        hyp["log_ell"] = torch.zeros((c.q,), dtype=f64, device=DEV)
        z, x = t(c.m, c.q), t(c.n, c.q)
        if name == "reg_stats":
            y, w = t(c.n, c.d), t(c.n, lo=0.0)
            wrapper = lambda: rs_ops.reg_stats(hyp, z, x, y, w)  # noqa: E731
            fn_cls, bare = rs_ops._RegStats, rs_ops._launch
        else:
            s = t(c.n, c.q, lo=0.05)
            w = t(c.n, lo=0.0)
            if name == "psi2":
                wrapper = lambda: ps_ops.psi2(hyp, z, x, s, w)  # noqa: E731
                fn_cls, bare = ps_ops._Psi2, ps_ops._launch_psi2
            else:
                wrapper = lambda: ps_ops.psi1(hyp, z, x, s)  # noqa: E731
                fn_cls, bare = ps_ops._Psi1, ps_ops._launch_psi1
        times = {"wrapper": [], "pre_operator": []}
        for key in ("wrapper", "pre_operator", "pre_operator", "wrapper"):
            if key == "wrapper":
                times[key].append(time_ms(wrapper))
                continue
            with mock.patch.object(fn_cls, "forward", launching(bare)):
                times[key].append(time_ms(wrapper))
        out[name] = {k: statistics.median(v) for k, v in times.items()}
        print(f"operator route {name} f64 ({c.name}): wrapper through the "
              f"operator {out[name]['wrapper']:.4f} ms, before the operator "
              f"{out[name]['pre_operator']:.4f} ms", flush=True)
    return out


def time_backwards(bwd) -> None:
    """Each backward beside its chunked recompute, from the full-width
    checks (``bwd``: ``check_reg_stats_bwd`` at sgpr-synth-1m, hyper-
    parameters and z as the SGPR takes them; ``check_psi2_bwd`` and
    ``check_psi1_bwd`` at gplvm-usps and gplvm-synth-100k, every
    gradient the GPLVM takes), one line each; psi2 and psi1 with their
    device time and each launch's device microseconds."""
    for key, res in bwd.items():
        more = "".join(f", {k} {res[k]}" for k in
                       ("device_ms", "kernels_us", "yardstick_ms") if k in res)
        print(f"backward {key}: kernel {res['ms']:.4f} ms, chunked recompute "
              f"{res['plain_ms']:.4f} ms, bound {res['bound_ms']:.4f} ms{more}",
              flush=True)


def hold_backward(label, got, again, plain, plain_abs, dtype) -> float:
    """A backward kernel's gradients against the chunked recompute's:
    f64 normwise relative <= GRAD_RTOL per input, f32 entrywise
    |kernel - plain| <= 2e-4 |plain| + 1e-5 plain_abs (``TIERS``, with
    plain_abs the closed form on absolute values), and a second call
    bitwise equal.  The tier is the kernel's dtype, whatever the dtype
    each gradient comes back in.  Returns the largest absolute error."""
    rtol, atol_abs = TIERS[dtype]
    worst = 0.0
    for i, (g, a, p, pa) in enumerate(zip(got, again, plain, plain_abs)):
        if p is None:
            continue
        if not torch.equal(g, a):
            raise AssertionError(f"{label}: input {i}'s gradient differs on "
                                 "a second run")
        g64 = g.double()
        if not bool(torch.isfinite(g64).all()) or g.shape != p.shape:
            raise AssertionError(f"{label}: input {i}: bad gradient")
        worst = max(worst, float((g64 - p).abs().max()) if p.numel() else 0.0)
        if dtype == torch.float64:
            rel = float(torch.linalg.vector_norm(g64 - p)
                        / torch.linalg.vector_norm(p).clamp_min(1e-300))
            if rel > GRAD_RTOL:
                raise AssertionError(f"{label}: input {i}: normwise relative "
                                     f"difference {rel:.3e} > {GRAD_RTOL}")
        else:
            ratio = float(((g64 - p).abs() / (rtol * p.abs() + atol_abs * pa)
                           .clamp_min(1e-300)).max()) if p.numel() else 0.0
            if ratio > 1.0:
                raise AssertionError(f"{label}: input {i}: max |err|/bound = "
                                     f"{ratio:.3e}")
    return worst


def reg_stats_bwd_bound(n, m, q, d, dtype, peaks) -> tuple[float, str]:
    """Least time of the backward's work: knm S (n m^2 FMAs), knm built
    once (n m (3q + 2), n m exps), each entry's P, E and per-feature r, E r,
    E r^2 (n m (2d + 4 + 4q)) at ``ops_seconds``; or the bytes read and
    written once (x, y, w, z, gC, gD, 1/ell^2; d z, d log_ell, d log_sf2)."""
    item = 4 if dtype == torch.float32 else 8
    flops = 2 * n * m * m + n * m * (3 * q + 2) + n * m * (2 * d + 4 + 4 * q)
    nbytes = item * (n * (q + d + 1) + 2 * m * q + m * m + m * d + 2 * q + 3)
    t_ops = ops_seconds(flops, n * m, dtype, peaks)
    t_bytes = nbytes / peaks[2]
    return 1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def psi2_bwd_bound(n, m, q, dtype, peaks) -> tuple[float, str]:
    """Least time of psi2's backward work over the upper pairs P = m (m +
    1) / 2: per (row, pair) the exponent (3q + 2), one exp and per feature
    r, F r, F r^2 and the point sums (6q), at ``ops_seconds``; or the bytes
    read and written once (mu, s, w, z, g, l^2; their gradients)."""
    item = 4 if dtype == torch.float32 else 8
    pairs = m * (m + 1) // 2
    flops = n * pairs * (9 * q + 2)
    nbytes = item * (2 * (2 * n * q + n + m * q + q + 1) + m * m)
    t_ops = ops_seconds(flops, n * pairs, dtype, peaks)
    t_bytes = nbytes / peaks[2]
    return 1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def psi1_bwd_bound(n, m, q, dtype, peaks) -> tuple[float, str]:
    """Least time of psi1's backward work, as ``psi_bound`` counts psi1's:
    per (row, point) entry the exponent (3q), psi1 and E (3), the row sums
    of E, E r, E r^2 (4q + 1) and the point sums of E r a (3q), and one
    exp (``ops_seconds``); or the bytes read and written once (g, mu, s,
    z and the log hyper-parameters; d mu, d s, d z, d log_ell and
    d log_sf2, every gradient the GPLVM takes)."""
    item = 4 if dtype == torch.float32 else 8
    entries = n * m
    nbytes = item * (n * m + 4 * n * q + 2 * m * q + 2 * q + 2)
    t_ops = ops_seconds(entries * (10 * q + 4), entries, dtype, peaks)
    t_bytes = nbytes / peaks[2]
    return 1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def check_psi1_bwd(ps_ops, ps_ref, peaks, n, m, q, dtype, timed,
                   needs=(True,) * 5, shift=0.0):
    """psi1's backward kernel (``torch.ops.repro_torch.psi1_bwd``, the
    Function's route) against the chunked recompute (``psi1_vjp``) on the
    same values in f64 (the kernel reads the log hyper-parameters in its
    dtype too); bitwise on a second call; ``shift`` added to mu and z
    (the offset case).  Timed: the operator, the bare launch on operands
    prepared once (``launch_only_ms``), its device time (``device_ms``,
    bare launches from one CUDA graph) and split by kernel
    (``kernels_us``), and the recompute, with ``needs`` (default: every
    gradient, as the GPLVM takes them)."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.psi_stats import kernel as ps_k

    rng = np.random.default_rng(SEED + 9 + n + m)
    f64 = torch.float64
    ins = [t64(rng.uniform(-0.5, 0.8)), t64(np.full(q, 0.5 * np.log(q))),
           t64(rng.standard_normal((m, q)) + shift),
           t64(rng.standard_normal((n, q)) + shift),
           t64(rng.uniform(0.05, 1.0, (n, q)))]
    kin = [t.to(dtype) for t in ins]
    kg = t64(rng.standard_normal((n, m))).to(dtype)
    pin, pg = [t.to(f64) for t in kin], kg.to(f64)
    flags = _build.row_flags((*needs, False))
    name = "psi1_bwd_" + ("float64" if dtype == f64 else "float32")
    before = ps_ops.LAUNCHES[name]

    def kernel():
        return torch.ops.repro_torch.psi1_bwd(*kin, kg, flags)
    got, again = kernel(), kernel()
    if ps_ops.LAUNCHES[name] != before + 2:
        raise AssertionError("psi1_bwd: the operator did not launch the "
                             "kernel once a call")
    got = [t if need else None for t, need in zip(got, needs)]
    again = [t if need else None for t, need in zip(again, needs)]
    plain = ps_ops.psi1_vjp(*pin, pg, list(needs))
    plain_abs = ps_ref.psi1_vjp_ref(*pin, pg, list(needs), absolute=True)
    label = f"psi1_bwd {dtype} n={n} m={m} q={q} shift={shift}"
    out = {"shape": dict(n=n, m=m, q=q), "dtype": str(dtype), "shift": shift,
           "needs": list(needs),
           "max_abs_err": hold_backward(label, got, again, plain, plain_abs,
                                        dtype)}
    del plain, plain_abs
    if timed:
        out["ms"] = time_ms(kernel)
        out["plain_ms"] = time_ms(
            lambda: ps_ops.psi1_vjp(*pin, pg, list(needs)), reps=3)
        args = ps_ops.psi1_bwd_launch_args(*kin, kg, flags,
                                           _build.sm_count(kg.device))

        def bare():
            ps_k.psi1_bwd(*args)
        out["launch_only_ms"] = time_ms(bare)
        out["device_ms"] = graph_ms(bare)
        out["kernels_us"] = kernel_split(bare)
        out["bound_ms"], out["bound_by"] = psi1_bwd_bound(n, m, q, dtype,
                                                          peaks)
    print(f"psi1_bwd {out}", flush=True)
    return out


def check_reg_stats_bwd(rs_ops, rs_ref, peaks, n, m, q, d, dtype, masked,
                        timed, needs=(True, True, True, False, False, False)):
    """The backward kernel (``torch.ops.repro_torch.reg_stats_bwd``, the
    Function's route) against the chunked recompute (``reg_stats_vjp``)
    on the same values in f64, for a non-symmetric gD; bitwise on a second
    call.  Timed: the kernel (the operator, and the bare launch on
    operands prepared once) and the recompute with ``needs`` (default:
    the SGPR's, hyper-parameters and z)."""
    from repro_torch.kernels import _build

    rng = np.random.default_rng(SEED + 5 + n + m)
    f64 = torch.float64
    x, y = make_regression(rng, n, q, d)
    ins = [t64(float(np.log(float(np.var(y))))),
           t64(np.full(q, 0.5 * np.log(q))), t64(rng.uniform(-2.0, 2.0, (m, q))),
           t64(x), t64(y),
           t64(rng.uniform(size=n) > 0.15) if masked
           else torch.ones(n, dtype=f64, device=DEV)]
    cts = [t64(rng.standard_normal(sh)) for sh in ((), (m, d), (m, m))]
    kin = ins[:2] + [t.to(dtype) for t in ins[2:]]
    kct = [t.to(dtype) for t in cts]
    # the plain versions on exactly the values the kernel sees
    pin = [t.to(f64) for t in kin]
    pct = [t.to(f64) for t in kct]
    flags = _build.row_flags(needs)
    name = "bwd_" + ("float64" if dtype == f64 else "float32")
    before = rs_ops.LAUNCHES[name]

    def kernel():
        return torch.ops.repro_torch.reg_stats_bwd(*kin, *kct, flags)
    got, again = kernel(), kernel()
    if rs_ops.LAUNCHES[name] != before + 2:
        raise AssertionError("reg_stats_bwd: the operator did not launch "
                             "the kernel once a call")
    got = [g if need else None for g, need in zip(got, needs)]
    again = [g if need else None for g, need in zip(again, needs)]
    plain = rs_ops.reg_stats_vjp(*pin, *pct, list(needs))
    plain_abs = rs_ref.reg_stats_vjp_ref(*pin, *pct, list(needs),
                                         absolute=True)
    label = f"reg_stats_bwd {dtype} n={n} m={m} q={q} d={d}"
    out = {"shape": dict(n=n, m=m, q=q, d=d), "dtype": str(dtype),
           "needs": list(needs),
           "max_abs_err": hold_backward(label, got, again, plain, plain_abs,
                                        dtype)}
    del plain, plain_abs
    if timed:
        from repro_torch.kernels.reg_stats import kernel as rs_k

        out["ms"] = time_ms(kernel)
        args = rs_ops.bwd_launch_args(
            *kin, *kct, flags, rs_k.bwd_slots(dtype, m, q, kct[0].device))
        out["launch_only_ms"] = time_ms(lambda: rs_k.reg_stats_bwd(*args))
        del args
        out["plain_ms"] = time_ms(
            lambda: rs_ops.reg_stats_vjp(*pin, *pct, list(needs)), reps=3)
        out["bound_ms"], out["bound_by"] = reg_stats_bwd_bound(n, m, q, d,
                                                               dtype, peaks)
    print(f"reg_stats_bwd {out}", flush=True)
    return out


def check_psi2_bwd(ps_ops, ps_ref, peaks, n, m, q, dtype, masked, timed,
                   needs=(True, True, True, True, True, False), shift=0.0):
    """psi2's backward kernel (``torch.ops.repro_torch.psi2_bwd``) against
    the chunked recompute (``psi2_vjp``) on the same values in f64, for a
    non-symmetric cotangent; bitwise on a second call; ``shift`` added to
    mu and z (the offset case: the kernel expands (mu - zbar)^2 after
    centring).  Timed, with ``needs`` (default: the GPLVM's,
    hyper-parameters, z, mu and s): the operator, the bare launch on
    operands prepared once (``launch_only_ms``), its device time
    (``device_ms``, bare launches from one CUDA graph), split by kernel
    (``kernels_us``, each launch's device microseconds), the recompute,
    and cuBLAS's f64 ``F Zb^T`` ((n, pairs) by (pairs, 2q), one of the
    kernel's three products: a yardstick, not the function)."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.psi_stats import kernel as ps_k

    rng = np.random.default_rng(SEED + 7 + n + m)
    f64 = torch.float64
    ins = [t64(rng.uniform(-0.5, 0.8)), t64(np.full(q, 0.5 * np.log(q))),
           t64(rng.standard_normal((m, q)) + shift),
           t64(rng.standard_normal((n, q)) + shift),
           t64(rng.uniform(0.05, 1.0, (n, q))),
           t64(rng.uniform(size=n) > 0.15) if masked
           else torch.ones(n, dtype=f64, device=DEV)]
    g = t64(rng.standard_normal((m, m)))
    kin = ins[:2] + [t.to(dtype) for t in ins[2:]]
    kg = g.to(dtype)
    pin, pg = [t.to(f64) for t in kin], kg.to(f64)
    flags = _build.row_flags(needs)
    name = "psi2_bwd_" + ("float64" if dtype == f64 else "float32")
    before = ps_ops.LAUNCHES[name]

    def kernel():
        return torch.ops.repro_torch.psi2_bwd(*kin, kg, flags)
    got, again = kernel(), kernel()
    if ps_ops.LAUNCHES[name] != before + 2:
        raise AssertionError("psi2_bwd: the operator did not launch the "
                             "kernel once a call")
    got = [t if need else None for t, need in zip(got, needs)]
    again = [t if need else None for t, need in zip(again, needs)]
    plain = ps_ops.psi2_vjp(*pin, pg, list(needs))
    plain_abs = ps_ref.psi2_vjp_ref(*pin, pg, list(needs), absolute=True)
    label = f"psi2_bwd {dtype} n={n} m={m} q={q} shift={shift}"
    out = {"shape": dict(n=n, m=m, q=q), "dtype": str(dtype), "shift": shift,
           "needs": list(needs),
           "max_abs_err": hold_backward(label, got, again, plain, plain_abs,
                                        dtype)}
    del plain, plain_abs
    if timed:
        out["ms"] = time_ms(kernel)
        out["plain_ms"] = time_ms(
            lambda: ps_ops.psi2_vjp(*pin, pg, list(needs)), reps=3)
        args = ps_ops.psi2_bwd_launch_args(*kin, kg, flags,
                                           _build.sm_count(kg.device))

        def bare():
            ps_k.psi2_bwd(*args)
        out["launch_only_ms"] = time_ms(bare)
        out["device_ms"] = graph_ms(bare)
        out["kernels_us"] = kernel_split(bare)
        del args
        pairs = m * (m + 1) // 2
        fm = torch.randn((n, pairs), dtype=f64, device=DEV)
        zb = torch.randn((pairs, 2 * q), dtype=f64, device=DEV)
        out["yardstick_ms"] = time_ms(lambda: torch.matmul(fm, zb))
        del fm, zb
        out["bound_ms"], out["bound_by"] = psi2_bwd_bound(n, m, q, dtype,
                                                          peaks)
    print(f"psi2_bwd {out}", flush=True)
    return out


def check_backwards(rs_ops, rs_ref, ps_ops, ps_ref, peaks, sgpr, usps,
                    synth) -> dict:
    """Phase 2's backward kernels: each instantiation at full width
    against the chunked recompute (timed at sgpr-synth-1m, gplvm-usps and
    gplvm-synth-100k), then untimed with every input's gradient asked for
    at ragged shapes (m off the 128-point tiles and psi2's 8-point
    patches, m past the reg_stats cluster's 1,024 points and psi1's
    256-column tile, q past one 16-feature chunk, d past 8, n below one
    row tile, masked rows) and at gplvm-usps's shape with mu and z
    shifted by +100 (psi2 and psi1).  Returns the timed results by
    label."""
    out = {}
    every = (True,) * 6
    for dtype in (torch.float32, torch.float64):
        tag = "f64" if dtype == torch.float64 else "f32"
        out[f"reg_stats {tag} {sgpr.name}"] = check_reg_stats_bwd(
            rs_ops, rs_ref, peaks, sgpr.n, sgpr.m, sgpr.q, sgpr.d, dtype,
            masked=False, timed=True)
        torch.cuda.empty_cache()
        out[f"psi2 {tag} {usps.name}"] = check_psi2_bwd(
            ps_ops, ps_ref, peaks, usps.n, usps.m, usps.q, dtype,
            masked=False, timed=True)
        out[f"psi2 {tag} {synth.name}"] = check_psi2_bwd(
            ps_ops, ps_ref, peaks, synth.n, synth.m, synth.q, dtype,
            masked=False, timed=True)
        check_psi2_bwd(ps_ops, ps_ref, peaks, usps.n, usps.m, usps.q, dtype,
                       masked=True, timed=False, needs=(True,) * 6,
                       shift=100.0)
        for n, m, q, d in ((100_003, 130, 3, 5), (20_011, 257, 20, 9),
                           (77, 64, 8, 1), (5_003, 2_048, 8, 4),
                           (3_001, 1_030, 3, 2)):
            check_reg_stats_bwd(rs_ops, rs_ref, peaks, n, m, q, d, dtype,
                                masked=True, timed=False, needs=every)
        for n, m, q in ((1_003, 151, 10), (1_003, 65, 18), (33, 1, 1),
                        (2_001, 63, 2)):
            check_psi2_bwd(ps_ops, ps_ref, peaks, n, m, q, dtype,
                           masked=True, timed=False, needs=every)
        out[f"psi1 {tag} {usps.name}"] = check_psi1_bwd(
            ps_ops, ps_ref, peaks, usps.n, usps.m, usps.q, dtype, timed=True)
        out[f"psi1 {tag} {synth.name}"] = check_psi1_bwd(
            ps_ops, ps_ref, peaks, synth.n, synth.m, synth.q, dtype,
            timed=True)
        for n, m, q in ((1_003, 37, 160), (1_003, 300, 18), (33, 257, 5),
                        (2_001, 63, 2), (1, 1, 1)):
            check_psi1_bwd(ps_ops, ps_ref, peaks, n, m, q, dtype,
                           timed=False)
        check_psi1_bwd(ps_ops, ps_ref, peaks, usps.n, usps.m, usps.q, dtype,
                       timed=False, shift=100.0)
        torch.cuda.empty_cache()
    return out


def f32_gp_counters() -> tuple:
    """(name, counter, key) of the f32 GP instantiations.  No main path
    takes them: phase 3 zeroes their keys once before its first path and
    reads them once after its last, and ``reset_counts`` leaves them be."""
    from repro_torch.kernels.psi_stats import ops as ps_ops
    from repro_torch.kernels.reg_stats import ops as rs_ops

    return (("reg_stats_f32", rs_ops.LAUNCHES, "float32"),
            ("reg_stats_bwd_f32", rs_ops.LAUNCHES, "bwd_float32"),
            ("psi2_f32", ps_ops.LAUNCHES, "psi2_float32"),
            ("psi2_bwd_f32", ps_ops.LAUNCHES, "psi2_bwd_float32"),
            ("psi1_f32", ps_ops.LAUNCHES, "psi1_float32"),
            ("psi1_bwd_f32", ps_ops.LAUNCHES, "psi1_bwd_float32"))


def reset_counts(*counts):
    """Zero every key of ``counts`` but the f32 GP instantiations'."""
    keep = {(id(c), k) for _, c, k in f32_gp_counters()}
    for c in counts:
        for k in c:
            if (id(c), k) not in keep:
                c[k] = 0


def timed_step(steps):
    """``step(name, fn)``: run ``fn`` between synchronisations and record
    its host time in ``steps[name]``."""
    def step(name, fn):
        torch.cuda.synchronize()
        s = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        steps[name] = step.last = time.perf_counter() - s
        return out
    return step


def rel_diff(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def check_value_and_grad(label, model, plain_neg, step, report,
                         reordered=()):
    """The model's ``_neg_vg`` (the kernels forward and backward; psi1's
    backward the chunked plain recompute) against the value and gradient
    of ``plain_neg`` by plain autograd, at the model's params: relative
    difference (normwise for the gradient) <= GRAD_RTOL.

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
    # one evaluation's card time (CUDA events, median of 5), beside phase
    # 2's forward and backward kernels at this shape
    report["sgpr_neg_vg_ms"] = time_ms(model._neg_vg, reps=5)
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
                "reg_stats_bwd_f64": rs_ops.LAUNCHES["bwd_float64"],
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
    # what phase 3f serves again: the loaded f64 state, the 65,536 queries
    # and their plain f64 answers (noise included)
    carry = {"state": loaded, "queries": queries[-1], "plain": plain[2],
             "std_y": ystd, "sf2": sf2, "model": model}
    return launches, carry


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
    report["gplvm_neg_vg_ms"] = time_ms(model._neg_vg, reps=5)
    check_fit("gplvm", model, GPLVM_FIT_ITERS, step, report)
    state = step("gplvm_predictive_state_s", model.predictive_state)
    eng = rt.PredictEngine(state, block_size=256, device=DEV)
    mean, var = step(f"gplvm_predict_t{cfg.n}_s", lambda: eng.predict(
        model.params["mu"], include_noise=True))
    launches = {"psi2_f64": ps_ops.LAUNCHES["psi2_float64"],
                "psi2_bwd_f64": ps_ops.LAUNCHES["psi2_bwd_float64"],
                "psi1_bwd_f64": ps_ops.LAUNCHES["psi1_bwd_float64"],
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
    return launches, model


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


def spawn_ranks(world, shape, device, target=None) -> list[dict]:
    """Run ``target`` (default ``dist_rank``) as ``target(rank, world,
    store_path, out_dir, shape, device)`` in ``world`` spawned processes;
    every one must exit 0 before DIST_DEADLINE_S.  Returns their
    ``rank<k>.npz`` results; kills what is left running."""
    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory() as tmp:
        procs = [ctx.Process(target=target or dist_rank, args=(
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
            raise AssertionError(f"ranks: exit codes {codes} "
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
                "reg_stats_bwd_f64": rs_ops.LAUNCHES["bwd_float64"],
                "psi2_f64": ps_ops.LAUNCHES["psi2_float64"],
                "psi2_bwd_f64": ps_ops.LAUNCHES["psi2_bwd_float64"],
                "psi1_bwd_f64": ps_ops.LAUNCHES["psi1_bwd_float64"],
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


# -- phase 3e: SVI and host streaming, the paper's 2M-row flight regression ---

# examples/flight_scale.py's defaults, uncut: flight_like (q 8, d 1), m 64,
# 2,048-row blocks, one block a chunk, 4 chunks an SVI step, 60 steps;
# 40,960 flight_like(seed=99) queries served in batches of 4,096.
FLIGHT_N, FLIGHT_M, FLIGHT_CHUNK = 2_000_000, 64, 2048
FLIGHT_BATCH_CHUNKS, FLIGHT_STEPS, FLIGHT_LR = 4, 60, 2e-2
FLIGHT_QUERIES, FLIGHT_QUERY_BATCH = 40_960, 4096
STREAM_RANKS_N = 262_144   # the 4-rank check's n (its only cut)
STREAM_SEED = 1            # the SVI draws' generator seed
# SVI on the paper's models: (steps, lr, chunk_size, batch_blocks)
SGPR_SVI = (5, 1e-2, 1024, 4)
GPLVM_SVI = (5, 1e-2, 1024, 2)
SVI_ENGINE_CHUNK = 1000    # divides sgpr-synth-1m's n: the sampled n is n


class TimedSource:
    """A block source whose reads add their seconds to ``seconds`` (in the
    prefetch worker's thread): the host reads of a streamed pass alone."""

    def __init__(self, src):
        self.src, self.n, self.fields, self.seconds = src, src.n, src.fields, 0.0

    def read(self, start, stop):
        t0 = time.perf_counter()
        out = self.src.read(start, stop)
        self.seconds += time.perf_counter() - t0
        return out


def device_busy_s(fn) -> float:
    """Seconds of device time of every kernel and copy ``fn`` issues
    (``torch.profiler``, CUDA activity only): the card's busy time,
    whatever the host's; 0.0 where the profiler sees no device."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))
               for e in prof.key_averages()) / 1e6


def flight_params(device):
    """examples/flight_scale.py's initial (hyp, z): z from the first rows'
    covariates, drawn with rng(0)."""
    from repro_torch.data import flight_like

    first = flight_like(n=FLIGHT_M + 256, seed=0).read(0, max(FLIGHT_M, 256))
    z0 = first["mu"][np.random.default_rng(0).choice(first["mu"].shape[0],
                                                     FLIGHT_M, replace=False)]
    return ({"log_sf2": t64(0.0, device), "log_ell": t64(np.zeros(8), device),
             "log_beta": t64(1.0, device)}, t64(z0, device))


def flat_grads(hyp, z):
    """(hyp, z) gradients as one vector in ``core.flat`` order."""
    from repro_torch.core.flat import Flat

    tree = {"hyp": hyp, "z": z}
    return Flat(tree).ravel(tree)


def stream_rank(rank, world, store_path, out_dir, n, device):
    """One rank of phase 3e's gloo run (a spawned process): an exact
    streamed bound over flight_like(n) (after one untimed set-up pass; its
    rows read and launches counted) and a streamed SVI step drawn from a
    generator seeded STREAM_SEED on every rank (after one untimed);
    writes ``rank<k>.npz``."""
    import datetime

    sys.path.insert(0, str(ROOT / "src"))
    import torch.distributed as dist

    from repro_torch.core.distributed import DistributedGP
    from repro_torch.data import flight_like
    from repro_torch.kernels.reg_stats import ops as rs_ops
    from repro_torch.launch import make_data_group

    torch.backends.cuda.matmul.allow_tf32 = False
    group = make_data_group(device, backend="gloo",
                            store=dist.FileStore(store_path, world),
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(
                                seconds=DIST_GROUP_TIMEOUT_S))
    eng = DistributedGP(group, chunk_size=FLIGHT_CHUNK, device=device)
    stream = eng.put_data(stream=flight_like(n=n, seed=0))
    hyp, z = flight_params(device)
    eng.streamed_bound(hyp, z, stream, d=1)   # first call: set-up
    eng.rows_read = 0
    reset_counts(rs_ops.LAUNCHES)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    bound = float(eng.streamed_bound(hyp, z, stream, d=1))
    t_bound = time.perf_counter() - t0
    rows, launches = eng.rows_read, rs_ops.LAUNCHES["float64"]
    step = eng.streamed_svi_value_and_grad(1, FLIGHT_BATCH_CHUNKS)
    step(hyp, z, stream, torch.Generator().manual_seed(STREAM_SEED))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    v, (gh, gz) = step(hyp, z, stream,
                       torch.Generator().manual_seed(STREAM_SEED))
    t_step = time.perf_counter() - t0
    np.savez(pathlib.Path(out_dir) / f"rank{rank}.npz", bound=bound,
             value=float(v), grad=flat_grads(gh, gz), rows_read=rows,
             pass_launches=launches, launches=rs_ops.LAUNCHES["float64"],
             n_chunks=stream.n_chunks, bound_s=t_bound, step_s=t_step)
    dist.destroy_process_group()


def stream_ranks_reference(eng) -> dict:
    """``eng``'s world of one over flight_like(STREAM_RANKS_N): the exact
    streamed bound, and the SVI step over the rows of the DIST_WORLD ranks'
    step (its chunks k * n_chunks + c for the ranks' chunks c, k the rank;
    the same n_chunks / B scale)."""
    from repro_torch.core.stats import sample_block_indices
    from repro_torch.data import flight_like

    n = STREAM_RANKS_N
    hyp, z = flight_params(DEV)
    stream = eng.put_data(stream=flight_like(n=n, seed=0))
    bound = float(eng.streamed_bound(hyp, z, stream, d=1))
    nc = stream.n_chunks // DIST_WORLD
    picked = sample_block_indices(torch.Generator().manual_seed(STREAM_SEED),
                                  nc, FLIGHT_BATCH_CHUNKS).tolist()
    same_rows = [k * nc + c for c in picked for k in range(DIST_WORLD)]
    v, (gh, gz) = eng.streamed_svi_value_and_grad(1, len(same_rows))(
        hyp, z, stream, same_rows)
    return {"n": n, "bound": bound, "value": float(v),
            "grad": flat_grads(gh, gz)}


def check_stream_ranks(ref, report) -> int:
    """DIST_WORLD gloo ranks on the one card streaming flight_like(
    STREAM_RANKS_N), each reading only its n / DIST_WORLD rows: the bound
    and the SVI step bitwise equal on every rank, and within 1e-9 (value) /
    GRAD_RTOL (gradient) of the world of one (``ref``).  Returns the ranks'
    reg_stats launches."""
    n, bound1, v1, g1 = ref["n"], ref["bound"], ref["value"], ref["grad"]
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    res = spawn_ranks(DIST_WORLD, n, str(torch.device(DEV, 0)),
                      target=stream_rank)
    report["four_ranks_wall_s"] = time.perf_counter() - t0
    for r, rr in enumerate(res[1:], 1):
        for k in ("bound", "value", "grad"):
            if rr[k].tobytes() != res[0][k].tobytes():
                raise AssertionError(f"phase 3e: rank {r}'s {k} differs from "
                                     "rank 0's")
    rows = [int(rr["rows_read"]) for rr in res]
    if rows != [n // DIST_WORLD] * DIST_WORLD:
        raise AssertionError(f"phase 3e: rows read per rank {rows}, not "
                             f"{n // DIST_WORLD} each")
    launches = [int(rr["pass_launches"]) for rr in res]
    if launches != [int(res[0]["n_chunks"])] * DIST_WORLD:
        raise AssertionError(f"phase 3e: reg_stats launches per rank in an "
                             f"exact pass {launches}")
    db = abs(float(res[0]["bound"]) - bound1) / abs(bound1)
    dv = abs(float(res[0]["value"]) - v1) / abs(v1)
    dg = rel_diff(res[0]["grad"], g1)
    report["four_ranks"] = {
        "n": n, "rows_read_per_rank": rows, "exact_pass_launches": launches,
        "bound_rel_diff": db, "svi_value_rel_diff": dv,
        "svi_grad_rel_diff": dg, "bitwise_equal_on_every_rank": True,
        "bound_s": [float(rr["bound_s"]) for rr in res],
        "svi_step_s": [float(rr["step_s"]) for rr in res]}
    if not (db <= 1e-9 and dv <= 1e-9 and dg <= GRAD_RTOL):
        raise AssertionError(f"phase 3e ranks: bound {db:.3e} / value "
                             f"{dv:.3e} / gradient {dg:.3e} against the "
                             "world of one")
    return int(sum(int(rr["launches"]) for rr in res))


def svi_models(rt, cfg, usps, report, count) -> None:
    """``SGPR.fit_svi`` at ``cfg`` and ``BayesianGPLVM.fit_svi`` at
    ``usps`` (the exact bound must rise), and ``DistributedGP(batch_blocks)``
    with explicit block indices against the SGPR's SVI objective."""
    from repro_torch.core.distributed import DistributedGP
    from repro_torch.core.stats import sample_block_indices
    from repro_torch.data import usps_like
    from repro_torch.train.svi import value_and_grad

    x, y, z, hyp = sgpr_inputs(cfg.n, cfg.q, cfg.d, cfg.m)
    steps, lr, chunk, bb = SGPR_SVI
    model = rt.SGPR(x, y, hyp=hyp, z=z, chunk_size=chunk, batch_blocks=bb,
                    device=DEV)
    b0 = model.log_bound()
    res = count("sgpr_fit_svi", lambda: model.fit_svi(steps=steps, lr=lr))
    b1 = model.log_bound()
    report["sgpr_fit_svi"] = {"bound_before": b0, "bound_after": b1,
                              "history": res.history}
    if not (math.isfinite(b1) and b1 > b0):
        raise AssertionError(f"phase 3e: SGPR.fit_svi moved the exact bound "
                             f"{b0} -> {b1}")
    del model

    yl, _ = usps_like(np.random.default_rng(SEED), usps.n)
    steps, lr, chunk, bb = GPLVM_SVI
    gm = rt.BayesianGPLVM(yl, q=usps.q, num_inducing=usps.m,
                          chunk_size=chunk, batch_blocks=bb, device=DEV)
    b0 = gm.log_bound()
    res = count("gplvm_fit_svi", lambda: gm.fit_svi(steps=steps, lr=lr))
    b1 = gm.log_bound()
    report["gplvm_fit_svi"] = {"bound_before": b0, "bound_after": b1,
                               "history": res.history}
    if not (math.isfinite(b1) and b1 > b0):
        raise AssertionError(f"phase 3e: BayesianGPLVM.fit_svi moved the "
                             f"exact bound {b0} -> {b1}")
    del gm

    # the engine's SVI step against the SGPR's SVI objective, same blocks
    bb = SGPR_SVI[3]
    eng = DistributedGP(chunk_size=SVI_ENGINE_CHUNK, batch_blocks=bb,
                        device=DEV)
    data, w = eng.put_data(y=y, mu=x)
    idx = sample_block_indices(torch.Generator().manual_seed(STREAM_SEED),
                               cfg.n // SVI_ENGINE_CHUNK, bb)
    params = {"hyp": {k: t64(v) for k, v in hyp.items()}, "z": t64(z)}
    v, (gh, gz) = count("dist_svi_step", lambda: eng.make_value_and_grad(
        cfg.d)(params["hyp"], params["z"], data["mu"], None, data["y"], w,
               np.ones(1), float(cfg.n), idx))
    ref = rt.SGPR(x, y, hyp=hyp, z=z, chunk_size=SVI_ENGINE_CHUNK,
                  device=DEV)
    vr, gr = value_and_grad(lambda p: ref._neg_bound(
        p, batch_blocks=bb, block_indices=idx), params)
    dv = abs(float(v) - float(vr)) / abs(float(vr))
    dg = rel_diff(flat_grads(gh, gz), flat_grads(gr["hyp"], gr["z"]))
    report["dist_svi_vs_sgpr_objective"] = {"value_rel_diff": dv,
                                            "grad_rel_diff": dg}
    if not (dv <= 1e-9 and dg <= GRAD_RTOL):
        raise AssertionError(f"phase 3e: DistributedGP SVI value {dv:.3e} / "
                             f"gradient {dg:.3e} against SGPR's objective")


def streaming_path(rt, cfg, usps) -> dict:
    """Phase 3e: the paper's 2M-row flight regression streamed from host
    through ``DistributedGP`` in a world of one over NCCL (60 SVI steps
    between two exact streamed bounds, the streamed predictive state, a
    served query stream), each streamed result against the in-memory
    engine on the same rows; SVI on the paper's models; then DIST_WORLD
    gloo ranks streaming on the one card (``check_stream_ranks``).

    The generator runs three exact passes over the 2M rows (the bounds
    before and after, the state) and materialises them once for the
    in-memory engine; the other streamed checks read the materialised rows
    (``ArraySource``), so they pay no generation."""
    import torch.distributed as dist

    from repro_torch.core.distributed import DistributedGP
    from repro_torch.data import flight_like
    from repro_torch.data.stream import ArraySource, prefetch, stage_to_device
    from repro_torch.kernels.predict import ops as p_ops
    from repro_torch.kernels.psi_stats import ops as ps_ops
    from repro_torch.kernels.reg_stats import ops as rs_ops
    from repro_torch.launch import make_data_group
    from repro_torch.train.svi import adam_init, adam_step

    steps, report = {}, {}
    step = timed_step(steps)

    def counts():
        return {"reg_stats_f64": rs_ops.LAUNCHES["float64"],
                "reg_stats_bwd_f64": rs_ops.LAUNCHES["bwd_float64"],
                "predict_f64": p_ops.LAUNCHES["float64"],
                "psi2_f64": ps_ops.LAUNCHES["psi2_float64"],
                "psi2_bwd_f64": ps_ops.LAUNCHES["psi2_bwd_float64"],
                "psi1_bwd_f64": ps_ops.LAUNCHES["psi1_bwd_float64"],
                "psi1_f64": ps_ops.LAUNCHES["psi1_float64"]}

    # Only the port's own calls count, not the in-memory and plain
    # references run beside them.
    launches = {k: 0 for k in counts()}
    per_call = {}

    def count(name, fn):
        """``step(name, fn)``, its launches added to ``launches``."""
        before = counts()
        out = step(name, fn)
        per_call[name] = {k: c - before[k] for k, c in counts().items()}
        for k, c in per_call[name].items():
            launches[k] += c
        return out

    reset_counts(rs_ops.LAUNCHES, p_ops.LAUNCHES, ps_ops.LAUNCHES)
    group = make_data_group(DEV)
    try:
        eng = DistributedGP(group, chunk_size=FLIGHT_CHUNK, device=DEV)
        src = TimedSource(flight_like(n=FLIGHT_N, seed=0))
        stream = eng.put_data(stream=src, blocks_per_chunk=1)
        nc = stream.n_chunks
        hyp, z = flight_params(DEV)
        params = {"hyp": hyp, "z": z}

        # -- exact pass 1: the bound before, its host reads alone -------------
        src.seconds, eng.rows_read = 0.0, 0
        before = float(count("exact_pass_bound_before_s", lambda:
                             eng.streamed_bound(hyp, z, stream, d=1)))
        report["exact_pass"] = {
            "s": steps["exact_pass_bound_before_s"],
            "host_reads_s": src.seconds, "rows_read": eng.rows_read,
            "reg_stats_launches": per_call["exact_pass_bound_before_s"][
                "reg_stats_f64"]}
        if per_call["exact_pass_bound_before_s"]["reg_stats_f64"] != nc \
                or eng.rows_read != FLIGHT_N:
            raise AssertionError(f"phase 3e: an exact pass launched "
                                 f"{report['exact_pass']} (expected {nc} "
                                 f"launches, {FLIGHT_N} rows)")

        # -- 60 streamed SVI Adam steps, FLIGHT_BATCH_CHUNKS chunks each --------
        svi = eng.streamed_svi_value_and_grad(1, FLIGHT_BATCH_CHUNKS)
        gen = torch.Generator().manual_seed(STREAM_SEED)
        opt = adam_init(params)
        history = []

        def run_svi():
            nonlocal params, opt
            for _ in range(FLIGHT_STEPS):
                v, (gh, gz) = svi(params["hyp"], params["z"], stream, gen)
                params, opt = adam_step(params, {"hyp": gh, "z": gz}, opt,
                                        lr=FLIGHT_LR)
                history.append(-float(v))
        count(f"svi_{FLIGHT_STEPS}_steps_s", run_svi)
        dt = steps[f"svi_{FLIGHT_STEPS}_steps_s"]
        rows = FLIGHT_STEPS * FLIGHT_BATCH_CHUNKS * stream.chunk_rows
        report["svi"] = {"steps": FLIGHT_STEPS, "s": dt,
                         "rows_per_s_touched": rows / dt,
                         "stochastic_bounds": history[::10] + history[-1:]}
        want = FLIGHT_STEPS * FLIGHT_BATCH_CHUNKS
        if per_call[f"svi_{FLIGHT_STEPS}_steps_s"]["reg_stats_f64"] != want:
            raise AssertionError(f"phase 3e: SVI launched "
                                 f"{per_call[f'svi_{FLIGHT_STEPS}_steps_s']}"
                                 " (expected "
                                 f"{want} reg_stats)")
        hyp, z = params["hyp"], params["z"]

        # -- exact passes 2 and 3: the bound after, the predictive state -------
        after = float(count("exact_pass_bound_after_s", lambda:
                            eng.streamed_bound(hyp, z, stream, d=1)))
        report["bound_before_after"] = (before, after)
        if not (math.isfinite(after) and after > before):
            raise AssertionError(f"phase 3e: SVI moved the exact bound "
                                 f"{before} -> {after}")
        state = count("exact_pass_predictive_state_s", lambda:
                      eng.streamed_predictive_state(hyp, z, stream))

        # -- the in-memory engine on the same rows ------------------------------
        rows = step("host_generation_2m_s",
                    lambda: flight_like(n=FLIGHT_N, seed=0).read(0, FLIGHT_N))
        mem = ArraySource(rows)
        data, w = eng.put_data(y=rows["y"], mu=rows["mu"])
        ones = np.ones(1)
        st_mem = step("in_memory_reduced_stats_s", lambda: eng.reduced_stats(
            1)(hyp, z, data["y"], data["mu"], None, w, ones))
        b_mem = float(eng.bound_fn(1)(hyp, z, data["y"], data["mu"], None, w,
                                      ones, float(FLIGHT_N)))
        st_str = count("array_pass_streamed_stats_s", lambda:
                       eng.streamed_stats(hyp, z, eng.open_stream(mem)))
        # Where a streamed chunk's host time goes: the staging alone (host
        # reads, pinned copy, side-stream copy; no fold), and the pass with
        # 8 blocks a chunk (a chunk's costs spread over 8 blocks).
        stager = stage_to_device(DEV)

        def staging_only():
            for staged in prefetch(eng.open_stream(mem).chunks(), stager):
                stager.ready(staged)
        step("array_staging_only_s", staging_only)
        st_8 = count("array_pass_8_blocks_a_chunk_s", lambda:
                     eng.streamed_stats(hyp, z, eng.open_stream(
                         mem, blocks_per_chunk=8)))
        busy = device_busy_s(lambda: eng.streamed_stats(
            hyp, z, eng.open_stream(mem)))
        report["array_pass_device"] = {
            "busy_s": busy,
            "busy_share": busy / steps["array_pass_streamed_stats_s"]}
        ps_mem = eng.predictive_state(hyp, z, data["y"], data["mu"], None, w)
        bitwise = {
            "streamed_stats": all(torch.equal(a, b)
                                  for a, b in zip(st_str, st_mem)),
            "streamed_stats_8_blocks_a_chunk": all(
                torch.equal(a, b) for a, b in zip(st_8, st_mem)),
            "streamed_bound": after == b_mem,
            "streamed_predictive_state": all(
                torch.equal(getattr(state, f), getattr(ps_mem, f))
                for f in STATE_FIELDS)}
        report["bitwise_in_memory"] = bitwise
        if not all(bitwise.values()):
            raise AssertionError(f"phase 3e: streamed against in memory "
                                 f"{bitwise}")
        v_mem, (gh, gz) = step("in_memory_value_and_grad_s", lambda:
                               eng.make_value_and_grad(1)(
                                   hyp, z, data["mu"], None, data["y"], w,
                                   ones, float(FLIGHT_N)))
        g_mem = flat_grads(gh, gz)
        v_str, (gh, gz) = count("array_passes_value_and_grad_s", lambda:
                                eng.streamed_value_and_grad(1)(
                                    hyp, z, eng.open_stream(mem)))
        dg_str = rel_diff(flat_grads(gh, gz), g_mem)
        v_full, (gh, gz) = count("array_pass_svi_full_batch_s", lambda:
                                 eng.streamed_svi_value_and_grad(1, nc)(
                                     hyp, z, eng.open_stream(mem),
                                     torch.Generator()))
        dv_full = abs(float(v_full) - float(v_mem)) / abs(float(v_mem))
        dg_full = rel_diff(flat_grads(gh, gz), g_mem)
        report["streamed_vs_in_memory"] = {
            "value_and_grad": {"value_bitwise": float(v_str) == float(v_mem),
                               "grad_rel_diff": dg_str},
            "svi_full_batch": {"value_rel_diff": dv_full,
                               "grad_rel_diff": dg_full}}
        if not (float(v_str) == float(v_mem) and dg_str <= GRAD_RTOL
                and dv_full <= 1e-12 and dg_full <= GRAD_RTOL):
            raise AssertionError(f"phase 3e: {report['streamed_vs_in_memory']}")
        for name, want in (("array_passes_value_and_grad_s", 2 * nc),
                           ("array_pass_svi_full_batch_s", nc)):
            if per_call[name]["reg_stats_f64"] != want:
                raise AssertionError(f"phase 3e: {name} launched "
                                     f"{per_call[name]} (expected {want})")

        # -- serving: a query stream through predict_stream -------------------
        serve = rt.PredictEngine(state, block_size=512, device=DEV)
        q_src = flight_like(n=FLIGHT_QUERIES, seed=99)
        batches = [q_src.read(i, i + FLIGHT_QUERY_BATCH)["mu"]
                   for i in range(0, FLIGHT_QUERIES, FLIGHT_QUERY_BATCH)]
        served = count("predict_stream_s", lambda: list(
            serve.predict_stream(iter(batches), include_noise=True)))
        if per_call["predict_stream_s"]["predict_f64"] < len(batches):
            raise AssertionError(f"phase 3e: predict_stream launched "
                                 f"{per_call['predict_stream_s']}")
        for xb, (mean, var) in zip(batches, served):
            m_ref, v_ref = serve.predict(xb, include_noise=True)
            if not (torch.equal(mean, m_ref) and torch.equal(var, v_ref)):
                raise AssertionError("phase 3e: a predict_stream batch "
                                     "differs from predict")
        plain_lb, plain = plain_serving(
            hyp, z, data["mu"][:FLIGHT_N], data["y"][:FLIGHT_N],
            [torch.from_numpy(b).to(DEV, torch.float64) for b in batches])
        mean = torch.cat([m for m, _ in served])
        var = torch.cat([v for _, v in served])
        pm = torch.cat([m for m, _ in plain])
        pv = torch.cat([v for _, v in plain])
        sf2 = float(torch.exp(hyp["log_sf2"]))
        mr = rmse(mean, pm) / float(np.std(rows["y"]))
        vr = rmse(var, pv) / sf2
        report["served"] = {"queries": FLIGHT_QUERIES,
                            "mean_rmse_over_std_y": mr,
                            "var_rmse_over_sf2": vr,
                            "plain_log_bound": plain_lb}
        if mean.shape != (FLIGHT_QUERIES, 1) or not (
                bool(torch.isfinite(mean).all())
                and bool(torch.isfinite(var).all())) \
                or mr > MEAN_BUDGET or vr > VAR_BUDGET:
            raise AssertionError(f"phase 3e: served {report['served']}")
        del data, w, serve, st_mem, st_str, st_8
        torch.cuda.empty_cache()

        # -- SVI on the paper's models -----------------------------------------
        svi_models(rt, cfg, usps, report, count)
        if per_call["gplvm_fit_svi"]["psi2_f64"] < GPLVM_SVI[0] \
                or per_call["gplvm_fit_svi"]["psi1_f64"] < GPLVM_SVI[0]:
            raise AssertionError(f"phase 3e: GPLVM fit_svi launched "
                                 f"{per_call['gplvm_fit_svi']}")
        ref = stream_ranks_reference(eng)
    finally:
        dist.destroy_process_group()
    launches["reg_stats_f64"] += check_stream_ranks(ref, report)
    print(f"streaming path (3e) steps (s): {json.dumps(steps)}", flush=True)
    print(f"streaming path (3e) launches per call: {json.dumps(per_call)}",
          flush=True)
    print(f"streaming path (3e): {json.dumps(report)}", flush=True)
    print(f"streaming path (3e) launches: {json.dumps(launches)}", flush=True)
    for name, c in launches.items():
        if c < 1:
            raise AssertionError(f"kernel {name} was not launched on the "
                                 "streaming path")
    return launches


# -- phase 3f: sharded and quantized serving, the GPLVM's reconstruction ------

SHARD_WORLD = 4          # gloo ranks sharing the one card
CKPT_STEPS, CKPT_KEEP = 4, 2
RECON_T, RECON_ITERS, RECON_FRAC = 100, 50, 0.34   # paper §4.5's protocol
MXU_RTOL = 1e-10         # the psi2_mxu forms' D against the kernel's
QUANT_DTYPES = (torch.bfloat16, torch.float16, torch.float32)


def serve_rank(rank, world, store_path, out_dir, paths, device):
    """One rank of phase 3f's gloo run (a spawned process): the saved
    state and queries, sharded over the ranks by ``PredictEngine(group=)``;
    counts its predict launches and the rows its plain calls saw, and
    writes ``rank<k>.npz``."""
    import datetime

    sys.path.insert(0, str(ROOT / "src"))
    import torch.distributed as dist

    from repro_torch.kernels.predict import ops as p_ops
    from repro_torch.launch import make_data_group
    from repro_torch.serve import PredictEngine, load_state, posterior

    group = make_data_group(device, backend="gloo",
                            store=dist.FileStore(store_path, world),
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(
                                seconds=DIST_GROUP_TIMEOUT_S))
    state_path, query_path = paths
    state, _ = load_state(state_path, device=device)
    xq = np.load(query_path)
    rows = []
    plain = posterior.predict_mean_var

    def counted(st, x):
        rows.append(x.shape[0])
        return plain(st, x)
    posterior.predict_mean_var = counted
    eng = PredictEngine(state, block_size=256, device=device, group=group)
    eng.predict(xq[:1024])                        # first call: set-up
    reset_counts(p_ops.LAUNCHES)
    rows.clear()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mean, var = eng.predict(xq, include_noise=True)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    dist.barrier()
    gather_ms = time_ms(lambda: eng._gather(mean[:xq.shape[0] // world],
                                            var[:xq.shape[0] // world]))
    np.savez(pathlib.Path(out_dir) / f"rank{rank}.npz",
             mean=mean.cpu().numpy(), var=var.cpu().numpy(),
             launches=p_ops.LAUNCHES["float64"], rows=sum(rows),
             calls=len(rows), seconds=seconds, gather_ms=gather_ms)
    dist.destroy_process_group()


def plain_quantized(qs, xq, noise):
    """The plain f64 composition of a quantized state's own values (lifted
    exactly) at the f32-rounded queries: (mean, its |operand| version,
    var, with the noise where ``noise``, its |operand| version), the f32
    tier's references."""
    from repro_torch.kernels.predict import ref as p_ref

    s64 = qs.astype(torch.float64)
    x = torch.from_numpy(np.asarray(xq)).to(DEV).float().double()
    hp = (s64.hyp["log_sf2"], s64.hyp["log_ell"], s64.z)
    mean, quad = p_ref.predict_ref(*hp, s64.a_mean, s64.g, x)
    mabs, qabs = p_ref.predict_ref(*hp, s64.a_mean.abs(), s64.g.abs(), x)
    var = torch.exp(hp[0]) - quad
    return mean, mabs, var + noise * torch.exp(-s64.hyp["log_beta"]), qabs


def serve_quantized(rt, qs, xq, plain64, ystd, sf2, count, label, budgets,
                    noise=True):
    """A quantized state through the engine: f32 compute, one f32 predict
    launch, outputs at the f32 tier of the plain composition of the same
    values; RMSE against the f64 path ``plain64`` (whose variance includes
    the noise where ``noise``), held to the serving budgets where
    ``budgets``."""
    from repro_torch.kernels.predict import ops as p_ops

    eng = rt.PredictEngine(qs, block_size=256, device=DEV)
    before = p_ops.LAUNCHES["float32"]
    qm, qv = count(f"predict_{label}_s",
                   lambda: eng.predict(xq, include_noise=noise))
    launched = p_ops.LAUNCHES["float32"] - before
    pm, pmabs, pv, pvabs = plain_quantized(qs, xq, noise)
    mean_err, _ = check_close(f"phase 3f {label} mean", qm, pm, pmabs)
    var_err, _ = check_close(f"phase 3f {label} var", qv, pv, pvabs)
    mr = rmse(qm, plain64[0]) / ystd
    vr = rmse(qv, plain64[1]) / sf2
    out = {"nbytes": qs.nbytes, "predict_f32_launches": launched,
           "max_abs_err_vs_own_values": [mean_err, var_err],
           "mean_rmse_over_std_y": mr, "var_rmse_over_sf2": vr,
           "within_budgets": mr <= MEAN_BUDGET and vr <= VAR_BUDGET,
           "ms": time_ms(lambda: eng.predict(xq, include_noise=noise))}
    if eng.compute_dtype != torch.float32 or launched != 1 \
            or qm.dtype != torch.float32 \
            or (budgets and not out["within_budgets"]):
        raise AssertionError(f"phase 3f: {label} {out}")
    return out


def quantized_budget_problem(rt, count) -> dict:
    """tests/test_serving_quant.py's fixed problem (n 120, q 2, d 2, m 10,
    fit(40)) on the card: every quantized state within the budgets against
    the f64 engine (variance RMSE absolute, as that test holds it), through
    the f32 predict kernel."""
    rng = np.random.default_rng(0)
    x, y = make_regression(rng, 120, 2, 2)
    model = rt.SGPR(x, y, num_inducing=10, seed=0, device=DEV)
    model.fit(max_iters=40)
    xs = rng.uniform(-2.0, 2.0, size=(200, 2))
    state = model.predictive_state()
    m64, v64 = rt.PredictEngine(state, block_size=64, device=DEV).predict(xs)
    out = {}
    for dt in QUANT_DTYPES:
        name = str(dt).removeprefix("torch.")
        out[name] = serve_quantized(rt, state.astype(dt), xs, (m64, v64),
                                    float(np.std(y)), 1.0, count,
                                    f"{name}_state_budget_problem",
                                    budgets=True, noise=False)
    return out


def check_bitwise(label, got, want):
    for a, b in zip(got, want):
        if not torch.equal(a.to(b.device), b):
            raise AssertionError(f"phase 3f: {label} is not bitwise the "
                                 "world of one's")


def sharded_serving(rt, cfg, sgpr, step, report, count):
    """sgpr-synth-1m's state (phase 3a) served by ``DistributedGP.
    predict_engine`` in a world of one over NCCL, quantized, checkpointed
    with rotation, and sharded over SHARD_WORLD gloo ranks on the card."""
    import torch.distributed as dist

    from repro_torch.checkpoint import AsyncCheckpointer, latest
    from repro_torch.kernels.predict import ops as p_ops
    from repro_torch.launch import make_data_group
    from repro_torch.serve.posterior import state_metadata

    state, xq = sgpr["state"], sgpr["queries"]
    pm, pv = sgpr["plain"]
    t = xq.shape[0]
    plain_eng = rt.PredictEngine(state, block_size=256, device=DEV)
    want = plain_eng.predict(xq, include_noise=True)

    # -- the sharded engine in a world of one over NCCL ---------------------
    group = make_data_group(DEV)
    try:
        eng = rt.DistributedGP(group, device=DEV).predict_engine(
            state, block_size=256)
        got = count("sharded_predict_t65536_s",
                    lambda: eng.predict(xq, include_noise=True))
        check_bitwise("DistributedGP.predict_engine", got, want)
        mean, var = got
        report["world_of_one"] = {
            "backend": dist.get_backend(group),
            "sharded_ms": time_ms(lambda: eng.predict(xq, include_noise=True)),
            "plain_engine_ms": time_ms(lambda: plain_eng.predict(
                xq, include_noise=True)),
            "gather_bytes": t * (cfg.d + 1) * 8,
            "gather_ms": time_ms(lambda: eng._gather(mean, var))}
    finally:
        dist.destroy_process_group()

    # -- quantized states through the f32 kernel ------------------------------
    # At sgpr-synth-1m each state is held to the plain f64 composition of
    # its own (lifted) values at the f32 tier; the f32 state also to the
    # serving budgets against the plain f64 path.  The 16-bit states' RMSE
    # there is recorded: g = Kmm^-1 - Sigma^-1 has entries O(cond(Kmm)),
    # and their storage rounding breaks the budgets at m = 512, in the JAX
    # engine alike (PERF.md).  The budgets bind every state on their own
    # problem, tests/test_serving_quant.py's, fitted on the card.
    ystd, sf2 = sgpr["std_y"], sgpr["sf2"]
    quant = {}
    for dt in QUANT_DTYPES:
        name = str(dt).removeprefix("torch.")
        qs = step(f"astype_{name}_s", lambda dt=dt: state.astype(dt))
        quant[name] = serve_quantized(rt, qs, xq, (pm, pv), ystd, sf2, count,
                                      f"{name}_state_t65536",
                                      budgets=dt == torch.float32)
        if dt == torch.bfloat16 and qs.nbytes * 4 != state.nbytes:
            raise AssertionError(f"phase 3f: bf16 nbytes {qs.nbytes} x 4 != "
                                 f"{state.nbytes}")
        if dt == torch.float16:
            for a, b in zip(qs._leaves(), state._leaves()):
                host = b.cpu().numpy().astype(np.float16)
                if not np.array_equal(a.cpu().numpy().view(np.uint16),
                                      host.view(np.uint16)):
                    raise AssertionError("phase 3f: an f16 leaf differs "
                                         "from numpy's rounding")
    quant["budget_problem"] = quantized_budget_problem(rt, count)
    # torch's own f64 -> f16 cast on the card, beside numpy's (the reason
    # astype rounds f16 on the host)
    a = np.random.default_rng(SEED).standard_normal(1_000_000)
    cast = torch.from_numpy(a).to(DEV).to(torch.float16).cpu().numpy()
    quant["torch_cuda_f16_cast_differs_from_numpy_in"] = int(
        (cast.view(np.uint16) != a.astype(np.float16).view(np.uint16)).sum())
    quant["f64_nbytes"] = state.nbytes
    report["quantized"] = quant

    # -- checkpoints: async writes, rotation, latest, reload -----------------
    with tempfile.TemporaryDirectory() as tmp:
        ck = AsyncCheckpointer()
        times = []
        for k in range(1, CKPT_STEPS + 1):
            t0 = time.perf_counter()
            ck.save(pathlib.Path(tmp) / f"state_step{k}", state,
                    metadata=state_metadata(state, {"step": k}),
                    keep=CKPT_KEEP)
            times.append(time.perf_counter() - t0)
        step("checkpoint_wait_s", ck.wait)
        left = sorted(p.name for p in pathlib.Path(tmp).glob("*.npz"))
        last = latest(tmp, base="state")
        loaded, md = rt.load_state(last, device=DEV)
        report["checkpoints"] = {"left": left, "latest": last.name,
                                 "save_returns_s": times}
        if left != [f"state_step{k}.npz" for k in
                    range(CKPT_STEPS - CKPT_KEEP + 1, CKPT_STEPS + 1)] \
                or last.name != f"state_step{CKPT_STEPS}" \
                or md["step"] != CKPT_STEPS:
            raise AssertionError(f"phase 3f: checkpoints "
                                 f"{report['checkpoints']}")
        reng = rt.PredictEngine(loaded, block_size=256, device=DEV)
        check_bitwise("the reloaded checkpoint",
                      count("checkpoint_predict_t65536_s",
                            lambda: reng.predict(xq, include_noise=True)),
                      want)

        # -- SHARD_WORLD gloo ranks on the card ----------------------------------
        rt.save_state(pathlib.Path(tmp) / "served", state)
        np.save(pathlib.Path(tmp) / "queries.npy", xq)
        torch.cuda.empty_cache()
        res = spawn_ranks(SHARD_WORLD, (str(pathlib.Path(tmp) / "served"),
                                        str(pathlib.Path(tmp) / "queries.npy")),
                          str(torch.device(DEV, 0)), target=serve_rank)
    ranks = {"rows_per_rank": [int(r["rows"]) for r in res],
             "launches_per_rank": [int(r["launches"]) for r in res],
             "predict_s_per_rank": [float(r["seconds"]) for r in res],
             "gather_ms_per_rank": [float(r["gather_ms"]) for r in res],
             "gather_bytes": t * (cfg.d + 1) * 8}
    report["four_gloo_ranks"] = ranks
    if ranks["rows_per_rank"] != [t // SHARD_WORLD] * SHARD_WORLD \
            or ranks["launches_per_rank"] != [1] * SHARD_WORLD:
        raise AssertionError(f"phase 3f: ranks {ranks}")
    for r, rr in enumerate(res):
        check_bitwise(f"rank {r}'s answer",
                      (torch.from_numpy(rr["mean"]),
                       torch.from_numpy(rr["var"])), want)
    return ranks


def gplvm_remainder(rt, usps, model, step, report, count):
    """gplvm-usps's fitted model (phase 3b): the psi2_fn hook in
    ``DistributedGP``, then ``reconstruct`` of 100 held-out digits with a
    third of their pixels missing, then the ``gplvm_embedding`` example."""
    import torch.distributed as dist

    from repro_torch.core import gp_kernels as gpk
    from repro_torch.data import drop_pixels, usps_like
    from repro_torch.examples import gplvm_embedding
    from repro_torch.kernels.psi_stats import psi2_fn_for_engine
    from repro_torch.launch import make_data_group

    p = model.params
    y = model.y.cpu().numpy()
    mu = p["mu"].cpu().numpy()
    s = torch.exp(p["log_s"]).cpu().numpy()
    ones = np.ones(1)
    group = make_data_group(DEV)
    try:
        bounds, d_stat = {}, {}
        for name, fn in (("default", None), ("engine", psi2_fn_for_engine()),
                         ("mxu", gpk.psi2_mxu), ("mxu_sym", gpk.psi2_mxu_sym)):
            eng = rt.DistributedGP(group, latent=True, chunk_size=1024,
                                   device=DEV, psi2_fn=fn)
            data, w = eng.put_data(y=y, mu=mu, s=s)
            args = (p["hyp"], p["z"], data["y"], data["mu"], data["s"], w,
                    ones)
            bound = eng.bound_fn(usps.d)
            bounds[name] = float(count(f"hook_{name}_bound_s", lambda:
                                       bound(*args, float(usps.n))))
            d_stat[name] = eng.reduced_stats(usps.d)(*args).D
    finally:
        dist.destroy_process_group()
    # The hook's own output, D, at the f64 tier of the kernel's; the bound
    # within the repo's limit on f64 bound parity between code paths
    # (1e-8): its conditioning amplifies D's last digits (its sensitivity,
    # the bound's relative move over D's largest relative move, printed).
    ref, dref = bounds["default"], d_stat["default"]
    hook = {"bounds": bounds}
    for k in ("engine", "mxu", "mxu_sym"):
        rel_d = float(((d_stat[k] - dref).abs() / dref.abs()).max())
        rel_b = abs(bounds[k] - ref) / abs(ref)
        hook[k] = {"bound_rel_diff": rel_b, "D_max_rel_diff": rel_d,
                   "sensitivity": rel_b / rel_d if rel_d else None}
    report["psi2_fn"] = hook
    if not math.isfinite(ref) or bounds["engine"] != ref \
            or not torch.equal(d_stat["engine"], dref) \
            or any(hook[k]["D_max_rel_diff"] > MXU_RTOL
                   or hook[k]["bound_rel_diff"] > GRAD_RTOL
                   for k in ("mxu", "mxu_sym")):
        raise AssertionError(f"phase 3f: psi2_fn {hook}")

    # -- reconstruction (paper §4.5) ------------------------------------------
    rng = np.random.default_rng(SEED + 7)
    ytest, _ = usps_like(rng, RECON_T)
    y_masked, observed = drop_pixels(rng, ytest, frac=RECON_FRAC)
    rec = count("reconstruct_s", lambda: model.reconstruct(
        y_masked, observed, iters=RECON_ITERS))
    miss = ~observed
    err = float(np.mean(np.abs(rec[:, miss] - ytest[:, miss])))
    base = float(np.mean(np.abs(y[:, miss].mean(0)[None] - ytest[:, miss])))
    report["reconstruct"] = {"t": RECON_T, "missing_pixels": int(miss.sum()),
                             "iters": RECON_ITERS, "mae_missing": err,
                             "mae_training_mean": base, "ratio": err / base}
    if rec.shape != ytest.shape or not np.isfinite(rec).all() \
            or not err < 0.5 * base:
        raise AssertionError(f"phase 3f: reconstruct {report['reconstruct']}")

    # -- the example at its own size ----------------------------------------------
    with tempfile.TemporaryDirectory() as tmp:
        ratio, eff = count("gplvm_embedding_example_s", lambda:
                           gplvm_embedding.main(["--device", DEV, "--out",
                                                 f"{tmp}/emb.npy"]))
    report["gplvm_embedding"] = {"separation_ratio": ratio,
                                 "effective_dims": eff}
    if not (math.isfinite(ratio) and ratio > 1.0):
        raise AssertionError(f"phase 3f: gplvm_embedding {ratio}")


def serving_remainder_path(rt, cfg, usps, sgpr, gplvm_model) -> dict:
    """Phase 3f: ``sharded_serving`` at sgpr-synth-1m, then
    ``gplvm_remainder`` at gplvm-usps, on the models phases 3a and 3b
    fitted.  Every launch counter is 0 just before and read just after;
    only the port's own calls count."""
    from repro_torch.kernels.predict import ops as p_ops
    from repro_torch.kernels.psi_stats import ops as ps_ops
    from repro_torch.kernels.reg_stats import ops as rs_ops

    steps, report = {}, {}
    step = timed_step(steps)

    def counts():
        return {"predict_f64": p_ops.LAUNCHES["float64"],
                "predict_f32": p_ops.LAUNCHES["float32"],
                "psi2_f64": ps_ops.LAUNCHES["psi2_float64"],
                "psi1_f64": ps_ops.LAUNCHES["psi1_float64"]}

    launches = {k: 0 for k in counts()}
    per_call = {}

    def count(name, fn):
        before = counts()
        out = step(name, fn)
        per_call[name] = {k: c - before[k] for k, c in counts().items()}
        for k, c in per_call[name].items():
            launches[k] += c
        return out

    reset_counts(rs_ops.LAUNCHES, p_ops.LAUNCHES, ps_ops.LAUNCHES)
    try:
        ranks = sharded_serving(rt, cfg, sgpr, step, report, count)
        launches["predict_f64"] += sum(ranks["launches_per_rank"])
        gplvm_remainder(rt, usps, gplvm_model, step, report, count)
        if per_call["reconstruct_s"]["predict_f64"] != 1:
            raise AssertionError(f"phase 3f: reconstruct launched "
                                 f"{per_call['reconstruct_s']}")
    finally:   # what was measured, also when a check failed
        print(f"serving remainder path (3f) steps (s): {json.dumps(steps)}",
              flush=True)
        print(f"serving remainder path (3f) launches per call: "
              f"{json.dumps(per_call)}", flush=True)
        print(f"serving remainder path (3f): {json.dumps(report)}",
              flush=True)
    print(f"serving remainder path (3f) launches: {json.dumps(launches)}",
          flush=True)
    for name, c in launches.items():
        if c < 1:
            raise AssertionError(f"kernel {name} was not launched on the "
                                 "serving remainder path")
    return launches


# -- phase 3g: the kernel zoo and online updates ------------------------------

ONLINE_K, ONLINE_SEED = 2048, 1   # the fresh block: 3a's generator, seed 1
# The reference's tolerances: the refreshed answers against re-extraction
# (tests/test_online_updates.py:209-210) and after a forget against the
# original (:241-242); the Stats back after a forget (:102).
REFRESH_TOL, FORGET_TOL, STATS_BACK_RTOL = (1e-9, 1e-10), (1e-10, 1e-12), 1e-13
# Where a tolerance is out of reach because the computation itself is
# conditioned past it (ROADMAP Queue 3 items 14 and 15), the result is held
# to the plain path's own spread instead: at most SPREAD_FACTOR times the
# distance between two evaluations of the same quantity that differ only in
# the order of their sums.  For the refresh against re-extraction the
# reference's own ratio is <= 1.31 at (n 20,000, m 512) and <= 1.13 at
# sgpr-zoo-trend, normwise (both packages on the CPU, PERF.md section 6).
SPREAD_FACTOR = 4.0
ILLEGIT_ROWS, ILLEGIT_WEIGHT = 15, 50.0   # tests/test_chol_update.py:195-206
ZOO_RTOL = 1e-8   # value and gradient, card against CPU
ZOO_REORDER_CHUNKS = (4096, 65536)   # the CPU path's own reorderings
# SCG rejects its first 7 steps at sgpr-zoo-trend's init, in both packages
# (the bound moves from the 8th iteration on, ROADMAP Queue 3 item 15), so
# 3 iterations leave it where it was; 10 raise it.
ZOO_FIT_ITERS = 10


def tol_use(got, want, rtol, atol) -> float:
    """max |got - want| / (atol + rtol |want|): at most 1 within the
    tolerance."""
    got, want = got.double(), want.double()
    return float(((got - want).abs() / (atol + rtol * want.abs())).max())


def nrel(got, want) -> float:
    """Normwise relative distance ||got - want|| / ||want|| on the card (the
    absolute distance where ``want`` is 0)."""
    diff = float(torch.linalg.norm((got - want).double()))
    den = float(torch.linalg.norm(want.double()))
    return diff / den if den > 0 else diff


def hold_refresh(label, pairs, tol, report):
    """Each ``(name, got, want, spread)``: within ``tol`` elementwise, or,
    where the extraction's own ``spread`` (another extraction of the same
    Stats) exceeds it, at most SPREAD_FACTOR times the spread normwise."""
    for name, got, want, spread in pairs:
        use, err, spr = (tol_use(got, want, *tol), nrel(got, want),
                         nrel(spread, want))
        report[f"{label}_{name}"] = {"tol_use": use, "rel": err,
                                     "spread_rel": spr}
        if not (use <= 1.0 or err <= SPREAD_FACTOR * spr):
            raise AssertionError(
                f"phase 3g {label}: {name} {err:.3e} from re-extraction "
                f"(tolerance use {use:.3g}), its spread {spr:.3e}")


def state_pairs(got, want, spread):
    return [(f, getattr(got, f), getattr(want, f), getattr(spread, f))
            for f in ("chol_sigma", "c2", "a_mean", "g")]


def answer_pairs(got, want, spread):
    return [(n, a, b, c) for n, a, b, c in zip(("mean", "var"), got, want,
                                                spread)]


def zoo_trend_data(rng, n):
    """sgpr-zoo-trend's data: x ~ U(-2, 2)^4; y (n, 2) a smooth function of
    dims 0-1, [sin(2 x0) cos(x1), cos(1.5 x0 + x1)], plus the linear trend
    x[:, 2:] @ [[0.8, -0.3], [0.4, 0.6]], plus N(0, 0.05^2) noise."""
    x = rng.uniform(-2.0, 2.0, (n, 4))
    f = np.stack([np.sin(2.0 * x[:, 0]) * np.cos(x[:, 1]),
                  np.cos(1.5 * x[:, 0] + x[:, 1])], 1)
    y = (f + x[:, 2:] @ np.array([[0.8, -0.3], [0.4, 0.6]])
         + 0.05 * rng.standard_normal((n, 2)))
    return x, y


def online_update_3a(rt, cfg, sgpr, step, count, report):
    """``update``/``forget`` of a fresh 2,048-row block on 3a's fitted
    model, its components timed, an illegitimate forget, a fresh engine's
    ``ingest``/``forget`` and ``DistributedGP.update_stats_fn`` (NCCL world
    of one)."""
    import torch.distributed as dist

    from repro_torch.core import chol_update
    from repro_torch.launch import make_data_group
    from repro_torch.serve import online, posterior
    from repro_torch.train.steps import make_gp_update_step

    model, xq = sgpr["model"], sgpr["queries"]
    hyp, z = model.params["hyp"], model.params["z"]
    f64 = torch.float64
    # 3a's live engine over its cached state, and 3a's cached Stats
    count("predict_3a_t65536_s", lambda: model.predict(xq))
    eng = model._engine_cache
    ans0 = eng.predict(xq)
    state0, stats0 = model._pstate_cache, model._stats()
    x_new, y_new = make_regression(np.random.default_rng(ONLINE_SEED),
                                   ONLINE_K, cfg.q, cfg.d)
    xn, yn = t64(x_new), t64(y_new)

    # -- update: the whole call, then its pieces alone --------------------------
    count("update_s", lambda: model.update(x_new, y_new))
    want = 1 if model.chunk_size is None else -(-ONLINE_K // model.chunk_size)
    got = report["update_reg_stats_launches"] = \
        count.per_call["update_s"]["reg_stats_f64"]
    if got != want:
        raise AssertionError(f"phase 3g: update launched reg_stats {got} "
                             f"times, not ceil(k / chunk) = {want}")
    folded, state1 = model._stats(), model._pstate_cache
    V, _ = online.block_update_factors(state0, xn, yn)
    report["rank_k_sweep_ms"] = time_ms(
        lambda: chol_update.chol_update_rank_k(state0.chol_sigma, V), reps=3)

    def woodbury():
        y1, _, zz = online._woodbury_correction(state0, V)
        return online._correction_from(y1, zz, 1.0)

    report["woodbury_ms"] = time_ms(woodbury, reps=3)

    def extract(stats):
        return posterior.extract_state(hyp, z, stats, jitter=model.jitter,
                                       kernel=model.kernel, device=DEV)

    report["extract_state_ms"] = time_ms(lambda: extract(folded), reps=3)
    ext = extract(folded)
    # The extraction's own spread: the union's Stats in one pass, summed in
    # another order than the fold (a reference: its launch is not counted).
    spread = extract(model._map_stats(hyp, z, model.y, model.x))
    for f in ("z", "chol_kmm"):
        if not torch.equal(getattr(state1, f), getattr(state0, f)):
            raise AssertionError(f"phase 3g: update moved {f}")
    hold_refresh("update_state", state_pairs(state1, ext, spread), REFRESH_TOL,
                 report)
    ans1 = count("predict_updated_t65536_s", lambda: eng.predict(xq))
    if count.per_call["predict_updated_t65536_s"]["predict_f64"] != 1:
        raise AssertionError("phase 3g: the swapped engine's batch took "
                             f"{count.per_call['predict_updated_t65536_s']}")
    ref_ans = rt.PredictEngine(ext, device=DEV).predict(xq)
    spread_ans = rt.PredictEngine(spread, device=DEV).predict(xq)
    hold_refresh("update_answers", answer_pairs(ans1, ref_ans, spread_ans),
                 REFRESH_TOL, report)

    # -- forget(-1): back to 3a ------------------------------------------------
    flags = []
    real = online.downdate_state

    def spy(*args, **kwargs):
        res = real(*args, **kwargs)
        flags.append(res.fallback)
        return res

    online.downdate_state = spy
    try:
        count("forget_s", lambda: model.forget(-1))
    finally:
        online.downdate_state = real
    report["forget_fallback"] = flags
    if flags != [False]:
        raise AssertionError(f"phase 3g: forget fallback {flags}")
    back = {f: nrel(a, b) for f, a, b in zip(stats0._fields, model._stats(),
                                             stats0)}
    report["forget_stats_rel"] = back
    if max(back.values()) > STATS_BACK_RTOL:
        raise AssertionError(f"phase 3g: Stats after forget {back}")
    ans2 = eng.predict(xq)
    spread_back = rt.PredictEngine(extract(model._stats()),
                                   device=DEV).predict(xq)
    hold_refresh("forget_answers", answer_pairs(ans2, ans0, spread_back),
                 FORGET_TOL, report)

    # -- an illegitimate forget: a block never folded, weights 50 ---------------
    rng = np.random.default_rng(3)
    xb, yb = (t64(rng.standard_normal((ILLEGIT_ROWS, cfg.q))),
              t64(5.0 * rng.standard_normal((ILLEGIT_ROWS, cfg.d))))
    # At n = 1e6 the test's 15 x 50 may still leave B - VV^T positive
    # definite; the test's own ratio of forgotten weight to held rows (50
    # over its 20 rows) makes it indefinite at any n.
    illegit = {}
    for wt in (ILLEGIT_WEIGHT, ILLEGIT_WEIGHT * model.n / 20):
        res = step(f"illegitimate_forget_w{wt:g}_s",
                   lambda wt=wt: online.downdate_state(
                       state0, xb, yb,
                       weights=torch.full((ILLEGIT_ROWS,), wt, dtype=f64,
                                          device=DEV)))
        illegit[f"{wt:g}"] = res.fallback
    report["illegitimate_forget_fallback"] = illegit
    if not illegit[f"{ILLEGIT_WEIGHT * model.n / 20:g}"]:
        raise AssertionError(f"phase 3g: illegitimate forget {illegit}")

    # -- PredictEngine.ingest and forget on a fresh engine over 3a's state -----
    fresh = rt.PredictEngine(sgpr["state"], device=DEV)
    res = count("engine_ingest_s", lambda: fresh.ingest(x_new, y_new))
    ans3 = fresh.predict(xq)
    report["ingest"] = {"fallback": res.fallback,
                        "bitwise_model_update": all(torch.equal(a, b) for a, b
                                                    in zip(ans3, ans1)),
                        "rel": [nrel(a, b) for a, b in zip(ans3, ans1)]}
    if res.fallback or max(report["ingest"]["rel"]) > 1e-12:
        raise AssertionError(f"phase 3g: ingest {report['ingest']}")
    res = count("engine_forget_s", lambda: fresh.forget(x_new, y_new))
    ans4 = fresh.predict(xq)
    report["engine_forget_fallback"] = res.fallback
    if res.fallback:
        raise AssertionError("phase 3g: engine forget fell back")
    hold_refresh("engine_forget_answers", answer_pairs(ans4, ans0,
                                                       spread_back),
                 FORGET_TOL, report)

    # -- DistributedGP.update_stats_fn, NCCL world of one -----------------------
    group = make_data_group(DEV)
    try:
        deng, fold = make_gp_update_step(group, cfg.d, device=DEV)
        new, wn = deng.put_data(y=y_new, mu=x_new)
        dist_folded = count("dist_fold_s", lambda: fold(
            stats0, hyp, z, new["y"], new["mu"], None, wn, np.ones(1)))
        report["dist_fold_bitwise"] = all(
            torch.equal(a, b) for a, b in zip(dist_folded, folded))
        if not report["dist_fold_bitwise"]:
            raise AssertionError("phase 3g: update_stats_fn's Stats differ "
                                 "from model.update's")
        buf = torch.zeros(cfg.m * cfg.m + cfg.m * cfg.d + 4, dtype=f64,
                          device=DEV)
        report["dist_fold_all_reduce"] = {
            "backend": dist.get_backend(group), "bytes": buf.numel() * 8,
            "ms": time_ms(lambda: dist.all_reduce(buf))}
    finally:
        dist.destroy_process_group()


def zoo_path(rt, zc, step, count, report):
    """sgpr-zoo-trend, uncut, on the card: value and gradient against the
    CPU (within 1e-8, or SPREAD_FACTOR times the CPU path's own spread
    where that is wider),
    ``fit`` (ZOO_FIT_ITERS iterations), ``save_state``/``load_state`` with the Sum spec, an
    update against re-extraction, and the same data under ``kernel="se"``;
    the counts are checked by the caller."""
    from repro_torch.core import init_utils
    from repro_torch.serve import posterior

    x, y = zoo_trend_data(np.random.default_rng(SEED), zc.n)
    z = init_utils.kmeans(x[:8192], zc.m, iters=5, seed=SEED)
    kern = zc.kernel_expr()
    hyp = init_utils.default_hyp_for(kern, y, zc.q)
    gpu = rt.SGPR(x, y, hyp=hyp, z=z, kernel=kern, device=DEV)
    cpu = rt.SGPR(x, y, hyp=hyp, z=z, kernel=kern, device="cpu")
    v, g = count("zoo_value_and_grad_s", gpu._neg_vg)
    vc, gc = step("zoo_value_and_grad_cpu_s", cpu._neg_vg)
    report["zoo_value_rel_diff"] = dv = abs(v - vc) / abs(vc)
    report["zoo_grad_rel_diff"] = dg = rel_diff(g, gc)
    # The bound here is conditioned past 1e-8 (ROADMAP Queue 3 item 15):
    # the CPU path disagrees with itself when its row sums only change
    # order.  The limit is then SPREAD_FACTOR times that spread.
    spread = [rt.SGPR(x, y, hyp=hyp, z=z, kernel=kern, chunk_size=c,
                      device="cpu")._neg_vg() for c in ZOO_REORDER_CHUNKS]
    lv = max(ZOO_RTOL, SPREAD_FACTOR * max(abs(vs - vc) / abs(vc)
                                           for vs, _ in spread))
    lg = max(ZOO_RTOL, SPREAD_FACTOR * max(rel_diff(gs, gc)
                                           for _, gs in spread))
    report["zoo_limits"] = {"value": lv, "grad": lg}
    if not (dv <= lv and dg <= lg):
        raise AssertionError(f"phase 3g zoo: value {dv:.3e} / gradient "
                             f"{dg:.3e}, card against CPU, above {lv:.3e} / "
                             f"{lg:.3e}")
    report["zoo_evaluation_ms"] = time_ms(gpu._neg_vg, reps=3)
    b0 = gpu.log_bound()
    count(f"zoo_fit_{ZOO_FIT_ITERS}_iters_s",
          lambda: gpu.fit(max_iters=ZOO_FIT_ITERS))
    b1 = gpu.log_bound()
    report["zoo_fit"] = {"bound_before": b0, "bound_after": b1}
    if not (math.isfinite(b1) and b1 > b0):
        raise AssertionError(f"phase 3g zoo: fit moved the bound {b0} -> {b1}")
    xq = np.random.default_rng(SEED + 1).uniform(-2.0, 2.0, (65_536, zc.q))
    count("zoo_predict_t65536_s", lambda: gpu.predict(xq))
    eng = gpu._engine_cache
    ans = eng.predict(xq)
    with tempfile.TemporaryDirectory() as tmp:
        rt.save_state(pathlib.Path(tmp) / "zoo", gpu.predictive_state())
        loaded, _ = rt.load_state(pathlib.Path(tmp) / "zoo", device=DEV)
    if loaded.kernel != kern:
        raise AssertionError(f"phase 3g zoo: reloaded kernel {loaded.kernel}")
    reload_ans = rt.PredictEngine(loaded, device=DEV).predict(xq)
    report["zoo_reload_bitwise"] = all(torch.equal(a, b)
                                       for a, b in zip(reload_ans, ans))
    if not report["zoo_reload_bitwise"]:
        raise AssertionError("phase 3g zoo: the reloaded state answers "
                             "otherwise")
    # update on the zoo model, against re-extraction
    x_new, y_new = zoo_trend_data(np.random.default_rng(ONLINE_SEED),
                                  ONLINE_K)
    count("zoo_update_s", lambda: gpu.update(x_new, y_new))
    hyp_t, z_t = gpu.params["hyp"], gpu.params["z"]

    def extract(stats):
        return posterior.extract_state(hyp_t, z_t, stats, jitter=gpu.jitter,
                                       kernel=kern, device=DEV)

    ext = extract(gpu._stats())
    spread = extract(gpu._map_stats(hyp_t, z_t, gpu.y, gpu.x))
    hold_refresh("zoo_update_state", state_pairs(gpu._pstate_cache, ext,
                                                 spread), REFRESH_TOL, report)
    hold_refresh("zoo_update_answers", answer_pairs(
        eng.predict(xq), rt.PredictEngine(ext, device=DEV).predict(xq),
        rt.PredictEngine(spread, device=DEV).predict(xq)), REFRESH_TOL,
        report)
    # the same data under the full-width SE-ARD: the kernel route
    se = rt.SGPR(x, y, hyp=init_utils.default_hyp_for("se", y, zc.q), z=z,
                 kernel="se", device=DEV)
    count("zoo_data_se_log_bound_s", se.log_bound)


def online_zoo_path(rt, cfg, zc, sgpr) -> dict:
    """Phase 3g: online updates on 3a's fitted sgpr-synth-1m model
    (``online_update_3a``), then the kernel zoo at sgpr-zoo-trend
    (``zoo_path``).  Every launch counter is 0 just before and read just
    after; only the port's own calls count, and each call's counts are
    checked: one reg_stats launch for the update's block, one predict launch
    for the swapped engine's batch, none on the zoo's route and reg_stats
    under ``kernel="se"``."""
    from repro_torch.kernels.predict import ops as p_ops
    from repro_torch.kernels.psi_stats import ops as ps_ops
    from repro_torch.kernels.reg_stats import ops as rs_ops

    steps, report = {}, {}
    step = timed_step(steps)

    def counts():
        return {"reg_stats_f64": rs_ops.LAUNCHES["float64"],
                "predict_f64": p_ops.LAUNCHES["float64"]}

    launches = {k: 0 for k in counts()}

    def count(name, fn):
        before = counts()
        out = step(name, fn)
        count.per_call[name] = {k: c - before[k] for k, c in counts().items()}
        for k, c in count.per_call[name].items():
            launches[k] += c
        return out

    count.per_call = {}
    reset_counts(rs_ops.LAUNCHES, p_ops.LAUNCHES, ps_ops.LAUNCHES)
    try:
        online_update_3a(rt, cfg, sgpr, step, count, report)
        zoo_path(rt, zc, step, count, report)
        pc = count.per_call
        for name in ("zoo_value_and_grad_s", f"zoo_fit_{ZOO_FIT_ITERS}_iters_s",
                     "zoo_predict_t65536_s", "zoo_update_s"):
            if any(pc[name].values()):
                raise AssertionError(f"phase 3g zoo: {name} launched "
                                     f"{pc[name]}")
        if pc["zoo_data_se_log_bound_s"]["reg_stats_f64"] < 1:
            raise AssertionError("phase 3g: kernel='se' launched no reg_stats")
    finally:   # what was measured, also when a check failed
        print(f"online and zoo path (3g) steps (s): {json.dumps(steps)}",
              flush=True)
        print(f"online and zoo path (3g) launches per call: "
              f"{json.dumps(count.per_call)}", flush=True)
        for key, val in report.items():
            print(f"online and zoo path (3g) {key}: {json.dumps(val)}",
                  flush=True)
        print(f"online and zoo path (3g) card: {nvidia_smi()}", flush=True)
    print(f"online and zoo path (3g) launches: {json.dumps(launches)}",
          flush=True)
    for name, c in launches.items():
        if c < 1:
            raise AssertionError(f"kernel {name} was not launched on the "
                                 "online path")
    return launches


# -- phase 3h: posterior sampling, the fleet engine and the front-end ---------

# 4,096 of 3a's queries (16 blocks of 256), 256 draws each.
SAMPLE_T, SAMPLE_BLOCK, SAMPLE_DRAWS, SAMPLE_SEED = 4096, 256, 256, 11
# _sample_from_normals on the card against the CPU on the same normals:
# max |card - CPU| / max |CPU|.
SAMPLE_REL = 1e-10
# Monte-Carlo checks, in standard errors of the estimator at 256 draws
# (tests/test_serving_sampling.py: 5 for means, 6 for covariances and
# variances).
MEAN_SE, COV_SE = 5.0, 6.0
# The fleet: 3a's state and the states after 1, 2 and 3 updates of fresh
# 2,048-row blocks (3a's generator; seeds after 3g's ONLINE_SEED).
FLEET_SEEDS = (2, 3, 4)
MIX_REL = 1e-12   # predict_mixture against mixture_moments in plain f64
# The front-end's burst: requests of 1-128 rows of 3a's queries (sizes and
# offsets from FE_SEED), a swap to the fleet's second state after request
# FE_SWAP_AT (once the first response is back, so flushes of both
# generations are in flight), then FE_EXPIRED requests whose deadline has
# passed; a
# fleet front-end answers the first FE_FLEET requests.  The queue holds the
# whole burst (~129,000 rows), which arrives at once.
FE_REQUESTS, FE_MAX_ROWS, FE_SEED, FE_SWAP_AT = 2000, 128, 12, 1000
FE_BATCH_ROWS, FE_WAIT_MS, FE_EXPIRED, FE_FLEET = 8192, 2.0, 5, 200
FE_QUEUE_ROWS = 1 << 18


def sampling_3h(rt, sgpr, count, report):
    """``PredictEngine.sample`` / ``sample_stream`` at 3a's state: repeated
    bits, the stream's bits, the card against the CPU on the same normals,
    the draws' moments against ``predict`` and ``predict_full_cov``,
    ``include_noise``, an f32 state and a refused bf16 one."""
    from repro_torch.serve import posterior

    state = sgpr["state"]
    xq = t64(sgpr["queries"][:SAMPLE_T])
    S, bs = SAMPLE_DRAWS, SAMPLE_BLOCK
    eng = rt.PredictEngine(state, block_size=bs, device=DEV)
    draws = count("sample_t4096_s", lambda: eng.sample(xq, S, SAMPLE_SEED))
    if draws.shape != (S, SAMPLE_T, state.d) \
            or not bool(torch.isfinite(draws).all()):
        raise AssertionError(f"phase 3h: draws {tuple(draws.shape)}")
    report["sample_same_seed_bitwise"] = torch.equal(
        draws, count("sample_again_s", lambda: eng.sample(xq, S,
                                                          SAMPLE_SEED)))
    streamed = count("sample_stream_4x1024_s", lambda: torch.cat(list(
        eng.sample_stream([xq[i:i + 1024] for i in range(0, SAMPLE_T, 1024)],
                          S, SAMPLE_SEED)), 1))
    report["sample_stream_bitwise"] = torch.equal(streamed, draws)
    if not (report["sample_same_seed_bitwise"]
            and report["sample_stream_bitwise"]):
        raise AssertionError(f"phase 3h: sampling bits {report}")
    report["sample_ms"] = {
        "t4096": count("sample_timed_t4096_s", lambda: time_ms(
            lambda: eng.sample(xq, S, SAMPLE_SEED), reps=3)),
        "one_block": count("sample_timed_block_s", lambda: time_ms(
            lambda: eng.sample(xq[:bs], S, SAMPLE_SEED), reps=5))}

    # -- the card against the CPU, the same normals --------------------------
    eps = np.random.default_rng(SAMPLE_SEED).standard_normal((S, bs, state.d))
    got = posterior._sample_from_normals(state, xq[:bs], t64(eps))
    want = posterior._sample_from_normals(state._to(device="cpu"),
                                          xq[:bs].cpu(), t64(eps, "cpu"))
    rel = report["sample_card_vs_cpu_rel"] = float(
        (got.cpu() - want).abs().max() / want.abs().max())
    if rel > SAMPLE_REL:
        raise AssertionError(f"phase 3h: card against CPU {rel:.3e}")

    # -- moments -------------------------------------------------------------
    sf2 = float(torch.exp(state.hyp["log_sf2"]))
    jit = eng.sample_jitter * sf2 + 1e-12   # the factor's diagonal jitter
    mean, var = eng.predict(xq)
    zmean = ((draws.mean(0) - mean).abs()
             / ((var + jit) / S).sqrt()[:, None])
    report["sample_mean_max_se"] = float(zmean.max())
    fmean, fcov = eng.predict_full_cov(xq[:bs])
    c = fcov + jit * torch.eye(bs, dtype=fcov.dtype, device=fcov.device)
    sd2 = torch.diagonal(c)
    se_cov = ((sd2[:, None] * sd2[None, :] + c ** 2) / S).sqrt()
    r = draws[:, :bs] - fmean[None]
    zcov = max(float(((torch.einsum("si,sj->ij", r[..., j], r[..., j]) / S
                       - c).abs() / se_cov).max()) for j in range(state.d))
    report["sample_block_cov_max_se"] = zcov
    noisy = eng.sample(xq[:bs], S, SAMPLE_SEED + 1, include_noise=True)
    _, vn = eng.predict(xq[:bs], include_noise=True)
    vt = vn + jit
    zvar = ((noisy.var(0, correction=0) - vt[:, None]).abs()
            / (math.sqrt(2.0 / S) * vt)[:, None])
    report["sample_noise_var_max_se"] = float(zvar.max())
    report["noise_var_over_latent_var"] = float((vn / var[:bs]).mean())
    if not (zmean.max() <= MEAN_SE and zcov <= COV_SE
            and zvar.max() <= COV_SE):
        raise AssertionError(f"phase 3h: moments {report}")

    # -- storage widths --------------------------------------------------------
    eng32 = rt.PredictEngine(state.astype(torch.float32), block_size=bs,
                             device=DEV)
    s32 = count("sample_f32_state_s", lambda: eng32.sample(xq[:bs], 16,
                                                           SAMPLE_SEED))
    if s32.dtype != torch.float32 or not bool(torch.isfinite(s32).all()):
        raise AssertionError("phase 3h: the f32 state's draws")
    refused = None
    try:
        rt.PredictEngine(state.astype(torch.bfloat16), device=DEV).sample(
            xq[:bs], 2, SAMPLE_SEED)
    except ValueError as e:
        refused = str(e)
    report["bf16_refused"] = refused is not None
    if refused is None:
        raise AssertionError("phase 3h: a bf16 state sampled")


def fleet_3h(rt, cfg, sgpr, count, report):
    """``MultiPredictEngine`` over 3a's state and the states after 1, 2 and
    3 updates: rows bitwise each model's own engine, one predict launch a
    model a batch, ``predict_mixture`` against ``mixture_moments`` in plain
    f64, ``swap_slot``, and ``DistributedGP.multi_predict_engine`` (and a
    sharded engine's ``sample``) in an NCCL world of one.  Returns the
    fleet's states."""
    import torch.distributed as dist

    from repro_torch.launch import make_data_group
    from repro_torch.serve import MultiPredictEngine

    model, xq = sgpr["model"], t64(sgpr["queries"])
    states = [sgpr["state"]]
    for seed in FLEET_SEEDS:
        x_new, y_new = make_regression(np.random.default_rng(seed), ONLINE_K,
                                       cfg.q, cfg.d)
        count(f"fleet_update_seed{seed}_s", lambda: model.update(x_new, y_new))
        states.append(model._pstate_cache)
    n = len(states)
    eng = count("fleet_engine_s", lambda: MultiPredictEngine(states,
                                                             device=DEV))
    mean, var = count("fleet_predict_t65536_s",
                      lambda: eng.predict(xq, include_noise=True))
    report["fleet_batch_ms"] = count(
        "fleet_timed_s", lambda: time_ms(lambda: eng.predict(xq), reps=5))
    singles = [rt.PredictEngine(s, device=DEV) for s in states]
    report["fleet_single_ms"] = time_ms(lambda: singles[0].predict(xq),
                                        reps=5)
    bitwise = []
    for k, one in enumerate(singles):
        m1, v1 = one.predict(xq, include_noise=True)
        bitwise.append(torch.equal(mean[k], m1) and torch.equal(var[k], v1))
    report["fleet_rows_bitwise"] = bitwise
    if not all(bitwise):
        raise AssertionError(f"phase 3h: fleet rows bitwise {bitwise}")

    mu, v = count("fleet_mixture_s", lambda: eng.predict_mixture(xq))
    m_np, v_np = (a.cpu().numpy() for a in eng.predict(xq))
    mu_ref = m_np.mean(0)
    v_ref = np.maximum(v_np, 0.0).mean(0)[:, None] + m_np.var(0)
    report["fleet_mixture_rel"] = {
        "mean": float(np.abs(mu.cpu().numpy() - mu_ref).max()
                      / np.abs(mu_ref).max()),
        "var": float(np.abs(v.cpu().numpy() - v_ref).max()
                     / np.abs(v_ref).max())}
    if max(report["fleet_mixture_rel"].values()) > MIX_REL:
        raise AssertionError(f"phase 3h: {report['fleet_mixture_rel']}")

    count("fleet_swap_slot_s", lambda: eng.swap_slot(2, states[0]))
    m2, v2 = count("fleet_predict_after_swap_s",
                   lambda: eng.predict(xq, include_noise=True))
    moved = [not (torch.equal(m2[k], mean[k]) and torch.equal(v2[k], var[k]))
             for k in range(n)]
    report["fleet_swap_slot"] = {
        "slot_is_new_state": torch.equal(m2[2], mean[0])
        and torch.equal(v2[2], var[0]),
        "moved": moved}
    if not report["fleet_swap_slot"]["slot_is_new_state"] \
            or moved != [False, False, True, False]:
        raise AssertionError(f"phase 3h: swap_slot {report['fleet_swap_slot']}")

    group = make_data_group(DEV)
    try:
        dgp = rt.DistributedGP(group, device=DEV)
        deng = dgp.multi_predict_engine(states)
        got = count("fleet_dist_predict_s",
                    lambda: deng.predict(xq, include_noise=True))
        report["fleet_dist_bitwise"] = all(
            torch.equal(a, b) for a, b in zip(got, (mean, var)))
        seng = dgp.predict_engine(states[0])
        sd = count("sample_dist_t4096_s", lambda: seng.sample(
            xq[:SAMPLE_T], SAMPLE_DRAWS, SAMPLE_SEED))
        report["sample_dist_bitwise"] = torch.equal(sd, rt.PredictEngine(
            states[0], device=DEV).sample(xq[:SAMPLE_T], SAMPLE_DRAWS,
                                          SAMPLE_SEED))
    finally:
        dist.destroy_process_group()
    if not (report["fleet_dist_bitwise"] and report["sample_dist_bitwise"]):
        raise AssertionError(f"phase 3h: NCCL world of one {report}")
    return states


def frontend_3h(rt, sgpr, states, count, report):
    """A ``Frontend`` over 3a's f64 engine: ``warmup``, a burst of
    FE_REQUESTS requests with a ``swap_state`` to the fleet's second state
    after request FE_SWAP_AT, every response bitwise a direct ``predict``
    under its generation's state, expired requests launching nothing, the
    predict launches equal to the flushes plus the warmup shapes; then the
    same front-end over the fleet engine."""
    import asyncio

    from repro_torch.kernels.predict import ops as p_ops
    from repro_torch.serve import Frontend, MultiPredictEngine, SLOExceeded

    xall = sgpr["queries"]
    rng = np.random.default_rng(FE_SEED)
    sizes = rng.integers(1, FE_MAX_ROWS + 1, FE_REQUESTS)
    offsets = rng.integers(0, xall.shape[0] - FE_MAX_ROWS, FE_REQUESTS)
    reqs = [xall[o:o + s] for o, s in zip(offsets, sizes)]

    pauses = []   # the garbage collector's pauses during a burst, seconds

    def on_gc(phase, info):
        if phase == "start":
            on_gc.t0 = time.perf_counter()
        else:
            pauses.append(time.perf_counter() - on_gc.t0)

    async def session(eng, n_req, swap_to=None):
        out = {}
        async with Frontend(eng, max_batch_rows=FE_BATCH_ROWS,
                            max_wait_ms=FE_WAIT_MS,
                            max_queue_rows=FE_QUEUE_ROWS) as fe:
            out["shapes"] = fe.warmup()
            pauses.clear()
            gc.callbacks.append(on_gc)
            t0 = time.perf_counter()
            if swap_to is None:
                futs = [asyncio.ensure_future(fe.submit(x)) for x in
                        reqs[:n_req]]
            else:
                futs = [asyncio.ensure_future(fe.submit(
                    x, include_noise=i % 2 == 0))
                    for i, x in enumerate(reqs[:FE_SWAP_AT])]
                await futs[0]   # the first flush answered, later ones queued
                ts = time.perf_counter()
                out["swap_generation"] = fe.swap_state(swap_to)
                out["swap_ms"] = 1e3 * (time.perf_counter() - ts)
                futs += [asyncio.ensure_future(fe.submit(
                    x, include_noise=i % 2 == 0))
                    for i, x in enumerate(reqs[FE_SWAP_AT:n_req], FE_SWAP_AT)]
            out["results"] = await asyncio.gather(*futs)
            out["burst_s"] = time.perf_counter() - t0
            gc.callbacks.remove(on_gc)
            out["gc_pauses_ms"] = [1e3 * p for p in pauses]
            out["flush_ms"] = [1e3 * r[0] for r in fe.timer.records]
            if swap_to is not None:
                before = p_ops.LAUNCHES["float64"]
                out["expired"] = await asyncio.gather(
                    *[fe.submit(x, deadline_ms=-1.0)
                      for x in reqs[:FE_EXPIRED]], return_exceptions=True)
                out["expired_launches"] = p_ops.LAUNCHES["float64"] - before
            out["summary"] = fe.metrics.summary()
            out["load"] = fe.load_summary()
        return out

    eng = rt.PredictEngine(sgpr["state"], device=DEV)
    res = count("frontend_burst_s", lambda: asyncio.run(
        session(eng, FE_REQUESTS, swap_to=states[1])))
    summ, c = res["summary"], res["summary"]["counters"]
    rows = int(sizes.sum())
    report["frontend"] = {
        "warmup_shapes": res["shapes"], "flushes": c["flushes"],
        "requests": FE_REQUESTS, "rows": rows, "burst_s": res["burst_s"],
        "rows_per_s": rows / res["burst_s"],
        "requests_per_s": FE_REQUESTS / res["burst_s"],
        "e2e_p50_ms": 1e3 * summ["e2e"]["p50"],
        "e2e_p99_ms": 1e3 * summ["e2e"]["p99"],
        "wait_p99_ms": 1e3 * summ["wait"]["p99"],
        "engine_p50_ms": 1e3 * summ["engine"]["p50"],
        "mean_batch_requests": summ["mean_batch_requests"],
        "pad_fraction": summ["pad_fraction"], "counters": c,
        "generations": {g: sum(r.generation == g for r in res["results"])
                        for g in (0, 1)},
        "expired_launches": res["expired_launches"],
        "swap_ms": res["swap_ms"], "flush_ms": res["flush_ms"],
        "gc_pauses_ms": res["gc_pauses_ms"]}
    report["frontend_load_summary"] = res["load"]
    launched = count.per_call["frontend_burst_s"]["predict_f64"]
    if launched != c["flushes"] + res["shapes"]:
        raise AssertionError(f"phase 3h: front-end launched {launched}, "
                             f"flushes {c['flushes']} + warmup "
                             f"{res['shapes']}")
    if res["expired_launches"] or c["expired"] != FE_EXPIRED or not all(
            isinstance(e, SLOExceeded) for e in res["expired"]):
        raise AssertionError(f"phase 3h: expired requests {res['expired']}")
    refs = {0: rt.PredictEngine(sgpr["state"], device=DEV),
            1: rt.PredictEngine(states[1], device=DEV)}
    bad = 0
    for i, (x, r) in enumerate(zip(reqs, res["results"])):
        m_ref, v_ref = refs[r.generation].predict(x, include_noise=i % 2 == 0)
        bad += not (np.array_equal(r.mean, m_ref.cpu().numpy())
                    and np.array_equal(r.var, v_ref.cpu().numpy()))
    report["frontend"]["responses_not_bitwise"] = bad
    if bad or c["completed"] != FE_REQUESTS or res["swap_generation"] != 1 \
            or 0 in report["frontend"]["generations"].values():
        raise AssertionError(f"phase 3h: front-end {report['frontend']}")

    # The same burst again on a fresh front-end over the same engine (no
    # swap, no expired requests): the warm numbers beside the first burst's.
    wres = count("frontend_warm_burst_s", lambda: asyncio.run(
        session(eng, FE_REQUESTS)))
    wsum = wres["summary"]
    report["frontend_warm"] = {
        "flushes": wsum["counters"]["flushes"], "burst_s": wres["burst_s"],
        "rows_per_s": rows / wres["burst_s"],
        "e2e_p50_ms": 1e3 * wsum["e2e"]["p50"],
        "e2e_p99_ms": 1e3 * wsum["e2e"]["p99"],
        "flush_ms": wres["flush_ms"], "gc_pauses_ms": wres["gc_pauses_ms"]}
    wl = count.per_call["frontend_warm_burst_s"]["predict_f64"]
    if wl != wsum["counters"]["flushes"] + wres["shapes"] \
            or wsum["counters"]["completed"] != FE_REQUESTS:
        raise AssertionError(f"phase 3h: warm burst {report['frontend_warm']}"
                             f", {wl} launches")

    feng = MultiPredictEngine(states, device=DEV)
    fres = count("frontend_fleet_s", lambda: asyncio.run(
        session(feng, FE_FLEET)))
    fc = fres["summary"]["counters"]
    fbad = 0
    for x, r in zip(reqs, fres["results"]):
        m_ref, v_ref = feng.predict(x)
        fbad += not (r.mean.shape == (len(states), x.shape[0],
                                      sgpr["state"].d)
                     and np.array_equal(r.mean, m_ref.cpu().numpy())
                     and np.array_equal(r.var, v_ref.cpu().numpy()))
    report["frontend_fleet"] = {
        "flushes": fc["flushes"], "warmup_shapes": fres["shapes"],
        "responses_not_bitwise": fbad,
        "e2e_p99_ms": 1e3 * fres["summary"]["e2e"]["p99"]}
    flaunched = count.per_call["frontend_fleet_s"]["predict_f64"]
    if fbad or flaunched != len(states) * (fc["flushes"] + fres["shapes"]):
        raise AssertionError(f"phase 3h: fleet front-end "
                             f"{report['frontend_fleet']}, {flaunched} "
                             "launches")


def serving_ext_path(rt, cfg, sgpr) -> dict:
    """Phase 3h on 3a's fitted model: sampling (``sampling_3h``), the fleet
    engine (``fleet_3h``) and the front-end (``frontend_3h``).  Every
    launch counter is 0 just before and read just after; only the port's
    own calls count (the reference engines the checks build launch the
    same kernel and are left out), and each call's count is checked: one
    reg_stats launch an update, one predict launch a model a batch, one a
    model a front-end flush and a warmup shape, none in sampling."""
    from repro_torch.kernels.predict import ops as p_ops
    from repro_torch.kernels.psi_stats import ops as ps_ops
    from repro_torch.kernels.reg_stats import ops as rs_ops

    steps, report = {}, {}
    step = timed_step(steps)

    def counts():
        return {"reg_stats_f64": rs_ops.LAUNCHES["float64"],
                "predict_f64": p_ops.LAUNCHES["float64"]}

    launches = {k: 0 for k in counts()}

    def count(name, fn):
        before = counts()
        out = step(name, fn)
        count.per_call[name] = {k: c - before[k] for k, c in counts().items()}
        for k, c in count.per_call[name].items():
            launches[k] += c
        return out

    count.per_call = {}
    reset_counts(rs_ops.LAUNCHES, p_ops.LAUNCHES, ps_ops.LAUNCHES)
    try:
        sampling_3h(rt, sgpr, count, report)
        states = fleet_3h(rt, cfg, sgpr, count, report)
        frontend_3h(rt, sgpr, states, count, report)
        pc = count.per_call
        n = len(states)
        # what each call implies: (call, kernel, launches)
        implied = [(name, "predict_f64", 0) for name in pc
                   if name.startswith("sample")]
        implied += [(f"fleet_update_seed{s}_s", "reg_stats_f64", 1)
                    for s in FLEET_SEEDS]
        implied += [("fleet_predict_t65536_s", "predict_f64", n),
                    ("fleet_timed_s", "predict_f64", 6 * n),
                    ("fleet_mixture_s", "predict_f64", n),
                    ("fleet_predict_after_swap_s", "predict_f64", n),
                    ("fleet_dist_predict_s", "predict_f64", n)]
        wrong = {name: pc[name] for name, k, c in implied if pc[name][k] != c}
        if wrong:
            raise AssertionError(f"phase 3h: launches {wrong}")
    finally:   # what was measured, also when a check failed
        print(f"serving extensions path (3h) steps (s): {json.dumps(steps)}",
              flush=True)
        print(f"serving extensions path (3h) launches per call: "
              f"{json.dumps(count.per_call)}", flush=True)
        for key, val in report.items():
            print(f"serving extensions path (3h) {key}: {json.dumps(val)}",
                  flush=True)
        print(f"serving extensions path (3h) card: {nvidia_smi()}",
              flush=True)
    fe = report["frontend"]
    for label, r in (("burst", fe), ("warm burst", report["frontend_warm"])):
        print(f"front-end (3h) SLO, {label}: p50 e2e {r['e2e_p50_ms']:.3f} "
              f"ms, p99 e2e {r['e2e_p99_ms']:.3f} ms, {r['rows_per_s']:.0f} "
              f"rows/s, {r['flushes']} flushes; card {nvidia_smi()}",
              flush=True)
    print(f"front-end (3h) load_summary(): "
          f"{json.dumps(report['frontend_load_summary'])}", flush=True)
    print(f"serving extensions path (3h) launches: {json.dumps(launches)}",
          flush=True)
    for name, c in launches.items():
        if c < 1:
            raise AssertionError(f"kernel {name} was not launched on the "
                                 "serving extensions path")
    return launches


# -- phase 3i: the overlapped reduce, the async engine, the front-end over ranks

OVERLAP_CHUNK = 65_536           # sgpr-synth-1m in 16 blocks
REDUCE_MODES = ("serial", "overlap", "overlap_eager")
STEP_REPS = 5                    # timed steps a mode (median)
USPS_OVERLAP_CHUNK = 1024        # gplvm-usps in 5 blocks
# 4 gloo ranks on the card: 3e's n, each rank 4 blocks of 16,384 rows
ASYNC_RANKS_N, ASYNC_RANKS_CHUNK = STREAM_RANKS_N, 16_384
ASYNC_RANKS_FMASK, ASYNC_RANKS_MODE = (1.0, 0.0, 1.0, 1.0), "rescale"
# AsyncEngine at sgpr-synth-1m: 8 shards of 125,000 rows, 2 blocks each
ASYNC_SHARDS, ASYNC_STALENESS, ASYNC_REFRESH = 8, 8, (1, 2, 4, 8)
# Clipped SGD under failures, on tests/test_async_stats.py:414's recipe
# (clip 50, staleness 2K) with a tenth of its step: at n = 1e6 its lr 2e-3
# let the stale folds run away (the async value to -2.0e9 in 20 steps on
# the H100) though the exact bound still rose; at 2e-4 the fold stays
# consistent and the exact bound rises further.
ASYNC_SGD_STEPS, ASYNC_SGD_STALENESS, ASYNC_CLIP, ASYNC_LR = 20, 16, 50.0, 2e-4
ASYNC_USPS_SHARDS = 4
ASYNC_REL = 1e-12                # the all-fresh step against its reference
# The front-end over the 4 ranks: the first 500 of 3h's requests, a swap
# after 250 to 3a's state updated by a fresh block (seed 5)
FE_RANK_REQUESTS, FE_RANK_SWAP_AT, FE_RANK_SWAP_SEED = 500, 250, 5


def median_step_s(fn, reps=STEP_REPS) -> float:
    """Median host seconds of ``fn`` between card synchronisations, after
    one untimed call."""
    fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return statistics.median(times)


def counting_all_reduce(calls: list):
    """Wrap ``torch.distributed.all_reduce`` so each call appends its
    element count to ``calls``; returns the function that undoes it."""
    import torch.distributed as dist

    real = dist.all_reduce

    def counted(t, *args, **kwargs):
        calls.append(t.numel())
        return real(t, *args, **kwargs)
    dist.all_reduce = counted

    def undo():
        dist.all_reduce = real
    return undo


def fe_rank_requests(xall):
    """3h's request list (FE_SEED), its first FE_RANK_REQUESTS."""
    rng = np.random.default_rng(FE_SEED)
    sizes = rng.integers(1, FE_MAX_ROWS + 1, FE_REQUESTS)
    offsets = rng.integers(0, xall.shape[0] - FE_MAX_ROWS, FE_REQUESTS)
    return [xall[o:o + s] for o, s in
            zip(offsets[:FE_RANK_REQUESTS], sizes[:FE_RANK_REQUESTS])]


def async_rank(rank, world, store_path, out_dir, paths, device):
    """One rank of phase 3i's gloo run (a spawned process).  (b) the
    overlapped reduce on this rank's n / world rows of ASYNC_RANKS_N under
    ASYNC_RANKS_FMASK and ASYNC_RANKS_MODE, each reduce mode's value and
    gradient, its all_reduce calls and step time; (d) rank 0 runs a
    ``Frontend`` over ``DistributedGP.predict_engine`` of the saved state
    (FE_RANK_REQUESTS of 3h's requests, a swap to the second saved state
    midway, ``close()``), the other ranks ``serve_follower``.  Writes
    ``rank<k>.npz``."""
    import asyncio
    import datetime

    sys.path.insert(0, str(ROOT / "src"))
    import torch.distributed as dist

    from repro_torch.core.distributed import DistributedGP
    from repro_torch.kernels.predict import ops as p_ops
    from repro_torch.kernels.reg_stats import ops as rs_ops
    from repro_torch.launch import make_data_group
    from repro_torch.serve import Frontend, load_state, serve_follower
    from repro_torch.train.steps import make_gp_train_step

    torch.backends.cuda.matmul.allow_tf32 = False
    group = make_data_group(device, backend="gloo",
                            store=dist.FileStore(store_path, world),
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(
                                seconds=DIST_GROUP_TIMEOUT_S))
    state_path, swap_path, query_path, shape = paths
    n, q, d, m = shape
    out = {}
    # -- (b) the overlapped reduce -------------------------------------------
    x, y, z, hyp = sgpr_inputs(n, q, d, m)
    h, zz = {k: t64(v, device) for k, v in hyp.items()}, t64(z, device)
    fmask = np.asarray(ASYNC_RANKS_FMASK)
    reset_counts(rs_ops.LAUNCHES, p_ops.LAUNCHES)
    calls = []
    undo = counting_all_reduce(calls)
    try:
        for mode in REDUCE_MODES:
            eng, vg = make_gp_train_step(group, d, failure_mode=ASYNC_RANKS_MODE,
                                         chunk_size=ASYNC_RANKS_CHUNK,
                                         reduce_mode=mode, device=device)
            data, w = eng.put_data(y=y, mu=x)

            def run():
                return vg(h, zz, data["mu"], None, data["y"], w, fmask,
                          float(n))
            calls.clear()
            v, (gh, gz) = run()
            out[f"{mode}_all_reduces"] = len(calls)
            out[f"{mode}_value"] = float(v)
            out[f"{mode}_grad"] = flat_grads(gh, gz)
            out[f"{mode}_step_s"] = median_step_s(run, reps=3)
            del data, w
    finally:
        undo()
    out["reg_stats_launches"] = rs_ops.LAUNCHES["float64"]
    # -- (d) the front-end over the ranks --------------------------------------
    state, _ = load_state(state_path, device=device)
    eng = DistributedGP(group, device=device).predict_engine(state)
    reset_counts(p_ops.LAUNCHES)
    if rank:
        out["served"] = serve_follower(eng)
    else:
        reqs = fe_rank_requests(np.load(query_path))
        swap_to, _ = load_state(swap_path, device=device)
        sent = []   # (bytes, seconds) of each broadcast rank 0 makes
        real = dist.broadcast

        def timed_broadcast(t, *args, **kwargs):
            t0 = time.perf_counter()
            res = real(t, *args, **kwargs)
            sent.append((t.numel() * t.element_size(),
                         time.perf_counter() - t0))
            return res
        dist.broadcast = timed_broadcast

        async def session():
            async with Frontend(eng, max_batch_rows=FE_BATCH_ROWS,
                                max_wait_ms=FE_WAIT_MS,
                                max_queue_rows=FE_QUEUE_ROWS) as fe:
                shapes = fe.warmup()
                sent.clear()
                t0 = time.perf_counter()
                first = await asyncio.gather(*[
                    fe.submit(x) for x in reqs[:FE_RANK_SWAP_AT]])
                ts = time.perf_counter()
                gen = fe.swap_state(swap_to)
                swap_ms = 1e3 * (time.perf_counter() - ts)
                rest = await asyncio.gather(*[
                    fe.submit(x) for x in reqs[FE_RANK_SWAP_AT:]])
                burst_s = time.perf_counter() - t0
            fe.close()
            return (first + rest, shapes, gen, swap_ms, burst_s,
                    fe.metrics.summary(), [r[0] for r in fe.timer.records])
        try:
            res, shapes, gen, swap_ms, burst_s, summ, flush_s = asyncio.run(
                session())
        finally:
            dist.broadcast = real
        out.update(
            fe_mean=np.concatenate([r.mean for r in res]),
            fe_var=np.concatenate([r.var for r in res]),
            fe_generation=np.asarray([r.generation for r in res]),
            fe_shapes=shapes, fe_swap_generation=gen, fe_swap_ms=swap_ms,
            fe_burst_s=burst_s, fe_flushes=summ["counters"]["flushes"],
            fe_completed=summ["counters"]["completed"],
            fe_e2e_p50_ms=1e3 * summ["e2e"]["p50"],
            fe_e2e_p99_ms=1e3 * summ["e2e"]["p99"],
            fe_flush_ms=1e3 * np.asarray(flush_s),
            fe_broadcasts=len(sent),
            fe_broadcast_bytes=sum(b for b, _ in sent),
            fe_broadcast_ms=1e3 * sum(s for _, s in sent))
    out["predict_launches"] = p_ops.LAUNCHES["float64"]
    np.savez(pathlib.Path(out_dir) / f"rank{rank}.npz", **out)
    dist.destroy_process_group()


def overlap_3i(rt, cfg, usps, count, report):
    """(a) ``make_gp_train_step`` in each reduce mode in an NCCL world of
    one at ``cfg``: value and gradient bitwise across the modes and within
    1e-9 / 1e-8 of ``SGPR._neg_vg``, the all_reduce calls of a step, each
    mode's step time; the latent map at ``usps`` under ``overlap`` against
    ``BayesianGPLVM._neg_vg``.  Returns 3a's inputs and the serial step's
    (value, flat gradient)."""
    import torch.distributed as dist

    from repro_torch.core.flat import Flat
    from repro_torch.data import usps_like
    from repro_torch.launch import make_data_group
    from repro_torch.train.steps import make_gp_train_step

    x, y, z, hyp = sgpr_inputs(cfg.n, cfg.q, cfg.d, cfg.m)
    params = {"hyp": {k: t64(v) for k, v in hyp.items()}, "z": t64(z)}
    group = make_data_group(DEV)
    out, calls = {}, []
    try:
        report["backend"] = dist.get_backend(group)
        undo = counting_all_reduce(calls)
        try:
            for mode in REDUCE_MODES:
                eng, vg = make_gp_train_step(group, cfg.d,
                                             chunk_size=OVERLAP_CHUNK,
                                             reduce_mode=mode, device=DEV)
                data, w = eng.put_data(y=y, mu=x)

                def run():
                    return vg(params["hyp"], params["z"], data["mu"], None,
                              data["y"], w, np.ones(1), float(cfg.n))
                calls.clear()
                v, (gh, gz) = count(f"overlap_{mode}_first_step_s", run)
                report[f"{mode}_all_reduces"] = len(calls)
                out[mode] = (float(v), flat_grads(gh, gz))
                report[f"{mode}_step_s"] = count(
                    f"overlap_{mode}_timed_s", lambda: median_step_s(run))
                del data, w
        finally:
            undo()
        blocks = -(-cfg.n // OVERLAP_CHUNK)
        report["blocks"] = blocks
        for mode in REDUCE_MODES[1:]:
            if out[mode][0] != out["serial"][0] or \
                    out[mode][1].tobytes() != out["serial"][1].tobytes():
                raise AssertionError(f"phase 3i: {mode} is not bitwise the "
                                     "serial step in a world of one")
            if report[f"{mode}_all_reduces"] != blocks + 1:
                raise AssertionError(f"phase 3i: {mode} made "
                                     f"{report[f'{mode}_all_reduces']} "
                                     f"all_reduces, not {blocks} + 1")
        if report["serial_all_reduces"] != 2:
            raise AssertionError("phase 3i: the serial step made "
                                 f"{report['serial_all_reduces']} all_reduces")
        model = rt.SGPR(x, y, hyp=hyp, z=z, device=DEV)
        vr, gr = model._neg_vg()
        v, g = out["serial"]
        report["sgpr_value_rel_diff"] = dv = abs(v - vr) / abs(vr)
        report["sgpr_grad_rel_diff"] = dg = rel_diff(g, gr)
        if not (dv <= 1e-9 and dg <= GRAD_RTOL):
            raise AssertionError(f"phase 3i: value {dv:.3e} / gradient "
                                 f"{dg:.3e} against SGPR._neg_vg")
        del model

        # -- the latent map at gplvm-usps, overlapped ------------------------------
        yl, _ = usps_like(np.random.default_rng(SEED), usps.n)
        gm = rt.BayesianGPLVM(yl, q=usps.q, num_inducing=usps.m, device=DEV)
        p = gm.params
        leng, lvg = make_gp_train_step(group, usps.d, latent=True,
                                       argnums=(0, 1, 2, 3),
                                       chunk_size=USPS_OVERLAP_CHUNK,
                                       reduce_mode="overlap", device=DEV)
        ldata, lw = leng.put_data(y=yl, mu=p["mu"].cpu().numpy(),
                                  s=torch.exp(p["log_s"]).cpu().numpy())
        lv, (gh, gz, gmu, gs) = count("overlap_gplvm_value_and_grad_s",
                                      lambda: lvg(p["hyp"], p["z"],
                                                  ldata["mu"], ldata["s"],
                                                  ldata["y"], lw, np.ones(1),
                                                  float(usps.n)))
        lvr, lgr = gm._neg_vg()
        n = usps.n
        lg = Flat(p).ravel({"hyp": gh, "z": gz, "mu": gmu[:n],
                            "log_s": gs[:n] * ldata["s"][:n]})
        report["gplvm_value_rel_diff"] = dv = abs(float(lv) - lvr) / abs(lvr)
        report["gplvm_grad_rel_diff"] = dg = rel_diff(lg, lgr)
        if not (dv <= 1e-9 and dg <= GPLVM_GRAD_SPREAD):
            raise AssertionError(f"phase 3i latent overlap: value {dv:.3e} / "
                                 f"gradient {dg:.3e} against "
                                 "BayesianGPLVM._neg_vg")
    finally:
        dist.destroy_process_group()
    return (x, y, z, hyp), out["serial"], gm


def async_engine_3i(rt, cfg, usps, inputs, serial, gm, count, report):
    """(c) ``AsyncEngine`` over ASYNC_SHARDS shards of ``cfg``'s rows: the
    all-fresh step against ``exact_value_and_grad`` and the serial
    distributed step, the fixed point at refresh 1, clipped SGD under
    ``FailureSimulator`` (the exact bound must rise), each refresh's step
    time and launches; the latent engine at ``usps`` all fresh against
    ``BayesianGPLVM._neg_vg``."""
    from repro_torch.core.flat import Flat
    from repro_torch.distributed import AsyncEngine, FailureSimulator
    from repro_torch.kernels.reg_stats import ops as rs_ops
    from repro_torch.train.steps import make_gp_async_step

    x, y, z, hyp = inputs
    rows = cfg.n // ASYNC_SHARDS
    shards = [{"y": y[k * rows:(k + 1) * rows], "mu": x[k * rows:(k + 1) * rows]}
              for k in range(ASYNC_SHARDS)]
    h, zz = {k: t64(v) for k, v in hyp.items()}, t64(z)
    blocks = -(-rows // OVERLAP_CHUNK)

    def engine(**kw):
        return AsyncEngine(shards, cfg.d, chunk_size=OVERLAP_CHUNK,
                           device=DEV, **kw)

    fresh = count("async_engine_build_s", lambda: engine(
        staleness=ASYNC_STALENESS, refresh=ASYNC_SHARDS))
    v, (gh, gz) = count("async_all_fresh_step_s", lambda: fresh.step(h, zz))
    ve, (ghe, gze) = count("async_exact_value_and_grad_s",
                           lambda: fresh.exact_value_and_grad(h, zz))
    g, ge = flat_grads(gh, gz), flat_grads(ghe, gze)
    report["all_fresh_vs_exact"] = {
        "value_rel_diff": abs(float(v) - float(ve)) / abs(float(ve)),
        "grad_rel_diff": rel_diff(g, ge)}
    report["all_fresh_vs_serial_step"] = {
        "value_rel_diff": abs(float(v) - serial[0]) / abs(serial[0]),
        "grad_rel_diff": rel_diff(g, serial[1])}
    if not (report["all_fresh_vs_exact"]["value_rel_diff"] <= ASYNC_REL
            and report["all_fresh_vs_exact"]["grad_rel_diff"] <= 1e-9
            and report["all_fresh_vs_serial_step"]["value_rel_diff"] <= 1e-9
            and report["all_fresh_vs_serial_step"]["grad_rel_diff"]
            <= GRAD_RTOL):
        raise AssertionError(f"phase 3i async all-fresh: {report}")

    # -- the fixed point: refresh 1, staleness 8, 8 steps at fixed (hyp, z) --
    fixed = engine(staleness=ASYNC_STALENESS, refresh=1)
    for i in range(ASYNC_SHARDS):
        vf, _ = count(f"async_fixed_point_step{i}_s",
                      lambda: fixed.step(h, zz))
    report["fixed_point_rel_diff"] = abs(float(vf) - float(ve)) / abs(float(ve))
    if not report["fixed_point_rel_diff"] <= ASYNC_REL:
        raise AssertionError(f"phase 3i async fixed point: {report}")

    # -- clipped SGD under failures: the exact bound must rise ------------------
    eng, step = make_gp_async_step(
        shards, cfg.d, staleness=ASYNC_SGD_STALENESS, refresh=1,
        failure=FailureSimulator(ASYNC_SHARDS, 0.1, seed=3),
        chunk_size=OVERLAP_CHUNK, clip=ASYNC_CLIP, device=DEV)
    ph, pz = dict(h), zz
    values = []

    def sgd():
        nonlocal ph, pz
        for _ in range(ASYNC_SGD_STEPS):
            val, (g_h, g_z) = step(ph, pz)
            values.append(float(val))
            ph = {k: ph[k] - ASYNC_LR * g_h[k] for k in ph}
            pz = pz - ASYNC_LR * g_z
    count("async_sgd_s", sgd)
    v1, _ = eng.exact_value_and_grad(ph, pz)
    report["sgd"] = {"steps": ASYNC_SGD_STEPS, "bound_before": -float(ve),
                     "bound_after": -float(v1),
                     "members_at_end": eng.acc.members(),
                     "async_values": values}
    if not (all(math.isfinite(a) for a in values) and float(v1) < float(ve)):
        raise AssertionError(f"phase 3i async SGD: {report['sgd']}")

    # -- each refresh's step time and launches ---------------------------------
    for r in ASYNC_REFRESH:
        e = engine(staleness=ASYNC_STALENESS, refresh=r)
        e.step(h, zz)
        before = rs_ops.LAUNCHES["float64"]
        report[f"refresh{r}_step_s"] = count(
            f"async_refresh{r}_timed_s", lambda: median_step_s(
                lambda: e.step(h, zz)))
        per_step = (rs_ops.LAUNCHES["float64"] - before) / (STEP_REPS + 1)
        report[f"refresh{r}_reg_stats_per_step"] = per_step
        if per_step != r * blocks:
            raise AssertionError(f"phase 3i async refresh {r}: {per_step} "
                                 f"reg_stats launches a step, not "
                                 f"{r * blocks}")
    report["exact_value_and_grad_s"] = median_step_s(
        lambda: fresh.exact_value_and_grad(h, zz), reps=3)

    # -- the latent engine at gplvm-usps, all fresh ------------------------------
    p = gm.params
    mu, s, yl = p["mu"], torch.exp(p["log_s"]), gm.y
    cut = np.linspace(0, usps.n, ASYNC_USPS_SHARDS + 1).astype(int)
    lshards = [{"y": yl[a:b], "mu": mu[a:b].detach(), "s": s[a:b].detach()}
               for a, b in zip(cut[:-1], cut[1:])]
    leng = AsyncEngine(lshards, usps.d, staleness=1,
                       refresh=ASYNC_USPS_SHARDS, latent=True, device=DEV)
    lv, (lgh, lgz) = count("async_gplvm_all_fresh_step_s",
                           lambda: leng.step(p["hyp"], p["z"]))
    lvr, lgr = gm._neg_vg()
    ref = Flat(p).unravel(lgr)
    report["gplvm_value_rel_diff"] = dv = abs(float(lv) - lvr) / abs(lvr)
    report["gplvm_grad_rel_diff"] = dg = rel_diff(
        flat_grads(lgh, lgz), flat_grads(ref["hyp"], ref["z"]))
    # The value of 4 shards' psi statistics summed, against one pass over
    # all rows: 1.4e-9 apart on the H100, inside the repo's f64 bound
    # parity limit (1e-8) though not 3d's 1e-9.
    if not (dv <= GRAD_RTOL and dg <= GPLVM_GRAD_SPREAD):
        raise AssertionError(f"phase 3i latent async: value {dv:.3e} / "
                             f"gradient {dg:.3e} against "
                             "BayesianGPLVM._neg_vg")


def async_ranks_3i(cfg, sgpr, serial, report) -> dict:
    """(b) and (d) in one spawn of DIST_WORLD gloo ranks on the card
    (``async_rank``): each mode's bits on every rank, ``overlap`` bitwise
    ``overlap_eager``, within 1e-9 / 1e-8 of the serial step, one
    all_reduce a block; every front-end response bitwise a world of one's
    answer under its generation's state, every follower exited 0.
    Returns the ranks' launches."""
    from repro_torch.serve import PredictEngine, online, save_state

    x_new, y_new = make_regression(np.random.default_rng(FE_RANK_SWAP_SEED),
                                   ONLINE_K, cfg.q, cfg.d)
    swap_to = online.update_state(sgpr["state"], x_new, y_new).state
    with tempfile.TemporaryDirectory() as tmp:
        paths = (f"{tmp}/state", f"{tmp}/swap", f"{tmp}/queries.npy",
                 (ASYNC_RANKS_N, cfg.q, cfg.d, cfg.m))
        save_state(paths[0], sgpr["state"])
        save_state(paths[1], swap_to)
        np.save(paths[2], sgpr["queries"])
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        res = spawn_ranks(DIST_WORLD, paths, str(torch.device(DEV, 0)),
                          target=async_rank)
        report["ranks_wall_s"] = time.perf_counter() - t0
    # (b)
    blocks = ASYNC_RANKS_N // DIST_WORLD // ASYNC_RANKS_CHUNK
    for mode in REDUCE_MODES:
        for r, rr in enumerate(res):
            for k in (f"{mode}_value", f"{mode}_grad"):
                if rr[k].tobytes() != res[0][k].tobytes():
                    raise AssertionError(f"phase 3i: rank {r}'s {k} differs "
                                         "from rank 0's")
    r0 = res[0]
    for k in ("value", "grad"):
        if r0[f"overlap_{k}"].tobytes() != r0[f"overlap_eager_{k}"].tobytes():
            raise AssertionError(f"phase 3i: overlap's {k} is not bitwise "
                                 "overlap_eager's")
    dv = abs(float(r0["overlap_value"]) - float(r0["serial_value"])) / abs(
        float(r0["serial_value"]))
    dg = rel_diff(r0["overlap_grad"], r0["serial_grad"])
    report["ranks_overlap_vs_serial"] = {"value_rel_diff": dv,
                                         "grad_rel_diff": dg}
    report["ranks_all_reduces"] = {m: int(r0[f"{m}_all_reduces"])
                                   for m in REDUCE_MODES}
    report["ranks_step_s"] = {m: float(r0[f"{m}_step_s"])
                              for m in REDUCE_MODES}
    if not (dv <= 1e-9 and dg <= GRAD_RTOL):
        raise AssertionError(f"phase 3i ranks: overlap value {dv:.3e} / "
                             f"gradient {dg:.3e} against the serial step")
    if report["ranks_all_reduces"] != {"serial": 2, "overlap": blocks + 1,
                                       "overlap_eager": blocks + 1}:
        raise AssertionError(f"phase 3i ranks: {report['ranks_all_reduces']}")
    # (d)
    reqs = fe_rank_requests(sgpr["queries"])
    gens = r0["fe_generation"]
    refs = {0: PredictEngine(sgpr["state"], device=DEV),
            1: PredictEngine(swap_to, device=DEV)}
    bad, lo = 0, 0
    for xq, g in zip(reqs, gens):
        hi = lo + xq.shape[0]
        m_ref, v_ref = refs[int(g)].predict(xq)
        bad += not (np.array_equal(r0["fe_mean"][lo:hi], m_ref.cpu().numpy())
                    and np.array_equal(r0["fe_var"][lo:hi],
                                       v_ref.cpu().numpy()))
        lo = hi
    served = [int(rr["served"]) for rr in res[1:]]
    flushes = int(r0["fe_flushes"])
    shapes = int(r0["fe_shapes"])
    rows = sum(xq.shape[0] for xq in reqs)
    report["frontend"] = {
        "requests": FE_RANK_REQUESTS, "rows": rows, "flushes": flushes,
        "warmup_shapes": shapes, "burst_s": float(r0["fe_burst_s"]),
        "rows_per_s": rows / float(r0["fe_burst_s"]),
        "e2e_p50_ms": float(r0["fe_e2e_p50_ms"]),
        "e2e_p99_ms": float(r0["fe_e2e_p99_ms"]),
        "flush_ms_median": float(np.median(r0["fe_flush_ms"])),
        "flush_ms_max": float(np.max(r0["fe_flush_ms"])),
        "broadcasts": int(r0["fe_broadcasts"]),
        "broadcast_bytes": int(r0["fe_broadcast_bytes"]),
        "broadcast_ms": float(r0["fe_broadcast_ms"]),
        "swap_ms": float(r0["fe_swap_ms"]),
        "generations": {g: int((gens == g).sum()) for g in (0, 1)},
        "followers_served": served, "responses_not_bitwise": bad,
        "predict_launches_per_rank": [int(rr["predict_launches"])
                                      for rr in res]}
    if bad or int(r0["fe_completed"]) != FE_RANK_REQUESTS \
            or gens.tolist() != [0] * FE_RANK_SWAP_AT + [1] * (
                FE_RANK_REQUESTS - FE_RANK_SWAP_AT) \
            or served != [flushes + shapes] * (DIST_WORLD - 1) \
            or report["frontend"]["predict_launches_per_rank"] != [
                flushes + shapes] * DIST_WORLD:
        raise AssertionError(f"phase 3i front-end over ranks: "
                             f"{report['frontend']}")
    return {"reg_stats_f64": int(sum(int(rr["reg_stats_launches"])
                                     for rr in res)),
            "predict_f64": int(sum(int(rr["predict_launches"])
                                   for rr in res))}


def async_path(rt, cfg, usps, sgpr) -> dict:
    """Phase 3i: the overlapped reduce (``overlap_3i``), the async engine
    (``async_engine_3i``), and 4 gloo ranks for the overlapped reduce and
    the front-end over the ranks (``async_ranks_3i``).  Every launch
    counter is 0 just before and read just after; the references run
    beside the port's calls (``SGPR``, ``BayesianGPLVM``, the world-of-one
    engines) are left out."""
    from repro_torch.kernels.predict import ops as p_ops
    from repro_torch.kernels.psi_stats import ops as ps_ops
    from repro_torch.kernels.reg_stats import ops as rs_ops

    steps, report = {}, {}
    step = timed_step(steps)

    def counts():
        return {"reg_stats_f64": rs_ops.LAUNCHES["float64"],
                "reg_stats_bwd_f64": rs_ops.LAUNCHES["bwd_float64"],
                "psi2_f64": ps_ops.LAUNCHES["psi2_float64"],
                "psi2_bwd_f64": ps_ops.LAUNCHES["psi2_bwd_float64"],
                "psi1_bwd_f64": ps_ops.LAUNCHES["psi1_bwd_float64"],
                "psi1_f64": ps_ops.LAUNCHES["psi1_float64"],
                "predict_f64": p_ops.LAUNCHES["float64"]}

    launches = {k: 0 for k in counts()}

    def count(name, fn):
        """``fn`` timed, its launches added to ``launches``."""
        before = counts()
        out = step(name, fn)
        for k, c in counts().items():
            launches[k] += c - before[k]
        return out

    reset_counts(rs_ops.LAUNCHES, p_ops.LAUNCHES, ps_ops.LAUNCHES)
    overlap, engine, ranks = {}, {}, {}
    t0 = time.perf_counter()
    try:
        inputs, serial, gm = overlap_3i(rt, cfg, usps, count, overlap)
        async_engine_3i(rt, cfg, usps, inputs, serial, gm, count, engine)
        del gm, inputs
        torch.cuda.empty_cache()
        for k, c in async_ranks_3i(cfg, sgpr, serial, ranks).items():
            launches[k] += c
    finally:   # what was measured, also when a check failed
        print(f"async path (3i) steps (s): {json.dumps(steps)}", flush=True)
        for label, rep in (("overlapped reduce, NCCL world of one", overlap),
                           ("AsyncEngine", engine),
                           (f"{DIST_WORLD} gloo ranks on one card", ranks)):
            print(f"async path (3i) {label}: {json.dumps(rep)}", flush=True)
        print(f"async path (3i) card: {nvidia_smi()}; phase 3i took "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
    print(f"async path (3i) launches: {json.dumps(launches)}", flush=True)
    for name, c in launches.items():
        if c < 1:
            raise AssertionError(f"kernel {name} was not launched on the "
                                 "async path")
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


def library_attention(q, k, v, causal=True):
    """``scaled_dot_product_attention`` on the same inputs (its is_causal
    aligns as the kernel does at T = S): GQA through ``enable_gqa``, or,
    where this torch lacks it, K/V expanded once outside the timed call."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    try:
        sdpa(q, k, v, is_causal=causal, enable_gqa=True)
        return lambda: sdpa(q, k, v, is_causal=causal, enable_gqa=True)
    except TypeError:
        g = q.shape[1] // k.shape[1]
        ke, ve = (x.repeat_interleave(g, dim=1) for x in (k, v))
        return lambda: sdpa(q, ke, ve, is_causal=causal)


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
        lib = library_attention(q, k, v, causal)
        out["library_ms"] = time_ms(lib)
        out["library_max_abs_err"] = float((lib().double() - plain).abs().max())
        out["visible_pairs"] = pairs
        out["bound_ms"], out["bound_by"] = flash_bound(
            pairs, b, h, hkv, t, s, dh, dtype, peaks)
    print(f"flash_attention {out}", flush=True)
    return out


# -- phase 3c: llama3.2-1b prefill and decode ----------------------------------

def rel_rms(got, want) -> float:
    return float(torch.linalg.norm(got.double() - want.double())
                 / torch.linalg.norm(want.double()))


def lm_path(fa_ops, fa_ref) -> dict:
    import dataclasses
    from unittest import mock

    from repro_torch.configs import get_config
    from repro_torch.models import transformer as tf
    from repro_torch.train import steps as lm_steps

    # The registered config prefills through the query-chunked attention,
    # as the JAX package's does; serving asks for the flash kernel.
    cfg = dataclasses.replace(get_config("llama3.2-1b"), use_flash=True)
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
    caches = step("grow_cache_s", lambda: tf.grow_decode_cache(
        cfg, caches, t + n_new))
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
        grown = tf.grow_decode_cache(c, c_short, t)
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


# -- phase 3j: LM training ------------------------------------------------------

LM_TRAIN_STEPS = 10        # Adam steps on one repeated batch (full width)
QWEN_TRAIN_STEPS = 3
TRAIN_ARGS = ["--reduced", "--batch", "2", "--seq", "32"]
COMPRESS_ARGS = ["--reduced", "--batch", "8", "--seq", "128", "--steps", "24",
                 "--compress-grads"]


def lm_loss_and_grads(tf, cfg, params, batch):
    """forward_train's loss and its gradient in every leaf, keyed by path."""
    from repro_torch.core.flat import tree_items

    paths, leaves = zip(*tree_items(params))
    for leaf in leaves:
        leaf.requires_grad_(True)
    loss, _ = tf.forward_train(cfg, params, batch)
    return loss.detach(), dict(zip(paths, torch.autograd.grad(loss, leaves)))


def lm_batch(cfg, b, t, device, seed=SEED):
    rng = np.random.default_rng(seed)
    return {k: torch.from_numpy(rng.integers(0, cfg.vocab_size, (b, t),
                                             dtype=np.int32)).to(device)
            for k in ("tokens", "labels")}


def get_lm_config(name):
    from repro_torch.configs import get_config
    return get_config(name)


def flat_tree(tree) -> dict:
    from repro_torch.core.flat import tree_items
    return dict(tree_items(tree))


def leaf_rels(got: dict, want: dict) -> dict:
    """Each leaf's relative RMS, keyed by its path joined with "/" (``got``
    may lie on another device than ``want``)."""
    return {"/".join(k): rel_rms(got[k].detach().to(want[k].device),
                                 want[k].detach()) for k in want}


def max_leaf_rel(got: dict, want: dict) -> float:
    return max(leaf_rels(got, want).values())


def lm_card_vs_cpu(tf, lm_steps, adam, report):
    """(a) Reduced configs in f32 (TF32 off): forward_train's loss and
    every gradient leaf, then one train step's state and metrics, on the
    card against the same calls on the CPU."""
    from repro_torch.models.common import tree_map

    for arch in ("llama3.2-1b", "starcoder2-3b"):
        cfg = get_lm_config(arch).reduced()
        params = tf.init_params(cfg, torch.Generator().manual_seed(SEED),
                                device="cpu")
        batch = lm_batch(cfg, 4, 256, "cpu")
        batch["labels"][0, :5] = -1
        out = {}
        for dev in (DEV, "cpu"):
            p = tree_map(lambda a, d=dev: a.to(d), params)
            bd = {k: v.to(dev) for k, v in batch.items()}
            loss, grads = lm_loss_and_grads(tf, cfg, p, bd)
            state = {"params": tree_map(lambda a: a.detach().clone(), p),
                     "opt": adam.init_opt_state(p)}
            state, m = lm_steps.make_train_step(cfg)(state, bd)
            out[dev] = (loss, grads, state, m)
        (loss, grads, state, m), (loss_c, grads_c, state_c, m_c) = (
            out[DEV], out["cpu"])
        by_leaf = leaf_rels(flat_tree(state["params"]),
                            flat_tree(state_c["params"]))
        res = {"loss": rel_rms(loss.cpu(), loss_c),
               "grad_leaf_max": max_leaf_rel(grads, grads_c),
               "params_leaf_max": max(by_leaf.values()),
               "m_leaf_max": max_leaf_rel(flat_tree(state["opt"]["m"]),
                                          flat_tree(state_c["opt"]["m"])),
               "v_leaf_max": max_leaf_rel(flat_tree(state["opt"]["v"]),
                                          flat_tree(state_c["opt"]["v"])),
               "step_loss": rel_rms(m["loss"].cpu(), m_c["loss"]),
               "step_grad_norm": rel_rms(m["grad_norm"].cpu(),
                                         m_c["grad_norm"])}
        report[f"card_vs_cpu_{arch}"] = res
        report[f"card_vs_cpu_{arch}_params_by_leaf"] = by_leaf
        if not all(v <= LOGIT_RTOL["float32"] for v in res.values()):
            raise AssertionError(f"phase 3j (a) {arch}: card against CPU "
                                 f"{res}")


def lm_full_width(tf, attn, lm_steps, adam, roofline, peaks, step, report):
    """(b) llama3.2-1b at full width (f32 params, bf16 compute, remat), B 4,
    T 2048: the chunkings against one chunk and bf16 against f32 compute
    (loss and gradients), then LM_TRAIN_STEPS Adam steps on the batch."""
    import dataclasses
    import functools
    from unittest import mock

    from repro_torch.configs import ShapeSpec

    cfg = get_lm_config("llama3.2-1b")
    assert cfg.remat and not cfg.use_flash and cfg.param_dtype == "float32"
    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    b, t = LM_BATCH, LM_PROMPT
    gen = torch.Generator(device=DEV).manual_seed(SEED)
    params = step("train_init_params_s",
                  lambda: tf.init_params(cfg, gen, device=DEV))
    batch = lm_batch(cfg, b, t, DEV)

    # f32 compute: the default chunks (512 query rows, 512 CE rows) against
    # one chunk of each.
    loss32, grads32 = step("f32_loss_and_grads_s", lambda: lm_loss_and_grads(
        tf, cfg32, params, batch))
    one_attn = functools.partial(attn._attend_chunked, chunk=t)
    one_ce = functools.partial(tf.cross_entropy_chunked, chunk=t)
    with mock.patch.object(attn, "_attend_chunked", one_attn), \
            mock.patch.object(tf, "cross_entropy_chunked", one_ce):
        loss1, grads1 = step("f32_one_chunk_loss_and_grads_s",
                             lambda: lm_loss_and_grads(tf, cfg32, params,
                                                       batch))
    chunks = {"loss": rel_rms(loss32, loss1),
              "grad_leaf_max": max_leaf_rel(grads32, grads1)}
    report["chunked_vs_one_chunk_f32"] = chunks
    if not all(v <= LOGIT_RTOL["float32"] for v in chunks.values()):
        raise AssertionError(f"phase 3j (b): chunked against one chunk "
                             f"{chunks}")
    del grads1
    torch.cuda.empty_cache()

    # bf16 compute against f32 compute on the same params and batch.
    loss16, grads16 = step("bf16_loss_and_grads_s", lambda: lm_loss_and_grads(
        tf, cfg, params, batch))
    gn16, gn32 = adam.global_norm(grads16), adam.global_norm(grads32)
    groups: dict = {}
    for path, g in grads32.items():
        key = "/".join(path[2:] if path[0] == "groups" else path)
        groups[key] = rel_rms(grads16[path], g)
    bf = {"loss": rel_rms(loss16, loss32), "grad_norm": rel_rms(gn16, gn32),
          "loss_bf16": float(loss16), "loss_f32": float(loss32),
          "grad_rel_rms_by_leaf": groups}
    report["bf16_vs_f32_compute"] = bf
    if not (bf["loss"] <= LOGIT_RTOL["bfloat16"]
            and bf["grad_norm"] <= LOGIT_RTOL["bfloat16"]):
        raise AssertionError(f"phase 3j (b): bf16 against f32 compute {bf}")
    del grads16, grads32
    torch.cuda.empty_cache()

    # LM_TRAIN_STEPS Adam steps on the repeated batch: the loss must fall.
    state = {"params": params, "opt": adam.init_opt_state(params)}
    train = lm_steps.make_train_step(cfg)
    torch.cuda.reset_peak_memory_stats()
    times, losses = [], []
    for i in range(LM_TRAIN_STEPS):
        state, m = step(f"train_step_{i}_s", lambda: train(state, batch))
        times.append(step.last)
        losses.append(float(m["loss"]))
    peak = torch.cuda.max_memory_allocated()
    med = statistics.median(times)
    flops = roofline.model_flops(cfg, ShapeSpec("train_cut", t, b, "train"),
                                 1)
    report["full_width_train"] = {
        "batch": b, "seq": t, "steps": LM_TRAIN_STEPS, "losses": losses,
        "step_s": times, "step_median_s": med, "tokens_per_s": b * t / med,
        "model_flops": flops, "mfu": flops / med / peaks[3],
        "bound_s": flops / peaks[3],
        "peak_memory_gb": peak / 1e9}
    if not (np.all(np.isfinite(losses)) and losses[-1] < losses[0]):
        raise AssertionError(f"phase 3j (b): losses {losses}")


def lm_qwen(tf, lm_steps, adam, step, report):
    """(c) qwen2-1.5b (launch/train.py's default arch) at full width, B 4,
    T 2048: QWEN_TRAIN_STEPS steps, the loss finite."""
    cfg = get_lm_config("qwen2-1.5b")
    gen = torch.Generator(device=DEV).manual_seed(SEED)
    state = lm_steps.init_train_state(cfg, gen, device=DEV)
    batch = lm_batch(cfg, LM_BATCH, LM_PROMPT, DEV)
    train = lm_steps.make_train_step(cfg)
    times, losses = [], []
    for i in range(QWEN_TRAIN_STEPS):
        state, m = step(f"qwen_step_{i}_s", lambda: train(state, batch))
        times.append(step.last)
        losses.append(float(m["loss"]))
    report["qwen2_full_width"] = {"losses": losses, "step_s": times}
    if not np.all(np.isfinite(losses)):
        raise AssertionError(f"phase 3j (c): qwen2-1.5b losses {losses}")


def lm_launch_train(report):
    """(d) ``launch.train.main`` on the card at --reduced: 8 steps straight
    against 4, a checkpoint and a resume to 8 (final losses within 1e-4),
    and a --compress-grads run (finite, falling)."""
    from repro_torch.launch import train as launch_train

    dev = ["--device", DEV]
    with tempfile.TemporaryDirectory() as d:
        d = pathlib.Path(d)
        straight = launch_train.main(TRAIN_ARGS + dev + [
            "--steps", "8", "--ckpt-dir", str(d / "a"), "--ckpt-every",
            "100"])
        launch_train.main(TRAIN_ARGS + dev + [
            "--steps", "4", "--ckpt-dir", str(d / "b"), "--ckpt-every", "4"])
        resumed = launch_train.main(TRAIN_ARGS + dev + [
            "--steps", "8", "--ckpt-dir", str(d / "b"), "--ckpt-every",
            "100"])
    compressed = launch_train.main(COMPRESS_ARGS + dev)
    res = {"straight_final": straight[-1], "resumed_final": resumed[-1],
           "resumed_rel_diff": abs(resumed[-1] - straight[-1])
           / abs(straight[-1]),
           "bitwise": resumed[-1] == straight[-1],
           "compressed_losses": compressed}
    report["launch_train"] = res
    first, last = np.mean(compressed[:4]), np.mean(compressed[-4:])
    if not (len(resumed) == 4 and res["resumed_rel_diff"] <= 1e-4
            and np.all(np.isfinite(compressed)) and last < first):
        raise AssertionError(f"phase 3j (d): {res}")


def lm_train_path(fa_ops, peaks) -> dict:
    from repro_torch.launch import roofline
    from repro_torch.models import attention as attn
    from repro_torch.models import transformer as tf
    from repro_torch.optim import adam
    from repro_torch.train import steps as lm_steps

    steps = {}
    step = timed_step(steps)
    report = {}
    counts = fa_ops.LAUNCHES
    # Every launch counter to 0 just before the path, read just after.
    t0 = time.perf_counter()
    reset_counts(counts)
    lm_card_vs_cpu(tf, lm_steps, adam, report)
    lm_full_width(tf, attn, lm_steps, adam, roofline, peaks, step, report)
    torch.cuda.empty_cache()
    lm_qwen(tf, lm_steps, adam, step, report)
    torch.cuda.empty_cache()
    lm_launch_train(report)
    launches = {"flash_attention_bf16": counts["bfloat16"],
                "flash_attention_f32": counts["float32"]}
    total = time.perf_counter() - t0
    print(f"LM training path (3j) steps (s): {json.dumps(steps)}", flush=True)
    for key, val in report.items():
        print(f"LM training path (3j) {key}: {json.dumps(val)}", flush=True)
    print(f"LM training path (3j) launches: {json.dumps(launches)}",
          flush=True)
    if any(launches.values()):
        raise AssertionError(f"phase 3j: the training path launched the "
                             f"flash kernel {launches}")
    print(f"LM training path (3j) card: {nvidia_smi()}; phase 3j took "
          f"{total:.1f} s", flush=True)
    return launches

# -- phase 3k: the other five LM architectures, served at full width -----------

ARCH_ORDER = ("mamba2-370m", "whisper-medium", "recurrentgemma-9b",
              "deepseek-v2-236b", "qwen3-moe-235b-a22b")
ARCH_FLASH = ("whisper-medium", "qwen3-moe-235b-a22b")   # Dh 64: the kernel
ARCH_PROMPT = {"recurrentgemma-9b": 3072}   # 1.5 windows of 2048
ARCH_CARD_VS_CPU = (2, 64)                  # B, T of the reduced configs
# The configs whose bf16 end-to-end logit checks (teacher-forced, flash
# against plain) hold at the repo's tier.  In the other three the bf16
# roundings the decode step makes at other points than the prefill (the
# window attention's f32 softmax over 2,048 slots, not 3,072 columns, then
# its bf16 output; MLA's decompressed K/V, which only the prefill rounds;
# the flash kernel's P) grow through depth and the MoE layers past 2e-2
# (PERF.md, PR 27; tools/decode_gap.py); their values are printed
# against the tier, and all five hold ARCH_DECODE_ERR_RATIO.
ARCH_BF16_END_TO_END = ("mamba2-370m", "whisper-medium")
# The bf16 decode step's relative RMS from the f32-compute prefill over the
# bf16 prefill's (MoE top-k pinned): the decode no less accurate than the
# prefill, within 50%.
ARCH_DECODE_ERR_RATIO = 1.5
# (B, H, Hkv, T, S, Dh, causal) of the flash launches 3k adds: qwen3-moe,
# the whisper decoder and the whisper encoder (the first full-size
# non-causal use)
ARCH_FLASH_SHAPES = ((LM_BATCH, 64, 4, LM_PROMPT, LM_PROMPT, 64, True),
                     (LM_BATCH, 16, 16, LM_PROMPT, LM_PROMPT, 64, True),
                     (LM_BATCH, 16, 16, 1500, 1500, 64, False))


def arch_config(name):
    """The registered config at full width, its depth cut only where one
    card forces it (deepseek: the dense layer and 2 of 59 MoE layers;
    qwen3-moe: 4 of 94 layers; the others whole), bf16 compute, the flash
    kernel asked for where the head dim is the kernel's."""
    import dataclasses

    from repro_torch.configs import BlockGroup

    cfg = get_lm_config(name)
    blocks = {"deepseek-v2-236b": (cfg.blocks[0],
                                   BlockGroup("mla", "moe", 2)),
              "qwen3-moe-235b-a22b": (BlockGroup("attn", "moe", 4),)
              }.get(name, cfg.blocks)
    return dataclasses.replace(
        cfg, blocks=blocks, num_layers=sum(g.count for g in blocks),
        use_flash=name in ARCH_FLASH)


def flash_layers(cfg) -> int:
    """Flash launches a prefill: every GQA layer of the decoder (and of the
    encoder) on the flash route; MLA, cross-attention and windows never."""
    if not cfg.use_flash:
        return 0
    n = sum(g.count for g in cfg.blocks if g.mixer == "attn")
    return n + (cfg.encoder_layers if cfg.family == "encdec" else 0)


def arch_batch(cfg, b, t, device):
    rng = np.random.default_rng(SEED)
    batch = {"tokens": torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (b, t), dtype=np.int32)).to(device)}
    if cfg.family == "encdec":
        batch["frames"] = torch.from_numpy(rng.standard_normal(
            (b, cfg.num_frames, cfg.d_model)).astype(np.float32)).to(device)
    return batch


def recording_route(moe_mod, record):
    """``moe._route`` that also keeps each call's expert ids."""
    real = moe_mod._route

    def route(cfg, router_w, x_flat, **kw):
        out = real(cfg, router_w, x_flat, **kw)
        record.append(out[1])
        return out
    return route


def routing_differences(prefill_eids, decode_eids, b) -> tuple[int, int]:
    """(top-k choices of the last token that differ between the prefill and
    the decode step, summed over MoE layers and batch rows; the choices
    compared), each row's choice a set of k experts."""
    diff = total = 0
    for pe, de in zip(prefill_eids, decode_eids):
        last = pe.reshape(b, -1, pe.shape[-1])[:, -1]
        for r in range(b):
            a, c = set(last[r].tolist()), set(de[r].tolist())
            diff += len(a - c)
            total += len(a)
    return diff, total


def pinned_route(moe_mod, choices):
    """``moe._route`` whose calls take their top-k experts from ``choices``
    (one (n, k) tensor a call, in call order) instead of their own: the
    gates are the call's own probabilities at those experts, renormalised,
    and the aux losses its own."""
    real = moe_mod._route
    calls = iter(choices)

    def route(cfg, router_w, x_flat, **kw):
        _, _, aux = real(cfg, router_w, x_flat, **kw)
        eids = next(calls)
        probs = torch.softmax((x_flat @ router_w.to(x_flat.dtype)).float(),
                              dim=-1)
        gates = probs.gather(-1, eids)
        return (gates / gates.sum(-1, keepdim=True)).to(x_flat.dtype), eids, \
            aux
    return route


def layer_recorder(tf, record):
    """``transformer._layer_fwd`` that also keeps each layer's input and
    output at the last position."""
    real = tf._layer_fwd

    def fwd(*args, **kwargs):
        x, cache, aux = real(*args, **kwargs)
        record.append((args[5][:, -1:].clone(), x[:, -1:].clone()))
        return x, cache, aux
    return fwd


def layer_forcer(tf, record, rels):
    """``transformer._layer_decode`` fed each layer's prefill input (from
    ``layer_recorder``) in place of the previous layer's decode output; it
    keeps the relative RMS of the layer's update (output minus input)
    against the prefill's."""
    real = tf._layer_decode
    calls = iter(record)

    def dec(cfg, mixer, ffn, cross, p, x_t, cache, pos):
        x_in, x_out = next(calls)
        y, cache = real(cfg, mixer, ffn, cross, p, x_in, cache, pos)
        rels.append(rel_rms(y.float() - x_in.float(),
                            x_out.float() - x_in.float()))
        return y, cache
    return dec


def arch_serve(name, fa_ops, fa_ref, smi, report) -> list[str]:
    """One config at full width (``arch_config``), B 4: prefill (cold,
    warm), LM_NEW greedy decode steps into the grown caches, an f32-compute
    prefill.  Checks, at bf16 and f32 compute: flash against the plain
    attention and teacher-forced decode against the prefill, end to end
    (the last logits), and layer by layer (each layer's decode step fed
    the prefill's input to that layer, its update against the prefill's;
    a MoE layer's top-k choice pinned to the prefill's); each flash call
    of the cold prefill against the plain version on its own q, k, v.  A
    MoE config counts the last token's top-k choices that differ between
    the two paths end to end, and decodes again with its top-k pinned.
    Returns the checks that failed (the caller raises once every config has
    run and printed): at f32 every logit check within 1e-4; at bf16 the
    layer-by-layer ones within 2e-2, each flash call within the kernel's
    tier, the end-to-end ones within 2e-2 for ``ARCH_BF16_END_TO_END`` (the
    others' printed against 2e-2), and for all five the decode's error from
    the f32-compute prefill within ``ARCH_DECODE_ERR_RATIO`` times the bf16
    prefill's."""
    import dataclasses
    from unittest import mock

    from repro_torch.models import moe as moe_mod
    from repro_torch.models import transformer as tf
    from repro_torch.train import steps as lm_steps

    cfg = arch_config(name)
    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    b, t, n_new = LM_BATCH, ARCH_PROMPT.get(name, LM_PROMPT), LM_NEW
    batch = arch_batch(cfg, b, t, DEV)
    short = {k: (v[:, :-1] if k == "tokens" else v) for k, v in batch.items()}
    steps = {}
    step = timed_step(steps)
    counts = fa_ops.LAUNCHES
    want_flash = flash_layers(cfg)

    def launched(label, fn, want):
        before = counts["bfloat16"] + counts["float32"]
        out = step(label, fn)
        got = counts["bfloat16"] + counts["float32"] - before
        if got != want:
            raise AssertionError(f"phase 3k {name} {label}: flash_attention "
                                 f"launched {got} times, expected {want}")
        return out

    cfgs = {"bfloat16": cfg, "float32": cfg32}
    prefill = {k: lm_steps.make_prefill_step(c) for k, c in cfgs.items()}
    serve = {k: lm_steps.make_serve_step(c) for k, c in cfgs.items()}
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device=DEV).manual_seed(SEED)
    params = step("init_params_s", lambda: tf.init_params(cfg, gen,
                                                          device=DEV))
    flash_worst = []

    def checked_flash(q, k, v, causal=True):
        """The kernel, then its plain version in f64 on the same q, k, v:
        the worst |err| / (tol (1 + |plain|)), as in phase 2."""
        o = real_flash(q, k, v, causal=causal)
        plain = plain_attention(fa_ref, q.double(), k.double(), v.double(),
                                causal)
        flash_worst.append(float(((o.double() - plain).abs() / (
            FA_TOL[o.dtype] * (1 + plain.abs()))).max()))
        return o
    real_flash = fa_ops.flash_attention
    with mock.patch.object(fa_ops, "flash_attention", checked_flash):
        launched("prefill_cold_s",
                 lambda: prefill["bfloat16"](params, batch), want_flash)
    torch.cuda.reset_peak_memory_stats()   # the params stay in the peak
    logits, caches = launched(
        "prefill_s", lambda: prefill["bfloat16"](params, batch), want_flash)
    caches = step("grow_cache_s", lambda: tf.grow_decode_cache(
        cfg, caches, t + n_new))
    tok = logits.argmax(-1, keepdim=True).to(torch.int32)
    decode_s = []
    for i in range(n_new):
        pos = torch.full((b,), t + i, dtype=torch.int32, device=DEV)
        step_logits, caches = launched(
            f"decode_{i}_s", lambda: serve["bfloat16"](params, caches, tok,
                                                       pos), 0)
        decode_s.append(step.last)
        if not bool(torch.isfinite(step_logits).all()):
            raise AssertionError(f"phase 3k {name} decode step {i}: logits "
                                 "not finite")
        tok = step_logits.argmax(-1, keepdim=True).to(torch.int32)
    del caches
    peak = torch.cuda.max_memory_allocated()
    logits32, _ = launched("prefill_f32_compute_s",
                           lambda: prefill["float32"](params, batch),
                           want_flash)
    out = {"config": {"layers": cfg.num_layers, "d_model": cfg.d_model,
                      "batch": b, "prompt": t, "flash": cfg.use_flash,
                      "param_dtype": cfg.param_dtype},
           "prefill_s": steps["prefill_s"],
           "prefill_tokens_per_s": b * t / steps["prefill_s"],
           "prefill_f32_compute_s": steps["prefill_f32_compute_s"],
           "decode_step_median_ms": 1e3 * statistics.median(decode_s),
           "decode_tokens_per_s": b / statistics.median(decode_s),
           "peak_memory_gb": peak / 1e9, "flash_launches_a_prefill":
           want_flash, "card": smi}
    for label, lg in (("bfloat16", logits), ("float32", logits32)):
        if lg.shape != (b, cfg.vocab_size) or not bool(torch.isfinite(lg).all()):
            raise AssertionError(f"phase 3k {name} prefill logits ({label}): "
                                 "bad shape/values")

    # -- flash against the plain attention (same weights, same tokens) ------
    if cfg.use_flash:
        out["bfloat16_flash_calls_worst_err_over_tol"] = max(flash_worst)

        def plain(q, k, v, causal=True):
            return plain_attention(fa_ref, q, k, v, causal)
        with torch.no_grad(), mock.patch.object(fa_ops, "flash_attention",
                                                plain):
            for label, lg in (("bfloat16", logits), ("float32", logits32)):
                out[f"{label}_vs_plain_attention"] = rel_rms(
                    lg, prefill[label](params, batch)[0])

    # -- teacher-forced: prefill T-1 tokens, decode token T-1 ----------------
    last_pos = torch.full((b,), t - 1, dtype=torch.int32, device=DEV)
    for label, lg in (("bfloat16", logits), ("float32", logits32)):
        routes, layers = [], []
        with mock.patch.object(moe_mod, "_route",
                               recording_route(moe_mod, routes)), \
                mock.patch.object(tf, "_layer_fwd",
                                  layer_recorder(tf, layers)):
            prefill[label](params, batch)           # all T tokens
        prefill_eids = list(routes)
        routes.clear()
        with mock.patch.object(moe_mod, "_route",
                               recording_route(moe_mod, routes)):
            _, c_short = prefill[label](params, short)
            grown = tf.grow_decode_cache(cfgs[label], c_short, t)
            del c_short
            n_short = len(routes)
            forced, _ = serve[label](params, grown, batch["tokens"][:, -1:],
                                     last_pos)
        out[f"{label}_teacher_forced_vs_prefill"] = rel_rms(forced, lg)
        last = [e.reshape(b, -1, e.shape[-1])[:, -1] for e in prefill_eids]
        if cfg.num_experts:
            out[f"{label}_routing_differences"] = list(routing_differences(
                prefill_eids, routes[n_short:], b))
            with mock.patch.object(moe_mod, "_route",
                                   pinned_route(moe_mod, last)):
                forced, _ = serve[label](params, grown,
                                         batch["tokens"][:, -1:], last_pos)
            out[f"{label}_teacher_forced_pinned_vs_prefill"] = rel_rms(
                forced, lg)
        if label == "bfloat16":
            out["bfloat16_prefill_vs_float32_compute"] = rel_rms(lg, logits32)
            out["bfloat16_decode_err_over_prefill_err"] = (
                rel_rms(forced, logits32) / rel_rms(lg, logits32))
        rels = []
        with mock.patch.object(tf, "_layer_decode",
                               layer_forcer(tf, layers, rels)), \
                mock.patch.object(moe_mod, "_route",
                                  pinned_route(moe_mod, last)):
            serve[label](params, grown, batch["tokens"][:, -1:], last_pos)
        del grown
        if len(rels) != cfg.num_layers:
            raise AssertionError(f"phase 3k {name}: {len(rels)} layers "
                                 f"forced, {cfg.num_layers} run")
        out[f"{label}_layerwise_teacher_forced_max"] = max(rels)
    report[name] = out
    print(f"LM architectures (3k) {name} steps (s): {json.dumps(steps)}",
          flush=True)
    print(f"LM architectures (3k) {name}: {json.dumps(out)}", flush=True)
    end_to_end = {k: v for k, v in out.items()
                  if k.endswith(("_vs_plain_attention", "_vs_prefill"))}
    limits = {k: LOGIT_RTOL[k.split("_")[0]] for k in end_to_end
              if k.startswith("float32") or name in ARCH_BF16_END_TO_END}
    limits.update({k: LOGIT_RTOL[k.split("_")[0]] for k in out
                   if k.endswith("_layerwise_teacher_forced_max")})
    limits["bfloat16_decode_err_over_prefill_err"] = ARCH_DECODE_ERR_RATIO
    failed = [f"{name} {k}: {out[k]:.3e} > {lim}"
              for k, lim in limits.items() if not out[k] <= lim]
    gaps = {k: v for k, v in end_to_end.items() if k not in limits}
    if gaps:
        print(f"LM architectures (3k) {name}: bf16 end to end against "
              f"{LOGIT_RTOL['bfloat16']} (held instead by the decode's "
              f"error ratio): {json.dumps(gaps)}", flush=True)
    if cfg.use_flash and not max(flash_worst) <= 1.0:
        failed.append(f"{name}: a flash call's max |err|/tol "
                      f"{max(flash_worst):.3e} > 1")
    return failed


def arch_card_vs_cpu(tf, report) -> list[str]:
    """Each of the five reduced configs in f32 (TF32 off): forward_train's
    total, its aux metrics and every gradient leaf on the card against the
    CPU (relative RMS 1e-4).  Returns the configs that missed."""
    from repro_torch.core.flat import tree_items
    from repro_torch.models.common import tree_map

    b, t = ARCH_CARD_VS_CPU
    failed = []
    for name in ARCH_ORDER:
        cfg = get_lm_config(name).reduced()
        params = tf.init_params(cfg, torch.Generator().manual_seed(SEED),
                                device="cpu")
        batch = {**arch_batch(cfg, b, t, "cpu"),
                 "labels": lm_batch(cfg, b, t, "cpu", seed=SEED + 1)["labels"]}
        batch["labels"][0, :5] = -1
        out = {}
        for dev in (DEV, "cpu"):
            p = tree_map(lambda a, d=dev: a.to(d), params)
            paths, leaves = zip(*tree_items(p))
            for leaf in leaves:
                leaf.requires_grad_(True)
            total, metrics = tf.forward_train(
                cfg, p, {k: v.to(dev) for k, v in batch.items()})
            grads = dict(zip(paths, torch.autograd.grad(total, leaves)))
            out[dev] = (total.detach(), {k: v.detach() for k, v in
                                         metrics.items()}, grads)
        (total, metrics, grads), (total_c, metrics_c, grads_c) = (
            out[DEV], out["cpu"])
        res = {"total": rel_rms(total.cpu(), total_c),
               "grad_leaf_max": max_leaf_rel(grads, grads_c)}
        for k, v in metrics_c.items():
            res[k] = rel_rms(metrics[k].cpu(), v) if float(v) else \
                abs(float(metrics[k]))
        report[f"card_vs_cpu_{name}"] = res
        if not all(v <= LOGIT_RTOL["float32"] for v in res.values()):
            failed.append(f"{name}: card against CPU {res}")
    return failed


def arch_serving_path(fa_ops, fa_ref) -> dict:
    """Phase 3k: the five architectures that are not dense GQA, served at
    full width on the card, then held card against CPU at reduced size."""
    from repro_torch.models import transformer as tf

    smi = nvidia_smi()
    report = {}
    counts = fa_ops.LAUNCHES
    # Every launch counter to 0 just before the path, read just after.
    t0 = time.perf_counter()
    reset_counts(counts)
    failed = []
    for name in ARCH_ORDER:
        failed += arch_serve(name, fa_ops, fa_ref, smi, report)
        gc.collect()
        torch.cuda.empty_cache()
    failed += arch_card_vs_cpu(tf, report)
    launches = {"flash_attention_bf16": counts["bfloat16"],
                "flash_attention_f32": counts["float32"]}
    total = time.perf_counter() - t0
    for key, val in report.items():
        if key.startswith("card_vs_cpu"):
            print(f"LM architectures (3k) {key}: {json.dumps(val)}",
                  flush=True)
    print(f"LM architectures (3k) launches: {json.dumps(launches)}",
          flush=True)
    if not all(launches.values()):
        raise AssertionError(f"phase 3k: a flash instantiation never "
                             f"launched {launches}")
    print(f"LM architectures (3k) card: {smi}; phase 3k took {total:.1f} s",
          flush=True)
    if failed:
        raise AssertionError(f"phase 3k: {failed}")
    return launches


# -- phase 3l: qwen3-moe served expert-parallel on 4 ranks of the card --------

EP_NAME = "qwen3-moe-235b-a22b"
EP_MESH = (1, 4)             # ("data", "model"): 4 gloo ranks sharing the card
EP_NODROP_CF = 16.0          # E / k: an expert can take every token of a slice
EP_NODROP_BATCH = 1          # check 1's prompts: (128, 512, 4096) dispatch buffers
EP_TRAIN = (2, 64)           # B, T of the reduced train step (check 5)
EP_GRAD_RTOL = 1e-4          # check 5: each gradient leaf's relative RMS
# tests/test_moe.py:45-46 holds the int8 wire within 5e-2 max |err| of the
# dense output, whose max |y| is 0.09238 on its problem (held by
# tests/test_torch_moe_sharded.py): a bound of 0.5412 max |y|.
INT8_MAX_ERR_OVER_MAX_Y = 5e-2 / 0.09238


def sync(dev):
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()


def ep_config(moe_impl="sharded"):
    """qwen3-moe at full width as phase 3k cuts it (4 of 94 layers, the
    flash kernel), bf16 compute."""
    import dataclasses
    return dataclasses.replace(arch_config(EP_NAME), moe_impl=moe_impl)


def ep_train_config():
    """The reduced qwen3-moe, f32, through the sharded path with no drop
    (capacity factor E / k)."""
    import dataclasses
    cfg = get_lm_config(EP_NAME).reduced()
    return dataclasses.replace(
        cfg, moe_impl="sharded",
        capacity_factor=cfg.num_experts / cfg.experts_per_token)


def recording_moe(moe_mod, record):
    """``moe.moe_forward`` that also keeps each call's input and output."""
    real = moe_mod.moe_forward

    def forward(cfg, p, x):
        y, aux = real(cfg, p, x)
        record.append((x.detach(), y.detach()))
        return y, aux
    return forward


def counting_collectives(moe_mod, record, dev):
    """Patches the MoE's ``all_to_all`` / ``all_gather`` (its own view of
    ``distributed.tensor_parallel``) to keep each call's (kind, bytes this
    rank sends in, seconds between synchronisations); the attention's and
    vocab's collectives are not counted here."""
    import types
    from unittest import mock

    tp = moe_mod.tp

    def wrap(kind, real):
        def call(t, group, *args):
            sync(dev)
            s = time.perf_counter()
            out = real(t, group, *args)
            sync(dev)
            record.append((kind, t.numel() * t.element_size(),
                           time.perf_counter() - s))
            return out
        return call
    view = types.SimpleNamespace(**{
        **vars(tp), "all_to_all": wrap("all_to_all", tp.all_to_all),
        "all_gather": wrap("all_gather", tp.all_gather)})
    return mock.patch.object(moe_mod, "tp", view)


def per_layer(record, layers) -> dict:
    """Bytes and ms a MoE layer of each collective kind."""
    out = {}
    for kind in ("all_to_all", "all_gather"):
        calls = [r for r in record if r[0] == kind]
        out[f"{kind}_calls"] = len(calls) / layers
        out[f"{kind}_bytes"] = sum(r[1] for r in calls) / layers
        out[f"{kind}_ms"] = 1e3 * sum(r[2] for r in calls) / layers
    return out


def bf16_bits(t) -> np.ndarray:
    return t.detach().contiguous().view(torch.int16).cpu().numpy()


def from_bits(a, device) -> torch.Tensor:
    return torch.from_numpy(a).view(torch.bfloat16).to(device)


def ep_rank(rank, world, store_path, out_dir, job, device):
    """One rank of phase 3l's gloo run (a spawned process) on the (1, 4)
    mesh: the params of ``init_params`` with this rank's 32 experts a
    layer, then (1) the no-drop prefill (B 1, routing pinned to the dense
    run's) at bf16 and f32 compute, each MoE layer's output kept; the
    config's capacity factor: (2) prefill B 4 (cold, warm), 16 greedy
    decode steps, each one's logits kept, the MoE layers' inputs, outputs
    and kept pairs, the collectives' bytes and times; (4) the same through
    the int8 wire, and each MoE layer on the native run's inputs through
    both wires; (5) the reduced config's cross-entropy gradient under the
    mesh against the dense path's, the int8 backward's, one train step.
    Writes ``rank<k>.npz``."""
    import dataclasses
    import datetime
    import os
    from unittest import mock

    # Before this process touches the card: freed whole expert leaves must
    # go back to it, not stay in segments that a kept shard pins.
    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
    sys.path.insert(0, str(ROOT / "src"))
    import torch.distributed as dist

    from repro_torch.distributed import sharding
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.launch import make_compat_mesh
    from repro_torch.models import moe as moe_mod
    from repro_torch.models import transformer as tf
    from repro_torch.optim import adam
    from repro_torch.train import steps as lm_steps

    dev = torch.device(device)
    cuda = dev.type == "cuda"
    if not cuda:
        torch.set_num_threads(1)   # CPU ranks share the cores
    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = make_compat_mesh(EP_MESH, ("data", "model"), dev, backend="gloo",
                            store=dist.FileStore(store_path, world),
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(
                                seconds=DIST_GROUP_TIMEOUT_S))
    i = sharding.mesh_coordinate(mesh)["model"]
    cfg, b, t, n_new = job["cfg"], job["batch"], job["prompt"], job["new"]
    layers = cfg.num_layers
    reset_counts(fa_ops.LAUNCHES)
    out = {}

    def timed(fn):
        sync(dev)
        s = time.perf_counter()
        res = fn()
        sync(dev)
        return res, time.perf_counter() - s

    # A stacked expert leaf is drawn whole (12.9 GB in f32): one rank at a
    # time, each keeping its shard and handing the rest back to the card.
    t_init = time.perf_counter()
    for r in range(world):
        if r == rank:
            gen = torch.Generator(device=dev).manual_seed(SEED)
            params = lm_steps.init_params_sharded(cfg, gen, mesh, device=dev)
            if cuda:
                torch.cuda.empty_cache()
        dist.barrier()
    out["init_s"] = time.perf_counter() - t_init
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    moe_p = params["groups"]["g0"]["moe"]

    # -- (1) no drop, routing pinned to the dense run's ----------------------
    b1 = arch_batch(cfg, EP_NODROP_BATCH, t, dev)
    per = EP_NODROP_BATCH * t // EP_MESH[1]
    for label in ("bfloat16", "float32"):
        c = dataclasses.replace(cfg, capacity_factor=EP_NODROP_CF,
                                compute_dtype=label)
        mine = [e[i * per:(i + 1) * per].to(dev) for e in job["choices"][label]]
        rec = []
        with sharding.use_mesh(mesh), \
                mock.patch.object(moe_mod, "_route",
                                  pinned_route(moe_mod, mine)), \
                mock.patch.object(moe_mod, "moe_forward",
                                  recording_moe(moe_mod, rec)):
            (logits, _), s = timed(lambda: lm_steps.make_prefill_step(c)(
                params, b1))
        out[f"nodrop_{label}_logits"] = logits.float().cpu().numpy()
        out[f"nodrop_{label}_prefill_s"] = s
        if rank == 0:
            out[f"nodrop_{label}_layers"] = torch.stack(
                [y for _, y in rec]).float().cpu().numpy()
        del rec

    # -- (2) the config's capacity factor, native and int8 wires -------------
    for wire in ("native", "int8"):
        c = dataclasses.replace(cfg, moe_dispatch_dtype=wire)
        prefill = lm_steps.make_prefill_step(c)
        serve = lm_steps.make_serve_step(c)
        batch = arch_batch(cfg, b, t, dev)
        rec, packed, coll, coll_dec = [], [], [], []
        real_pack = moe_mod._pack_local

        def recording_pack(cfg_, xs, gates, eids, cap):
            buf, meta = real_pack(cfg_, xs, gates, eids, cap)
            packed.append(moe_mod.kept_pairs(meta, *eids.shape))
            return buf, meta
        with sharding.use_mesh(mesh):
            _, out[f"{wire}_prefill_cold_s"] = timed(
                lambda: prefill(params, batch))
            with mock.patch.object(moe_mod, "moe_forward",
                                   recording_moe(moe_mod, rec)), \
                    mock.patch.object(moe_mod, "_pack_local", recording_pack):
                (logits, caches), out[f"{wire}_prefill_s"] = timed(
                    lambda: prefill(params, batch))
            with counting_collectives(moe_mod, coll, dev):
                prefill(params, batch)
            caches = tf.grow_decode_cache(c, caches, t + n_new)
            tok = logits.argmax(-1, keepdim=True).to(torch.int32)
            steps_s, dec_logits = [], [logits.float().cpu().numpy()]
            for s_i in range(n_new):
                pos = torch.full((b,), t + s_i, dtype=torch.int32, device=dev)
                with counting_collectives(moe_mod, coll_dec if s_i == 0
                                          else [], dev):
                    (lg, caches), s = timed(lambda: serve(params, caches, tok,
                                                          pos))
                steps_s.append(s)
                dec_logits.append(lg.float().cpu().numpy())
                tok = lg.argmax(-1, keepdim=True).to(torch.int32)
            del caches
        out[f"{wire}_logits"] = np.stack(dec_logits)
        out[f"{wire}_decode_step_ms"] = 1e3 * statistics.median(steps_s[1:])
        out[f"{wire}_decode_first_ms"] = 1e3 * steps_s[0]
        for k, v in per_layer(coll, layers).items():
            out[f"{wire}_prefill_{k}"] = v
        for k, v in per_layer(coll_dec, layers).items():
            out[f"{wire}_decode_{k}"] = v
        if wire == "native":
            out["kept"] = torch.stack(packed).cpu().numpy()
            moe_in = [x for x, _ in rec]
            moe_out = [y for _, y in rec]
            if rank == 0:
                out["moe_in_bits"] = np.stack([bf16_bits(x) for x in moe_in])
                out["moe_out_bits"] = np.stack([bf16_bits(y) for y in moe_out])
        del rec, packed

    # each MoE layer on the native run's inputs, through both wires
    c8 = dataclasses.replace(cfg, moe_dispatch_dtype="int8")
    rel, worst = [], []
    with torch.no_grad(), sharding.use_mesh(mesh):
        for layer, (x, y) in enumerate(zip(moe_in, moe_out)):
            p_l = {k: v[layer] for k, v in moe_p.items()}
            y8, _ = moe_mod.moe_sharded(c8, p_l, x)
            rel.append(rel_rms(y8.float(), y.float()))
            worst.append(float((y8.float() - y.float()).abs().max()
                               / y.float().abs().max()))
    out["layers_int8_rel_rms"] = np.asarray(rel)
    out["layers_int8_max_err_over_max_y"] = np.asarray(worst)
    del moe_in, moe_out
    out["serving_peak_gb"] = (torch.cuda.max_memory_allocated() / 1e9
                              if cuda else 0.0)
    out["flash_bf16"] = fa_ops.LAUNCHES["bfloat16"]
    out["flash_f32"] = fa_ops.LAUNCHES["float32"]
    del params, moe_p
    if cuda:
        torch.cuda.empty_cache()

    # -- (5) a reduced train step under the mesh, f32, no drop ---------------
    red = job["train_cfg"]
    bt, tt = EP_TRAIN
    tb = lm_batch(red, bt, tt, dev, seed=SEED + 1)
    dense = tf.init_params(dataclasses.replace(red, moe_impl="dense"),
                           torch.Generator(device=dev).manual_seed(SEED),
                           device=dev)
    want = ce_grads(tf, dataclasses.replace(red, moe_impl="dense"), dense,
                    tb)
    logical = flat_tree(tf.param_logical_axes(red))
    rels = {}
    for wire in ("native", "int8"):
        ep = lm_steps.init_params_sharded(
            dataclasses.replace(red, moe_dispatch_dtype=wire),
            torch.Generator(device=dev).manual_seed(SEED), mesh, device=dev)
        with sharding.use_mesh(mesh):
            got = ce_grads(tf, dataclasses.replace(
                red, moe_dispatch_dtype=wire), ep, tb)
        if wire == "int8":
            out["train_int8_grads_finite"] = all(
                bool(torch.isfinite(g).all()) for g in got.values())
            out["train_int8_grads_sq"] = float(sum(
                (g.double() ** 2).sum() for g in got.values()))
            continue
        coord = sharding.mesh_coordinate(mesh)
        for k, g in got.items():
            w = want[k][sharding.shard_slices(logical[k], want[k].shape,
                                              mesh, coord)]
            rels["/".join(k)] = rel_rms(g, w)
        state = {"params": ep, "opt": adam.init_opt_state(ep)}
        with sharding.use_mesh(mesh):
            state, metrics = lm_steps.make_train_step(red)(state, tb)
        out["train_step_loss"] = float(metrics["loss"])
        out["train_step_finite"] = all(
            bool(torch.isfinite(v).all()) for v in metrics.values())
    out["train_grad_leaf_max"] = max(rels.values())
    out["train_grad_worst_leaf"] = max(rels, key=rels.get)
    np.savez(pathlib.Path(out_dir) / f"rank{rank}.npz", **out)
    dist.destroy_process_group()


def ce_grads(tf, cfg, params, batch) -> dict:
    """The gradient of forward_train's cross-entropy (not its aux losses,
    which under a mesh are each token slice's, ROADMAP Queue 3 item 22) in
    every leaf, keyed by path."""
    from repro_torch.core.flat import tree_items

    paths, leaves = zip(*tree_items(params))
    for leaf in leaves:
        leaf.requires_grad_(True)
    _, metrics = tf.forward_train(cfg, params, batch)
    return dict(zip(paths, torch.autograd.grad(metrics["loss"], leaves)))


def plain_ep_moe(moe_mod, cfg, p, x, em):
    """The expert-parallel schedule in one process, no collective: the
    same token slices, routing, stable sort and capacity, every expert on
    its slice's packed buffer.  Returns (y, each slice's kept pairs)."""
    b, t, d = x.shape
    n = b * t
    xf = torch.nn.functional.pad(x.reshape(n, d), (0, 0, 0, (-n) % em))
    per = xf.shape[0] // em
    ys, kept = [], []
    for i in range(em):
        xs = xf[i * per:(i + 1) * per]
        gates, eids, _ = moe_mod._route(cfg, p["router"], xs)
        tok = i * per + torch.arange(per, device=x.device)
        gates = torch.where((tok < n)[:, None], gates, torch.zeros_like(gates))
        cap = moe_mod._capacity(cfg, per)
        buf, meta = moe_mod._pack_local(cfg, xs, gates, eids, cap)
        yb = moe_mod._expert_ffn(p["w_gate"], p["w_up"], p["w_down"],
                                 buf.reshape(cfg.num_experts, cap, d),
                                 x.dtype)
        ys.append(moe_mod._unpack_local(
            cfg, yb.reshape(cfg.num_experts * cap, d), meta, per, d))
        kept.append(moe_mod.kept_pairs(meta, per, cfg.experts_per_token))
    return torch.cat(ys)[:n].reshape(b, t, d), kept


def ep_dense_reference(moe_mod, tf, lm_steps, cfg, b1) -> dict:
    """Phase 3l's one-process reference: the dense path on the same
    weights, B 1, at bf16 and f32 compute: the last logits, each MoE
    layer's output and its top-k choices."""
    import dataclasses
    from unittest import mock

    dense = ep_config("dense")
    gen = torch.Generator(device=DEV).manual_seed(SEED)
    params = tf.init_params(dense, gen, device=DEV)
    ref = {}
    for label in ("bfloat16", "float32"):
        c = dataclasses.replace(dense, compute_dtype=label)
        routes, rec = [], []
        with mock.patch.object(moe_mod, "_route",
                               recording_route(moe_mod, routes)), \
                mock.patch.object(moe_mod, "moe_forward",
                                  recording_moe(moe_mod, rec)):
            logits, _ = lm_steps.make_prefill_step(c)(params, b1)
        ref[label] = {"logits": logits.float().cpu(),
                      "layers": [y.float().cpu() for _, y in rec],
                      "choices": [e.cpu() for e in routes]}
        del rec
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return ref


def ep_serving_path(fa_ops) -> dict:
    """Phase 3l: ``qwen3-moe-235b-a22b`` at full width (4 of 94 layers)
    served through the expert-parallel MoE on a (1, 4) mesh of 4 gloo
    ranks sharing the card (``ep_rank``), held against the dense path in
    one process and the schedule's plain re-computation (module doc)."""
    import dataclasses

    from repro_torch.models import moe as moe_mod
    from repro_torch.models import transformer as tf
    from repro_torch.train import steps as lm_steps

    smi = nvidia_smi()
    t0 = time.perf_counter()
    cfg = ep_config()
    b, t, n_new = LM_BATCH, LM_PROMPT, LM_NEW
    em = EP_MESH[1]
    ref = ep_dense_reference(moe_mod, tf, lm_steps, cfg,
                             arch_batch(cfg, EP_NODROP_BATCH, t, DEV))
    job = {"cfg": cfg, "batch": b, "prompt": t, "new": n_new,
           "train_cfg": ep_train_config(),
           "choices": {k: v["choices"] for k, v in ref.items()}}
    t_ranks = time.perf_counter()
    ranks = spawn_ranks(em, job, str(torch.device(DEV, 0)), target=ep_rank)
    report = {"config": {"layers": cfg.num_layers, "d_model": cfg.d_model,
                         "experts": cfg.num_experts,
                         "top_k": cfg.experts_per_token, "mesh": EP_MESH,
                         "batch": b, "prompt": t, "new": n_new,
                         "capacity_factor": cfg.capacity_factor,
                         "capacity": moe_mod._capacity(cfg, b * t // em)},
              "ranks_wall_s": time.perf_counter() - t_ranks}
    failed = []
    r0 = ranks[0]

    # (2) every rank's logits bitwise the same
    keys = [k for k in r0 if k.endswith("logits")]
    report["logits_bitwise_on_every_rank"] = {
        k: all(np.array_equal(r[k], r0[k]) for r in ranks[1:]) for k in keys}
    if not all(report["logits_bitwise_on_every_rank"].values()):
        failed.append(f"logits differ between ranks "
                      f"{report['logits_bitwise_on_every_rank']}")
    # (1) no drop, routing pinned: against the dense path in one process
    for label in ("bfloat16", "float32"):
        lim = LOGIT_RTOL[label]
        got = torch.from_numpy(r0[f"nodrop_{label}_logits"])
        lg = rel_rms(got, ref[label]["logits"])
        lay = [rel_rms(torch.from_numpy(y), want) for y, want in
               zip(r0[f"nodrop_{label}_layers"], ref[label]["layers"])]
        report[f"nodrop_{label}"] = {"logits_rel_rms": lg,
                                     "moe_layers_rel_rms": lay,
                                     "prefill_s": float(
                                         r0[f"nodrop_{label}_prefill_s"])}
        if not (lg <= lim and max(lay) <= lim):
            failed.append(f"no-drop {label}: logits {lg:.3e}, layers {lay} "
                          f"against {lim}")
    del ref
    # (3) capacity factor 1.25 against the schedule's plain re-computation
    gen = torch.Generator(device=DEV).manual_seed(SEED)
    params = tf.init_params(cfg, gen, device=DEV)
    moe_p = params["groups"]["g0"]["moe"]
    kept_same, out_rel, dropped = [], [], []
    with torch.no_grad():
        for layer in range(cfg.num_layers):
            x = from_bits(r0["moe_in_bits"][layer], DEV)
            y = from_bits(r0["moe_out_bits"][layer], DEV)
            p_l = {k: v[layer] for k, v in moe_p.items()}
            y_plain, kept = plain_ep_moe(moe_mod, cfg, p_l, x, em)
            kept_same.append(all(
                np.array_equal(ranks[i]["kept"][layer], kept[i].cpu().numpy())
                for i in range(em)))
            out_rel.append(rel_rms(y.float(), y_plain.float()))
            dropped.append(float(np.mean([~r["kept"][layer] for r in ranks])))
    del params, moe_p
    gc.collect()
    torch.cuda.empty_cache()
    report["capacity_factor_1.25"] = {"kept_pairs_identical": kept_same,
                                      "moe_layers_rel_rms": out_rel,
                                      "dropped_share": dropped}
    if not (all(kept_same) and max(out_rel) <= LOGIT_RTOL["bfloat16"]):
        failed.append(f"capacity factor 1.25: kept identical {kept_same}, "
                      f"outputs {out_rel}")
    # (4) the int8 wire
    worst = max(float(r["layers_int8_max_err_over_max_y"].max())
                for r in ranks)
    report["int8_wire"] = {
        "layer_rel_rms": r0["layers_int8_rel_rms"].tolist(),
        "layer_max_err_over_max_y": worst,
        "bound_max_err_over_max_y": INT8_MAX_ERR_OVER_MAX_Y,
        "logits_rel_rms_vs_native": rel_rms(
            torch.from_numpy(r0["int8_logits"][0]),
            torch.from_numpy(r0["native_logits"][0]))}
    if not worst <= INT8_MAX_ERR_OVER_MAX_Y:
        failed.append(f"int8: max |err| / max |y| {worst:.3e}")
    # (5) the reduced train step
    report["train"] = {
        "grad_leaf_max_rel_rms": max(float(r["train_grad_leaf_max"])
                                     for r in ranks),
        "worst_leaf": str(r0["train_grad_worst_leaf"]),
        "int8_grads_finite": all(bool(r["train_int8_grads_finite"])
                                 for r in ranks),
        "int8_grads_nonzero": all(float(r["train_int8_grads_sq"]) > 0
                                  for r in ranks),
        "train_step_finite": all(bool(r["train_step_finite"]) for r in ranks),
        "train_step_loss": float(r0["train_step_loss"])}
    tr = report["train"]
    if not (tr["grad_leaf_max_rel_rms"] <= EP_GRAD_RTOL
            and tr["int8_grads_finite"] and tr["int8_grads_nonzero"]
            and tr["train_step_finite"]):
        failed.append(f"train step: {tr}")
    # times, bytes, memory, launches
    for wire in ("native", "int8"):
        report[wire] = {k[len(wire) + 1:]: float(r0[k]) for k in r0
                        if k.startswith(wire + "_") and not
                        k.endswith("logits")}
    report["serving_peak_gb_per_rank"] = [float(r["serving_peak_gb"])
                                          for r in ranks]
    report["init_s"] = float(r0["init_s"])
    # a flash launch a layer a prefill: no-drop bf16, and cold, warm and
    # counted for each wire; no-drop f32
    want_bf16, want_f32 = 7 * flash_layers(cfg), flash_layers(cfg)
    launches = {"flash_attention_bf16": sum(int(r["flash_bf16"])
                                            for r in ranks),
                "flash_attention_f32": sum(int(r["flash_f32"])
                                           for r in ranks)}
    report["flash_launches_per_rank"] = [
        [int(r["flash_bf16"]), int(r["flash_f32"])] for r in ranks]
    if any(v != [want_bf16, want_f32]
           for v in report["flash_launches_per_rank"]):
        failed.append(f"flash launches per rank "
                      f"{report['flash_launches_per_rank']}, expected "
                      f"[{want_bf16}, {want_f32}]")
    total = time.perf_counter() - t0
    report["phase_s"] = total
    for key, val in report.items():
        print(f"expert-parallel MoE (3l) {key} ({smi}): {json.dumps(val)}",
              flush=True)
    print(f"expert-parallel MoE (3l) card: {smi}; phase 3l took "
          f"{total:.1f} s", flush=True)
    if failed:
        raise AssertionError(f"phase 3l: {failed}")
    return launches


# -- phases 3m and 3n: tensor-parallel serving on 4 ranks --------------------


class TPServe(NamedTuple):
    """One config of phases 3m and 3n: its phase, the teacher-forced
    decode steps a mesh, the layers kept (decoder, and encoder; None: 3k's
    depth), the flash kernel asked for, a first prefill of ``warmup``
    tokens (the process's first, so that the timed prefill is warm), the
    teacher-forced check (prefill T - 1 tokens, decode token T - 1), and
    whether its bf16 split logits are held to 2e-2 of the one-process bf16
    run.  Every config's bf16 split is also held no less accurate than the
    one-process bf16 run against the one-process f32-compute run
    (ARCH_DECODE_ERR_RATIO)."""
    name: str
    phase: str
    new: dict
    layers: int | None = None
    flash: bool = False
    warmup: int = 0
    forced: bool = False
    end_to_end: bool = True


# Depth is cut so that the whole script stays well inside its limit: llama
# 8 of 16 layers; mamba2 24 of 48 (its bf16 split left the one-process bf16
# run by ~4e-2 at 48 layers while its f32-compute split held 1e-5: the two
# bf16 paths round at other points, the row-parallel sums and the column
# blocks' GEMMs, and random layers amplify it, as ROADMAP Queue 3 item 21
# records for 3k; PERF.md); recurrentgemma R, R, A (each of its layers
# moves ~0.6 GB over gloo a prefill at d 4,096); whisper 12 + 12 of 24 + 24.
TP_SERVE = (
    TPServe("llama3.2-1b", "3m", {(1, 4): LM_NEW, (2, 2): 4}, layers=8,
            flash=True, warmup=128, forced=True),
    TPServe("mamba2-370m", "3n", {(1, 4): 4, (2, 2): 4}, layers=24,
            end_to_end=False),
    TPServe("whisper-medium", "3n", {(1, 4): 4}, layers=12),
    TPServe("recurrentgemma-9b", "3n", {(1, 4): 4}, layers=3),
    TPServe("deepseek-v2-236b", "3n", {(1, 4): 4}),
)
TP_F32_RTOL = 1e-5          # f32 compute against one process
TP_EP = 4                   # deepseek's MoE: expert-parallel over 4 ranks


def cut_depth(cfg, layers):
    """``cfg`` with its first ``layers`` decoder layers (and at most as
    many encoder layers)."""
    import dataclasses

    from repro_torch.configs import BlockGroup

    left, blocks = layers, []
    for g in cfg.blocks:
        if left > 0:
            blocks.append(BlockGroup(g.mixer, g.ffn, min(g.count, left),
                                     g.scan))
            left -= g.count
    return dataclasses.replace(
        cfg, blocks=tuple(blocks), num_layers=sum(g.count for g in blocks),
        encoder_layers=min(cfg.encoder_layers, layers))


def tp_config(entry: TPServe, compute="bfloat16"):
    """3k's config (``arch_config``: full width, deepseek its dense and 2
    MoE layers, whisper's flash kernel), cut to ``entry.layers``, the
    flash kernel where the entry asks for it, an MoE expert-parallel as in
    3l."""
    import dataclasses

    cfg = arch_config(entry.name)
    if entry.layers is not None:
        cfg = cut_depth(cfg, entry.layers)
    if entry.flash:
        cfg = dataclasses.replace(cfg, use_flash=True)
    if cfg.num_experts:
        cfg = dataclasses.replace(cfg, moe_impl="sharded")
    return dataclasses.replace(cfg, compute_dtype=compute)


def tp_inputs(cfg, n_new) -> dict:
    """3k's prompts (``arch_batch``: tokens, and frames for enc-dec) and
    the ``n_new`` tokens the decode steps are fed, as numpy."""
    t = ARCH_PROMPT.get(cfg.name, LM_PROMPT)
    batch = {k: v.cpu().numpy()
             for k, v in arch_batch(cfg, LM_BATCH, t, "cpu").items()}
    batch["new"] = np.random.default_rng(SEED + 1).integers(
        0, cfg.vocab_size, (LM_BATCH, n_new), dtype=np.int32)
    return batch


def tp_prefill_batch(inputs, device, rows=slice(None), t=None):
    """The prompts' rows ``rows`` (their first ``t`` tokens) on
    ``device``."""
    out = {"tokens": torch.from_numpy(inputs["tokens"][rows, :t]).to(device)}
    if "frames" in inputs:
        out["frames"] = torch.from_numpy(inputs["frames"][rows]).to(device)
    return out


def ep_plain_forward(moe_mod, em):
    """``moe.moe_forward`` as the expert-parallel schedule over ``em``
    slices in one process (``plain_ep_moe``): the same drops as the ranks'
    schedule."""
    def forward(cfg, p, x):
        return plain_ep_moe(moe_mod, cfg, p, x, em)[0], {}
    return forward


def tp_reference(tf, lm_steps, moe_mod, cfg, inputs, n_new) -> dict:
    """One process on the card, 3k's weights: the prefill's logits and
    ``n_new`` teacher-forced decode steps' at bf16 and f32 compute, and
    (MoE) every ``_route`` call's top-k choices, in call order, with the
    MoE as the expert-parallel schedule's plain one-process run."""
    import dataclasses
    from unittest import mock

    t = inputs["tokens"].shape[1]
    params = tf.init_params(cfg, torch.Generator(device=DEV).manual_seed(SEED),
                            device=DEV)
    routes: list = []
    ref = {}
    with mock.patch.object(moe_mod, "_route",
                           recording_route(moe_mod, routes)), \
            mock.patch.object(moe_mod, "moe_forward",
                              ep_plain_forward(moe_mod, TP_EP)):
        for label in ("bfloat16", "float32"):
            c = dataclasses.replace(cfg, compute_dtype=label)
            logits, caches = lm_steps.make_prefill_step(c)(
                params, tp_prefill_batch(inputs, DEV))
            ref[label] = logits.float().cpu()
            caches = tf.grow_decode_cache(c, caches, t + n_new)
            serve = lm_steps.make_serve_step(c)
            new = torch.from_numpy(inputs["new"]).to(DEV)
            dec = []
            for i in range(n_new):
                pos = torch.full((LM_BATCH,), t + i, dtype=torch.int32,
                                 device=DEV)
                lg, caches = serve(params, caches, new[:, i:i + 1], pos)
                dec.append(lg.float().cpu())
            ref[f"decode_{label}"] = torch.stack(dec)
            del caches
    ref["choices"] = [e.cpu() for e in routes]
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return ref


def tp_layout(cfg, mesh_shape) -> dict:
    """The layout terms the collective formulas of 3m, 3n and 3o share:
    ``leaves`` (path -> ``param_layout``'s leaf), ``vocab`` (the
    vocabulary split over ``model``), ``layers`` / ``encoder`` (each
    decoder / encoder layer's mixer and its sublayers that take
    collectives, in order: "mixer" a mixer split over ``model``, "xattn"
    enc-dec's cross-attention, "mlp" a split MLP, "moe" an
    expert-parallel MoE, "shared" its split shared MLP) and ``fsdp`` (each
    leaf cut over ``data`` of more than one rank: its path, its layers,
    and the elements of one layer's whole block)."""
    from repro_torch.core.flat import tree_items
    from repro_torch.distributed import sharding
    from repro_torch.models import attention as attn_mod
    from repro_torch.models import transformer as tf_mod

    data, model = mesh_shape
    mesh = type("Sizes", (), {"shape": {"data": data, "model": model}})()
    leaves = dict(tree_items(sharding.param_layout(cfg, mesh)))
    with sharding.use_mesh(mesh):
        heads_split = attn_mod.head_layout(cfg).split

    def cut(parent, leaf):
        return any("model" in lay.axes for path, lay in leaves.items()
                   if path[-2:] == (parent, leaf))
    split_mixer = {"attn": heads_split, "lattn": heads_split,
                   "mla": cut("attn", "wq_b"), "ssd": cut("ssd", "w_in"),
                   "rglru": cut("rglru", "w_x")}
    mlp = ("mlp",) if cut("mlp", "w_down") else ()
    layers = []
    for g in cfg.blocks:
        subs = (("mixer",) if split_mixer[g.mixer] else ()) + (
            ("xattn",) if cfg.family == "encdec" and heads_split else ())
        if g.ffn == "mlp":
            subs += mlp
        elif g.ffn == "moe":
            subs += ("moe",) + (
                ("shared",) if cfg.num_shared_experts
                and cut("shared_mlp", "w_down") else ())
        layers += [(g.mixer, subs)] * g.count
    encoder = ([("attn", (("mixer",) if heads_split else ()) + mlp)]
               * cfg.encoder_layers if cfg.family == "encdec" else [])
    fsdp = []
    for path, lay in leaves.items():
        if data == 1 or "data" not in lay.axes:
            continue
        group = None
        if path[0] == "groups":
            group = cfg.blocks[int(path[1][1:])]
        elif path[0] == "encoder":
            group = tf_mod._encoder_group(cfg)
        n, block = 1, lay.local
        if group is not None and tf_mod._stacked(group):
            n, block = group.count, lay.local[1:]
        fsdp.append((path, n, math.prod(block) * data))
    return {"leaves": leaves, "vocab": "model" in leaves[("embed",)].axes,
            "layers": layers, "encoder": encoder, "fsdp": fsdp}


def collective_counts():
    return {k: {"calls": 0, "bytes": 0}
            for k in ("all_reduce", "all_gather", "reduce_scatter",
                      "all_to_all")}


def tp_expected_collectives(cfg, mesh_shape, b_loc, t_q, act_bytes,
                            prefill: bool) -> dict:
    """Calls and bytes of each collective kind in one prefill (t_q the
    prompt) or decode step (t_q = 1) on a rank of ``mesh_shape``, from
    ``tp_layout``: a row-parallel product (an all_to_all of the (B/data,
    t_q, D) f32 partials, an all_gather of the summed columns in the
    compute dtype, ``act_bytes`` an element) for each split mixer,
    cross-attention, MLP and shared MLP (the encoder's at its frames, in a
    prefill); the SSD's ordered sum of squares (an all_gather of (model,
    B/data, t_q, 1) f32), RG-LRU's gathered conv output (B/data, t_q,
    lru); an expert-parallel MoE layer's two all_to_alls of (E, C, D), its
    tokens' all_gather and its two f32 aux means; the split vocabulary's
    embedding all_reduce and (B/data, V) f32 logits gather; and with data
    > 1 each leaf cut over ``data`` gathered whole at each use."""
    from repro_torch.models import moe as moe_mod

    model = mesh_shape[1]
    d = cfg.d_model
    out = collective_counts()

    def add(kind, calls, nbytes):
        out[kind]["calls"] += calls
        out[kind]["bytes"] += calls * nbytes

    lay = tp_layout(cfg, mesh_shape)
    if lay["vocab"]:
        add("all_reduce", 1, b_loc * t_q * d * act_bytes)
        add("all_gather", 1, b_loc * cfg.vocab_size * 4)
    stacks = [(lay["layers"], t_q)] + (
        [(lay["encoder"], cfg.num_frames)] if prefill else [])
    for layers, t in stacks:
        for mixer, subs in layers:
            for sub in subs:
                if sub == "moe":
                    per = -(-b_loc * t // model)
                    cap = moe_mod._capacity(cfg, per)
                    add("all_to_all", 2,
                        cfg.num_experts * cap * d * act_bytes)
                    add("all_gather", 1, model * per * d * act_bytes)
                    add("all_reduce", 2, 4)
                    continue
                # a row-parallel product
                add("all_to_all", 1, b_loc * t * d * 4)
                add("all_gather", 1, b_loc * t * d * act_bytes)
                if sub == "mixer" and mixer == "ssd":
                    add("all_gather", 1, model * b_loc * t * 4)
                elif sub == "mixer" and mixer == "rglru":
                    add("all_gather", 1,
                        b_loc * t * cfg.lru_width * act_bytes)
    item = 4 if cfg.param_dtype == "float32" else 2
    for path, n, numel in lay["fsdp"]:
        if not prefill and (path[0] == "encoder" or path[-2:] in (
                ("xattn", "wk"), ("xattn", "wv"))):
            continue
        uses = 2 if path == ("embed",) and cfg.tie_embeddings else 1
        if path[-1] == "wkv_a" and prefill:   # the cache's latent too
            uses = 2
        add("all_gather", uses * n, numel * item)
    return out


def tp_rank(rank, world, store_path, out_dir, job, device):
    """One rank of phases 3m and 3n's gloo run (a spawned process): for
    each config and mesh, the rank's blocks of ``init_params``' draws (the
    port's layout, drawn one rank at a time), its data shard of the
    prompts; the config's warm-up prefill (its first mesh), the bf16
    prefill, its teacher-forced decode steps, the teacher-forced check
    where asked, and at (1, 4) an f32-compute prefill (MoE top-k pinned to
    the one-process run's choices); logits, times, the collectives' calls
    and bytes (``tensor_parallel.COUNTS``), the flash calls' shapes and
    launches, params and peak memory.  Writes ``rank<k>.npz``."""
    import contextlib
    import dataclasses
    import datetime
    import os
    from unittest import mock

    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
    sys.path.insert(0, str(ROOT / "src"))
    import torch.distributed as dist

    from repro_torch.distributed import sharding
    from repro_torch.distributed import tensor_parallel as tp
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.launch import make_compat_mesh
    from repro_torch.models import moe as moe_mod
    from repro_torch.models import transformer as tf
    from repro_torch.train import steps as lm_steps
    from torch.utils._pytree import tree_leaves

    dev = torch.device(device)
    cuda = dev.type == "cuda"
    if not cuda:
        torch.set_num_threads(1)   # CPU ranks share the cores
    torch.backends.cuda.matmul.allow_tf32 = False
    store = dist.FileStore(store_path, world)
    shapes = sorted({m for c in job["configs"] for m in c["entry"]["new"]})
    meshes = {m: make_compat_mesh(m, ("data", "model"), dev, backend="gloo",
                                  store=store, rank=rank, world_size=world,
                                  timeout=datetime.timedelta(
                                      seconds=DIST_GROUP_TIMEOUT_S))
              for m in shapes}
    calls = []
    real_flash = fa_ops.flash_attention

    def recording_flash(q, k, v, causal=True):
        calls.append((tuple(q.shape), tuple(k.shape), bool(causal)))
        return real_flash(q, k, v, causal=causal)
    fa_ops.flash_attention = recording_flash
    reset_counts(fa_ops.LAUNCHES)
    out = {}

    def timed(fn):
        sync(dev)
        s = time.perf_counter()
        res = fn()
        sync(dev)
        return res, time.perf_counter() - s

    def counted(fn):
        tp.reset_counts()
        res, s = timed(fn)
        return res, s, json.dumps(tp.counts())

    for c in job["configs"]:
        cfg, inputs, entry = c["cfg"], c["inputs"], c["entry"]
        t = inputs["tokens"].shape[1]
        for m, n_new in entry["new"].items():
            mesh = meshes[m]
            tag = f"{cfg.name}/{m[0]}x{m[1]}"
            data, model = m
            rows = slice(mesh.get_local_rank("data") * LM_BATCH // data,
                         (mesh.get_local_rank("data") + 1) * LM_BATCH // data)
            if cuda:
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats()
            # one rank at a time: each draws a whole leaf before it keeps
            # its block (deepseek's two MoE layers: 15 GB for a moment)
            for turn in range(world):
                if turn == rank:
                    params, out[f"{tag}/init_s"] = timed(
                        lambda: lm_steps.init_params_sharded(
                            cfg, torch.Generator(device=dev).manual_seed(SEED),
                            mesh, device=dev))
                    if cuda:
                        torch.cuda.empty_cache()
                dist.barrier()
            out[f"{tag}/param_bytes"] = sum(
                a.numel() * a.element_size() for a in tree_leaves(params))
            batch = tp_prefill_batch(inputs, dev, rows)
            new = torch.from_numpy(inputs["new"][rows]).to(dev)
            b_loc = new.shape[0]
            prefill = lm_steps.make_prefill_step(cfg)
            serve = lm_steps.make_serve_step(cfg)
            # this rank's MoE calls of the one-process run, in order
            mine = c["choices"][mesh.get_local_rank("model")::model] \
                if c["choices"] and m == (1, 4) else None
            pin = (mock.patch.object(moe_mod, "_route", pinned_route(
                moe_mod, [e.to(dev) for e in mine]))
                if mine else contextlib.nullcontext())
            with sharding.use_mesh(mesh), pin:
                if entry["warmup"] and m == next(iter(entry["new"])):
                    _, out[f"{tag}/warmup_s"] = timed(lambda: prefill(
                        params, tp_prefill_batch(inputs, dev, rows,
                                                 entry["warmup"])))
                calls.clear()
                before = dict(fa_ops.LAUNCHES)
                (logits, caches), out[f"{tag}/prefill_s"], \
                    out[f"{tag}/prefill_collectives"] = counted(
                        lambda: prefill(params, batch))
                out[f"{tag}/prefill_flash_launches"] = (
                    fa_ops.LAUNCHES["bfloat16"] - before["bfloat16"])
                out[f"{tag}/prefill_flash_shapes"] = json.dumps(
                    sorted(set(calls)))
                out[f"{tag}/logits"] = logits.float().cpu().numpy()
                caches = tf.grow_decode_cache(cfg, caches, t + n_new)
                dec, dec_s = [], []
                for i in range(n_new):
                    pos = torch.full((b_loc,), t + i, dtype=torch.int32,
                                     device=dev)
                    (lg, caches), s, coll = counted(
                        lambda: serve(params, caches, new[:, i:i + 1], pos))
                    dec.append(lg.float().cpu().numpy())
                    dec_s.append(s)
                    if i == 0:
                        out[f"{tag}/decode_collectives"] = coll
                del caches
                out[f"{tag}/decode_logits"] = np.stack(dec)
                out[f"{tag}/decode_step_s"] = np.asarray(dec_s)
                if entry["forced"] and m == (1, 4):
                    # prefill T - 1 tokens, decode token T - 1
                    _, c_short = prefill(params, tp_prefill_batch(
                        inputs, dev, rows, t - 1))
                    grown = tf.grow_decode_cache(cfg, c_short, t)
                    forced, _ = serve(params, grown, batch["tokens"][:, t - 1:],
                                      torch.full((b_loc,), t - 1,
                                                 dtype=torch.int32, device=dev))
                    out[f"{tag}/forced_logits"] = forced.float().cpu().numpy()
                    del c_short, grown
                if m == (1, 4):
                    c32 = dataclasses.replace(cfg, compute_dtype="float32")
                    (lg32, _), out[f"{tag}/prefill_f32_s"], \
                        out[f"{tag}/prefill_f32_collectives"] = counted(
                            lambda: lm_steps.make_prefill_step(c32)(params,
                                                                    batch))
                    out[f"{tag}/f32_logits"] = lg32.float().cpu().numpy()
            out[f"{tag}/peak_gb"] = (torch.cuda.max_memory_allocated() / 1e9
                                     if cuda else 0.0)
            del params
            gc.collect()
            if cuda:
                torch.cuda.empty_cache()
    out["flash_bf16"] = fa_ops.LAUNCHES["bfloat16"]
    out["flash_f32"] = fa_ops.LAUNCHES["float32"]
    fa_ops.flash_attention = real_flash
    np.savez(pathlib.Path(out_dir) / f"rank{rank}.npz", **out)
    dist.destroy_process_group()


def tp_check(cfg, entry, m, ranks, ref) -> tuple[dict, bool]:
    """One config and mesh of phases 3m and 3n against the one-process
    run: the report and whether every check held."""
    from repro_torch.distributed import sharding
    from repro_torch.models import attention as attn_mod

    lim = LOGIT_RTOL["bfloat16"]
    n_new = entry.new[m]
    tag = f"{cfg.name}/{m[0]}x{m[1]}"
    data, model = m
    groups = [[ranks[d * model + i] for i in range(model)]
              for d in range(data)]
    t = ARCH_PROMPT.get(cfg.name, LM_PROMPT)
    rep = {"layers": cfg.num_layers, "prompt": t, "new": n_new}
    keys = [k for k in ranks[0] if k.startswith(tag + "/")
            and k.endswith("logits")]
    rep["logits_bitwise_in_each_model_group"] = all(
        np.array_equal(r[k], g[0][k]) for g in groups for r in g[1:]
        for k in keys)

    def whole(key, axis=0):
        return torch.from_numpy(np.concatenate(
            [g[0][f"{tag}/{key}"] for g in groups], axis=axis))
    logits, dec = whole("logits"), whole("decode_logits", axis=1)
    rep["prefill_vs_one_process"] = rel_rms(logits, ref["bfloat16"])
    rep["decode_vs_one_process"] = [
        rel_rms(dec[i], ref["decode_bfloat16"][i]) for i in range(n_new)]
    # each bf16 output's error from the one-process f32-compute run, over
    # one process's
    pairs = [(logits, ref["bfloat16"], ref["float32"])] + [
        (dec[i], ref["decode_bfloat16"][i], ref["decode_float32"][i])
        for i in range(n_new)]
    rep["bf16_error_vs_one_process_error"] = [
        rel_rms(got, f32) / rel_rms(one, f32) for got, one, f32 in pairs]
    ok = (rep["logits_bitwise_in_each_model_group"]
          and max(rep["bf16_error_vs_one_process_error"])
          <= ARCH_DECODE_ERR_RATIO)
    if entry.end_to_end:
        ok &= (rep["prefill_vs_one_process"] <= lim
               and max(rep["decode_vs_one_process"]) <= lim)
    if m == (1, 4):
        rep["f32_prefill_vs_one_process"] = rel_rms(whole("f32_logits"),
                                                    ref["float32"])
        ok &= rep["f32_prefill_vs_one_process"] <= TP_F32_RTOL
    if entry.forced and m == (1, 4):
        rep["teacher_forced_vs_prefill"] = rel_rms(whole("forced_logits"),
                                                   logits)
        ok &= rep["teacher_forced_vs_prefill"] <= lim
    b_loc = LM_BATCH // data
    # flash on each rank's heads (whisper: its encoder and decoder)
    rep["flash_launches_a_prefill"] = [
        int(r[f"{tag}/prefill_flash_launches"]) for r in ranks]
    shapes = [json.loads(str(r[f"{tag}/prefill_flash_shapes"]))
              for r in ranks]
    rep["flash_shapes"] = shapes[0]
    if cfg.use_flash:
        with sharding.use_mesh(type("Sizes", (), {"shape": {
                "data": data, "model": model}})()):
            hl = attn_mod.head_layout(cfg)
        dh = attn_mod.head_dim(cfg)
        want_shapes = sorted(
            [[[b_loc, hl.h, t, dh], [b_loc, hl.kv, t, dh], True]]
            + ([[[b_loc, hl.h, cfg.num_frames, dh],
                 [b_loc, hl.kv, cfg.num_frames, dh], False]]
               if cfg.family == "encdec" else []))
        ok &= all(sh == want_shapes for sh in shapes)
    ok &= rep["flash_launches_a_prefill"] == [flash_layers(cfg)] * 4
    # the collectives' calls and bytes, to the byte
    for kind, t_q, key, ab in (
            ("prefill", t, "prefill_collectives", 2),
            ("decode", 1, "decode_collectives", 2),
            ("prefill_f32", t, "prefill_f32_collectives", 4)):
        if f"{tag}/{key}" not in ranks[0]:
            continue
        want = tp_expected_collectives(cfg, m, b_loc, t_q, ab,
                                       kind != "decode")
        got = [json.loads(str(r[f"{tag}/{key}"])) for r in ranks]
        rep[f"{kind}_collectives"] = got[0]
        same = all({k: g[k] for k in want} == want for g in got)
        rep[f"{kind}_collectives_as_predicted"] = same
        if not same:
            rep[f"{kind}_collectives_predicted"] = want
        ok &= same
    for k in ("init_s", "warmup_s", "prefill_s", "prefill_f32_s"):
        if f"{tag}/{k}" in ranks[0]:
            rep[k] = float(ranks[0][f"{tag}/{k}"])
    steps_s = ranks[0][f"{tag}/decode_step_s"]
    rep["decode_step_ms"] = [1e3 * float(s) for s in steps_s]
    rep["decode_step_ms_median"] = 1e3 * float(np.median(steps_s))
    rep["prefill_tokens_per_s"] = LM_BATCH * t / rep["prefill_s"]
    rep["param_gb_per_rank"] = [float(r[f"{tag}/param_bytes"]) / 1e9
                                for r in ranks]
    rep["peak_gb_per_rank"] = [float(r[f"{tag}/peak_gb"]) for r in ranks]
    return rep, ok


def tp_serving_path(fa_ops) -> dict:
    """Phases 3m and 3n: ``TP_SERVE``'s configs at full width (3k's
    weights and prompts, depth cut as each entry says), served
    tensor-parallel on 4 gloo ranks sharing the card (``tp_rank``, one
    spawn) on each entry's meshes, against one process on the same card
    with the same weights (``tp_check``)."""
    from repro_torch.models import moe as moe_mod
    from repro_torch.models import transformer as tf
    from repro_torch.train import steps as lm_steps

    smi = nvidia_smi()
    t0 = time.perf_counter()
    refs, configs = [], []
    for entry in TP_SERVE:
        cfg = tp_config(entry)
        n_new = max(entry.new.values())
        inputs = tp_inputs(cfg, n_new)
        ref = tp_reference(tf, lm_steps, moe_mod, cfg, inputs, n_new)
        refs.append(ref)
        configs.append({"cfg": cfg, "inputs": inputs,
                        "entry": entry._asdict(),
                        "choices": ref.pop("choices")})
    report = {"reference_s": time.perf_counter() - t0}
    t_ranks = time.perf_counter()
    ranks = spawn_ranks(4, {"configs": configs}, str(torch.device(DEV, 0)),
                        target=tp_rank)
    report["ranks_wall_s"] = time.perf_counter() - t_ranks
    failed = []
    for entry, c, ref in zip(TP_SERVE, configs, refs):
        for m in entry.new:
            rep, ok = tp_check(c["cfg"], entry, m, ranks, ref)
            report[f"({entry.phase}) {c['cfg'].name}/{m[0]}x{m[1]}"] = rep
            if not ok:
                failed.append(f"{entry.name} {m}: {json.dumps(rep)}")
    launches = {"flash_attention_bf16": sum(int(r["flash_bf16"])
                                            for r in ranks),
                "flash_attention_f32": sum(int(r["flash_f32"])
                                           for r in ranks)}
    report["flash_launches_per_rank"] = [[int(r["flash_bf16"]),
                                          int(r["flash_f32"])] for r in ranks]
    total = time.perf_counter() - t0
    report["phase_s"] = total
    for key, val in report.items():
        print(f"tensor-parallel serving {key} ({smi}): {json.dumps(val)}",
              flush=True)
    print(f"tensor-parallel serving (3m, 3n) card: {smi}; phases 3m and 3n "
          f"took {total:.1f} s", flush=True)
    if failed:
        raise AssertionError(f"phases 3m and 3n: {failed}")
    return launches


# -- phase 3o: llama3.2-1b trained tensor-parallel on 4 ranks -----------------

TRAIN_TP_MESHES = ((1, 4), (2, 2))
TRAIN_TP_LAYERS = 8           # of 16: the script's time limit
TRAIN_TP_GRAD_RTOL = 1e-4     # the training-gradient tier (PERF.md 2)
TRAIN_TP_F32_RTOL = 1e-5      # the f32-compute loss against one process
# The step's update against the reference's, over its norm: Adam's first
# step divides each gradient element by its own magnitude (plus eps), so
# elements near eps turn the gradients' 1e-5 differences into ~1e-3 of a
# zero-drawn leaf's update (8.4e-4 at a norm scale, PERF.md); a misapplied
# update (a block, the clip, the decay) would be O(1).
TRAIN_TP_UPDATE_RTOL = 1e-2


def train_tp_configs():
    """3j's llama3.2-1b (f32 params, remat, bf16 compute) at full width,
    cut to TRAIN_TP_LAYERS, and its f32-compute twin."""
    import dataclasses
    cfg = cut_depth(get_lm_config("llama3.2-1b"), TRAIN_TP_LAYERS)
    return cfg, dataclasses.replace(cfg, compute_dtype="float32")


def capture_grads(box):
    """A ``compression`` hook of ``make_train_step`` that keeps the
    gradients it is handed (after the sums over ``data``) and passes them
    on."""
    def hook(grads):
        box["grads"] = grads
        return grads
    return hook


def digest(tensors) -> str:
    import hashlib
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().reshape(-1).contiguous().cpu()
                 .view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def train_tp_reference(tf, lm_steps, adam, path) -> dict:
    """Phase 3o's one-process reference on the card (3j's step at
    TRAIN_TP_LAYERS, the same weights and batch): a bf16-compute train step's loss and time, then,
    from the same initial params, an f32-compute step's loss, its
    gradients and the params after it, saved to ``path`` (by leaf path)
    for the ranks.  Returns the losses and times."""
    from repro_torch.core.flat import tree_items

    cfg, cfg32 = train_tp_configs()
    batch = lm_batch(cfg, LM_BATCH, LM_PROMPT, DEV)
    out = {}
    for label, c in (("bfloat16", cfg), ("float32", cfg32)):
        params = tf.init_params(c, torch.Generator(device=DEV).manual_seed(
            SEED), device=DEV)
        state = {"params": params, "opt": adam.init_opt_state(params)}
        box = {}
        step = lm_steps.make_train_step(c, compression=capture_grads(box))
        torch.cuda.synchronize()
        s = time.perf_counter()
        state, metrics = step(state, batch)
        torch.cuda.synchronize()
        out[f"{label}_step_s"] = time.perf_counter() - s
        out[f"{label}_loss"] = float(metrics["loss"])
        out[f"{label}_grad_norm"] = float(metrics["grad_norm"])
        if label == "float32":
            torch.save({"grads": {"/".join(map(str, k)): v.detach().cpu()
                                  for k, v in tree_items(box["grads"])},
                        "after": {"/".join(map(str, k)): v.detach().cpu()
                                  for k, v in tree_items(state["params"])}},
                       path)
        del state, params, box
        gc.collect()
        torch.cuda.empty_cache()
    return out


def train_tp_expected_collectives(cfg, mesh_shape, b_loc, t, act_bytes) -> dict:
    """Calls and bytes of each collective kind in one train step of a
    dense attention / MLP layout (``llama3.2-1b``'s: GQA and SwiGLU split,
    tied vocabulary split, remat of every layer) on a rank of
    ``mesh_shape``, from ``tp_layout``: each layer's row-parallel products
    (an all_to_all of the (B/data, T, D) f32 partials, an all_gather in
    the compute dtype) in the forward, and all but its last again in the
    remat's recompute (which stops once the tensors the backward needs are
    back: no op of the layer saves the MLP's row-parallel sum); the
    backward of each ``copy_to_model`` (one a product, and the
    cross-entropy's input) an all_reduce of its (B/data, T, D) gradient;
    the embedding's all_reduce; the vocab-split cross-entropy's three
    (B/data, 512) f32 all_reduces a chunk, forward and recompute; the
    gradient norm's scalar sums, one a group of leaves cut alike and axis;
    and with data > 1 each leaf cut over ``data`` gathered at each use (a
    layer's again in its recompute) and its gradient reduce-scattered
    once, the loss's (2,) sum over ``data`` and each whole leaf's gradient
    summed over ``data``."""
    data, model = mesh_shape
    d = cfg.d_model
    act = b_loc * t * d
    chunk = min(512, t)
    chunks = -(-t // chunk)
    out = collective_counts()

    def add(kind, calls, nbytes):
        out[kind]["calls"] += calls
        out[kind]["bytes"] += calls * nbytes
    lay = tp_layout(cfg, mesh_shape)
    assert lay["vocab"] and all(mixer == "attn" and set(subs) <= {
        "mixer", "mlp"} for mixer, subs in lay["layers"]), lay["layers"]
    for _, subs in lay["layers"]:
        rows = 2 * len(subs) - 1 if subs else 0
        add("all_to_all", rows, act * 4)
        add("all_gather", rows, act * act_bytes)
        add("all_reduce", len(subs), act * act_bytes)
    add("all_reduce", 2, act * act_bytes)
    add("all_reduce", 6 * chunks, b_loc * chunk * 4)
    keys = {tuple(sorted(leaf.axes)) for leaf in lay["leaves"].values()}
    sizes = {"data": data, "model": model}
    add("all_reduce", sum(sizes[a] > 1 for k in keys for a in k), 4)
    if data > 1:
        add("all_reduce", 1, 8)
        item = 4 if cfg.param_dtype == "float32" else 2
        for leaf in lay["leaves"].values():
            if "data" not in leaf.axes:
                add("all_reduce", 1, math.prod(leaf.local) * 4)
        for path, n, numel in lay["fsdp"]:
            uses = (2 * n if path[0] == "groups" else
                    2 if path == ("embed",) and cfg.tie_embeddings else 1)
            add("all_gather", uses, numel * item)
            add("reduce_scatter", uses // 2 if path[0] == "groups" else uses,
                numel // data * 4)
    return out


def train_tp_rank(rank, world, store_path, out_dir, job, device):
    """One rank of phase 3o's gloo run (a spawned process): for each mesh,
    the rank's blocks of ``init_params``' draws and its data shard of the
    batch; a bf16-compute train step (timed, its collectives counted),
    then from fresh params an f32-compute step whose gradients (handed to
    the step's ``compression`` hook) and params after are held leaf by
    leaf against the reference's blocks (``local_shard`` of its file,
    memory-mapped); the losses, digests of the loss and of every leaf the
    layout does not cut over ``model``, times and peak memory.  Writes
    ``rank<k>.npz``."""
    import datetime
    import os

    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
    sys.path.insert(0, str(ROOT / "src"))
    import torch.distributed as dist

    from repro_torch.core.flat import tree_items
    from repro_torch.distributed import sharding
    from repro_torch.distributed import tensor_parallel as tp
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.launch import make_compat_mesh
    from repro_torch.models import transformer as tf
    from repro_torch.optim import adam
    from repro_torch.train import steps as lm_steps

    dev = torch.device(device)
    cuda = dev.type == "cuda"
    if not cuda:
        torch.set_num_threads(1)
    torch.backends.cuda.matmul.allow_tf32 = False
    reset_counts(fa_ops.LAUNCHES)
    store = dist.FileStore(store_path, world)
    meshes = {m: make_compat_mesh(m, ("data", "model"), dev, backend="gloo",
                                  store=store, rank=rank, world_size=world,
                                  timeout=datetime.timedelta(
                                      seconds=DIST_GROUP_TIMEOUT_S))
              for m in job["meshes"]}
    ref = torch.load(job["reference"], mmap=True, weights_only=True)
    cfg, cfg32 = job["cfg"], job["cfg32"]
    logical = dict(tree_items(tf.param_logical_axes(cfg)))
    whole = {"tokens": torch.from_numpy(job["tokens"]),
             "labels": torch.from_numpy(job["labels"])}
    out = {}
    for m, mesh in meshes.items():
        tag = f"{m[0]}x{m[1]}"
        axes = {p: lay.axes for p, lay in tree_items(
            sharding.param_layout(cfg, mesh))}
        with sharding.use_mesh(mesh):
            batch = {k: v.to(dev) for k, v in
                     lm_steps.local_batch(whole, mesh).items()}
            for label, c in (("bfloat16", cfg), ("float32", cfg32)):
                if cuda:
                    torch.cuda.empty_cache()
                    torch.cuda.reset_peak_memory_stats()
                params = lm_steps.init_params_sharded(
                    c, torch.Generator(device=dev).manual_seed(SEED), mesh,
                    device=dev)
                before = ({p: t.clone() for p, t in tree_items(params)}
                          if label == "float32" else None)
                state = {"params": params, "opt": adam.init_opt_state(params)}
                box = {}
                step = lm_steps.make_train_step(
                    c, compression=capture_grads(box))
                tp.reset_counts()
                sync(dev)
                s = time.perf_counter()
                state, metrics = step(state, batch)
                sync(dev)
                out[f"{tag}/{label}_step_s"] = time.perf_counter() - s
                out[f"{tag}/{label}_collectives"] = json.dumps(tp.counts())
                out[f"{tag}/{label}_loss"] = metrics["loss"].cpu().numpy()
                out[f"{tag}/{label}_peak_gb"] = (
                    torch.cuda.max_memory_allocated() / 1e9 if cuda else 0.0)
                grads = dict(tree_items(box["grads"]))
                after = dict(tree_items(state["params"]))
                whole_leaves = sorted(p for p in grads
                                      if "model" not in axes[p])
                out[f"{tag}/{label}_digest"] = digest(
                    [metrics["loss"]] + [grads[p] for p in whole_leaves]
                    + [after[p] for p in whole_leaves])
                if label == "float32":
                    g_rel, p_rel, u_rel = {}, {}, {}
                    for p in grads:
                        key = "/".join(map(str, p))
                        g_ref, p_ref = (sharding.local_shard(
                            ref[name][key], logical[p], mesh).to(dev).float()
                            for name in ("grads", "after"))
                        g_rel[key] = rel_rms(grads[p].float(), g_ref)
                        # params after the step, against the reference's:
                        # over the leaf (a leaf drawn nonzero), and over
                        # the reference's update (every leaf)
                        diff = torch.linalg.vector_norm(after[p].float()
                                                        - p_ref)
                        if torch.any(before[p] != 0):
                            p_rel[key] = float(
                                diff / torch.linalg.vector_norm(p_ref))
                        u_rel[key] = float(diff / torch.linalg.vector_norm(
                            p_ref - before[p].float()))
                    out[f"{tag}/grad_rel"] = json.dumps(g_rel)
                    out[f"{tag}/after_rel"] = json.dumps(p_rel)
                    out[f"{tag}/update_rel"] = json.dumps(u_rel)
                    out[f"{tag}/param_bytes"] = sum(
                        a.numel() * a.element_size() for a in after.values())
                del state, params, box, grads, after, before
                gc.collect()
                if cuda:
                    torch.cuda.empty_cache()
    out["flash_launches"] = sum(fa_ops.LAUNCHES.values())
    np.savez(pathlib.Path(out_dir) / f"rank{rank}.npz", **out)
    dist.destroy_process_group()


def train_tp_path() -> dict:
    """Phase 3o: ``llama3.2-1b``'s train step at full width, cut to
    TRAIN_TP_LAYERS (3j's shape: B 4 x 2,048, f32 params, remat, AdamW
    clipped by the whole gradient's norm), on 4 gloo ranks sharing the
    card at (1, 4) and (2, 2) (``train_tp_rank``), against the same
    step in one process on the same card with the same weights and
    batch."""
    from repro_torch.launch import roofline
    from repro_torch.models import transformer as tf
    from repro_torch.optim import adam
    from repro_torch.train import steps as lm_steps
    from repro_torch.configs import ShapeSpec

    smi = nvidia_smi()
    t0 = time.perf_counter()
    cfg, cfg32 = train_tp_configs()
    failed = []
    with tempfile.TemporaryDirectory() as tmp:
        path = f"{tmp}/reference.pt"
        ref = train_tp_reference(tf, lm_steps, adam, path)
        report = {"reference": ref, "reference_s": time.perf_counter() - t0}
        batch = lm_batch(cfg, LM_BATCH, LM_PROMPT, "cpu")
        job = {"cfg": cfg, "cfg32": cfg32, "meshes": TRAIN_TP_MESHES,
               "reference": path,
               "tokens": batch["tokens"].numpy(),
               "labels": batch["labels"].numpy()}
        t_ranks = time.perf_counter()
        ranks = spawn_ranks(4, job, str(torch.device(DEV, 0)),
                            target=train_tp_rank)
        report["ranks_wall_s"] = time.perf_counter() - t_ranks
    flops = roofline.model_flops(
        cfg, ShapeSpec("train_cut", LM_PROMPT, LM_BATCH, "train"), 1)
    for m in TRAIN_TP_MESHES:
        tag = f"{m[0]}x{m[1]}"
        data, model = m
        b_loc = LM_BATCH // data
        rep = {}
        for label in ("bfloat16", "float32"):
            lim = (LOGIT_RTOL["bfloat16"] if label == "bfloat16"
                   else TRAIN_TP_F32_RTOL)
            losses = [float(r[f"{tag}/{label}_loss"]) for r in ranks]
            rel = abs(losses[0] - ref[f"{label}_loss"]) / abs(
                ref[f"{label}_loss"])
            digests = [str(r[f"{tag}/{label}_digest"]) for r in ranks]
            bitwise = all(digests[d * model + i] == digests[d * model]
                          for d in range(data) for i in range(model))
            want = train_tp_expected_collectives(
                cfg, m, b_loc, LM_PROMPT, 2 if label == "bfloat16" else 4)
            got = [json.loads(str(r[f"{tag}/{label}_collectives"]))
                   for r in ranks]
            same = all({k: g[k] for k in want} == want for g in got)
            step_s = max(float(r[f"{tag}/{label}_step_s"]) for r in ranks)
            rep[label] = {
                "loss": losses[0], "loss_vs_one_process": rel,
                "bitwise_in_each_model_group": bitwise,
                "collectives": got[0], "collectives_as_predicted": same,
                "step_s": step_s, "tokens_per_s": LM_BATCH * LM_PROMPT / step_s,
                "one_process_step_s": ref[f"{label}_step_s"],
                "mfu": flops / step_s / card_peaks(
                    torch.cuda.get_device_name(0))[3],
                "peak_gb_per_rank": [float(r[f"{tag}/{label}_peak_gb"])
                                     for r in ranks]}
            if not same:
                rep[label]["collectives_predicted"] = want
            ok = rel <= lim and bitwise and same
            if label == "float32":
                g_rel = [json.loads(str(r[f"{tag}/grad_rel"])) for r in ranks]
                worst = {}
                for key in ("grad_rel", "after_rel", "update_rel"):
                    per = [json.loads(str(r[f"{tag}/{key}"])) for r in ranks]
                    worst[key] = max((v, k) for g in per for k, v in g.items())
                    rep[label][f"{key}_max"] = worst[key]
                rep[label]["param_gb_per_rank"] = [
                    float(r[f"{tag}/param_bytes"]) / 1e9 for r in ranks]
                ok &= (worst["grad_rel"][0] <= TRAIN_TP_GRAD_RTOL
                       and worst["after_rel"][0] <= TRAIN_TP_GRAD_RTOL
                       and worst["update_rel"][0] <= TRAIN_TP_UPDATE_RTOL)
            if not ok:
                failed.append(f"{tag} {label}: {json.dumps(rep[label])}")
        report[tag] = rep
    report["flash_launches_per_rank"] = [int(r["flash_launches"])
                                         for r in ranks]
    if any(report["flash_launches_per_rank"]):
        failed.append("the training path launched the flash kernel "
                      f"{report['flash_launches_per_rank']}")
    total = time.perf_counter() - t0
    report["phase_s"] = total
    for key, val in report.items():
        print(f"tensor-parallel training (3o) {key} ({smi}): "
              f"{json.dumps(val)}", flush=True)
    print(f"tensor-parallel training (3o) card: {smi}; phase 3o took "
          f"{total:.1f} s", flush=True)
    if failed:
        raise AssertionError(f"phase 3o: {failed}")
    return {}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke: run from a checkout (src/repro_torch missing)",
              file=sys.stderr)
        return 2
    t_script = time.perf_counter()
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
    # Past one 16-feature chunk, and a wide y: shared memory is fixed; more
    # (slice, tile) units than SMs (136, one block each).
    for dtype in (torch.float32, torch.float64):
        for q, d in ((40, 1), (8, 64)):
            check_reg_stats(rs_ops, rs_ref, peaks, 100_003, 130, q, d, dtype,
                            masked=True, timed=False)
        check_reg_stats(rs_ops, rs_ref, peaks, 20_011, 2_048, 8, 4, dtype,
                        masked=True, timed=False)
    # f32's ragged m across the 128-tile edge, and past 65,535 upper
    # 128-tiles (66,066 at m 46,400: the old gridDim.y limit), its D held
    # 2,048 rows at a time (the whole plain D and its error tensors would
    # not fit beside the kernel's).
    for m in (127, 129, 257):
        check_reg_stats(rs_ops, rs_ref, peaks, 20_011, m, 8, 4,
                        torch.float32, masked=True, timed=False)
    check_reg_stats_rows(rs_ops, 1_003, 46_400, 3, 2, torch.float32)
    # Phase 3e's streamed blocks: 2,048 rows at m 64, one cluster of one
    # block a 32-row slice.
    check_reg_stats(rs_ops, rs_ref, peaks, 2_048, 64, 8, 1, torch.float64,
                    masked=False, timed=True)
    torch.cuda.empty_cache()
    print("cublas f64 K^T (w K), 65,536 x 512 scaled to n = 1e6 (yardstick "
          f"of the DMMA loop, not called by the port): "
          f"{cublas_d_product_ms(cfg.n, cfg.m):.4f} ms", flush=True)
    print("cublas f32 K^T (w K), 65,536 x 512 scaled to n = 1e6, TF32 off "
          "(yardstick of the f32 reg_stats kernel's FMA loop, not called by "
          "the port): "
          f"{cublas_d_product_ms(cfg.n, cfg.m, dtype=torch.float32):.4f} ms",
          flush=True)
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
    print("cublas f64 Knm S, 65,536 x 512 by 512 x 512 scaled to n = 1e6 "
          "(yardstick of the reg_stats backward's DMMA loop, not called by "
          "the port): "
          f"{cublas_quad_product_ms(65_536, cfg.m) * cfg.n / 65_536:.4f} ms",
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
    # Ten 16-feature chunks: shared memory is fixed; psi2's packed patches
    # at the tile edges, and its centred exponent where its terms are
    # largest against their sum.
    for dtype in (torch.float32, torch.float64):
        check_psi(ps_ops, ps_ref, peaks, 1003, 37, 160, dtype, masked=True,
                  timed=False)
        for m in (63, 65, 151):
            check_psi(ps_ops, ps_ref, peaks, 1003, m, 10, dtype, masked=True,
                      timed=False)
    check_psi2_midway(ps_ops, ps_ref, 1003, 150, 10)
    check_psi2_midway(ps_ops, ps_ref, 1003, 150, 10, torch.float32, 20.0)
    bwd = check_backwards(rs_ops, rs_ref, ps_ops, ps_ref, peaks, cfg, usps,
                          synth)
    time_backwards(bwd)
    time_operator_routes(rs_ops, ps_ops, cfg, usps)
    fa_full = {}
    for dtype in (torch.bfloat16, torch.float32):
        fa_full[dtype] = check_flash(fa_ops, fa_ref, peaks, LM_BATCH, 32, 8,
                                     LM_PROMPT, LM_PROMPT, 64, True, dtype,
                                     timed=True)
        for shape in ARCH_FLASH_SHAPES:   # timed: phase 3k's new shapes
            check_flash(fa_ops, fa_ref, peaks, *shape, dtype, timed=True)
        for shape in ((1, 32, 8, 8192, 8192, 64, True),
                      (2, 4, 2, 64, 64, 64, True), (1, 8, 1, 70, 70, 64, True),
                      (1, 4, 4, 33, 90, 128, True),
                      (2, 2, 2, 96, 48, 64, False),
                      (1, 4, 2, 64, 64, 64, True), (1, 4, 4, 1, 57, 64, True),
                      (1, 2, 1, 96, 48, 64, True)):
            check_flash(fa_ops, fa_ref, peaks, *shape, dtype, timed=False)

    # -- phase 3: the main paths ------------------------------------------------
    # Phase 2's launches are not the paths'.
    for _, c, k in f32_gp_counters():
        c[k] = 0
    sgpr_launches, sgpr = serving_path(rt, cfg)
    dist_launches = distributed_path(rt, cfg, usps)
    stream_launches = streaming_path(rt, cfg, usps)
    gplvm_launches, gplvm_model = gplvm_path(rt, usps)
    remainder_launches = serving_remainder_path(rt, cfg, usps, sgpr,
                                                gplvm_model)
    online_launches = online_zoo_path(rt, cfg, GP_CONFIGS["sgpr-zoo-trend"],
                                      sgpr)
    ext_launches = serving_ext_path(rt, cfg, sgpr)
    del gplvm_model
    torch.cuda.empty_cache()
    async_launches = async_path(rt, cfg, usps, sgpr)
    del sgpr
    torch.cuda.empty_cache()
    lm_launches = lm_path(fa_ops, fa_ref)
    torch.cuda.empty_cache()
    lm_train_path(fa_ops, peaks)
    torch.cuda.empty_cache()
    arch_launches = arch_serving_path(fa_ops, fa_ref)
    gc.collect()
    torch.cuda.empty_cache()
    ep_launches = ep_serving_path(fa_ops)
    gc.collect()
    torch.cuda.empty_cache()
    tp_launches = tp_serving_path(fa_ops)
    gc.collect()
    torch.cuda.empty_cache()
    train_tp_path()
    launches = {**sgpr_launches, **gplvm_launches, **lm_launches,
                **{name: c[k] for name, c, k in f32_gp_counters()},
                "predict_f64": sgpr_launches["predict_f64"]
                + gplvm_launches["predict_f64"]}
    for kname, count in (*dist_launches.items(), *stream_launches.items(),
                         *remainder_launches.items(),
                         *online_launches.items(), *ext_launches.items(),
                         *async_launches.items(), *arch_launches.items(),
                         *ep_launches.items(), *tp_launches.items()):
        launches[kname] += count

    def entry(kname, source, replaces, res):
        return {"name": kname, "route": "cuda", "source": source,
                "replaces": replaces, "launches": launches[kname],
                "max_abs_err": res["max_abs_err"], "ms": res["ms"],
                "plain_ms": res["plain_ms"], "bound_ms": res["bound_ms"],
                "bound_by": res["bound_by"],
                "library_ms": res.get("library_ms")}

    # Every instantiation, times at the main paths' shapes.  The f32 GP ones
    # serve only f32 callers (the f64 models never reach them): their
    # launches on the paths are counted all the same.
    kernels = [
        entry("reg_stats_f32", "src/repro_torch/csrc/reg_stats.cu",
              "src/repro/kernels/reg_stats/kernel.py:99",
              rs_full[torch.float32]),
        entry("reg_stats_f64", "src/repro_torch/csrc/reg_stats.cu",
              "src/repro/kernels/reg_stats/kernel.py:99",
              rs_full[torch.float64]),
        entry("predict_f32", "src/repro_torch/csrc/predict.cu",
              "src/repro/kernels/predict/kernel.py:75", pr_full[torch.float32]),
        entry("predict_f64", "src/repro_torch/csrc/predict.cu",
              "src/repro/kernels/predict/kernel.py:75", pr_full[torch.float64]),
        entry("psi2_f32", "src/repro_torch/csrc/psi_stats.cu",
              "src/repro/kernels/psi_stats/kernel.py:76",
              psi_full[torch.float32]["psi2"]),
        entry("psi2_f64", "src/repro_torch/csrc/psi_stats.cu",
              "src/repro/kernels/psi_stats/kernel.py:76",
              psi_full[torch.float64]["psi2"]),
        entry("psi1_f32", "src/repro_torch/csrc/psi_stats.cu",
              "src/repro/kernels/psi_stats/kernel.py:125",
              psi_full[torch.float32]["psi1"]),
        entry("psi1_f64", "src/repro_torch/csrc/psi_stats.cu",
              "src/repro/kernels/psi_stats/kernel.py:125",
              psi_full[torch.float64]["psi1"]),
        entry("reg_stats_bwd_f32", "src/repro_torch/csrc/reg_stats_bwd.cu",
              "src/repro/kernels/reg_stats/ops.py:62",
              bwd[f"reg_stats f32 {cfg.name}"]),
        entry("reg_stats_bwd_f64", "src/repro_torch/csrc/reg_stats_bwd.cu",
              "src/repro/kernels/reg_stats/ops.py:62",
              bwd[f"reg_stats f64 {cfg.name}"]),
        entry("psi2_bwd_f32", "src/repro_torch/csrc/psi2_bwd.cu",
              "src/repro/kernels/psi_stats/ops.py:56",
              bwd[f"psi2 f32 {usps.name}"]),
        entry("psi2_bwd_f64", "src/repro_torch/csrc/psi2_bwd.cu",
              "src/repro/kernels/psi_stats/ops.py:56",
              bwd[f"psi2 f64 {usps.name}"]),
        entry("psi1_bwd_f32", "src/repro_torch/csrc/psi1_bwd.cu",
              "src/repro/core/gp_kernels.py:97",
              bwd[f"psi1 f32 {usps.name}"]),
        entry("psi1_bwd_f64", "src/repro_torch/csrc/psi1_bwd.cu",
              "src/repro/core/gp_kernels.py:97",
              bwd[f"psi1 f64 {usps.name}"]),
        entry("flash_attention_bf16", "src/repro_torch/csrc/flash_attention.cu",
              "src/repro/kernels/flash_attention/kernel.py:80",
              fa_full[torch.bfloat16]),
        entry("flash_attention_f32", "src/repro_torch/csrc/flash_attention.cu",
              "src/repro/kernels/flash_attention/kernel.py:80",
              fa_full[torch.float32]),
    ]
    print(f"chip_smoke took {time.perf_counter() - t_script:.1f} s",
          flush=True)
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
