"""The paper's §5 at full scale: 2M-row flight-delay regression, streamed
from host (torch copy of ``examples/flight_scale.py``).

``data.synthetic.flight_like`` computes rows on demand (a stand-in for a
2M-row file); ``DistributedGP`` folds its chunks through
``streamed_svi_value_and_grad``, so a step's cost and a rank's memory are
O(batch * chunk) whatever n is; then one exact streamed bound, a streamed
predictive state, and ``PredictEngine.predict_stream`` answering a query
stream.  One process per data shard; each rank reads only its own rows.

  PYTHONPATH=src python -m repro_torch.examples.flight_scale

  # 4 ranks on the CPU over gloo:
  PYTHONPATH=src torchrun --standalone --nproc-per-node=4 \\
      -m repro_torch.examples.flight_scale --device cpu --tiny

  # smoke (seconds): 20k rows, 10 steps
  PYTHONPATH=src python -m repro_torch.examples.flight_scale --tiny
"""
import argparse
import time

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core import DistributedGP
from repro_torch.data.synthetic import flight_like
from repro_torch.launch import make_data_group
from repro_torch.serve import PredictEngine
from repro_torch.train.svi import adam_init, adam_step


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=2_000_000)
    ap.add_argument("--m", type=int, default=64, help="inducing points")
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--chunk", type=int, default=2048)
    ap.add_argument("--batch-chunks", type=int, default=4)
    ap.add_argument("--tiny", action="store_true",
                    help="smoke: 20k rows, 10 steps, small blocks")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    if args.tiny:
        args.n, args.m, args.steps = 20_000, 16, 10
        args.chunk, args.batch_chunks = 256, 2
    return args


def main(argv=None):
    args = parse(argv)
    owned = not dist.is_initialized()
    group = make_data_group(args.device)
    try:
        return _run(group, args)
    finally:
        if owned:
            dist.destroy_process_group()


def _run(group, args):
    eng = DistributedGP(group, latent=False, chunk_size=args.chunk,
                        device=args.device)
    say = print if eng.rank == 0 else (lambda *a, **k: None)
    src = flight_like(n=args.n, seed=0)
    stream = eng.put_data(stream=src, blocks_per_chunk=1)
    say(f"flight_like n={args.n:,} q=8  ->  {stream.n_chunks} chunks of "
        f"{stream.chunk_rows} rows across {eng.n_shards} shards "
        f"(each rank holds its window of one chunk at a time)")

    # Inducing inputs from the first rows' covariates; delay target d=1.
    first = src.read(0, max(args.m, 256))
    rng = np.random.default_rng(0)
    z0 = first["mu"][rng.choice(first["mu"].shape[0], args.m, replace=False)]

    def t64(a):
        return torch.as_tensor(np.asarray(a, np.float64), device=eng.device)

    params = {"hyp": {"log_sf2": t64(0.0), "log_ell": t64(np.zeros(8)),
                      "log_beta": t64(1.0)},
              "z": t64(z0)}

    # SVI over the stream: each step folds batch_chunks random chunks, the
    # same ones on every rank (one seeded generator on every rank).  Adam:
    # raw bound gradients scale with n, so plain SGD would need an
    # n-dependent learning rate.
    step = eng.streamed_svi_value_and_grad(d=1,
                                           batch_chunks=args.batch_chunks)
    gen = torch.Generator().manual_seed(1)
    opt = adam_init(params)
    t0 = time.perf_counter()
    for i in range(args.steps):
        v, (g_hyp, g_z) = step(params["hyp"], params["z"], stream, gen)
        params, opt = adam_step(params, {"hyp": g_hyp, "z": g_z}, opt,
                                lr=2e-2)
        if i % max(1, args.steps // 6) == 0 or i == args.steps - 1:
            say(f"  step {i:>4d}: stochastic bound {-float(v):14.1f}")
    dt = time.perf_counter() - t0
    rows_seen = args.steps * args.batch_chunks * stream.chunk_rows
    say(f"{args.steps} SVI steps in {dt:.1f}s "
        f"({rows_seen / dt:,.0f} rows/s touched)")

    # Exact streamed bound: one full pass, O(chunk) host memory.
    hyp, z = params["hyp"], params["z"]
    bound = float(eng.streamed_bound(hyp, z, stream, d=1))
    say(f"exact streamed bound over all {args.n:,} rows: {bound:,.1f}")

    # Serve a query stream against the streamed posterior.
    state = eng.streamed_predictive_state(hyp, z, stream)
    serve = PredictEngine(state, block_size=min(args.chunk, 512),
                          device=eng.device)
    q_src = flight_like(n=10 * 4096 if not args.tiny else 4096, seed=99)
    windows = range(0, q_src.n, 4096)
    queries = (q_src.read(i, min(i + 4096, q_src.n))["mu"] for i in windows)
    truth = (q_src.read(i, min(i + 4096, q_src.n))["y"] for i in windows)
    se = count = 0.0
    for (mean, _), yt in zip(serve.predict_stream(queries), truth):
        se += float(np.sum((mean.cpu().numpy() - yt) ** 2))
        count += yt.size
    rmse = float(np.sqrt(se / count))
    say(f"served {int(count):,} streamed queries: RMSE vs noisy delays "
        f"{rmse:.3f} (generator noise floor ~0.21)")
    return bound, rmse


if __name__ == "__main__":
    main()
