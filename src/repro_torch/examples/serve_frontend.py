"""A serving deployment in one file: fit, queue, burst, hot-swap, report
(torch copy of ``examples/serve_frontend.py``).

An async ``Frontend`` over the engine coalesces concurrent requests into
the engine's block batches, enforces per-request deadlines, and hot-swaps
a re-fitted state mid-traffic.  Every response is checked bitwise against
a direct engine call on the state of the generation it was served under.

  PYTHONPATH=src python -m repro_torch.examples.serve_frontend [--device cpu]

Under a launcher the engine is sharded over the ranks: rank 0 runs the
front-end, the other ranks ``serve_follower`` (each rank fits the same
states from the same seed):

  PYTHONPATH=src torchrun --standalone --nproc-per-node=4 \
      -m repro_torch.examples.serve_frontend --device cpu
"""
import asyncio
import os
import tempfile

import numpy as np

from repro_torch.core import SGPR
from repro_torch.examples import device_args
from repro_torch.serve import (Frontend, PredictEngine, load_state,
                               save_state, serve_follower)


def fit_state(rng, wiggle, device):
    n = 400
    x = rng.uniform(-3, 3, size=(n, 1))
    y = np.sin(wiggle * x) + 0.1 * rng.standard_normal((n, 1))
    model = SGPR(x, y, num_inducing=20, seed=0, device=device)
    model.fit(max_iters=60)
    return model.predictive_state()


async def serve(engine, state_a, ckpt_b, rng, device):
    fe = Frontend(engine, max_wait_ms=2.0, max_batch_rows=128,
                  default_deadline_ms=250.0)
    async with fe:
        n_shapes = fe.warmup()        # run every padded batch size once
        print(f"frontend up: block 128 on {engine.n_shards} rank(s), "
              f"batches <= {fe.max_batch_rows} rows, {n_shapes} shapes "
              "warmed")

        # -- a concurrent burst: 60 clients, mixed request sizes ------------
        queries = [rng.uniform(-3, 3, size=(rng.integers(1, 9), 1))
                   for _ in range(60)]
        results = await asyncio.gather(*[fe.submit(x) for x in queries])
        c = fe.metrics.summary()["counters"]
        print(f"burst: {len(results)} requests answered in {c['flushes']} "
              f"flushes (mean batch "
              f"{c['flushed_requests'] / c['flushes']:.1f} requests)")
        assert c["flushes"] < len(results), "burst should coalesce"

        # -- hot swap mid-flight: new requests see the new generation -------
        load = [asyncio.ensure_future(fe.submit(x)) for x in queries[:20]]
        gen = fe.swap_state(ckpt_b)   # restored from the checkpoint sidecar
        after = await fe.submit(queries[0])
        inflight = await asyncio.gather(*load)
        print(f"hot swap -> generation {gen}; in-flight requests answered "
              f"on generations {sorted({r.generation for r in inflight})}, "
              f"new request on {after.generation}")
        assert after.generation == gen
        assert len(inflight) == 20, "a swap must not drop in-flight requests"

        # -- every response is bitwise its generation's engine answer -------
        engines = {0: PredictEngine(state_a, block_size=128, device=device),
                   gen: PredictEngine(load_state(ckpt_b, device=device)[0],
                                      block_size=128, device=device)}
        for x, res in zip(queries, list(results) + list(inflight)):
            ref_m, ref_v = engines[res.generation].predict(x)
            assert np.array_equal(res.mean, ref_m.cpu().numpy())
            assert np.array_equal(res.var, ref_v.cpu().numpy())
        print("all responses bitwise-match their generation's state: OK")

        summ = fe.metrics.summary()
        print(f"SLO summary: p50 wait {summ['wait']['p50'] * 1e3:.2f} ms, "
              f"p99 e2e {summ['e2e']['p99'] * 1e3:.2f} ms, "
              f"goodput {summ['goodput_rps']:.0f} req/s, "
              f"pad fraction {summ['pad_fraction']:.2f}")
        lo = fe.load_summary()
        print(f"engine load (per flush): min {lo['min'] * 1e3:.2f} ms, "
              f"mean {lo['mean'] * 1e3:.2f} ms, max {lo['max'] * 1e3:.2f} ms")
        assert summ["counters"]["completed"] == 81    # 60 + 20 + 1, none lost
    fe.close()   # ends the followers' loop (nothing to do alone)
    return summ["counters"]


def main(argv=None):
    args = device_args(__doc__, argv)
    rng = np.random.default_rng(7)
    print("fitting generation-0 and generation-1 models ...")
    state_a = fit_state(rng, 2.0, args.device)
    state_b = fit_state(rng, 2.4, args.device)   # the "re-fit" to roll out
    group = None
    if int(os.environ.get("WORLD_SIZE", "1")) > 1:   # under a launcher
        from repro_torch.launch import make_data_group
        group = make_data_group(args.device)
    try:
        engine = PredictEngine(state_a, block_size=128, device=args.device,
                               group=group)
        if engine.rank:
            print(f"rank {engine.rank}: served {serve_follower(engine)} "
                  "batches")
            return None
        ckpt_dir = tempfile.mkdtemp(prefix="serve_frontend_")
        ckpt_b = save_state(f"{ckpt_dir}/refit", state_b)
        return asyncio.run(serve(engine, state_a, str(ckpt_b), rng,
                                 args.device))
    finally:
        if group is not None:
            import torch.distributed as dist
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
