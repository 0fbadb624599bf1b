"""The overlapped reduce, the front-end and the expert-parallel MoE over a
process group, one rank a card over NCCL (what ``chip_smoke.py`` phases 3i
and 3l cannot run on one card: NCCL refuses two ranks on one GPU):

    python3 -c "import sys; sys.path.insert(0, 'src'); \\
        from repro_torch.kernels import _build; _build.build_all()"
    torchrun --standalone --nproc-per-node=4 tools/four_cards.py
    # the same on the CPU over gloo, at a small size:
    torchrun --standalone --nproc-per-node=4 tools/four_cards.py --cpu
    # the expert-parallel prefill alone (either device):
    torchrun --standalone --nproc-per-node=4 tools/four_cards.py --ep-only
    # the tensor-parallel chameleon-34b alone (either device):
    torchrun --standalone --nproc-per-node=4 tools/four_cards.py --tp-only

Each rank holds n / 4 rows of ``sgpr-synth-1m`` (3a's data and init,
``chunk_size`` 65,536: 4 blocks a rank) and takes the distributed step in
each ``reduce_mode``: every rank's bits the same, ``overlap`` bitwise
``overlap_eager``, within 1e-9 / 1e-8 of ``serial``, one all_reduce a
block; each mode's step time (host clock, synchronised, median of 5).
Then every rank extracts the predictive state at the init and at a second
``log_beta`` (``DistributedGP.predictive_state``, the same bits on every
rank) and serves over the ranks, each answer bitwise a world of one's on
the rank's own card and the same on every rank: the fleet
(``multi_predict_engine`` of the two states) on 65,536 of phase 3h's
queries, before and after a ``swap_slot`` of slot 1; the sharded
``sample`` of 4,096 queries x 256 draws (phase 3h's seed); then rank 0
serves the first 500 of phase 3h's requests through a ``Frontend`` over
``predict_engine`` with a ``swap_state`` to the second state midway and
``close()``, the other ranks run ``serve_follower``: every response bitwise
a world of one's on rank 0's card.  Between the two, phase 3l's prefill
(``qwen3-moe-235b-a22b``, 4 of 94 layers, B 4 x 2,048, bf16, flash, the
config's capacity factor) through the expert-parallel MoE on a (1, 4)
mesh over the default group (NCCL) and on a (1, 4) mesh of gloo groups
over the same ranks (``DeviceMesh.from_group``, host copies): every rank's
logits bitwise the same on each, the two within 2e-2 relative RMS
(``--cpu``: the reduced config, B 2 x 16).  ``--tp-only``: chameleon-34b
at full depth (48 layers, bf16 params, 64 / 8 heads, d_ff 22,016, 34.3 B
params, 8.6 B a rank) tensor-parallel on a (1, 4) mesh, prefill B 4 x
2,048 and 16 teacher-forced decode steps, over NCCL and over gloo groups
of the same ranks: every rank's logits bitwise the same on each, and the
two meshes' logits bitwise the same (``--cpu``: the reduced config with
8 heads, B 2 x 16).
Rank 0 prints a JSON line for each part and the cards' name and power
limit; any failed check raises.
"""
import asyncio
import json
import pathlib
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke as cs  # noqa: E402
from repro_torch.configs import GP_CONFIGS, GPConfig  # noqa: E402
from repro_torch.core.distributed import DistributedGP  # noqa: E402
from repro_torch.launch import make_data_group  # noqa: E402
from repro_torch.serve import (Frontend, MultiPredictEngine,  # noqa: E402
                               PredictEngine, serve_follower)
from repro_torch.train.steps import make_gp_train_step  # noqa: E402

MODES = ("serial", "overlap", "overlap_eager")


def steps(group, cfg, chunk, device, report):
    """Each reduce mode's step: value and flat gradient, all_reduce calls,
    median step time."""
    x, y, z, hyp = cs.sgpr_inputs(cfg.n, cfg.q, cfg.d, cfg.m)
    h, zz = {k: cs.t64(v, device) for k, v in hyp.items()}, cs.t64(z, device)
    out, calls = {}, []
    undo = cs.counting_all_reduce(calls)
    try:
        for mode in MODES:
            eng, vg = make_gp_train_step(group, cfg.d, chunk_size=chunk,
                                         reduce_mode=mode, device=device)
            data, w = eng.put_data(y=y, mu=x)

            def run():
                return vg(h, zz, data["mu"], None, data["y"], w,
                          np.ones(eng.n_shards), float(cfg.n))
            calls.clear()
            v, (gh, gz) = run()
            report[f"{mode}_all_reduces"] = len(calls)
            out[mode] = (float(v), cs.flat_grads(gh, gz))
            report[f"{mode}_step_s"] = cs.median_step_s(run)
    finally:
        undo()
    return out, (x, y, z, hyp)


def same_on_every_rank(group, arrays) -> bool:
    """Whether every rank holds the same bits in ``arrays``."""
    mine = b"".join(np.ascontiguousarray(a).tobytes() for a in arrays)
    every = [None] * dist.get_world_size(group)
    dist.all_gather_object(every, mine, group=group)
    return all(e == mine for e in every)


def fleet_and_sample(eng, group, states, queries, dev, report):
    """The fleet over the ranks (before and after a ``swap_slot``) and the
    sharded ``sample``, each bitwise a world of one's on this rank's card
    and the same on every rank."""
    xq = torch.from_numpy(queries).to(dev)
    fleet = eng.multi_predict_engine(states)
    one = MultiPredictEngine(states, device=dev)
    got, want = [], []
    for swapped in (False, True):
        if swapped:
            fleet.swap_slot(1, states[0])
            one.swap_slot(1, states[0])
        got += [a.cpu().numpy() for a in fleet.predict(xq)]
        want += [a.cpu().numpy() for a in one.predict(xq)]
    xs = xq[:cs.SAMPLE_T]
    draws = eng.predict_engine(states[0]).sample(xs, cs.SAMPLE_DRAWS,
                                                 cs.SAMPLE_SEED)
    got.append(draws.cpu().numpy())
    want.append(PredictEngine(states[0], device=dev).sample(
        xs, cs.SAMPLE_DRAWS, cs.SAMPLE_SEED).cpu().numpy())
    res = {"fleet_queries": xq.shape[0], "fleet_models": fleet.n_models,
           "sample_shape": list(draws.shape),
           "bitwise_world_of_one": [bool(np.array_equal(a, b))
                                    for a, b in zip(got, want)],
           "same_on_every_rank": same_on_every_rank(group, got)}
    if not (all(res["bitwise_world_of_one"]) and res["same_on_every_rank"]):
        raise AssertionError(f"fleet and sample over the ranks: {res}")
    report["fleet_and_sample"] = res


def ep_prefill(group, cpu, dev, report):
    """Phase 3l's prefill through the expert-parallel MoE on a (1, world)
    mesh over the default group and on one over gloo groups of the same
    ranks: each mesh's logits the same bits on every rank, the two meshes'
    within 2e-2."""
    import dataclasses

    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch.distributed import sharding
    from repro_torch.launch import make_compat_mesh
    from repro_torch.train import steps as lm_steps

    world, rank = dist.get_world_size(group), dist.get_rank(group)
    if cpu:
        cfg = dataclasses.replace(cs.ep_train_config(),
                                  capacity_factor=1.25,
                                  compute_dtype="bfloat16")
        b, t = 2, 16
    else:
        cfg, b, t = cs.ep_config(), cs.LM_BATCH, cs.LM_PROMPT
    singles = [dist.new_group([r], backend="gloo") for r in range(world)]
    meshes = {
        dist.get_backend(group): make_compat_mesh((1, world),
                                                  ("data", "model"), dev),
        "gloo groups": DeviceMesh.from_group(
            [singles[rank], dist.new_group(list(range(world)),
                                           backend="gloo")],
            dev.type, mesh=torch.arange(world).reshape(1, world),
            mesh_dim_names=("data", "model"))}
    params = lm_steps.init_params_sharded(
        cfg, torch.Generator(device=dev).manual_seed(cs.SEED),
        meshes["gloo groups"], device=dev)
    batch = cs.arch_batch(cfg, b, t, dev)
    prefill = lm_steps.make_prefill_step(cfg)
    logits, res = {}, {}
    for name, mesh in meshes.items():
        with sharding.use_mesh(mesh):
            prefill(params, batch)                      # warm-up
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            lg, _ = prefill(params, batch)
            torch.cuda.synchronize()
        res[f"{name}_prefill_s"] = time.perf_counter() - t0
        logits[name] = lg.float().cpu()
        res[f"{name}_same_on_every_rank"] = same_on_every_rank(
            group, [logits[name].numpy()])
    a, g = logits.values()
    res["rel_rms_between_meshes"] = cs.rel_rms(a, g)
    res["config"] = {"layers": cfg.num_layers, "d_model": cfg.d_model,
                     "experts": cfg.num_experts, "batch": b, "prompt": t}
    report["ep_prefill"] = res
    if not (all(v for k, v in res.items() if k.endswith("every_rank"))
            and res["rel_rms_between_meshes"] <= cs.LOGIT_RTOL["bfloat16"]):
        raise AssertionError(f"expert-parallel prefill over the ranks: {res}")


def tp_serving(group, cpu, dev, report):
    """chameleon-34b tensor-parallel over the ranks (module doc)."""
    import dataclasses
    import os

    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch.distributed import sharding
    from repro_torch.launch import make_compat_mesh
    from repro_torch.models import transformer as tf
    from repro_torch.train import steps as lm_steps

    world, rank = dist.get_world_size(group), dist.get_rank(group)
    cfg = dataclasses.replace(cs.get_lm_config("chameleon-34b"),
                              use_flash=True)
    b, t, n_new = cs.LM_BATCH, cs.LM_PROMPT, cs.LM_NEW
    if cpu:
        cfg = dataclasses.replace(cfg.reduced(), num_heads=8, num_kv_heads=4,
                                  compute_dtype="bfloat16")
        b, t, n_new = 2, 16, 3
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF",
                          "expandable_segments:True")
    singles = [dist.new_group([r], backend="gloo") for r in range(world)]
    meshes = {
        dist.get_backend(group): make_compat_mesh((1, world),
                                                  ("data", "model"), dev),
        "gloo groups": DeviceMesh.from_group(
            [singles[rank], dist.new_group(list(range(world)),
                                           backend="gloo")],
            dev.type, mesh=torch.arange(world).reshape(1, world),
            mesh_dim_names=("data", "model"))}
    t0 = time.perf_counter()
    params = lm_steps.init_params_sharded(
        cfg, torch.Generator(device=dev).manual_seed(cs.SEED),
        meshes["gloo groups"], device=dev)
    res = {"init_s": time.perf_counter() - t0}
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    tokens = torch.from_numpy(np.random.default_rng(cs.SEED).integers(
        0, cfg.vocab_size, (b, t + n_new), dtype=np.int32)).to(dev)
    prefill = lm_steps.make_prefill_step(cfg)
    serve = lm_steps.make_serve_step(cfg)
    logits = {}
    for name, mesh in meshes.items():
        with sharding.use_mesh(mesh):
            prefill(params, {"tokens": tokens[:, :t]})          # warm-up
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            lg, caches = prefill(params, {"tokens": tokens[:, :t]})
            torch.cuda.synchronize()
            res[f"{name}_prefill_s"] = time.perf_counter() - t0
            caches = tf.grow_decode_cache(cfg, caches, t + n_new)
            out, steps_s = [lg], []
            for i in range(n_new):
                t0 = time.perf_counter()
                lg, caches = serve(params, caches, tokens[:, t + i:t + i + 1],
                                   torch.full((b,), t + i, dtype=torch.int32,
                                              device=dev))
                torch.cuda.synchronize()
                steps_s.append(time.perf_counter() - t0)
                out.append(lg)
            del caches
        res[f"{name}_decode_step_ms_median"] = 1e3 * float(
            np.median(steps_s[1:]))
        logits[name] = torch.stack(out).float().cpu()
        res[f"{name}_same_on_every_rank"] = same_on_every_rank(
            group, [logits[name].numpy()])
    a, g = logits.values()
    res["bitwise_between_meshes"] = bool(torch.equal(a, g))
    res["rel_rms_between_meshes"] = cs.rel_rms(a, g)
    res["param_gb_per_rank"] = sum(
        x.numel() * x.element_size()
        for x in torch.utils._pytree.tree_leaves(params)) / 1e9
    res["peak_gb"] = (torch.cuda.max_memory_allocated() / 1e9
                      if dev.type == "cuda" else 0.0)
    res["config"] = {"layers": cfg.num_layers, "d_model": cfg.d_model,
                     "heads": cfg.num_heads, "kv_heads": cfg.num_kv_heads,
                     "d_ff": cfg.d_ff, "batch": b, "prompt": t, "new": n_new}
    report["tp_serving"] = res
    if not (all(v for k, v in res.items() if k.endswith("every_rank"))
            and res["bitwise_between_meshes"]):
        raise AssertionError(f"tensor-parallel serving over the ranks: {res}")


def main():
    cpu = "--cpu" in sys.argv
    device = "cpu" if cpu else None
    if cpu:
        torch.cuda.synchronize = lambda *a, **k: None
        cs.DEV = "cpu"
        cfg, chunk = GPConfig("tiny", 8192, 4, 8, 16, False), 512
    else:
        cfg, chunk = GP_CONFIGS["sgpr-synth-1m"], cs.OVERLAP_CHUNK
    torch.backends.cuda.matmul.allow_tf32 = False
    group = make_data_group(device)
    rank, world = dist.get_rank(group), dist.get_world_size(group)
    dev = torch.device("cpu") if cpu else torch.device(
        "cuda", torch.cuda.current_device())
    only = {"--ep-only": ep_prefill, "--tp-only": tp_serving}
    for flag, part in only.items():
        if flag not in sys.argv:
            continue
        report = {}
        part(group, cpu, dev, report)
        if rank == 0:
            print(json.dumps(report), flush=True)
            if not cpu:
                print(cs.nvidia_smi(), flush=True)
        dist.destroy_process_group()
        return
    report = {"backend": dist.get_backend(group), "world": world}
    out, (x, y, z, hyp) = steps(group, cfg, chunk, dev, report)
    # -- the bits: every rank's the same, overlap's eager's, near serial's --
    mine = np.concatenate([[out[m][0]] + list(out[m][1]) for m in MODES])
    every = [None] * world
    dist.all_gather_object(every, mine, group=group)
    if any(e.tobytes() != mine.tobytes() for e in every):
        raise AssertionError("the ranks' values and gradients differ")
    for k in (0, 1):
        if np.asarray(out["overlap"][k]).tobytes() != \
                np.asarray(out["overlap_eager"][k]).tobytes():
            raise AssertionError("overlap is not bitwise overlap_eager")
    dv = abs(out["overlap"][0] - out["serial"][0]) / abs(out["serial"][0])
    dg = cs.rel_diff(out["overlap"][1], out["serial"][1])
    report["overlap_vs_serial"] = {"value_rel_diff": dv,
                                   "grad_rel_diff": dg}
    blocks = -(-cfg.n // (world * chunk))
    if not (dv <= 1e-9 and dg <= cs.GRAD_RTOL
            and report["serial_all_reduces"] == 2
            and report["overlap_all_reduces"] == blocks + 1):
        raise AssertionError(f"overlapped reduce: {report}")
    if rank == 0:
        print(json.dumps(report), flush=True)

    # -- the front-end over the ranks ------------------------------------------
    eng = DistributedGP(group, chunk_size=chunk, device=device)
    data, w = eng.put_data(y=y, mu=x)
    h = {k: cs.t64(v, dev) for k, v in hyp.items()}
    states = [eng.predictive_state(hh, cs.t64(z, dev), data["y"], data["mu"],
                                   None, w)
              for hh in (h, {**h, "log_beta": h["log_beta"] + 0.1})]
    del data, w
    queries = np.random.default_rng(cs.SEED + 1).uniform(
        -2.0, 2.0, (65_536, cfg.q))
    report = {}
    fleet_and_sample(eng, group, states, queries, dev, report)
    if rank == 0:
        print(json.dumps(report), flush=True)
    report = {}
    ep_prefill(group, cpu, dev, report)
    if rank == 0:
        print(json.dumps(report), flush=True)
    peng = eng.predict_engine(states[0])
    if rank:
        serve_follower(peng)
        dist.destroy_process_group()
        return
    reqs = cs.fe_rank_requests(queries)
    sent = []
    real = dist.broadcast

    def timed_broadcast(t, *args, **kwargs):
        t0 = time.perf_counter()
        res = real(t, *args, **kwargs)
        torch.cuda.synchronize()
        sent.append((t.numel() * t.element_size(), time.perf_counter() - t0))
        return res
    dist.broadcast = timed_broadcast

    async def session():
        async with Frontend(peng, max_batch_rows=cs.FE_BATCH_ROWS,
                            max_wait_ms=cs.FE_WAIT_MS,
                            max_queue_rows=cs.FE_QUEUE_ROWS) as fe:
            shapes = fe.warmup()
            sent.clear()
            t0 = time.perf_counter()
            first = await asyncio.gather(*[
                fe.submit(q) for q in reqs[:cs.FE_RANK_SWAP_AT]])
            fe.swap_state(states[1])
            rest = await asyncio.gather(*[
                fe.submit(q) for q in reqs[cs.FE_RANK_SWAP_AT:]])
            burst = time.perf_counter() - t0
        fe.close()
        return first + rest, shapes, burst, fe
    try:
        res, shapes, burst, fe = asyncio.run(session())
    finally:
        dist.broadcast = real
    one = [PredictEngine(s, device=dev) for s in states]
    bad = 0
    for q, r in zip(reqs, res):
        m, v = one[r.generation].predict(q)
        bad += not (np.array_equal(r.mean, m.cpu().numpy())
                    and np.array_equal(r.var, v.cpu().numpy()))
    summ = fe.metrics.summary()
    rows = sum(q.shape[0] for q in reqs)
    report = {"frontend": {
        "requests": len(reqs), "rows": rows,
        "flushes": summ["counters"]["flushes"], "warmup_shapes": shapes,
        "burst_s": burst, "rows_per_s": rows / burst,
        "e2e_p50_ms": 1e3 * summ["e2e"]["p50"],
        "e2e_p99_ms": 1e3 * summ["e2e"]["p99"],
        "flush_ms": [1e3 * r[0] for r in fe.timer.records],
        "broadcasts": len(sent), "broadcast_bytes": sum(b for b, _ in sent),
        "broadcast_ms": 1e3 * sum(s for _, s in sent),
        "generations": [sum(r.generation == g for r in res) for g in (0, 1)],
        "responses_not_bitwise": bad}}
    print(json.dumps(report), flush=True)
    if bad or 0 in report["frontend"]["generations"]:
        raise AssertionError(f"front-end over {world} ranks: "
                             f"{report['frontend']}")
    if not cpu:
        print(cs.nvidia_smi(), flush=True)
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
