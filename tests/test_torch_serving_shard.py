"""Sharded serving (``PredictEngine(group=...)``,
``DistributedGP.predict_engine``, ``sample`` under the group) and
checkpoint rotation against the JAX package.

The reference runs in one subprocess on 4 placeholder devices:
``PredictEngine(state, mesh=...)`` over axis ``"data"`` for ragged batch
sizes t (0, 1, 257, 1,000) and block sizes 1, 64 and 256.  The port runs
4 gloo ranks, spawned once for the module, each serving the same state
(the reference's, carried leaf for leaf) and the same batches; every rank
must return every row, the same bits on every rank, within f64 rounding of
the reference (rtol 1e-9 / atol 1e-11 on the mean, 1e-8 / 1e-10 on the
variance, as ``tests/test_torch_serving.py``), and compute only its own
quarter of the rows.  The same spawn serves a ``Frontend`` over the
sharded engine (ROADMAP Queue 1 item 15): rank 0 takes 40 requests of
1-30 rows with a ``swap_state`` to the reference's refitted state midway
and ``close()``s, ranks 1-3 run ``serve_follower``; every response is
bitwise a world of one's answer under its generation's state, within the
tolerances above of JAX's mesh engine, and every follower exits 0.
Checkpoint directories written by either package give the other the same
``latest`` and the same leaves, bit for bit.
"""
import datetime
import os
import pathlib
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

from test_torch_spawn import spawn_ranks

ROOT = pathlib.Path(__file__).resolve().parents[1]
W = 4
TS = (0, 1, 257, 1000)
BLOCKS = (1, 64, 256)
FIELDS = ("z", "chol_kmm", "chol_sigma", "c2", "a_mean", "g")
GROUP_TIMEOUT = datetime.timedelta(seconds=60)


def _problem():
    from conftest import make_regression

    rng = np.random.default_rng(3)
    x, y = make_regression(rng, n=80, q=2, d=3)
    queries = {t: rng.uniform(-2.5, 2.5, (t, 2)) for t in TS}
    return x, y, queries


FE_REQUESTS, FE_SWAP_AT, FE_BLOCK = 40, 20, 8
FLEET_REQUESTS, FLEET_SWAP_AT = 20, 10   # the fleet front-end's share


def _fe_requests():
    """The front-end's requests: 40 of 1-30 rows."""
    rng = np.random.default_rng(12)
    return [rng.uniform(-2.5, 2.5, (int(t), 2))
            for t in rng.integers(1, 31, FE_REQUESTS)]


_JAX_WORKER = """
import sys
import jax.numpy as jnp
import numpy as np
sys.path.insert(0, {tests!r})
import test_torch_serving_shard as t
from repro.core import SGPR
from repro.launch.mesh import make_compat_mesh
from repro.serve import PredictEngine

x, y, queries = t._problem()
model = SGPR(x, y, num_inducing=11, seed=0)
model.fit(max_iters=5)
state = model.predictive_state()
out = {{"hyp/" + k: np.asarray(v) for k, v in state.hyp.items()}}
out.update({{"state/" + f: np.asarray(getattr(state, f)) for f in t.FIELDS}})
mesh = make_compat_mesh((t.W,), ("data",))
model.fit(max_iters=3)
state2 = model.predictive_state()   # the front-end's hot swap
out.update({{"hyp2/" + k: np.asarray(v) for k, v in state2.hyp.items()}})
out.update({{"state2/" + f: np.asarray(getattr(state2, f)) for f in t.FIELDS}})
rows = jnp.asarray(np.concatenate(t._fe_requests()))
for g, st in enumerate((state, state2)):
    eng = PredictEngine(st, block_size=t.FE_BLOCK, mesh=mesh,
                        data_axes=("data",))
    mean, var = eng.predict(rows)
    out[f"fe_mean/{{g}}"], out[f"fe_var/{{g}}"] = np.asarray(mean), np.asarray(var)
for b in t.BLOCKS:
    eng = PredictEngine(state, block_size=b, mesh=mesh, data_axes=("data",))
    for n, xq in queries.items():
        mean, var = eng.predict(jnp.asarray(xq), include_noise=True)
        out[f"mean/{{b}}/{{n}}"] = np.asarray(mean)
        out[f"var/{{b}}/{{n}}"] = np.asarray(var)
np.savez({out!r}, **out)
print("JAX-REF-OK")
"""


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    out = tmp_path_factory.mktemp("jax_ref") / "ref.npz"
    env = {**os.environ, "XLA_FLAGS": "--xla_force_host_platform_device_count=4",
           "PYTHONPATH": os.pathsep.join([str(ROOT / "src"),
                                          os.environ.get("PYTHONPATH", "")])}
    code = _JAX_WORKER.format(tests=str(ROOT / "tests"), out=str(out))
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0 and "JAX-REF-OK" in res.stdout, \
        res.stdout + res.stderr
    return dict(np.load(out))


def _state(ref, tag=""):
    """The reference's state (``tag`` "2": the refitted one) on the CPU."""
    from repro_torch import convert

    hyp = f"hyp{tag}/"
    leaves = {"hyp": {k[len(hyp):]: v for k, v in ref.items()
                      if k.startswith(hyp)},
              **{f: ref[f"state{tag}/{f}"] for f in FIELDS}}
    return convert.state_from_numpy(leaves, "cpu")


def _frontend_rank(rank, group, ref, out):
    """Rank 0: a ``Frontend`` over the sharded engine, 40 requests, a swap
    midway, ``close()``; then one over a sharded fleet of the two states,
    20 requests, a ``swap_slot`` midway; the other ranks: ``serve_follower``
    for each.  Every tensor handed to ``dist.broadcast`` is recorded: NCCL
    takes contiguous ones only, and the swapped state holds a column-major
    factor, as a Cholesky on the card returns it."""
    import asyncio
    import dataclasses

    from repro_torch.serve import (Frontend, MultiPredictEngine,
                                   PredictEngine, serve_follower)

    eng = PredictEngine(_state(ref), block_size=FE_BLOCK, device="cpu",
                        group=group)
    fleet = MultiPredictEngine([_state(ref), _state(ref, "2")],
                               block_size=FE_BLOCK, device="cpu", group=group)
    real = dist.broadcast
    contiguous = []

    def recorded(t, *args, **kwargs):
        contiguous.append(t.is_contiguous())
        return real(t, *args, **kwargs)
    dist.broadcast = recorded
    if rank:
        out["fe_served"] = np.asarray(serve_follower(eng))
        out["fleet_served"] = np.asarray(serve_follower(fleet))
        out["fe_contiguous"] = np.asarray(contiguous)
        return
    xs = _fe_requests()
    swap = _state(ref, "2")
    swap = dataclasses.replace(swap, chol_kmm=swap.chol_kmm.T.contiguous().T)
    assert not swap.chol_kmm.is_contiguous()

    async def main():
        async with Frontend(eng, max_wait_ms=5.0, max_batch_rows=64) as fe:
            fe.warmup()
            first = await asyncio.gather(*[fe.submit(x)
                                           for x in xs[:FE_SWAP_AT]])
            fe.swap_state(swap)
            rest = await asyncio.gather(*[fe.submit(x)
                                          for x in xs[FE_SWAP_AT:]])
            res = first + rest
        fe.close()
        fe.close()   # idempotent
        return res

    async def fleet_main():
        async with Frontend(fleet, max_wait_ms=5.0, max_batch_rows=64) as fe:
            first = await asyncio.gather(*[fe.submit(x)
                                           for x in xs[:FLEET_SWAP_AT]])
            fe.swap_state(swap, slot=0)
            rest = await asyncio.gather(*[
                fe.submit(x) for x in xs[FLEET_SWAP_AT:FLEET_REQUESTS]])
        fe.close()
        return first + rest

    res = asyncio.run(main())
    out["fe_mean"] = np.concatenate([r.mean for r in res])
    out["fe_var"] = np.concatenate([r.var for r in res])
    out["fe_generation"] = np.asarray([r.generation for r in res])
    res = asyncio.run(fleet_main())
    out["fleet_mean"] = np.concatenate([r.mean for r in res], 1)
    out["fleet_var"] = np.concatenate([r.var for r in res], 1)
    out["fleet_generation"] = np.asarray([r.generation for r in res])
    out["fe_contiguous"] = np.asarray(contiguous)


# -- the port, 4 gloo ranks ------------------------------------------------------

def _rank_main(rank, world, store_path, out_dir):
    torch.set_num_threads(1)   # ranks share the cores: no oversubscription
    from repro_torch.core.distributed import DistributedGP
    from repro_torch.launch import make_data_group
    from repro_torch.serve import PredictEngine, posterior

    group = make_data_group("cpu", store=dist.FileStore(store_path, world),
                            rank=rank, world_size=world, timeout=GROUP_TIMEOUT)
    state = _state(dict(np.load(pathlib.Path(out_dir) / "ref.npz")))
    _, _, queries = _problem()
    rows = []   # rows each call of the plain predict computed on this rank
    plain = posterior.predict_mean_var

    def counted(st, x):
        rows.append(x.shape[0])
        return plain(st, x)
    posterior.predict_mean_var = counted

    out = {}
    for b in BLOCKS:
        eng = PredictEngine(state, block_size=b, device="cpu", group=group)
        for n, xq in queries.items():
            rows.clear()
            mean, var = eng.predict(xq, include_noise=True)
            out[f"mean/{b}/{n}"], out[f"var/{b}/{n}"] = mean.numpy(), var.numpy()
            out[f"rows/{b}/{n}"] = np.asarray(sum(rows))
    # DistributedGP.predict_engine, predict_np, predict_stream, run_blocks
    eng = DistributedGP(group, device="cpu").predict_engine(state,
                                                            block_size=64)
    xq = torch.from_numpy(queries[1000])
    keep = xq.clone()
    eng_d = DistributedGP(group, device="cpu").predict_engine(
        state, block_size=64, donate=True)
    out["donated_mean"] = eng_d.predict(xq)[0].numpy()
    out["donate_kept_queries"] = np.asarray(torch.equal(xq, keep))
    out["dgp_mean"], out["dgp_var"] = eng.predict_np(queries[257],
                                                     include_noise=True)
    streamed = list(eng.predict_stream(iter([queries[257], queries[1],
                                             queries[0]]),
                                       include_noise=True))
    out["stream_mean"] = torch.cat([m for m, _ in streamed]).numpy()
    padded, t = eng.pad_queries(queries[257])
    out["padded_rows"] = np.asarray([padded.shape[0], t])
    out["run_blocks_rows"] = np.asarray(eng.run_blocks(padded)[0].shape[0])
    # sample: each rank draws its own contiguous blocks, one all_gather
    sampled = []   # rows each sample_block call drew on this rank
    plain_block = posterior.sample_block

    def counted_block(st, x, *args, **kwargs):
        sampled.append(x.shape[0])
        return plain_block(st, x, *args, **kwargs)
    posterior.sample_block = counted_block
    out["sample"] = eng.sample(queries[257], 5, 3).numpy()
    out["sample_rows"] = np.asarray(sum(sampled))
    out["sample_stream"] = torch.cat(list(eng.sample_stream(
        iter([queries[1000][:256], queries[1000][256:512]]), 5, 3)), 1).numpy()
    _frontend_rank(rank, group, dict(np.load(pathlib.Path(out_dir)
                                             / "ref.npz")), out)
    np.savez(pathlib.Path(out_dir) / f"rank{rank}.npz", **out)
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def ranks(jax_ref, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ranks")
    np.savez(tmp / "ref.npz", **jax_ref)
    codes, _ = spawn_ranks(_rank_main, W, tmp)
    assert codes == [0] * W, f"rank exit codes {codes}"
    return [dict(np.load(tmp / f"rank{r}.npz")) for r in range(W)]


@pytest.mark.parametrize("t", TS)
@pytest.mark.parametrize("block", BLOCKS)
def test_sharded_engine_matches_jax_mesh_engine(ranks, jax_ref, block, t):
    want_m, want_v = jax_ref[f"mean/{block}/{t}"], jax_ref[f"var/{block}/{t}"]
    for r in ranks:
        got_m, got_v = r[f"mean/{block}/{t}"], r[f"var/{block}/{t}"]
        assert got_m.shape == want_m.shape == (t, 3)
        assert got_v.shape == want_v.shape == (t,)
        np.testing.assert_allclose(got_m, want_m, rtol=1e-9, atol=1e-11)
        np.testing.assert_allclose(got_v, want_v, rtol=1e-8, atol=1e-10)


@pytest.mark.parametrize("t", TS)
@pytest.mark.parametrize("block", BLOCKS)
def test_every_rank_returns_the_same_bits_computing_its_own_rows(ranks,
                                                                 block, t):
    for r in ranks[1:]:
        for k in ("mean", "var"):
            np.testing.assert_array_equal(r[f"{k}/{block}/{t}"],
                                          ranks[0][f"{k}/{block}/{t}"])
    mult = W * block
    padded = -(-t // mult) * mult
    for r in ranks:   # each rank computed a quarter of the padded rows
        assert int(r[f"rows/{block}/{t}"]) == padded // W


def test_sharded_sample_is_the_world_of_ones_bits(ranks, jax_ref):
    """``PredictEngine.sample`` under the group: every rank returns all 257
    rows, bitwise a world of one's draws (block i's normals depend on the
    key and i alone), each rank drawing only its own 2 of the 8 padded
    blocks of 64; ``sample_stream`` over whole blocks is the one-shot."""
    from repro_torch.serve import PredictEngine

    state = _state(jax_ref)
    _, _, queries = _problem()
    one = PredictEngine(state, block_size=64, device="cpu")
    want = one.sample(queries[257], 5, 3).numpy()
    stream = one.sample(queries[1000][:512], 5, 3).numpy()
    for r in ranks:
        assert r["sample"].shape == (5, 257, 3)
        np.testing.assert_array_equal(r["sample"], want)
        np.testing.assert_array_equal(r["sample_stream"], stream)
        assert int(r["sample_rows"]) == 2 * 64


def test_frontend_over_four_ranks_answers_as_a_world_of_one(ranks, jax_ref):
    """Rank 0's front-end over the sharded engine: every response bitwise
    a world of one's answer under its generation's state (the front-end's
    contract, ``tests/test_torch_frontend.py``), both generations served,
    within the file's tolerances of JAX's mesh engine; the followers served
    the same flushes (the warmup's 2 shapes included) and exited 0."""
    from repro_torch.serve import PredictEngine

    xs = _fe_requests()
    gens = ranks[0]["fe_generation"]
    assert gens.tolist() == [0] * FE_SWAP_AT + [1] * (FE_REQUESTS
                                                      - FE_SWAP_AT)
    one = [PredictEngine(_state(jax_ref, tag), block_size=FE_BLOCK,
                         device="cpu") for tag in ("", "2")]
    lo = 0
    for x, g in zip(xs, gens):
        hi = lo + x.shape[0]
        m, v = one[g].predict(x)
        np.testing.assert_array_equal(ranks[0]["fe_mean"][lo:hi], m.numpy())
        np.testing.assert_array_equal(ranks[0]["fe_var"][lo:hi], v.numpy())
        np.testing.assert_allclose(ranks[0]["fe_mean"][lo:hi],
                                   jax_ref[f"fe_mean/{g}"][lo:hi], rtol=1e-9,
                                   atol=1e-11)
        np.testing.assert_allclose(ranks[0]["fe_var"][lo:hi],
                                   jax_ref[f"fe_var/{g}"][lo:hi], rtol=1e-8,
                                   atol=1e-10)
        lo = hi
    served = {int(r["fe_served"]) for r in ranks[1:]}
    assert len(served) == 1 and served.pop() >= 2 + 2
    for r in ranks:   # NCCL's condition, held over gloo
        assert r["fe_contiguous"].size > 0 and r["fe_contiguous"].all()


def test_fleet_frontend_over_four_ranks_answers_as_a_world_of_one(ranks,
                                                                 jax_ref):
    """The same over a sharded ``MultiPredictEngine`` of the two states:
    a ``swap_slot`` midway sends the followers the whole stacked state;
    every response bitwise a world of one's fleet under its generation."""
    from repro_torch.serve import MultiPredictEngine

    xs = _fe_requests()[:FLEET_REQUESTS]
    gens = ranks[0]["fleet_generation"]
    assert gens.tolist() == [0] * FLEET_SWAP_AT + [1] * (FLEET_REQUESTS
                                                         - FLEET_SWAP_AT)
    a, b = _state(jax_ref), _state(jax_ref, "2")
    one = [MultiPredictEngine(states, block_size=FE_BLOCK, device="cpu")
           for states in ([a, b], [b, b])]
    lo = 0
    for x, g in zip(xs, gens):
        hi = lo + x.shape[0]
        m, v = one[g].predict(x)
        np.testing.assert_array_equal(ranks[0]["fleet_mean"][:, lo:hi],
                                      m.numpy())
        np.testing.assert_array_equal(ranks[0]["fleet_var"][:, lo:hi],
                                      v.numpy())
        lo = hi
    served = {int(r["fleet_served"]) for r in ranks[1:]}
    assert len(served) == 1 and served.pop() >= 2   # a flush a half at least


def test_predict_engine_and_its_entry_points_on_four_ranks(ranks, jax_ref):
    from repro_torch.serve import PredictEngine

    state = _state(jax_ref)
    _, _, queries = _problem()
    one = PredictEngine(state, block_size=64, device="cpu")
    m257, v257 = one.predict(queries[257], include_noise=True)
    m1000, _ = one.predict(queries[1000])
    for r in ranks:
        # a world of one's blocks are the same rows: the same bits
        np.testing.assert_array_equal(r["dgp_mean"], m257.numpy())
        np.testing.assert_array_equal(r["dgp_var"], v257.numpy())
        np.testing.assert_array_equal(r["donated_mean"], m1000.numpy())
        assert bool(r["donate_kept_queries"])
        np.testing.assert_array_equal(
            r["stream_mean"],
            np.concatenate([m257.numpy(), one.predict(queries[1])[0].numpy()]))
        assert r["padded_rows"].tolist() == [512, 257]   # 4 x 64 x 2
        assert int(r["run_blocks_rows"]) == 512


@pytest.fixture
def world_of_one():
    from repro_torch.launch import make_data_group

    assert not dist.is_initialized()
    group = make_data_group("cpu", timeout=GROUP_TIMEOUT)
    try:
        yield group
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("block", BLOCKS)
def test_distributed_predict_engine_in_a_world_of_one(world_of_one, jax_ref,
                                                      block):
    from repro_torch.core.distributed import DistributedGP
    from repro_torch.serve import PredictEngine

    state = _state(jax_ref)
    _, _, queries = _problem()
    eng = DistributedGP(world_of_one, device="cpu").predict_engine(
        state, block_size=block)
    assert eng.group is world_of_one and eng.n_shards == 1
    plain = PredictEngine(state, block_size=block, device="cpu")
    for xq in queries.values():
        for got, want in zip(eng.predict(xq, include_noise=True),
                             plain.predict(xq, include_noise=True)):
            assert torch.equal(got, want)


def test_donate_never_consumes_the_callers_buffer():
    from repro_torch.serve import PredictEngine

    rng = np.random.default_rng(0)
    x, y, _ = _problem()
    import repro_torch as rt

    state = rt.SGPR(x, y, num_inducing=7, device="cpu").predictive_state()
    for t in (64, 100):   # already padded, and padded by the engine
        xq = torch.from_numpy(rng.standard_normal((t, 2)))
        keep = xq.clone()
        eng = PredictEngine(state, block_size=64, device="cpu", donate=True)
        mean, _ = eng.predict(xq)
        assert eng.donate and torch.equal(xq, keep)
        assert torch.equal(mean, PredictEngine(state, block_size=64,
                                               device="cpu").predict(xq)[0])


# -- checkpoint rotation against the reference -------------------------------

def _tree(seed):
    rng = np.random.default_rng(seed)
    return {"w": rng.standard_normal((5, 3)), "b": {"x": rng.standard_normal(4),
                                                    "s": np.float64(seed)}}


def _torch_tree(tree):
    return {"w": torch.from_numpy(tree["w"]),
            "b": {k: torch.as_tensor(v) for k, v in tree["b"].items()}}


@pytest.mark.parametrize("keep", [1, 2, 3])
def test_jax_rotated_directory_reads_in_the_port(tmp_path, keep):
    from repro.checkpoint import checkpoint as jck
    from repro_torch.checkpoint import checkpoint as tck

    for step in (1, 2, 10, 3):
        jck.save(tmp_path / f"state_step{step}", _tree(step),
                 metadata={"step": step}, keep=keep)
    jck.save(tmp_path / "other", _tree(0))   # no step: never rotated
    want = sorted(p.name for p in tmp_path.glob("*.npz"))
    assert tck.latest(tmp_path, base="state") == jck.latest(tmp_path,
                                                            base="state")
    assert tck.latest(tmp_path, base="state").name == "state_step10"
    assert tck.latest(tmp_path) is None and jck.latest(tmp_path) is None
    like = {"w": torch.empty((5, 3), dtype=torch.float64, device="meta"),
            "b": {"x": torch.empty(4, dtype=torch.float64, device="meta"),
                  "s": torch.empty((), dtype=torch.float64, device="meta")}}
    tree, md = tck.restore(tck.latest(tmp_path, base="state"), like, "cpu")
    assert md == {"step": 10}
    ref = _tree(10)
    np.testing.assert_array_equal(tree["w"].numpy(), ref["w"])
    np.testing.assert_array_equal(tree["b"]["x"].numpy(), ref["b"]["x"])
    # the port's rotation over the same files keeps the same set
    tck.save(tmp_path / "state_step0", _torch_tree(_tree(0)), keep=keep)
    assert sorted(p.name for p in tmp_path.glob("*.npz")) == want


def test_port_async_checkpointer_reads_in_jax(tmp_path):
    from repro.checkpoint import checkpoint as jck
    from repro_torch.checkpoint import AsyncCheckpointer, latest

    ck = AsyncCheckpointer()
    live = _torch_tree(_tree(0))
    for step in range(1, 6):
        live["w"].copy_(torch.from_numpy(_tree(step)["w"]))
        live["b"]["x"].copy_(torch.from_numpy(_tree(step)["b"]["x"]))
        ck.save(tmp_path / f"ckpt_step{step}", live, metadata={"step": step},
                keep=2)
        live["w"].fill_(np.nan)   # save copied already: the file is unharmed
    ck.wait()
    assert sorted(p.name for p in tmp_path.glob("*.npz")) == [
        "ckpt_step4.npz", "ckpt_step5.npz"]
    assert latest(tmp_path) == jck.latest(tmp_path) == tmp_path / "ckpt_step5"
    like = jax.tree.map(np.asarray, _tree(0))
    tree, md = jck.restore(latest(tmp_path), like)
    assert md == {"step": 5}
    ref = _tree(5)
    np.testing.assert_array_equal(np.asarray(tree["w"]), ref["w"])
    np.testing.assert_array_equal(np.asarray(tree["b"]["x"]), ref["b"]["x"])


def test_async_checkpointer_raises_a_failed_write_on_wait(tmp_path):
    from repro_torch.checkpoint import AsyncCheckpointer

    (tmp_path / "file").write_text("")
    ck = AsyncCheckpointer()
    ck.save(tmp_path / "file" / "ckpt_step1", _torch_tree(_tree(1)))
    with pytest.raises(OSError):
        ck.wait()
    ck.wait()   # the error is raised once


def test_model_serve_engine_takes_group_and_donate(world_of_one, jax_ref):
    """``SGPR.serve_engine`` / ``BayesianGPLVM.serve_engine`` with the JAX
    signature's ``group`` (the mesh) and ``donate``: the same answers as
    the default engine."""
    import repro_torch as rt

    x, y, queries = _problem()
    for model in (rt.SGPR(x, y, num_inducing=7, device="cpu"),
                  rt.BayesianGPLVM(y, q=2, num_inducing=6, device="cpu")):
        eng = model.serve_engine(block_size=64, group=world_of_one,
                                 donate=True)
        assert eng.group is world_of_one and eng.donate
        for got, want in zip(eng.predict(queries[257]), model.serve_engine(
                block_size=64).predict(queries[257])):
            assert torch.equal(got, want)
