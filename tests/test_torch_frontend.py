"""The port's async micro-batching front-end (``serve.Frontend``) against
the JAX package.

Predictions are row-local, so every response the front-end scatters out of
a coalesced batch must be BITWISE what a direct ``PredictEngine.predict``
of the port returns for that request, whatever the batch, the padding or a
hot swap racing the flush (the response then matches the state of the
generation it carries).  The SLO counters that do not depend on timing
(``submitted``, ``rejected_queue_full``, ``expired``, ``cancelled``,
``completed``) must equal the JAX front-end's on the same scenario, run
once for the module.  The cases of ``tests/test_frontend.py`` then run on
the port.  The event loop is driven by ``asyncio.run``; waits stay at or
under 50 ms, deadlines coarse enough for a loaded machine.
"""
import asyncio
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch as rt
from repro.core.stats import partial_stats as j_partial_stats
from repro.serve import Frontend as JFrontend
from repro.serve import PredictEngine as JEngine
from repro.serve import QueueFull as JQueueFull
from repro.serve import extract_state as j_extract
from repro_torch import convert
from repro_torch.core.stats import partial_stats
from repro_torch.serve import (Frontend, FrontendError, MultiPredictEngine,
                               PredictEngine, QueueFull, SLOExceeded,
                               save_state, stack_states)
from repro_torch.serve.posterior import _ARRAY_FIELDS

CPU = "cpu"
TIMELESS = ("submitted", "rejected_queue_full", "expired", "cancelled",
            "completed")


def _inputs(rng, n=80, m=11, q=2, d=3, shift=0.0):
    hyp = {"log_sf2": np.float64(rng.uniform(-0.5, 0.8) + shift),
           "log_ell": rng.uniform(-0.4, 0.4, q),
           "log_beta": np.float64(1.2)}
    return (hyp, rng.standard_normal((n, q)), rng.standard_normal((n, d)),
            rng.standard_normal((m, q)))


def _state(rng, **kw):
    hyp, x, y, z = _inputs(rng, **kw)
    th = {k: torch.as_tensor(v) for k, v in hyp.items()}
    z = torch.from_numpy(z)
    return rt.extract_state(th, z, partial_stats(th, z, torch.from_numpy(y),
                                                 torch.from_numpy(x)),
                            device=CPU)


def _engine(rng, block=8, **kw):
    return PredictEngine(_state(rng, **kw), block_size=block, device=CPU)


def _direct(eng, x, noise=False):
    return tuple(a.numpy() for a in eng.predict(x, include_noise=noise))


# -- the same scenario in both packages ---------------------------------------------

async def _scenario(frontend_cls, queue_full_cls, eng, xs):
    """Four requests answered, one past its deadline, one cancelled while
    queued and one refused at admission, in one front-end."""
    async with frontend_cls(eng, max_wait_ms=20.0, max_batch_rows=64,
                            max_queue_rows=40) as fe:
        fe.warmup()
        answered = [asyncio.ensure_future(fe.submit(x)) for x in xs[:4]]
        late = asyncio.ensure_future(fe.submit(xs[4], deadline_ms=-1.0))
        doomed = asyncio.ensure_future(fe.submit(xs[5]))
        await asyncio.sleep(0)                       # all six queue
        doomed.cancel()
        try:
            await fe.submit(np.zeros((30, 2)))       # 18 + 30 rows > 40
        except queue_full_cls:
            pass
        out = await asyncio.gather(*answered, late, return_exceptions=True)
        return out, fe.metrics.summary()["counters"]


@pytest.fixture(scope="module")
def ref():
    """The JAX front-end's counters on the scenario, and its state's
    leaves for the port."""
    rng = np.random.default_rng(0)
    hyp, x, y, z = _inputs(rng)
    jh = {k: jnp.asarray(v) for k, v in hyp.items()}
    js = j_extract(jh, jnp.asarray(z), j_partial_stats(
        jh, jnp.asarray(z), jnp.asarray(y), jnp.asarray(x), s=None,
        latent=False))
    xs = [rng.standard_normal((3, 2)) for _ in range(6)]
    _, counters = asyncio.run(_scenario(JFrontend, JQueueFull,
                                        JEngine(js, block_size=8), xs))
    leaves = {"hyp": {k: np.array(v) for k, v in js.hyp.items()},
              **{f: np.array(getattr(js, f)) for f in _ARRAY_FIELDS}}
    return {"counters": counters, "leaves": leaves, "xs": xs}


def test_timeless_counters_equal_jaxs_on_the_same_scenario(ref):
    eng = PredictEngine(convert.state_from_numpy(ref["leaves"], CPU),
                        block_size=8, device=CPU)
    out, counters = asyncio.run(_scenario(Frontend, QueueFull, eng,
                                          ref["xs"]))
    assert {k: counters[k] for k in TIMELESS} == \
        {k: ref["counters"][k] for k in TIMELESS}
    assert counters["expired"] == counters["cancelled"] == 1
    assert counters["completed"] == 4 and counters["rejected_queue_full"] == 1
    assert isinstance(out[4], SLOExceeded)
    for x, res in zip(ref["xs"], out[:4]):
        m_ref, v_ref = _direct(eng, x)
        np.testing.assert_array_equal(res.mean, m_ref)
        np.testing.assert_array_equal(res.var, v_ref)


def test_a_sharded_engine_is_refused_naming_its_roadmap_item(rng):
    """A sharded engine, once refused naming ROADMAP Queue 1 item 15, is
    served now: its front-end runs on rank 0 (another rank is told to run
    ``serve_follower``, which refuses rank 0 and a world of one), and a
    world of one is served as without a group, ``close()`` a no-op.  The
    4-rank front-end rides in ``tests/test_torch_serving_shard.py``."""
    import torch.distributed as dist

    from repro_torch.launch import make_data_group
    from repro_torch.serve import serve_follower

    with pytest.raises(ValueError, match="serve_follower"):
        Frontend(types.SimpleNamespace(n_shards=4, rank=1))
    for shards, rank in ((4, 0), (1, 0)):
        with pytest.raises(ValueError, match="ranks > 0"):
            serve_follower(types.SimpleNamespace(n_shards=shards, rank=rank))
    state = _state(rng)
    group = make_data_group(CPU)
    try:
        eng = rt.DistributedGP(group, device=CPU).predict_engine(
            state, block_size=8)
        x = rng.standard_normal((5, 2))

        async def main():
            async with Frontend(eng) as fe:
                return await fe.submit(x)

        res = asyncio.run(main())
        np.testing.assert_array_equal(res.mean, _direct(eng, x)[0])
        fe = Frontend(eng)
        fe.close()
        fe.close()
        with pytest.raises(FrontendError, match="closed"):
            fe.start()
    finally:
        dist.destroy_process_group()


# -- the reference's cases, on the port ----------------------------------------------

def test_frontend_bitwise_parity_concurrent(rng):
    """Mixed-size concurrent requests coalesce, and every response is
    bitwise the direct engine answer for its rows (noise included)."""
    eng = _engine(rng)
    xs = [rng.standard_normal((t, 2)) for t in (1, 3, 8, 5, 2, 13, 7)]

    async def main():
        async with Frontend(eng, max_wait_ms=30.0, max_batch_rows=64) as fe:
            fe.warmup()
            return await asyncio.gather(*[
                fe.submit(x, include_noise=(i % 2 == 0))
                for i, x in enumerate(xs)])

    for i, (x, res) in enumerate(zip(xs, asyncio.run(main()))):
        m_ref, v_ref = _direct(eng, x, noise=(i % 2 == 0))
        assert res.generation == 0 and res.mean.shape == (x.shape[0], 3)
        np.testing.assert_array_equal(res.mean, m_ref)
        np.testing.assert_array_equal(res.var, v_ref)


def test_frontend_coalesces_and_accounts(rng):
    """Concurrent submits land in fewer flushes than requests, and the
    row and pad accounting adds up exactly."""
    eng = _engine(rng)
    xs = [rng.standard_normal((3, 2)) for _ in range(12)]

    async def main():
        async with Frontend(eng, max_wait_ms=50.0, max_batch_rows=64) as fe:
            fe.warmup()
            await asyncio.gather(*[fe.submit(x) for x in xs])
            return fe.metrics.summary()

    summ = asyncio.run(main())
    c = summ["counters"]
    assert c["flushes"] < len(xs)
    assert summ["mean_batch_requests"] > 1.0
    assert c["flushed_requests"] == len(xs)
    assert c["flushed_rows"] == 3 * len(xs)
    assert (c["flushed_rows"] + c["padded_rows"]) % 8 == 0
    assert c["completed"] == len(xs) and c["expired"] == 0


def test_frontend_deadline_expires_as_slo_exceeded(rng):
    """A deadline shorter than the batching wait fails fast and typed, and
    is counted as expired."""
    eng = _engine(rng)

    async def main():
        async with Frontend(eng, max_wait_ms=50.0, max_batch_rows=800) as fe:
            fe.warmup()
            with pytest.raises(SLOExceeded, match="deadline expired"):
                await fe.submit(rng.standard_normal((4, 2)), deadline_ms=1.0)
            return fe.metrics.summary()["counters"]

    c = asyncio.run(main())
    assert c["expired"] == 1 and c["completed"] == 0


def test_frontend_queue_full_backpressure(rng):
    """Rows beyond max_queue_rows are rejected with QueueFull at submit
    time and never enqueued."""
    eng = _engine(rng)

    async def main():
        async with Frontend(eng, max_wait_ms=50.0, max_batch_rows=800,
                            max_queue_rows=16) as fe:
            fe.warmup()
            t1 = asyncio.ensure_future(fe.submit(rng.standard_normal((8, 2))))
            t2 = asyncio.ensure_future(fe.submit(rng.standard_normal((8, 2))))
            await asyncio.sleep(0)
            assert fe.queued_rows == 16
            with pytest.raises(QueueFull, match="16 of 16"):
                await fe.submit(rng.standard_normal((1, 2)))
            counters = fe.metrics.summary()["counters"]
            return (counters, *await asyncio.gather(t1, t2))

    counters, r1, r2 = asyncio.run(main())
    assert counters["rejected_queue_full"] == 1
    assert r1.mean.shape == (8, 3) and r2.mean.shape == (8, 3)


def test_frontend_empty_request_inline(rng):
    """A zero-row request is answered inline with empty arrays of the
    right shape (no queue, no engine)."""
    eng = _engine(rng)

    async def main():
        async with Frontend(eng) as fe:
            return (await fe.submit(np.zeros((0, 2))),
                    fe.metrics.summary()["counters"])

    res, c = asyncio.run(main())
    assert res.mean.shape == (0, 3) and res.var.shape == (0,)
    assert res.generation == 0
    assert c["flushes"] == 0 and c["submitted"] == 0


def test_frontend_hot_swap_mid_load_bitwise(rng):
    """``swap_state`` mid-load: no response dropped, each bitwise against
    the state of the generation it carries."""
    state_a, state_b = _state(rng), _state(rng, shift=0.3)
    eng = PredictEngine(state_a, block_size=8, device=CPU)
    states = {0: state_a}
    xs = [rng.standard_normal((3, 2)) for _ in range(40)]

    async def main():
        async with Frontend(eng, max_wait_ms=1.0, max_batch_rows=16) as fe:
            fe.warmup()

            async def load():
                return [await fe.submit(x) for x in xs]

            async def swapper():
                flip = [state_b, state_a]
                for k in range(4):
                    await asyncio.sleep(0.01)
                    states[fe.swap_state(flip[k % 2])] = flip[k % 2]

            results, _ = await asyncio.gather(load(), swapper())
            return results

    results = asyncio.run(main())
    assert len(results) == len(xs)
    refs = {g: PredictEngine(s, block_size=8, device=CPU)
            for g, s in states.items()}
    for x, res in zip(xs, results):
        m_ref, v_ref = _direct(refs[res.generation], x)
        np.testing.assert_array_equal(res.mean, m_ref)
        np.testing.assert_array_equal(res.var, v_ref)
    assert len({r.generation for r in results}) > 1


def test_frontend_swap_from_checkpoint_path(rng, tmp_path):
    """``swap_state`` takes a checkpoint path, restored from its sidecar
    onto the engine's device with no model code."""
    state_a, state_b = _state(rng), _state(rng, shift=0.5)
    path = save_state(tmp_path / "swap_in", state_b)
    eng = PredictEngine(state_a, block_size=8, device=CPU)
    x = rng.standard_normal((5, 2))

    async def main():
        async with Frontend(eng) as fe:
            before = await fe.submit(x)
            gen = fe.swap_state(path)
            return before, gen, await fe.submit(x)

    before, gen, after = asyncio.run(main())
    assert (before.generation, after.generation) == (0, 1) and gen == 1
    np.testing.assert_array_equal(before.mean, _direct(
        PredictEngine(state_a, 8, device=CPU), x)[0])
    np.testing.assert_array_equal(after.mean, _direct(
        PredictEngine(state_b, 8, device=CPU), x)[0])
    assert not np.array_equal(before.mean, after.mean)


def test_frontend_stop_drains_and_restarts(rng):
    """``stop`` answers everything accepted, refuses new submits, and
    ``start`` brings the loop back."""
    eng = _engine(rng)

    async def main():
        fe = Frontend(eng, max_wait_ms=50.0, max_batch_rows=800).start()
        fe.warmup()
        tasks = [asyncio.ensure_future(fe.submit(rng.standard_normal((2, 2))))
                 for _ in range(5)]
        await asyncio.sleep(0)
        await fe.stop()
        results = await asyncio.gather(*tasks)
        with pytest.raises(FrontendError, match="not running"):
            await fe.submit(rng.standard_normal((2, 2)))
        fe.start()
        again = await fe.submit(rng.standard_normal((2, 2)))
        await fe.stop()
        return results, again

    results, again = asyncio.run(main())
    assert all(r.mean.shape == (2, 3) for r in results)
    assert again.mean.shape == (2, 3)


def test_frontend_steptimer_wiring(rng):
    """Each flush's engine time feeds the StepTimer: one record a flush,
    ``load_summary`` in the training loop's shape."""
    eng = _engine(rng)

    async def main():
        async with Frontend(eng, max_wait_ms=20.0) as fe:
            fe.warmup()
            for _ in range(3):
                await fe.submit(rng.standard_normal((4, 2)))
            return fe.metrics.summary()["counters"], fe.load_summary()

    counters, load = asyncio.run(main())
    assert set(load) >= {"min", "mean", "max", "straggler_overhead"}
    assert 0.0 < load["min"] <= load["mean"] <= load["max"]
    assert counters["flushes"] == 3


def test_frontend_multi_engine_and_slot_swap(rng):
    """Over a ``MultiPredictEngine``: (N, t, d) responses bitwise, and
    ``swap_state(state, slot=k)`` replaces one model."""
    fleet = [_state(rng, shift=0.1 * k) for k in range(3)]
    newcomer = _state(rng, shift=0.9)
    eng = MultiPredictEngine(stack_states(fleet), block_size=8, device=CPU)
    x = rng.standard_normal((6, 2))

    async def main():
        async with Frontend(eng) as fe:
            before = await fe.submit(x, include_noise=True)
            gen = fe.swap_state(newcomer, slot=1)
            return before, gen, await fe.submit(x, include_noise=True)

    before, gen, after = asyncio.run(main())
    assert before.mean.shape == (3, 6, 3) and before.var.shape == (3, 6)
    ref0 = MultiPredictEngine(fleet, block_size=8, device=CPU)
    ref1 = MultiPredictEngine([fleet[0], newcomer, fleet[2]], block_size=8,
                              device=CPU)
    for res, ref in ((before, ref0), (after, ref1)):
        m_ref, v_ref = _direct(ref, x, noise=True)
        np.testing.assert_array_equal(res.mean, m_ref)
        np.testing.assert_array_equal(res.var, v_ref)
    assert gen == 1 and after.generation == 1
    np.testing.assert_array_equal(before.mean[0], after.mean[0])
    assert not np.array_equal(before.mean[1], after.mean[1])


def test_frontend_validation(rng):
    eng = _engine(rng)
    with pytest.raises(ValueError, match="max_wait_ms"):
        Frontend(eng, max_wait_ms=-1.0)
    with pytest.raises(ValueError, match="max_queue_rows"):
        Frontend(eng, max_queue_rows=0)
    with pytest.raises(ValueError, match="max_batch_requests"):
        Frontend(eng, max_batch_requests=0)
    with pytest.raises(ValueError, match="max_batch_rows"):
        Frontend(eng, max_batch_rows=0)
    assert Frontend(eng, max_batch_rows=9).max_batch_rows == 16

    async def main():
        fe = Frontend(eng)
        with pytest.raises(FrontendError, match="not running"):
            await fe.submit(rng.standard_normal((2, 2)))
        fe.start()
        with pytest.raises(ValueError, match=r"\(t, 2\)"):
            await fe.submit(rng.standard_normal((2, 5)))
        with pytest.raises(ValueError, match="slot"):
            fe.swap_state(_state(rng), slot=0)
        await fe.stop()

    asyncio.run(main())


def test_frontend_warmup_covers_all_shapes(rng):
    """``warmup`` runs one batch per padded size the dispatch loop can
    produce (max_batch_rows / the padding multiple)."""
    assert Frontend(_engine(rng), max_batch_rows=32).warmup() == 4
