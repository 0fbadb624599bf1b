"""The port's fleet engine (``serve.stack_states``, ``mixture_moments``,
``MultiPredictEngine``, ``DistributedGP.multi_predict_engine``) against the
JAX package.

A fleet of three same-shape states (the reference tests' ``_fleet``) is
built once in JAX, its leaves carried into the port; the port's fleet
answers are held to JAX's ``MultiPredictEngine`` at the 1e-12 of
``tests/test_torch_serving.py``'s map statistics, padding and noise
included, and its stacked leaves and mixture moments to JAX's.  The cases
of ``tests/test_serving_multi.py`` then run on the port, where every
model's rows are bitwise its own ``PredictEngine``'s (the port answers
model by model; JAX ``vmap``s).  The port has no ``kernel_backend``: the
device picks the route, as in its ``PredictEngine``.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch as rt
from repro.core.stats import partial_stats as j_partial_stats
from repro.serve import MultiPredictEngine as JMulti
from repro.serve import extract_state as j_extract
from repro.serve import mixture_moments as j_mixture
from repro.serve import stack_states as j_stack
from repro_torch import convert
from repro_torch.core import covariance as cov
from repro_torch.core.stats import partial_stats
from repro_torch.serve import (MultiPredictEngine, PredictEngine,
                               mixture_moments, stack_states)
from repro_torch.serve.posterior import _ARRAY_FIELDS

CPU = "cpu"
TOL = dict(rtol=1e-12, atol=1e-12)
CASES = [(1, 8), (23, 4), (16, 16)]   # (t, block_size)


def _fleet_inputs(rng, n_models=3, n=70, m=9, q=2, d=2):
    """The reference's ``_fleet``: shared data, per-model hypers."""
    x, y, z = (rng.standard_normal(s) for s in ((n, q), (n, d), (m, q)))
    hyps = [{"log_sf2": np.float64(0.2 + 0.1 * k),
             "log_ell": rng.uniform(-0.3, 0.3, q),
             "log_beta": np.float64(1.0 + 0.2 * k)} for k in range(n_models)]
    return x, y, z, hyps


def _fleet(rng, **kw):
    """N port states sharing shapes but not hypers/posteriors."""
    x, y, z, hyps = _fleet_inputs(rng, **kw)
    x, y, z = (torch.from_numpy(a) for a in (x, y, z))
    out = []
    for hyp in hyps:
        th = {k: torch.as_tensor(v) for k, v in hyp.items()}
        out.append(rt.extract_state(th, z, partial_stats(th, z, y, x),
                                    device=CPU))
    return out


@pytest.fixture(scope="module")
def ref():
    """JAX's fleet (leaves of each state, the stacked state) and its
    ``MultiPredictEngine`` answers for every (t, block) case, noise-free
    and noisy, and its mixture moments."""
    rng = np.random.default_rng(0)
    x, y, z, hyps = _fleet_inputs(rng)
    states = []
    for hyp in hyps:
        jh = {k: jnp.asarray(v) for k, v in hyp.items()}
        states.append(j_extract(jh, jnp.asarray(z), j_partial_stats(
            jh, jnp.asarray(z), jnp.asarray(y), jnp.asarray(x), s=None,
            latent=False)))
    out = {"leaves": [_leaves(s) for s in states],
           "stacked": _leaves(j_stack(states))}
    for t, block in CASES:
        xs = rng.standard_normal((t, 2))
        out[f"x/{t}"] = xs
        eng = JMulti(states, block_size=block)
        for noise in (False, True):
            mean, var = eng.predict(jnp.asarray(xs), include_noise=noise)
            out[f"{t}/{block}/{noise}"] = (np.array(mean), np.array(var))
        mu, v = eng.predict_mixture(jnp.asarray(xs))
        out[f"mix/{t}/{block}"] = (np.array(mu), np.array(v))
    return out


def _leaves(state):
    return {"hyp": {k: np.array(v) for k, v in state.hyp.items()},
            **{f: np.array(getattr(state, f)) for f in _ARRAY_FIELDS}}


def _port_fleet(ref):
    return [convert.state_from_numpy(lv, CPU) for lv in ref["leaves"]]


# -- against the JAX package ------------------------------------------------------

def test_stacked_leaves_are_jaxs(ref):
    stacked = stack_states(_port_fleet(ref))
    want = ref["stacked"]
    for k, v in want["hyp"].items():
        np.testing.assert_array_equal(stacked.hyp[k].numpy(), v)
    for f in _ARRAY_FIELDS:
        np.testing.assert_array_equal(getattr(stacked, f).numpy(), want[f])


@pytest.mark.parametrize("t,block", CASES)
def test_fleet_answers_match_jax(ref, t, block):
    eng = MultiPredictEngine(_port_fleet(ref), block_size=block, device=CPU)
    xs = ref[f"x/{t}"]
    for noise in (False, True):
        mean, var = eng.predict(xs, include_noise=noise)
        want_m, want_v = ref[f"{t}/{block}/{noise}"]
        assert mean.shape == want_m.shape == (3, t, 2)
        assert var.shape == want_v.shape == (3, t)
        np.testing.assert_allclose(mean.numpy(), want_m, **TOL)
        np.testing.assert_allclose(var.numpy(), want_v, **TOL)
    mu, v = eng.predict_mixture(xs)
    for got, want in zip((mu, v), ref[f"mix/{t}/{block}"]):
        np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_mixture_moments_match_jax_on_the_same_inputs():
    rng = np.random.default_rng(4)
    mean = rng.standard_normal((4, 6, 3))
    var = rng.uniform(-0.1, 1.0, (4, 6))
    got = mixture_moments(torch.from_numpy(mean), torch.from_numpy(var))
    want = j_mixture(jnp.asarray(mean), jnp.asarray(var))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)


def test_distributed_multi_predict_engine_in_a_world_of_one(ref):
    """``DistributedGP.multi_predict_engine`` (the port's counterpart of
    the JAX mesh engine's): the group's engine, bitwise the engine alone."""
    import torch.distributed as dist

    from repro_torch.launch import make_data_group

    states = _port_fleet(ref)
    group = make_data_group(CPU)
    try:
        eng = rt.DistributedGP(group, device=CPU).multi_predict_engine(
            states, block_size=4)
        assert eng.group is group and eng.n_shards == 1
        alone = MultiPredictEngine(states, block_size=4, device=CPU)
        for got, want in zip(eng.predict(ref["x/23"], include_noise=True),
                             alone.predict(ref["x/23"], include_noise=True)):
            assert torch.equal(got, want)
    finally:
        dist.destroy_process_group()


def test_a_zoo_fleet_answers_as_its_single_engines(rng):
    """A Matern-3/2 fleet takes the plain route, model by model: each
    model's rows bitwise its own engine's."""
    m32 = cov.Matern32()
    x, y, z, hyps = _fleet_inputs(rng)
    x, y, z = (torch.from_numpy(a) for a in (x, y, z))
    fleet = []
    for hyp in hyps:
        th = {"log_beta": torch.as_tensor(hyp["log_beta"]),
              **{k: torch.as_tensor(v) for k, v in m32.default_hyp(2).items()}}
        th["log_sf2"] = torch.as_tensor(hyp["log_sf2"])
        fleet.append(rt.extract_state(th, z, partial_stats(th, z, y, x,
                                                           kernel=m32),
                                      kernel=m32, device=CPU))
    eng = MultiPredictEngine(fleet, block_size=4, device=CPU)
    xs = rng.standard_normal((9, 2))
    mean, var = eng.predict(xs)
    assert mean.shape == (3, 9, 2)
    for k, s in enumerate(fleet):
        m1, v1 = PredictEngine(s, block_size=4, device=CPU).predict(xs)
        assert torch.equal(mean[k], m1) and torch.equal(var[k], v1)


# -- the reference's cases, on the port ----------------------------------------------

def test_stack_states_shapes(rng):
    states = _fleet(rng)
    stacked = stack_states(states)
    assert stacked.z.shape == (3, 9, 2)
    assert stacked.g.shape == (3, 9, 9)
    assert stacked.hyp["log_beta"].shape == (3,)
    assert (stacked.m, stacked.q, stacked.d) == (9, 2, 2)
    for k, s in enumerate(states):
        assert torch.equal(stacked.a_mean[k], s.a_mean)


@pytest.mark.parametrize("t,block", CASES)
def test_multi_engine_rows_equal_single_engines(rng, t, block):
    """Stacked row k is model k's own engine's, bitwise, padding and noise
    included."""
    states = _fleet(rng)
    eng = MultiPredictEngine(states, block_size=block, device=CPU)
    xs = rng.standard_normal((t, 2))
    for noise in (False, True):
        mean, var = eng.predict(xs, include_noise=noise)
        assert mean.shape == (3, t, 2) and var.shape == (3, t)
        for k, s in enumerate(states):
            m1, v1 = PredictEngine(s, block_size=block, device=CPU).predict(
                xs, include_noise=noise)
            assert torch.equal(mean[k], m1) and torch.equal(var[k], v1)


def test_multi_engine_accepts_prestacked(rng):
    """A stacked state (e.g. another engine's .state) builds directly."""
    states = _fleet(rng)
    eng = MultiPredictEngine(stack_states(states), block_size=8, device=CPU)
    assert eng.n_models == 3
    xs = rng.standard_normal((5, 2))
    ref = MultiPredictEngine(states, block_size=8, device=CPU).predict(xs)
    for a, b in zip(ref, eng(xs)):
        assert torch.equal(a, b)


def test_mixture_moments_algebra(rng):
    """Equal-weight mixture: the mean of means; the mean variance plus the
    spread of the means."""
    eng = MultiPredictEngine(_fleet(rng), block_size=8, device=CPU)
    xs = rng.standard_normal((7, 2))
    mean, var = (a.numpy() for a in eng.predict(xs))
    mu, v = (a.numpy() for a in mixture_moments(*eng.predict(xs)))
    assert mu.shape == (7, 2) and v.shape == (7, 2)
    np.testing.assert_allclose(mu, mean.mean(0), rtol=1e-12)
    manual = np.maximum(var, 0.0).mean(0)[:, None] + mean.var(axis=0)
    np.testing.assert_allclose(v, manual, rtol=1e-12)
    mu2, v2 = eng.predict_mixture(xs)
    np.testing.assert_array_equal(mu, mu2.numpy())
    np.testing.assert_array_equal(v, v2.numpy())
    assert (v >= var.mean(0)[:, None] - 1e-12).all()


def test_multi_engine_quantized_fleet(rng):
    """A bf16-stacked fleet serves through f32 accumulation and stays near
    the f64 fleet."""
    states = _fleet(rng)
    xs = rng.standard_normal((9, 2))
    ref_mean, _ = MultiPredictEngine(states, block_size=8,
                                     device=CPU).predict(xs)
    eng = MultiPredictEngine(stack_states(states).astype(torch.bfloat16),
                             block_size=8, device=CPU)
    assert eng.compute_dtype == torch.float32
    mean, var = eng.predict(xs)
    assert mean.dtype == torch.float32
    assert float((mean.double() - ref_mean).abs().max()) < 0.5
    assert bool(torch.isfinite(var).all())


def test_multi_engine_rejects_bad_inputs(rng):
    states = _fleet(rng)
    with pytest.raises(ValueError, match="at least one"):
        stack_states([])
    other = _fleet(rng, n_models=1, m=7)[0]    # different m
    with pytest.raises(ValueError, match="share leaf shapes"):
        stack_states([states[0], other])
    with pytest.raises(ValueError, match="model axis"):
        MultiPredictEngine(states[0], device=CPU)   # unstacked single state
    with pytest.raises(ValueError, match="block_size"):
        MultiPredictEngine(states, block_size=0, device=CPU)


def test_stack_states_rejects_mismatched_trees(rng):
    """A mixed fleet fails with a typed message: a dtype mismatch and a
    kernel mismatch each."""
    states = _fleet(rng)
    with pytest.raises(ValueError, match="shapes/dtypes"):
        stack_states([states[0], states[1].astype(torch.bfloat16)])
    rekernel = dataclasses.replace(states[1], kernel=cov.Matern32())
    with pytest.raises(ValueError, match="kernel expression"):
        stack_states([states[0], rekernel])


def test_mixture_moments_clamps_negative_variance(rng):
    """A quantized state can round a within-model variance slightly
    negative; the mixture clamps it at 0 so the result stays a variance."""
    mean = torch.from_numpy(rng.standard_normal((3, 5, 2)))
    var = torch.from_numpy(rng.uniform(0.1, 1.0, (3, 5)))
    var[1, 2], var[2, 0] = -1e-4, -0.5
    mu, v = mixture_moments(mean, var)
    assert bool(torch.isfinite(v).all()) and bool((v >= 0).all())
    np.testing.assert_allclose(mu.numpy(), mean.numpy().mean(0), rtol=1e-12)
    clamped = (np.maximum(var.numpy(), 0.0).mean(0)[:, None]
               + mean.numpy().var(axis=0))
    np.testing.assert_allclose(v.numpy(), clamped, rtol=1e-12)
    assert (v.numpy() >= mean.numpy().var(axis=0) - 1e-12).all()


def test_multi_engine_swap_state_and_slot(rng):
    """Fleet hot swap: ``swap_state`` replaces the fleet, ``swap_slot`` one
    model; answers as freshly built engines; shapes validated."""
    fleet_a, fleet_b = _fleet(rng), _fleet(rng)
    eng = MultiPredictEngine(fleet_a, block_size=8, device=CPU)
    xs = rng.standard_normal((6, 2))
    before = eng.predict(xs)

    def fresh(states):
        return MultiPredictEngine(states, block_size=8, device=CPU).predict(xs)

    eng.swap_state(fleet_b)                       # sequence form
    assert torch.equal(eng.predict(xs)[0], fresh(fleet_b)[0])
    eng.swap_state(stack_states(fleet_a))         # stacked form, back to A
    assert torch.equal(eng.predict(xs)[0], before[0])
    eng.swap_slot(2, fleet_b[0])                  # one-model rollout
    after = eng.predict(xs)
    assert torch.equal(after[0], fresh([fleet_a[0], fleet_a[1],
                                        fleet_b[0]])[0])
    assert torch.equal(after[0][:2], before[0][:2])   # the others stay
    with pytest.raises(ValueError, match="out of range"):
        eng.swap_slot(3, fleet_b[0])
    with pytest.raises(ValueError, match="per-model leaf shapes"):
        eng.swap_slot(0, _fleet(rng, n_models=1, m=7)[0])
    with pytest.raises(ValueError, match="identical leaf shapes"):
        eng.swap_state(_fleet(rng, n_models=2))  # N=2 into an N=3 engine


def test_multi_engine_empty_batch_is_noop(rng):
    """t = 0 through the fleet: (N, 0, d) / (N, 0), not a shape error."""
    eng = MultiPredictEngine(_fleet(rng), block_size=8, device=CPU)
    mean, var = eng.predict(np.zeros((0, 2)))
    assert mean.shape == (3, 0, 2) and var.shape == (3, 0)
    assert mean.dtype == eng.compute_dtype
