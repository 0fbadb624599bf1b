"""The port's SGPR training against the JAX package's.

One regression problem (``conftest.make_regression``) and its starting
``hyp``/``z`` go to ``repro.core.SGPR`` and, through
``convert.params_from_numpy``, to ``repro_torch.SGPR`` on the CPU:

* SCG is a numpy copy: on the same oracle both give bitwise-equal iterates;
* value and flat gradient of the negative bound (f64, the same math):
  rtol 1e-10 on the value, 1e-8 on the gradient, the f64 tiers of the JAX
  package's own parity tests;
* ``fit(max_iters=20)`` from the same start reaches the reference's bound
  within 1e-6 relative (the two SCG runs see gradients that differ in the
  last digits, which 20 iterations may amplify, but not past that);
* ``fold_stats`` / ``downdate_stats`` round-trip.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

import repro_torch as rt
from repro.core import SGPR as JSGPR
from repro.core import scg as j_scg
from repro_torch import convert
from repro_torch.core import flat as t_flat
from repro_torch.core import scg as t_scg
from repro_torch.core import stats as t_stats

from conftest import make_regression

CPU = "cpu"


def _start():
    rng = np.random.default_rng(0)
    x, y = make_regression(rng, n=70, q=2, d=2)
    jm = JSGPR(x, y, num_inducing=10, seed=0)
    params = {"hyp": {k: np.asarray(v) for k, v in jm.params["hyp"].items()},
              "z": np.asarray(jm.params["z"])}
    tp = convert.params_from_numpy(params, CPU)
    return x, y, jm, rt.SGPR(x, y, hyp=tp["hyp"], z=tp["z"], device=CPU)


@pytest.fixture(scope="module")
def models():
    return _start()


@pytest.fixture(scope="module")
def fitted():
    """Both models after ``fit(max_iters=20)`` from the same start."""
    _, _, jm, tm = _start()
    jres = jm.fit(max_iters=20)
    tres = tm.fit(max_iters=20)
    return jm, tm, jres, tres


def _rosenbrock(x):
    a, b = x[:-1], x[1:]
    f = float(np.sum(100.0 * (b - a * a) ** 2 + (1.0 - a) ** 2))
    g = np.zeros_like(x)
    g[:-1] = -400.0 * a * (b - a * a) - 2.0 * (1.0 - a)
    g[1:] += 200.0 * (b - a * a)
    return f, g


def test_scg_is_bitwise_the_reference():
    x0 = np.array([-1.2, 1.0, 0.3, -0.7])
    want = j_scg.scg(_rosenbrock, x0, max_iters=60)
    got = t_scg.scg(_rosenbrock, x0, max_iters=60)
    np.testing.assert_array_equal(got.x, want.x)
    assert got.f == want.f and got.history == want.history
    assert (got.n_iters, got.n_evals, got.converged) == \
        (want.n_iters, want.n_evals, want.converged)


def test_flat_order_is_ravel_pytree(models):
    _, _, jm, tm = models
    flat = t_flat.Flat(tm.params)
    want, _ = ravel_pytree(jm.params)
    np.testing.assert_array_equal(flat.ravel(tm.params), np.asarray(want))
    back = flat.unravel(flat.ravel(tm.params))
    assert torch.equal(back["z"], tm.params["z"])
    for k, v in tm.params["hyp"].items():
        assert torch.equal(back["hyp"][k], v)


def test_value_and_gradient_match(models):
    x, y, jm, tm = models
    jv, jg = jm._neg_vg(jm.params, jnp.asarray(x), jnp.asarray(y))
    jg, _ = ravel_pytree(jg)
    v, g = tm._neg_vg()
    assert abs(v - float(jv)) <= 1e-10 * abs(float(jv))
    np.testing.assert_allclose(g, np.asarray(jg), rtol=1e-8,
                               atol=1e-8 * np.abs(np.asarray(jg)).max())


def test_chunked_gradient_matches(models):
    """The chunked map (a block size that divides nothing) gives the same
    value and gradient as the monolithic one."""
    _, _, _, tm = models
    ch = rt.SGPR(tm.x, tm.y, hyp=tm.params["hyp"], z=tm.params["z"],
                 chunk_size=16, device=CPU)
    v0, g0 = tm._neg_vg()
    v1, g1 = ch._neg_vg()
    assert abs(v1 - v0) <= 1e-12 * abs(v0)
    np.testing.assert_allclose(g1, g0, rtol=1e-10, atol=1e-12)


def test_fit_reaches_reference_bound(fitted):
    jm, tm, jres, tres = fitted
    want = jm.log_bound()
    got = tm.log_bound()
    assert got > -tres.history[0]          # the fit raised the bound
    assert abs(got - want) <= 1e-6 * abs(want)
    assert abs(tres.f - jres.f) <= 1e-6 * abs(jres.f)


def test_fit_drops_posterior_caches(fitted):
    _, tm, _, _ = fitted
    state = tm.predictive_state()
    assert tm.predictive_state() is state
    tm.fit(max_iters=1)
    assert tm._stats_cache is None and tm._pstate_cache is None
    assert tm.predictive_state() is not state


def test_fold_downdate_round_trip(models):
    _, _, _, tm = models
    hyp, z = tm.params["hyp"], tm.params["z"]
    a = t_stats.partial_stats(hyp, z, tm.y[:40], tm.x[:40])
    b = t_stats.partial_stats(hyp, z, tm.y[40:], tm.x[40:])
    whole = t_stats.partial_stats(hyp, z, tm.y, tm.x)
    folded = t_stats.fold_stats(a, b)
    back = t_stats.downdate_stats(folded, b)
    for name, f, w, r, o in zip(whole._fields, folded, whole, back, a):
        np.testing.assert_allclose(f.numpy(), w.numpy(), rtol=1e-12,
                                   atol=1e-12, err_msg=name)
        np.testing.assert_allclose(r.numpy(), o.numpy(), rtol=1e-12,
                                   atol=1e-12, err_msg=name)


def test_non_finite_step_is_a_failed_step(models):
    """A Cholesky that fails at a wild step gives NaN value and gradient,
    as the JAX package's NaN factor does, so SCG counts a failed step."""
    _, _, _, tm = models
    flat = t_flat.Flat(tm.params)
    x = flat.ravel(tm.params)
    x[flat.paths.index(("hyp", "log_beta"))] = 800.0
    v, g = flat.value_and_grad(tm._neg_bound, x)
    assert np.isnan(v) and np.isnan(g).all()
