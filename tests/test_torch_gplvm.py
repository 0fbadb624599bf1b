"""The port's Bayesian GPLVM against the JAX package's.

The same numpy ``y`` (``sines_dataset``, n = 70, q = 2, m = 9) goes to
``repro.core.BayesianGPLVM`` and to ``repro_torch.BayesianGPLVM`` on the
CPU, where the psi wrappers compute the plain versions in f64:

* the init (PCA latents, k-means Z, data-driven hyp) is bitwise equal;
* the bound agrees at 1e-10 relative and the flattened gradient at 1e-8
  (the same f64 math, summed in another order);
* ``fit(max_iters=20)``, joint and alternating, reaches the reference's
  final bound within 1e-6 relative (SCG from the same start on gradients
  that differ in the last digits);
* the chunked latent map equals the monolithic one; ``predictive_state``
  matches the JAX ``state_from_model`` at 1e-10.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

import repro_torch as rt
from repro.core import BayesianGPLVM as JGPLVM
from repro.core import init_utils as j_init
from repro.data import synthetic as j_synth
from repro_torch import convert
from repro_torch.core import bound as t_bound
from repro_torch.core import init_utils as t_init
from repro_torch.core import stats as t_stats
from repro_torch.data import synthetic as t_synth
from repro_torch.serve.posterior import _ARRAY_FIELDS

CPU = "cpu"
N, Q, M = 70, 2, 9


def _y():
    y, _ = t_synth.sines_dataset(np.random.default_rng(0), n=N, noise=0.1)
    return y


def _pair():
    y = _y()
    return JGPLVM(y, q=Q, num_inducing=M), rt.BayesianGPLVM(
        y, q=Q, num_inducing=M, device=CPU)


def _np(v):
    return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) \
        else np.asarray(v)


def _leaves(params):
    return {("hyp", k): v for k, v in params["hyp"].items()} | {
        (k,): params[k] for k in ("z", "mu", "log_s")}


@pytest.fixture(scope="module")
def models():
    return _pair()


def test_data_generators_match_reference():
    for gen in ("sines_dataset", "usps_like"):
        got = getattr(t_synth, gen)(np.random.default_rng(3), n=25)
        want = getattr(j_synth, gen)(np.random.default_rng(3), n=25)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
    y = _y()
    for a, b in zip(t_synth.drop_pixels(np.random.default_rng(4), y, 0.34),
                    j_synth.drop_pixels(np.random.default_rng(4), y, 0.34)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(t_init.pca(y, 2), j_init.pca(y, 2))


def test_init_params_are_bitwise_equal(models):
    jm, tm = models
    want, got = _leaves(jm.params), _leaves(tm.params)
    assert sorted(want) == sorted(got)
    for k in want:
        np.testing.assert_array_equal(_np(got[k]), np.asarray(want[k]),
                                      err_msg=str(k))


def test_bound_and_gradient_match(models):
    jm, tm = models
    want = jm.log_bound()
    assert abs(tm.log_bound() - want) <= 1e-10 * abs(want)
    jv, jg = jm._neg_vg(jm.params, jm.y)
    jg = np.asarray(ravel_pytree(jg)[0])
    v, g = tm._neg_vg()
    assert abs(v - float(jv)) <= 1e-10 * abs(float(jv))
    np.testing.assert_allclose(g, jg, rtol=1e-8, atol=1e-8 * np.abs(jg).max())


def test_regression_is_zero_variance_gplvm():
    """The paper's unifying claim: the latent bound with S -> 0, mu = X and
    no KL equals the SGPR bound (the port's ``tests/test_gplvm.py:11-24``)."""
    rng = np.random.default_rng(0)
    n, q, d, m = 30, 2, 2, 8
    x, y, z = (torch.from_numpy(rng.standard_normal(sh))
               for sh in ((n, q), (n, d), (m, q)))
    hyp = {"log_sf2": torch.tensor(0.2, dtype=torch.float64),
           "log_ell": torch.zeros(q, dtype=torch.float64),
           "log_beta": torch.tensor(1.0, dtype=torch.float64)}
    st_reg = t_stats.partial_stats(hyp, z, y, x, s=None, latent=False)
    st_lvm = t_stats.partial_stats(hyp, z, y, x, s=torch.full((n, q), 1e-13),
                                   latent=False)
    b_reg = float(t_bound.collapsed_bound(hyp, z, st_reg, d))
    b_lvm = float(t_bound.collapsed_bound(hyp, z, st_lvm, d))
    assert abs(b_reg - b_lvm) < 1e-5 * max(1.0, abs(b_reg))


@pytest.mark.parametrize("joint", [True, False])
def test_fit_reaches_reference_bound(joint):
    jm, tm = _pair()
    b0 = tm.log_bound()
    jm.fit(max_iters=20, joint=joint, outer_rounds=5)
    tm.fit(max_iters=20, joint=joint, outer_rounds=5)
    want = jm.log_bound()
    got = tm.log_bound()
    assert got > b0
    assert abs(got - want) <= 1e-6 * abs(want)


def test_chunked_latent_map_equals_monolithic(models):
    """A block size that divides nothing (s padded with 1, w with 0)."""
    _, tm = models
    p = tm.params
    s = torch.exp(p["log_s"])
    full = t_stats.partial_stats(p["hyp"], p["z"], tm.y, p["mu"], s,
                                 latent=True)
    ch = t_stats.partial_stats_chunked(p["hyp"], p["z"], tm.y, p["mu"], s,
                                       latent=True, block_size=16)
    for name, a, b in zip(full._fields, full, ch):
        np.testing.assert_allclose(_np(b), _np(a), rtol=1e-12, atol=1e-12,
                                   err_msg=name)
    model = rt.BayesianGPLVM(_y(), q=Q, num_inducing=M, chunk_size=16,
                             device=CPU)
    assert abs(model.log_bound() - tm.log_bound()) <= 1e-12 * abs(
        tm.log_bound())


def test_predictive_state_matches(models):
    jm, tm = models
    js, ts = jm.predictive_state(), tm.predictive_state()
    for f in _ARRAY_FIELDS:
        np.testing.assert_allclose(_np(getattr(ts, f)), _np(getattr(js, f)),
                                   rtol=1e-10, atol=1e-10, err_msg=f)
    for k in js.hyp:
        np.testing.assert_array_equal(_np(ts.hyp[k]), _np(js.hyp[k]))
    mean, var = tm.serve_engine(block_size=16).predict(tm.params["mu"])
    assert mean.shape == (N, 3) and var.shape == (N,)
    np.testing.assert_allclose(tm.ard_weights(), np.asarray(jm.ard_weights()),
                               rtol=1e-15)
    np.testing.assert_array_equal(tm.latent_mean(), jm.latent_mean())


def test_params_cross_from_jax(models):
    """``convert.params_from_numpy`` carries mu and log_s too."""
    jm, tm = models
    p = convert.params_from_numpy(
        {"hyp": {k: np.asarray(v) for k, v in jm.params["hyp"].items()},
         **{k: np.asarray(jm.params[k]) for k in ("z", "mu", "log_s")}}, CPU)
    assert abs(tm.log_bound(p) - tm.log_bound()) == 0.0
    assert jnp.asarray(jm.params["log_s"]).shape == tuple(p["log_s"].shape)
