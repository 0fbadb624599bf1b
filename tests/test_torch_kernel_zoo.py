"""The port's kernel zoo against the JAX package's.

The eight expressions of the reference's ``ZOO``
(``tests/test_kernel_zoo.py:62-74``) built in both packages: every
covariance and psi statistic at 1e-12 (analytic and quadrature forms),
their structure (``hyp_shapes``, ``default_hyp``, ``to_spec``) and specs
read across, the dispatch shims, an SGPR at ``sgpr-zoo-trend``'s expression
and a composite GPLVM (bound and gradient at 1e-8), a ``Sum`` state file
crossing between the packages, and ``convert`` on nested trees.
"""
import json
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

import repro_torch as rt
from repro.core import BayesianGPLVM as JGPLVM
from repro.core import SGPR as JSGPR
from repro.core import covariance as jcov
from repro.core import init_utils as j_init
from repro.core import stats as j_stats
from repro.serve import load_state as j_load_state
from repro.serve import predict_mean_var as j_predict
from repro.serve import save_state as j_save_state
from repro.serve import state_from_model as j_state_from_model
from repro_torch import convert
from repro_torch.core import covariance as tcov
from repro_torch.core import gp_kernels as t_gpk
from repro_torch.core import init_utils as t_init
from repro_torch.core import stats as t_stats
from repro_torch.serve import posterior as t_post
from repro_torch.serve.posterior import _ARRAY_FIELDS

CPU = "cpu"
N, M, Q = 5, 4, 2
TOL = dict(rtol=1e-12, atol=1e-12)   # tests/test_kernel_zoo.py:108-110


def _zoo(c):
    """The reference test's ``ZOO``, built from package ``c``."""
    return {
        "se": c.SEARD(),
        "se_dims": c.SEARD(dims=(0,)),
        "matern32": c.Matern32(dims=(0, 1), quad_order=11),
        "linear": c.Linear(),
        "periodic": c.Periodic(dims=(1,), quad_order=15),
        "sum_disjoint": c.Sum(c.SEARD(dims=(0,)), c.Linear(dims=(1,))),
        "prod_disjoint": c.Product(c.SEARD(dims=(0,)), c.Matern32(dims=(1,))),
        "sum_overlap": c.Sum(c.SEARD(dims=(0, 1)), c.Linear(dims=(0,)),
                             quad_order=9),
    }


T_ZOO, J_ZOO = _zoo(tcov), _zoo(jcov)
NAMES = sorted(T_ZOO)


def _rand_tree(shapes, rng):
    return {k: (_rand_tree(v, rng) if isinstance(v, dict)
                else 0.2 * rng.standard_normal(v)) for k, v in shapes.items()}


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _t(tree):
    return _map(lambda v: torch.as_tensor(np.asarray(v, np.float64)), tree)


def _j(tree):
    return _map(lambda v: jnp.asarray(np.asarray(v, np.float64)), tree)


def _inputs(name, seed=0):
    """A diagonal q(X) with modest variances, Z, weights and a random hyp
    tree for expression ``name`` (numpy)."""
    rng = np.random.default_rng(seed)
    mu = rng.standard_normal((N, Q))
    s = 0.08 * (0.5 + rng.random((N, Q)))
    z = rng.standard_normal((M, Q))
    w = 0.5 + rng.random((N,))
    hyp = _rand_tree(T_ZOO[name].hyp_shapes(Q), rng)
    return hyp, mu, s, z, w


QUANTITIES = {
    "K": lambda k, h, mu, s, z, w: k.K(h, mu, z),
    "kdiag": lambda k, h, mu, s, z, w: k.kdiag(h, mu),
    "psi0": lambda k, h, mu, s, z, w: k.psi0(h, mu, s),
    "psi1": lambda k, h, mu, s, z, w: k.psi1(h, z, mu, s),
    "psi2_per_point": lambda k, h, mu, s, z, w: k.psi2_per_point(h, z, mu, s),
    "psi2": lambda k, h, mu, s, z, w: k.psi2(h, z, mu, s, w),
}


@pytest.mark.parametrize("quantity", sorted(QUANTITIES))
@pytest.mark.parametrize("name", NAMES)
def test_quantity_matches_jax(name, quantity):
    """Closed forms, factored compositions and Gauss–Hermite quadrature
    alike give JAX's numbers."""
    hyp, mu, s, z, w = _inputs(name)
    fn = QUANTITIES[quantity]
    got = fn(T_ZOO[name], _t(hyp), *(_t(a) for a in (mu, s, z, w)))
    want = fn(J_ZOO[name], _j(hyp), *(_j(a) for a in (mu, s, z, w)))
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("name", NAMES)
def test_structure_and_specs_cross(name):
    tk, jk = T_ZOO[name], J_ZOO[name]
    assert tk.hyp_shapes(Q) == jk.hyp_shapes(Q)
    assert tcov.full_hyp_shapes(tk, Q) == jcov.full_hyp_shapes(jk, Q)
    assert tk.to_spec() == jk.to_spec()
    assert str(tk) == str(jk)                      # the sidecar's JSON, key order too
    assert tcov.kernel_from_spec(jk.to_spec()) == tk
    assert jcov.kernel_from_spec(tk.to_spec()) == jk
    assert tcov.kernel_from_spec(str(jk)) == tk
    rebuilt = tcov.kernel_from_spec(tk.to_spec())
    assert hash(rebuilt) == hash(tk)
    assert tk.analytic_psi() == jk.analytic_psi()
    assert tk.support_dims(3) == jk.support_dims(3)
    got, want = tk.default_hyp(Q, var_y=2.0), jk.default_hyp(Q, var_y=2.0)
    assert json.dumps(_map(np.ndarray.tolist, _map(np.asarray, got)),
                      sort_keys=True) == json.dumps(
        _map(np.ndarray.tolist, _map(np.asarray, want)), sort_keys=True)
    y = np.random.default_rng(1).standard_normal((10, 3))
    got = t_init.default_hyp_for(tk, y, Q)
    want = j_init.default_hyp_for(jk, y, Q)
    assert sorted(got) == sorted(want)
    for a, b in zip(jax.tree.leaves(_j(got)), jax.tree.leaves(_j(want))):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    hyp = _t(_rand_tree(tk.hyp_shapes(Q), np.random.default_rng(2)))
    np.testing.assert_allclose(float(tk.variance_scale(hyp)),
                               float(jk.variance_scale(_j(_map(
                                   lambda v: v.numpy(), hyp)))), **TOL)


@pytest.mark.parametrize("name", NAMES)
def test_zero_variance_limit(name):
    """s = 0: psi0 == kdiag, psi1 == K, psi2_per_point == outer(K, K), for
    every expression (``tests/test_kernel_zoo.py:137``)."""
    hyp, mu, _, z, _ = _inputs(name, seed=3)
    k, h, mu, z = T_ZOO[name], _t(hyp), _t(mu), _t(z)
    s0 = torch.zeros_like(mu)
    kk = k.K(h, mu, z)
    torch.testing.assert_close(k.psi0(h, mu, s0), k.kdiag(h, mu), **TOL)
    torch.testing.assert_close(k.psi1(h, z, mu, s0), kk, **TOL)
    torch.testing.assert_close(k.psi2_per_point(h, z, mu, s0),
                               kk[:, :, None] * kk[:, None, :], **TOL)


def test_registry_and_dispatch_helpers():
    assert tcov.kernel_names() == jcov.kernel_names()
    assert tcov.as_kernel(None) == tcov.SE_ARD
    assert tcov.as_kernel({"kind": "se"}) == tcov.SE_ARD
    with pytest.raises(TypeError):
        tcov.as_kernel(42)
    with pytest.raises(ValueError, match="unknown kernel kind"):
        tcov.kernel_from_spec({"kind": "nope"})
    with pytest.raises(ValueError, match=">= 2"):
        tcov.Sum(tcov.SEARD())
    for name in NAMES:
        assert tcov.is_fused_se(T_ZOO[name]) == jcov.is_fused_se(J_ZOO[name])
    assert tcov.is_fused_se(None) and tcov.is_fused_se("se")


def test_sqdist_large_offset_regression():
    """``tests/test_kernel_zoo.py:175``: distances of points on a huge
    common offset match the exact O(1) ones."""
    rng = np.random.default_rng(0)
    a = rng.standard_normal((40, 3))
    b = rng.standard_normal((30, 3))
    exact = np.sum((a[:, None, :] - b[None, :, :]) ** 2, axis=-1)
    shifted = t_gpk.sqdist(torch.as_tensor(a + 1e4), torch.as_tensor(b + 1e4))
    np.testing.assert_allclose(shifted.numpy(), exact, rtol=1e-6, atol=1e-6)
    assert float(shifted.min()) >= 0.0


def test_deprecated_wrappers_still_warn_once():
    hyp = {"log_sf2": torch.tensor(0.0, dtype=torch.float64),
           "log_ell": torch.zeros(Q, dtype=torch.float64)}
    a = torch.ones((3, Q), dtype=torch.float64)
    t_gpk._DEPRECATION_WARNED.discard("ard_kernel")
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        t_gpk.ard_kernel(hyp, a, a)
        t_gpk.ard_kernel(hyp, a, a)
    assert len([r for r in rec
                if issubclass(r.category, DeprecationWarning)]) == 1


# -- the dispatch shims ------------------------------------------------------

@pytest.mark.parametrize("name", ["se", "sum_disjoint", "matern32"])
def test_shims_give_jax_values(name):
    """``reg_stats_fn_for_engine``, ``psi2_fn_for_engine`` and the predict
    route against the JAX shims' closures (the fused route's plain version
    on the CPU)."""
    from repro.kernels.psi_stats import psi2_fn_for_engine as j_psi2_fn
    from repro.kernels.reg_stats import reg_stats_fn_for_engine as j_rs_fn
    from repro_torch.kernels.predict.ops import predict_fn_for_engine
    from repro_torch.kernels.psi_stats.ops import psi2_fn_for_engine
    from repro_torch.kernels.reg_stats.ops import reg_stats_fn_for_engine

    hyp, mu, s, z, w = _inputs(name, seed=4)
    y = np.random.default_rng(5).standard_normal((N, 3))
    tk, jk = T_ZOO[name], J_ZOO[name]
    ta = [_t(a) for a in (mu, s, z, w, y)]
    ja = [_j(a) for a in (mu, s, z, w, y)]
    got = psi2_fn_for_engine(kernel=tk)(_t(hyp), ta[2], ta[0], ta[1], ta[3])
    want = jk.psi2(_j(hyp), ja[2], ja[0], ja[1], ja[3])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    if name != "se":          # the reference's fused SE psi2 computes in f32
        want = j_psi2_fn(kernel=jk)(_j(hyp), ja[2], ja[0], ja[1], ja[3])
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    got = reg_stats_fn_for_engine(kernel=tk)(_t(hyp), ta[2], ta[0], ta[4],
                                             ta[3])
    want = j_rs_fn(kernel=jk)(_j(hyp), ja[2], ja[0], ja[4], ja[3]) \
        if name != "se" else j_stats.reg_stats_dense(
            _j(hyp), ja[2], ja[0], ja[4], ja[3], kernel=jk)
    for g, e in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(e), **TOL)
    # The predict route: a state of this expression through the engine's
    # per-block function, against the JAX serving math.
    full = {**hyp, "log_beta": np.asarray(0.7)}
    st = t_stats.partial_stats(_t(full), ta[2], ta[4], ta[0], kernel=tk)
    state = rt.extract_state(_t(full), ta[2], st, kernel=tk, device=CPU)
    jst = j_stats.partial_stats(_j(full), ja[2], ja[4], ja[0], s=None,
                                latent=False, kernel=jk)
    from repro.serve import extract_state as j_extract
    jstate = j_extract(_j(full), ja[2], jst, kernel=jk)
    xs = np.random.default_rng(6).standard_normal((7, Q))
    mean, var = predict_fn_for_engine(tk)(state, _t(xs))
    jmean, jvar = j_predict(jstate, jnp.asarray(xs))
    np.testing.assert_allclose(mean.numpy(), np.asarray(jmean), rtol=1e-9,
                               atol=1e-10)
    np.testing.assert_allclose(var.numpy(), np.asarray(jvar), rtol=1e-9,
                               atol=1e-10)


def test_latent_map_of_a_composite_matches_jax():
    """The GPLVM map (psi0/psi1/psi2 of a Sum, KL) in both packages."""
    name = "sum_overlap"
    hyp, mu, s, z, w = _inputs(name, seed=7)
    y = np.random.default_rng(8).standard_normal((N, 2))
    got = t_stats.partial_stats(_t(hyp), _t(z), _t(y), _t(mu), s=_t(s),
                                weights=_t(w), latent=True,
                                kernel=T_ZOO[name])
    want = j_stats.partial_stats(_j(hyp), _j(z), _j(y), _j(mu), s=_j(s),
                                 weights=_j(w), latent=True,
                                 kernel=J_ZOO[name])
    for f, g, e in zip(got._fields, got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(e), err_msg=f,
                                   **TOL)


# -- models with a composite expression ----------------------------------------

def _trend_data(n=120, seed=0):
    """``sgpr-zoo-trend``'s shape (q 4, d 2) at a small n: a smooth
    function of dims 0-1 plus a linear trend in dims 2-3."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(-2.0, 2.0, (n, 4))
    f = np.stack([np.sin(2.0 * x[:, 0]) * np.cos(x[:, 1]),
                  np.cos(1.5 * x[:, 0] + x[:, 1])], 1)
    y = f + x[:, 2:] @ np.array([[0.8, -0.3], [0.4, 0.6]]) \
        + 0.05 * rng.standard_normal((n, 2))
    return x, y


@pytest.fixture(scope="module")
def trend_models():
    from repro_torch.configs import GP_CONFIGS

    spec = GP_CONFIGS["sgpr-zoo-trend"].kernel
    x, y = _trend_data()
    jm = JSGPR(x, y, num_inducing=12, seed=0, kernel=spec, chunk_size=50)
    params = {"hyp": _map(np.asarray, jm.params["hyp"]),
              "z": np.asarray(jm.params["z"])}
    tp = convert.params_from_numpy(params, CPU)
    tm = rt.SGPR(x, y, hyp=tp["hyp"], z=tp["z"], kernel=spec, chunk_size=50,
                 device=CPU)
    return x, y, jm, tm


def test_zoo_trend_config_parses_as_jax_does():
    from repro.configs.gp_paper import GP_CONFIGS as J_CONFIGS
    from repro_torch.configs import GP_CONFIGS

    got, want = GP_CONFIGS["sgpr-zoo-trend"], J_CONFIGS["sgpr-zoo-trend"]
    assert (got.n, got.d, got.q, got.m, got.latent, got.kernel) == \
        (want.n, want.d, want.q, want.m, want.latent, want.kernel)
    assert got.kernel_expr().to_spec() == want.kernel_expr().to_spec()
    assert got.kernel_expr() == tcov.Sum(tcov.SEARD(dims=(0, 1)),
                                         tcov.Linear(dims=(2, 3)))


def test_sgpr_zoo_trend_bound_and_gradient_match_jax(trend_models):
    x, y, jm, tm = trend_models
    assert tm.kernel == tcov.kernel_from_spec(jm.kernel.to_spec())
    jv, jg = jm._neg_vg(jm.params, jnp.asarray(x), jnp.asarray(y))
    jg = np.asarray(ravel_pytree(jg)[0])
    v, g = tm._neg_vg()
    assert abs(v - float(jv)) <= 1e-8 * abs(float(jv))
    np.testing.assert_allclose(g, jg, rtol=1e-8, atol=1e-8 * np.abs(jg).max())
    assert abs(tm.log_bound() - jm.log_bound()) <= 1e-8 * abs(jm.log_bound())


def test_sgpr_zoo_trend_fits_and_serves(trend_models):
    x, y, _, tm = trend_models
    m = rt.SGPR(x, y, hyp=tm.params["hyp"], z=tm.params["z"],
                kernel=tm.kernel, device=CPU)
    b0 = m.log_bound()
    m.fit(max_iters=5)
    assert m.log_bound() > b0
    mean, var = m.predict(x[:9])
    assert mean.shape == (9, 2) and np.isfinite(mean).all()
    assert (var > 0).all()
    assert set(m.params["hyp"]) == {"k0", "k1", "log_beta"}


def test_composite_gplvm_step_matches_jax():
    """A ``BayesianGPLVM`` over ``Sum(SE dims 0, Linear dims 1)``
    (``tests/test_kernel_zoo.py:296``): the same init in both packages, the
    bound and gradient at 1e-8; then an SVI step moves it, and
    ``ard_weights`` refuses the composite."""
    y = np.random.default_rng(3).normal(size=(40, 3))
    jk = jcov.Sum(jcov.SEARD(dims=(0,)), jcov.Linear(dims=(1,)))
    tk = tcov.kernel_from_spec(jk.to_spec())
    jm = JGPLVM(y, Q, num_inducing=6, kernel=jk, chunk_size=16)
    tm = rt.BayesianGPLVM(y, Q, num_inducing=6, kernel=tk, chunk_size=16,
                          batch_blocks=2, device=CPU)
    jv, jg = jm._neg_vg(jm.params, jm.y)
    jg = np.asarray(ravel_pytree(jg)[0])
    v, g = tm._neg_vg()
    assert abs(v - float(jv)) <= 1e-8 * abs(float(jv))
    np.testing.assert_allclose(g, jg, rtol=1e-8, atol=1e-8 * np.abs(jg).max())
    b0 = tm.log_bound()
    tm.fit_svi(steps=3, lr=1e-2, seed=0)
    assert np.isfinite(tm.log_bound()) and tm.log_bound() != b0
    with pytest.raises(ValueError, match="ARD lengthscales"):
        tm.ard_weights()


# -- a Sum state across the packages ---------------------------------------------

def _state_leaves(state):
    return {"hyp": _map(np.asarray, state.hyp),
            **{f: np.asarray(getattr(state, f)) for f in _ARRAY_FIELDS}}


def test_sum_state_files_cross_both_ways(trend_models, tmp_path):
    x, _, jm, _ = trend_models
    jstate = j_state_from_model(jm)
    xs = x[:11]
    # JAX writes, the port reads: every leaf bitwise, the same answers.
    j_save_state(tmp_path / "j", jstate)
    tstate, _ = rt.load_state(tmp_path / "j", device=CPU)
    assert tstate.kernel.to_spec() == jstate.kernel.to_spec()
    want = _state_leaves(jstate)
    for a, b in zip(jax.tree.leaves(_map(lambda t: t.numpy(),
                                         {"hyp": tstate.hyp,
                                          **{f: getattr(tstate, f)
                                             for f in _ARRAY_FIELDS}})),
                    jax.tree.leaves(want)):
        np.testing.assert_array_equal(a, b)
    jmean, jvar = j_predict(jstate, jnp.asarray(xs))
    mean, var = t_post.predict_mean_var(tstate, torch.as_tensor(xs))
    np.testing.assert_allclose(mean.numpy(), np.asarray(jmean), rtol=1e-9,
                               atol=1e-10)
    # The port writes, JAX reads: the same leaves back, 0 difference.
    rt.save_state(tmp_path / "t", tstate)
    back, _ = j_load_state(tmp_path / "t")
    assert back.kernel == jstate.kernel
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jstate)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    side = json.loads((tmp_path / "t").with_suffix(".json").read_text())
    assert side["metadata"]["kernel"] == jstate.kernel.to_spec()


def test_convert_carries_nested_trees(trend_models):
    _, _, jm, _ = trend_models
    jstate = j_state_from_model(jm)
    leaves = _state_leaves(jstate)
    state = convert.state_from_numpy(leaves, CPU,
                                     kernel=jstate.kernel.to_spec())
    assert state.kernel == tcov.kernel_from_spec(jstate.kernel.to_spec())
    assert set(state.hyp["k0"]) == {"log_sf2", "log_ell"}
    np.testing.assert_array_equal(state.hyp["k1"]["log_sv2"].numpy(),
                                  leaves["hyp"]["k1"]["log_sv2"])
    params = convert.params_from_numpy(
        {"hyp": leaves["hyp"], "z": leaves["z"]}, CPU)
    np.testing.assert_array_equal(params["hyp"]["k0"]["log_ell"].numpy(),
                                  leaves["hyp"]["k0"]["log_ell"])
    # astype and nbytes walk the nested hyp too.
    q32 = state.astype(torch.float32)
    assert q32.hyp["k1"]["log_sv2"].dtype == torch.float32
    assert state.nbytes == sum(a.nbytes for a in jax.tree.leaves(leaves))
