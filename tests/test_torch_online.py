"""Online updates in the port against the JAX package: the rank-k Cholesky
update and downdate (``core.chol_update``), the guarded serve refresh
(``serve.online``), ``SGPR.update``/``forget``/``num_blocks``,
``PredictEngine.ingest``/``forget``/``swap_state`` and the posterior-cache
bookkeeping, each at the reference tests' tolerances
(``tests/test_chol_update.py``, ``tests/test_online_updates.py``) and
with the reference's ``ok`` and ``fallback`` flags.
"""
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch as rt
from repro.core import SGPR as JSGPR
from repro.core import chol_update as j_chol
from repro.core import stats as j_stats
from repro.serve import extract_state as j_extract
from repro.serve import online as j_online
from repro_torch import convert
from repro_torch.core import chol_update as t_chol
from repro_torch.core import covariance as tcov
from repro_torch.core import stats as t_stats
from repro_torch.serve import online as t_online
from repro_torch.serve import posterior as t_post
from repro_torch.serve.posterior import _ARRAY_FIELDS

CPU = "cpu"
STATE_FIELDS = ("chol_sigma", "c2", "a_mean", "g")


def _t(a):
    return torch.as_tensor(np.asarray(a, np.float64))


def _spd_chol(rng, m, scale=1.0):
    a = rng.standard_normal((m, m))
    return np.linalg.cholesky(scale * (a @ a.T + m * np.eye(m)))


# -- core.chol_update ------------------------------------------------------------

@pytest.mark.parametrize("m,k", [(3, 1), (7, 2), (12, 5), (9, 9)])
def test_rank_k_update_matches_jax_and_refactorization(m, k):
    rng = np.random.default_rng(m * 31 + k)
    L = _spd_chol(rng, m)
    V = rng.standard_normal((m, k))
    Lu, ok = t_chol.chol_update_rank_k(_t(L), _t(V))
    assert bool(ok)
    direct = np.linalg.cholesky(L @ L.T + V @ V.T)
    np.testing.assert_allclose(Lu.numpy(), direct, rtol=1e-12, atol=1e-13)
    Lj, okj = j_chol.chol_update_rank_k(jnp.asarray(L), jnp.asarray(V))
    assert bool(okj)
    np.testing.assert_allclose(Lu.numpy(), np.asarray(Lj), rtol=1e-12,
                               atol=1e-13)
    assert np.allclose(np.triu(Lu.numpy(), 1), 0.0)
    assert (np.diag(Lu.numpy()) > 0).all()


@pytest.mark.parametrize("m,k", [(5, 1), (9, 3), (12, 4)])
def test_rank_k_downdate_matches_jax_and_refactorization(m, k):
    rng = np.random.default_rng(m * 17 + k)
    L0 = _spd_chol(rng, m)
    V = rng.standard_normal((m, k))
    Lup, _ = t_chol.chol_update_rank_k(_t(L0), _t(V))
    Ldn, ok = t_chol.chol_downdate_rank_k(Lup, _t(V))
    assert bool(ok)
    np.testing.assert_allclose(Ldn.numpy(), L0, rtol=1e-11, atol=1e-12)
    up = Lup.numpy()
    direct = np.linalg.cholesky(up @ up.T - V @ V.T)
    np.testing.assert_allclose(Ldn.numpy(), direct, rtol=1e-10, atol=1e-11)
    Lj, okj = j_chol.chol_downdate_rank_k(jnp.asarray(up), jnp.asarray(V))
    assert bool(okj)
    np.testing.assert_allclose(Ldn.numpy(), np.asarray(Lj), rtol=1e-10,
                               atol=1e-11)


def test_vector_v_is_rank_1():
    rng = np.random.default_rng(3)
    L = _t(_spd_chol(rng, 6))
    v = _t(rng.standard_normal(6))
    L1, ok1 = t_chol.chol_update_rank_k(L, v)
    L2, ok2 = t_chol.chol_update_rank_k(L, v[:, None])
    assert bool(ok1) and bool(ok2)
    assert torch.equal(L1, L2)


def test_zero_columns_are_exact_noops():
    rng = np.random.default_rng(4)
    L = _t(_spd_chol(rng, 8))
    for f in (t_chol.chol_update_rank_k, t_chol.chol_downdate_rank_k):
        Lz, ok = f(L, torch.zeros((8, 3), dtype=torch.float64))
        assert bool(ok)
        assert torch.equal(Lz, L)
    # Zero columns between real ones change nothing either.
    V = _t(rng.standard_normal((8, 2)))
    padded = torch.cat([V[:, :1], torch.zeros((8, 2), dtype=V.dtype),
                        V[:, 1:]], 1)
    np.testing.assert_allclose(t_chol.chol_update_rank_k(L, padded)[0],
                               t_chol.chol_update_rank_k(L, V)[0],
                               rtol=1e-14, atol=1e-15)


FLAG_CASES = {
    # tests/test_chol_update.py:108-148
    "indefinite": lambda: (_spd_chol(np.random.default_rng(5), 6),
                           10.0 * np.random.default_rng(5).standard_normal(
                               (6, 2)), -1.0, 1e-8),
    "ill_conditioned": lambda: (np.eye(2),
                                np.array([[np.sqrt(1.0 - 1e-10)], [0.0]]),
                                -1.0, 1e-8),
    "ill_conditioned_loose": lambda: (np.eye(2),
                                      np.array([[np.sqrt(1.0 - 1e-10)],
                                                [0.0]]), -1.0, 1e-12),
    "huge_update": lambda: (_spd_chol(np.random.default_rng(6), 5, 1e-6),
                            1e3 * np.random.default_rng(7).standard_normal(
                                (5, 4)), 1.0, 1e-8),
}


@pytest.mark.parametrize("case", sorted(FLAG_CASES))
def test_ok_flag_equals_jax(case):
    L, V, sign, tol = FLAG_CASES[case]()
    t_fn = t_chol.chol_update_rank_k if sign > 0 else \
        t_chol.chol_downdate_rank_k
    j_fn = j_chol.chol_update_rank_k if sign > 0 else \
        j_chol.chol_downdate_rank_k
    Lt, ok = t_fn(_t(L), _t(V), cond_tol=tol)
    _, okj = j_fn(jnp.asarray(L), jnp.asarray(V), cond_tol=tol)
    assert bool(ok) == bool(okj)
    assert Lt.shape == L.shape
    if case == "ill_conditioned_loose":
        direct = np.linalg.cholesky(L @ L.T - V @ V.T)
        np.testing.assert_allclose(Lt.numpy(), direct, rtol=1e-6, atol=1e-12)


def test_chol_update_module_never_calls_cholesky():
    assert "cholesky(" not in inspect.getsource(t_chol)
    assert "cholesky_ex(" not in inspect.getsource(t_chol)


# -- serve.online --------------------------------------------------------------

def _problem(seed=0, n=40, m=9, q=2, d=2):
    rng = np.random.default_rng(seed)
    hyp = {"log_sf2": np.asarray(0.3), "log_ell": np.zeros(q),
           "log_beta": np.asarray(1.2)}
    x = rng.standard_normal((n, q))
    y = rng.standard_normal((n, d))
    z = rng.standard_normal((m, q))
    return hyp, x, y, z, rng


def _t_state(hyp, z, x, y, weights=None):
    th = {k: _t(v) for k, v in hyp.items()}
    st = t_stats.partial_stats(th, _t(z), _t(y), _t(x),
                               weights=None if weights is None
                               else _t(weights))
    return rt.extract_state(th, _t(z), st, device=CPU)


def _j_state(hyp, z, x, y):
    jh = {k: jnp.asarray(v) for k, v in hyp.items()}
    st = j_stats.partial_stats(jh, jnp.asarray(z), jnp.asarray(y),
                               jnp.asarray(x), s=None, latent=False)
    return j_extract(jh, jnp.asarray(z), st)


def _close(got, want, rtol, atol, fields=STATE_FIELDS):
    for f in fields:
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(want, f)), rtol=rtol,
                                   atol=atol, err_msg=f)


def test_update_state_matches_jax_and_union_extract():
    hyp, x, y, z, rng = _problem()
    xb, yb = rng.standard_normal((7, 2)), rng.standard_normal((7, 2))
    res = t_online.update_state(_t_state(hyp, z, x, y), _t(xb), _t(yb))
    jres = j_online.update_state(_j_state(hyp, z, x, y), jnp.asarray(xb),
                                 jnp.asarray(yb))
    assert res.fallback is False and jres.fallback is False
    _close(res.state, jres.state, 1e-10, 1e-11)
    union = _t_state(hyp, z, np.vstack([x, xb]), np.vstack([y, yb]))
    _close(res.state, union, 1e-8, 1e-9)     # tests/test_chol_update.py:166
    xs = _t(rng.standard_normal((11, 2)))
    mg, vg = t_post.predict_mean_var(res.state, xs)
    mr, vr = t_post.predict_mean_var(union, xs)
    np.testing.assert_allclose(mg.numpy(), mr.numpy(), rtol=1e-9, atol=1e-10)
    np.testing.assert_allclose(vg.numpy(), vr.numpy(), rtol=1e-8, atol=1e-10)


def test_downdate_after_update_is_identity():
    hyp, x, y, z, rng = _problem(seed=1)
    state = _t_state(hyp, z, x, y)
    xb, yb = _t(rng.standard_normal((5, 2))), _t(rng.standard_normal((5, 2)))
    up = t_online.update_state(state, xb, yb)
    back = t_online.downdate_state(up.state, xb, yb)
    assert up.fallback is False and back.fallback is False
    _close(back.state, state, 1e-11, 1e-12)


def test_padded_block_refreshes_like_unpadded():
    hyp, x, y, z, rng = _problem(seed=2)
    state = _t_state(hyp, z, x, y)
    xb, yb = rng.standard_normal((4, 2)), rng.standard_normal((4, 2))
    pad_x = np.vstack([xb, rng.standard_normal((3, 2))])
    pad_y = np.vstack([yb, rng.standard_normal((3, 2))])
    w = np.array([1.0] * 4 + [0.0] * 3)
    res_pad = t_online.update_state(state, _t(pad_x), _t(pad_y),
                                    weights=_t(w))
    res = t_online.update_state(state, _t(xb), _t(yb))
    assert res_pad.fallback is False
    _close(res_pad.state, res.state, 1e-12, 1e-14)


def test_illegitimate_forget_takes_the_fallback_without_raising():
    """A block never folded, weights 50 (``tests/test_chol_update.py:
    195-206``): fallback True in both packages, nothing raised; B − VVᵀ
    is indefinite, so the state is non-finite, as JAX's is."""
    hyp, x, y, z, rng = _problem(seed=3, n=20)
    xb = rng.standard_normal((15, 2))
    yb = 5.0 * rng.standard_normal((15, 2))
    state = _t_state(hyp, z, x, y)
    res = t_online.downdate_state(state, _t(xb), _t(yb),
                                  weights=50.0 * torch.ones(15,
                                                            dtype=torch.float64))
    jres = j_online.downdate_state(_j_state(hyp, z, x, y), jnp.asarray(xb),
                                   jnp.asarray(yb),
                                   weights=50.0 * jnp.ones(15))
    assert res.fallback is True and jres.fallback is True
    assert res.state.chol_sigma.shape == state.chol_sigma.shape
    assert bool(torch.isfinite(res.state.chol_sigma).all()) == \
        bool(jnp.isfinite(jres.state.chol_sigma).all())


def test_ill_conditioned_forget_falls_back_to_the_exact_state():
    hyp, x, y, z, _ = _problem(seed=4, n=30)
    state = _t_state(hyp, z, x, y)
    res = t_online.downdate_state(state, _t(x[2:]), _t(y[2:]))
    jres = j_online.downdate_state(_j_state(hyp, z, x, y),
                                   jnp.asarray(x[2:]), jnp.asarray(y[2:]))
    assert res.fallback == jres.fallback
    _close(res.state, _t_state(hyp, z, x[:2], y[:2]), 1e-6, 1e-8)


def test_refresh_refuses_quantized_states_and_bad_signs():
    hyp, x, y, z, rng = _problem(seed=5, n=15)
    state = _t_state(hyp, z, x, y)
    xb, yb = _t(rng.standard_normal((2, 2))), _t(rng.standard_normal((2, 2)))
    with pytest.raises(ValueError, match="sub-f32"):
        t_online.update_state(state.astype(torch.bfloat16), xb, yb)
    with pytest.raises(ValueError, match="sign"):
        t_online.refresh_state(state, xb, yb, sign=2.0)


def _spy(monkeypatch):
    calls = []
    for name in ("cholesky", "cholesky_ex"):
        real = getattr(torch.linalg, name)

        def spy(a, *args, _real=real, **kwargs):
            calls.append(tuple(a.shape))
            return _real(a, *args, **kwargs)

        monkeypatch.setattr(torch.linalg, name, spy)
    return calls


@pytest.mark.parametrize("direction", ["update", "downdate"])
def test_happy_path_factorizes_no_m_by_m_matrix(monkeypatch, direction):
    hyp, x, y, z, rng = _problem(seed=6)
    state = _t_state(hyp, z, x, y)
    k = 3
    xb, yb = _t(rng.standard_normal((k, 2))), _t(rng.standard_normal((k, 2)))
    if direction == "downdate":
        state = t_online.update_state(state, xb, yb).state
    calls = _spy(monkeypatch)
    fn = t_online.update_state if direction == "update" \
        else t_online.downdate_state
    assert fn(state, xb, yb).fallback is False
    assert calls == [(k, k)]


def test_fallback_is_the_only_m_by_m_factorization(monkeypatch):
    hyp, x, y, z, rng = _problem(seed=7, n=20)
    state = _t_state(hyp, z, x, y)
    m = state.chol_sigma.shape[0]
    xb, yb = _t(rng.standard_normal((15, 2))), \
        _t(5.0 * rng.standard_normal((15, 2)))
    calls = _spy(monkeypatch)
    res = t_online.downdate_state(state, xb, yb,
                                  weights=50.0 * torch.ones(15,
                                                            dtype=torch.float64))
    assert res.fallback is True
    assert (m, m) in calls


# -- SGPR.update / forget ----------------------------------------------------------

def _pair(x, y, m, kernel=None):
    """A JAX SGPR and the port's at its start (``convert``)."""
    jm = JSGPR(x, y, num_inducing=m, kernel=kernel)
    params = {"hyp": jax.tree.map(np.asarray, jm.params["hyp"]),
              "z": np.asarray(jm.params["z"])}
    tp = convert.params_from_numpy(params, CPU)
    tm = rt.SGPR(x, y, hyp=tp["hyp"], z=tp["z"], kernel=kernel, device=CPU)
    return jm, tm


def _fresh_like(mdl, x, y):
    """The full-rescan reference an update must match."""
    ref = rt.SGPR(np.asarray(x), np.asarray(y),
                  num_inducing=mdl.params["z"].shape[0],
                  z=mdl.params["z"].numpy(), kernel=mdl.kernel, device=CPU)
    ref.params = mdl.params
    return ref


def test_update_then_predict_matches_jax_and_retrain(rng):
    n, k, q, d = 48, 9, 2, 2
    x, y = rng.standard_normal((n, q)), rng.standard_normal((n, d))
    xb, yb = rng.standard_normal((k, q)), rng.standard_normal((k, d))
    xs = rng.standard_normal((17, q))
    jm, tm = _pair(x, y, 7)
    jm.predict(xs)
    tm.predict(xs)                       # warm every cache before the update
    assert tm.update(xb, yb) == jm.update(xb, yb) == 1
    assert tm.num_blocks == jm.num_blocks == 2 and tm.n == n + k
    m_up, v_up = tm.predict(xs, include_noise=True)
    jm_up, jv_up = jm.predict(xs, include_noise=True)
    np.testing.assert_allclose(m_up, jm_up, rtol=1e-9, atol=1e-10)
    np.testing.assert_allclose(v_up, jv_up, rtol=1e-9, atol=1e-10)
    ref = _fresh_like(tm, np.vstack([x, xb]), np.vstack([y, yb]))
    m_ref, v_ref = ref.predict(xs, include_noise=True)
    np.testing.assert_allclose(m_up, m_ref, rtol=1e-9, atol=1e-10)
    np.testing.assert_allclose(v_up, v_ref, rtol=1e-9, atol=1e-10)
    assert abs(tm.log_bound() - ref.log_bound()) < 1e-9 * abs(ref.log_bound())
    for f, a, b in zip(t_stats.Stats._fields, tm._stats(), jm._stats()):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-12,
                                   atol=1e-12, err_msg=f)


@pytest.mark.parametrize("name", ["matern32", "sum"])
def test_update_composes_with_kernel_zoo(rng, name):
    """``tests/test_online_updates.py:216``: an update under a non-SE
    expression, against the retrain and against JAX."""
    spec = {"matern32": {"kind": "matern32", "dims": [0, 1],
                         "quad_order": 11},
            "sum": {"kind": "sum", "parts": [{"kind": "se", "dims": [0]},
                                             {"kind": "linear", "dims": [1]}],
                    "quad_order": 11}}[name]
    x, y = rng.standard_normal((30, 2)), rng.standard_normal((30, 2))
    xb, yb = rng.standard_normal((6, 2)), rng.standard_normal((6, 2))
    jm, tm = _pair(x, y, 6, kernel=spec)
    assert tm.kernel == tcov.kernel_from_spec(spec)
    tm.predict(rng.standard_normal((5, 2)))
    jm.predict(np.zeros((5, 2)))
    tm.update(xb, yb)
    jm.update(xb, yb)
    ref = _fresh_like(tm, np.vstack([x, xb]), np.vstack([y, yb]))
    xs = rng.standard_normal((9, 2))
    np.testing.assert_allclose(tm.predict(xs)[0], ref.predict(xs)[0],
                               rtol=1e-8, atol=1e-9)
    np.testing.assert_allclose(tm.predict(xs)[0], jm.predict(xs)[0],
                               rtol=1e-8, atol=1e-9)


def test_forget_round_trip_restores_the_original(rng):
    x, y = rng.standard_normal((40, 2)), rng.standard_normal((40, 2))
    xb, yb = rng.standard_normal((8, 2)), rng.standard_normal((8, 2))
    mdl = rt.SGPR(x, y, num_inducing=6, device=CPU)
    xs = rng.standard_normal((13, 2))
    m0, v0 = mdl.predict(xs)
    st0 = mdl._stats()
    block = mdl.update(xb, yb)
    xr, yr = mdl.forget(block)
    np.testing.assert_array_equal(xr, xb)
    np.testing.assert_array_equal(yr, yb)
    assert mdl.num_blocks == 1 and mdl.n == 40
    m1, v1 = mdl.predict(xs)
    np.testing.assert_allclose(m1, m0, rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(v1, v0, rtol=1e-10, atol=1e-12)
    for f, a, b in zip(t_stats.Stats._fields, mdl._stats(), st0):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-13,
                                   atol=1e-13, err_msg=f)


def test_forget_renumbers_and_takes_negative_indices_as_jax_does(rng):
    x, y = rng.standard_normal((25, 2)), rng.standard_normal((25, 2))
    b1 = rng.standard_normal((4, 2)), rng.standard_normal((4, 2))
    b2 = rng.standard_normal((6, 2)), rng.standard_normal((6, 2))
    jm, tm = _pair(x, y, 5)
    for mdl in (jm, tm):
        mdl.update(*b1)
        mdl.update(*b2)
    assert tm.num_blocks == jm.num_blocks == 3
    xr, _ = tm.forget(1)
    jxr, _ = jm.forget(1)
    np.testing.assert_array_equal(xr, b1[0])
    np.testing.assert_array_equal(xr, jxr)
    assert tm._blocks == jm._blocks and tm.n == 25 + 6
    xr2, _ = tm.forget(-1)
    jm.forget(-1)
    np.testing.assert_array_equal(xr2, b2[0])
    assert tm.num_blocks == jm.num_blocks == 1 and tm.n == 25
    for mdl in (tm, jm):
        with pytest.raises(IndexError, match="out of range"):
            mdl.forget(5)


def test_update_validates_shapes(rng):
    mdl = rt.SGPR(rng.standard_normal((20, 2)), rng.standard_normal((20, 2)),
                  num_inducing=4, device=CPU)
    with pytest.raises(ValueError, match="row mismatch"):
        mdl.update(rng.standard_normal((3, 2)), rng.standard_normal((4, 2)))
    with pytest.raises(ValueError, match="expected"):
        mdl.update(rng.standard_normal((3, 5)), rng.standard_normal((3, 2)))


# -- the cache chain: update/forget/fit never serve old factors ------------------

def test_engine_serves_the_refreshed_state_after_update(rng):
    x, y = rng.standard_normal((30, 2)), rng.standard_normal((30, 2))
    mdl = rt.SGPR(x, y, num_inducing=5, device=CPU)
    xs = rng.standard_normal((7, 2))
    stale, _ = mdl.predict(xs)
    engine = mdl._engine_cache
    mdl.update(rng.standard_normal((5, 2)), rng.standard_normal((5, 2)))
    assert mdl._engine_cache is engine                  # swapped, not rebuilt
    assert mdl._engine_cache.state is mdl._pstate_cache
    fresh = _fresh_like(mdl, mdl.x, mdl.y)
    np.testing.assert_allclose(mdl.predict(xs)[0], fresh.predict(xs)[0],
                               rtol=1e-9, atol=1e-10)
    assert not np.allclose(mdl.predict(xs)[0], stale)
    b = mdl.update(rng.standard_normal((3, 2)), rng.standard_normal((3, 2)))
    before = mdl.predict(xs)[0]
    mdl.forget(b)
    assert mdl._engine_cache is engine
    assert mdl._engine_cache.state is mdl._pstate_cache
    assert not np.allclose(mdl.predict(xs)[0], before)


def test_fit_drops_every_posterior_cache(rng):
    mdl = rt.SGPR(rng.standard_normal((25, 2)), rng.standard_normal((25, 2)),
                  num_inducing=4, device=CPU)
    mdl.predict(rng.standard_normal((3, 2)))
    assert mdl._stats_cache is not None and mdl._engine_cache is not None
    mdl.fit(max_iters=2)
    assert mdl._stats_cache is None and mdl._pstate_cache is None
    assert mdl._engine_cache is None


def test_update_before_any_predict_folds_stats_only(rng):
    x, y = rng.standard_normal((30, 2)), rng.standard_normal((30, 2))
    xb, yb = rng.standard_normal((4, 2)), rng.standard_normal((4, 2))
    mdl = rt.SGPR(x, y, num_inducing=5, device=CPU)
    mdl.update(xb, yb)
    assert mdl._pstate_cache is None and mdl._engine_cache is None
    ref = _fresh_like(mdl, np.vstack([x, xb]), np.vstack([y, yb]))
    xs = rng.standard_normal((6, 2))
    np.testing.assert_allclose(mdl.predict(xs)[0], ref.predict(xs)[0],
                               rtol=1e-9, atol=1e-10)


def test_gplvm_shares_the_invalidation_helper(rng):
    mdl = rt.BayesianGPLVM(rng.standard_normal((20, 3)), 2, num_inducing=4,
                           device=CPU)
    st1 = mdl._stats()
    assert mdl._stats() is st1
    mdl._invalidate_posterior()
    assert mdl._stats_cache is None
    assert mdl._stats() is not st1


# -- PredictEngine.ingest / forget / swap_state ----------------------------------------

def test_ingest_and_forget_match_jax_engine(rng):
    from repro.serve import PredictEngine as JEngine

    hyp, x, y, z, _ = _problem(seed=8)
    xb, yb = rng.standard_normal((5, 2)), rng.standard_normal((5, 2))
    xs = rng.standard_normal((19, 2))
    eng = rt.PredictEngine(_t_state(hyp, z, x, y), block_size=8, device=CPU)
    jeng = JEngine(_j_state(hyp, z, x, y), block_size=8)
    m0, v0 = eng.predict(xs)
    res = eng.ingest(xb, yb)
    jres = jeng.ingest(jnp.asarray(xb), jnp.asarray(yb))
    assert res.fallback is jres.fallback is False
    assert eng.state is res.state
    mean, var = eng.predict(xs)
    jmean, jvar = jeng.predict(xs)
    np.testing.assert_allclose(mean.numpy(), np.asarray(jmean), rtol=1e-9,
                               atol=1e-10)
    np.testing.assert_allclose(var.numpy(), np.asarray(jvar), rtol=1e-9,
                               atol=1e-10)
    res = eng.forget(xb, yb)
    assert res.fallback is False
    m1, v1 = eng.predict(xs)
    np.testing.assert_allclose(m1.numpy(), m0.numpy(), rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(v1.numpy(), v0.numpy(), rtol=1e-10, atol=1e-12)


def test_swap_state_refuses_other_kernels_and_shapes_and_rebuilds_width():
    hyp, x, y, z, _ = _problem(seed=9)
    state = _t_state(hyp, z, x, y)
    eng = rt.PredictEngine(state, device=CPU, compute_dtype=torch.float32)
    other = _t_state(hyp, z[:5], x, y)
    with pytest.raises(ValueError, match="identical leaf shapes"):
        eng.swap_state(other)
    zoo = rt.extract_state(
        {"k0": {"log_sf2": _t(0.3), "log_ell": _t(np.zeros(1))},
         "k1": {"log_sv2": _t(np.zeros(1))}, "log_beta": _t(1.2)}, _t(z),
        t_stats.partial_stats(
            {"k0": {"log_sf2": _t(0.3), "log_ell": _t(np.zeros(1))},
             "k1": {"log_sv2": _t(np.zeros(1))}, "log_beta": _t(1.2)},
            _t(z), _t(y), _t(x),
            kernel=tcov.Sum(tcov.SEARD(dims=(0,)), tcov.Linear(dims=(1,)))),
        kernel=tcov.Sum(tcov.SEARD(dims=(0,)), tcov.Linear(dims=(1,))),
        device=CPU)
    with pytest.raises(ValueError, match="same kernel expression"):
        eng.swap_state(zoo)
    new = t_online.update_state(state, _t(x[:3]), _t(y[:3])).state
    eng.swap_state(new)
    assert eng.state is new
    assert eng.compute_state.g.dtype == torch.float32
    torch.testing.assert_close(eng.compute_state.g, new.g.float(), rtol=0,
                               atol=0)


# -- DistributedGP's serve side and the update step (a world of one) ---------------

def test_distributed_online_methods_in_a_world_of_one():
    from repro_torch.train.steps import make_gp_update_step

    hyp, x, y, z, rng = _problem(seed=10)
    th = {k: _t(v) for k, v in hyp.items()}
    eng, fold = make_gp_update_step(None, 2, device=CPU)
    data, w = eng.put_data(y=y, mu=x)
    base = eng.reduced_stats(2)(th, _t(z), data["y"], data["mu"], None, w,
                                np.ones(1))
    xb, yb = rng.standard_normal((7, 2)), rng.standard_normal((7, 2))
    new, wn = eng.put_data(y=yb, mu=xb)
    folded = fold(base, th, _t(z), new["y"], new["mu"], None, wn, np.ones(1))
    union = t_stats.partial_stats(th, _t(z), _t(np.vstack([y, yb])),
                                  _t(np.vstack([x, xb])))
    for f, a, b in zip(t_stats.Stats._fields, folded, union):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-12,
                                   atol=1e-12, err_msg=f)
    state = rt.extract_state(th, _t(z), base, device=CPU)
    up = eng.update_predictive_state(state, _t(xb), _t(yb))
    assert up.fallback is False
    _close(up.state, rt.extract_state(th, _t(z), folded, device=CPU), 1e-8,
           1e-9, fields=STATE_FIELDS + ("chol_kmm",))
    dn = eng.downdate_predictive_state(up.state, _t(xb), _t(yb))
    assert dn.fallback is False
    _close(dn.state, state, 1e-9, 1e-10, fields=_ARRAY_FIELDS)
