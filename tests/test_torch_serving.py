"""The port's serving slice as a whole against the JAX package.

One regression problem, its starting ``hyp`` and ``z`` carried from
``repro.core.SGPR`` to ``repro_torch.SGPR`` with ``convert.params_from_numpy``,
then: the map statistics, the bound, the extracted state, the engine's
predictions (against both JAX backends) and the checkpoint format, each at
the f64 tolerances the JAX package's own serving tests use.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch as rt
from repro.core import SGPR as JSGPR
from repro.core import bound as j_bound
from repro.core import init_utils as j_init
from repro.serve import PredictEngine as JEngine
from repro.serve import load_state as j_load_state
from repro.serve import save_state as j_save_state
from repro_torch import convert
from repro_torch.core import bound as t_bound
from repro_torch.core import covariance
from repro_torch.core import init_utils as t_init
from repro_torch.serve.posterior import _ARRAY_FIELDS

from conftest import make_regression

CPU = "cpu"


@pytest.fixture(scope="module")
def models():
    rng = np.random.default_rng(0)
    x, y = make_regression(rng, n=70, q=2, d=2)
    jm = JSGPR(x, y, num_inducing=10, seed=0)
    params = {"hyp": {k: np.asarray(v) for k, v in jm.params["hyp"].items()},
              "z": np.asarray(jm.params["z"])}
    tp = convert.params_from_numpy(params, CPU)
    tm = rt.SGPR(x, y, hyp=tp["hyp"], z=tp["z"], device=CPU)
    xs = rng.standard_normal((101, 2))
    return jm, tm, xs


def _leaves(state):
    return {"hyp": dict(state.hyp),
            **{f: getattr(state, f) for f in _ARRAY_FIELDS}}


def _np(v):
    return v.cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def test_stats_match(models):
    jm, tm, _ = models
    for name, a, b in zip(jm._stats()._fields, jm._stats(), tm._stats()):
        np.testing.assert_allclose(_np(b), _np(a), rtol=1e-12, atol=1e-12,
                                   err_msg=name)


def test_log_bound_matches(models):
    jm, tm, _ = models
    want = jm.log_bound()
    assert abs(tm.log_bound() - want) <= 1e-10 * abs(want)


def test_chunked_model_matches(models):
    jm, tm, _ = models
    ch = rt.SGPR(tm.x, tm.y, hyp=tm.params["hyp"], z=tm.params["z"],
                 chunk_size=16, device=CPU)
    want = jm.log_bound()
    assert abs(ch.log_bound() - want) <= 1e-10 * abs(want)


def test_state_leaves_match(models):
    jm, tm, _ = models
    js, ts = jm.predictive_state(), tm.predictive_state()
    assert (ts.m, ts.q, ts.d, ts.dtype) == (10, 2, 2, torch.float64)
    for f in _ARRAY_FIELDS:
        np.testing.assert_allclose(_np(getattr(ts, f)), _np(getattr(js, f)),
                                   rtol=1e-10, atol=1e-10, err_msg=f)
    for k in js.hyp:
        np.testing.assert_allclose(_np(ts.hyp[k]), _np(js.hyp[k]),
                                   rtol=1e-15, err_msg=k)


def test_optimal_qu_matches(models):
    jm, tm, _ = models
    for name, a, b in zip(jm.qu()._fields, jm.qu(), tm.qu()):
        np.testing.assert_allclose(_np(b), _np(a), rtol=1e-9, atol=1e-10,
                                   err_msg=name)


@pytest.mark.parametrize("backend", ["xla", "pallas"])
@pytest.mark.parametrize("t,block", [(1, 8), (37, 8), (64, 16), (101, 64)])
def test_engine_matches_jax_engine(models, backend, t, block):
    jm, tm, xs = models
    jeng = JEngine(jm.predictive_state(), block_size=block,
                   kernel_backend=backend)
    teng = rt.PredictEngine(tm.predictive_state(), block_size=block,
                            device=CPU)
    for noise in (False, True):
        m0, v0 = jeng.predict(jnp.asarray(xs[:t]), include_noise=noise)
        m1, v1 = teng.predict(xs[:t], include_noise=noise)
        assert m1.shape == (t, 2) and v1.shape == (t,)
        np.testing.assert_allclose(_np(m1), _np(m0), rtol=1e-9, atol=1e-11)
        np.testing.assert_allclose(_np(v1), _np(v0), rtol=1e-8, atol=1e-10)
    m0, c0 = jeng.predict_full_cov(jnp.asarray(xs[:t]), include_noise=True)
    m1, c1 = teng(xs[:t], full_cov=True, include_noise=True)
    np.testing.assert_allclose(_np(m1), _np(m0), rtol=1e-9, atol=1e-11)
    np.testing.assert_allclose(_np(c1), _np(c0), rtol=1e-8, atol=1e-10)


def test_model_predict_matches(models):
    jm, tm, xs = models
    for full_cov in (False, True):
        want = jm.predict(xs[:9], include_noise=True, full_cov=full_cov)
        got = tm.predict(xs[:9], include_noise=True, full_cov=full_cov)
        for a, b in zip(got, want):
            assert isinstance(a, np.ndarray)
            np.testing.assert_allclose(a, b, rtol=1e-8, atol=1e-10)


def test_engine_padding_and_empty_batch(models):
    _, tm, xs = models
    eng = rt.PredictEngine(tm.predictive_state(), block_size=8, device=CPU)
    mean, var = eng.predict(xs[:5])
    padded, t = eng.pad_queries(xs[:5])
    assert t == 5 and padded.shape == (8, 2)
    pm, pv = eng.run_blocks(padded, eng.compute_state)
    assert torch.equal(pm[:5], mean) and torch.equal(pv[:5], var)
    mean, var = eng.predict(np.zeros((0, 2)), include_noise=True)
    assert mean.shape == (0, 2) and var.shape == (0,)
    assert mean.dtype == var.dtype == eng.compute_dtype
    m_np, v_np = eng.predict_np(xs[:3])
    assert isinstance(m_np, np.ndarray) and v_np.shape == (3,)
    with pytest.raises(ValueError, match="block_size"):
        rt.PredictEngine(tm.predictive_state(), block_size=0, device=CPU)


def test_compute_dtype_resolution(models):
    _, tm, _ = models
    state = tm.predictive_state()
    assert rt.PredictEngine(state, device=CPU).compute_dtype == torch.float64
    for dt, want in [(torch.float32, torch.float32),
                     (torch.bfloat16, torch.float32),
                     (torch.float16, torch.float32)]:
        eng = rt.PredictEngine(state._to(dtype=dt), device=CPU)
        assert eng.compute_dtype == want
        assert eng.state.dtype == dt and eng.compute_state.dtype == want
    eng = rt.PredictEngine(state, compute_dtype=torch.float32, device=CPU)
    assert eng.predict(np.zeros((3, 2)))[0].dtype == torch.float32


def test_convert_state_from_numpy(models):
    jm, tm, xs = models
    js = jm.predictive_state()
    leaves = {"hyp": {k: np.asarray(v) for k, v in js.hyp.items()},
              **{f: np.asarray(getattr(js, f)) for f in _ARRAY_FIELDS}}
    ts = convert.state_from_numpy(leaves, CPU)
    m0, v0 = JEngine(js, block_size=16).predict(jnp.asarray(xs))
    m1, v1 = rt.PredictEngine(ts, block_size=16, device=CPU).predict(xs)
    np.testing.assert_allclose(_np(m1), _np(m0), rtol=1e-9, atol=1e-11)
    np.testing.assert_allclose(_np(v1), _np(v0), rtol=1e-8, atol=1e-10)


@pytest.mark.parametrize("dtype", ["float64", "float32", "bfloat16"])
def test_jax_saved_state_loads_in_port(models, tmp_path, dtype):
    jm, _, _ = models
    js = jm.predictive_state().astype(dtype)
    j_save_state(tmp_path / "st", js, metadata={"run": "jax"})
    ts, md = rt.load_state(tmp_path / "st", device=CPU)
    assert md["run"] == "jax" and md["dtype"] == dtype
    assert ts.kernel == covariance.SE_ARD
    want, got = _leaves(js), _leaves(ts)
    for f in _ARRAY_FIELDS:
        assert str(got[f].dtype) == f"torch.{dtype}"
        np.testing.assert_array_equal(_np(got[f].float()),
                                      _np(jnp.asarray(want[f], jnp.float32)))
        if dtype != "bfloat16":
            np.testing.assert_array_equal(_np(got[f]), _np(want[f]))
    for k in want["hyp"]:
        np.testing.assert_array_equal(_np(got["hyp"][k].double()),
                                      np.asarray(want["hyp"][k], np.float64))


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32,
                                   torch.bfloat16])
def test_port_saved_state_loads_in_jax(models, tmp_path, dtype):
    _, tm, _ = models
    ts = tm.predictive_state()._to(dtype=dtype)
    rt.save_state(tmp_path / "st", ts, metadata={"run": "torch"})
    js, md = j_load_state(tmp_path / "st")
    assert md["run"] == "torch"
    assert len(jax.tree.leaves(js)) == 9
    got, want = _leaves(js), _leaves(ts)
    for f in _ARRAY_FIELDS:
        np.testing.assert_array_equal(np.asarray(got[f], np.float64),
                                      _np(want[f].double()))
    for k in want["hyp"]:
        np.testing.assert_array_equal(np.asarray(got["hyp"][k], np.float64),
                                      _np(want["hyp"][k].double()))
    # and back: the port reloads its own file leaf for leaf
    back, _ = rt.load_state(tmp_path / "st", device=CPU)
    for f in _ARRAY_FIELDS:
        assert torch.equal(getattr(back, f), want[f])


def test_save_state_rejects_reserved_metadata(models, tmp_path):
    _, tm, _ = models
    with pytest.raises(ValueError, match="reserved"):
        rt.save_state(tmp_path / "st", tm.predictive_state(),
                      metadata={"m": 3})


def test_bound_predict_matches(models):
    jm, tm, xs = models
    for full_cov in (False, True):
        want = j_bound.predict(jm.params["hyp"], jm.params["z"], jm.qu(),
                               jnp.asarray(xs[:11]), full_cov=full_cov,
                               include_noise=True)
        got = t_bound.predict(tm.params["hyp"], tm.params["z"], tm.qu(),
                              torch.from_numpy(xs[:11]), full_cov=full_cov,
                              include_noise=True)
        for a, b in zip(got, want):
            np.testing.assert_allclose(_np(a), _np(b), rtol=1e-8, atol=1e-10)


def test_init_utils_match(models):
    rng = np.random.default_rng(3)
    x, y = make_regression(rng, n=90, q=3, d=2)
    np.testing.assert_array_equal(t_init.kmeans(x, 7, iters=4, seed=1),
                                  j_init.kmeans(x, 7, iters=4, seed=1))
    for got in (t_init.default_hyp(y, 3),
                t_init.default_hyp_for(covariance.SE_ARD, y, 3)):
        want = j_init.default_hyp(y, 3)
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])


def test_only_se_ard_is_ported():
    """Only the full-width SE-ARD is the fused kernels' expression; since
    the kernel zoo (ROADMAP Queue 1 item 6) the other specs, which this
    test once found refused, parse to the JAX package's expressions."""
    from repro.core import covariance as j_cov

    assert covariance.is_fused_se(None) and covariance.is_fused_se("se")
    assert covariance.kernel_from_spec('{"kind": "se", "dims": null}') \
        == covariance.SE_ARD
    assert covariance.as_kernel("se") == covariance.SE_ARD
    assert covariance.SE_ARD.to_spec() == {"kind": "se", "dims": None}
    for spec in ('{"kind": "matern32"}', {"kind": "se", "dims": [0]}):
        got, want = covariance.as_kernel(spec), j_cov.as_kernel(spec)
        assert got.to_spec() == want.to_spec()
        assert not covariance.is_fused_se(got)
