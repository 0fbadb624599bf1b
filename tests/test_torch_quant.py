"""Quantized serving states (``PredictiveState.astype`` / ``nbytes``) against
the JAX package.

``astype`` must give the reference's bits: on 1,000,000 seeded normals (f64
to f16 is where torch's own cast rounds twice, through f32, and JAX once)
and on a fitted state.  The port's engine on a quantized state is held to
JAX's ``PredictEngine`` on the same bits at the f32 tier (rtol 2e-4, atol
2e-5), and to ``tests/test_serving_quant.py``'s budgets on its fixed problem
against the f64 engine.  No strict ordering of errors across dtypes is
tested (the reference's property test of it is flaky, ROADMAP Queue 3
item 10).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch as rt
from repro.core import SGPR as JSGPR
from repro.serve import PredictEngine as JEngine
from repro_torch import convert
from repro_torch.serve.posterior import _ARRAY_FIELDS

from conftest import make_regression

CPU = "cpu"
DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16,
          "float32": torch.float32, "float64": torch.float64}
# tests/test_serving_quant.py:25-26
MEAN_BUDGET, VAR_BUDGET = 2e-2, 5e-3


@pytest.fixture(scope="module")
def fitted():
    """tests/test_serving_quant.py's fixed problem, fitted once by the JAX
    package; its state carried to the port leaf for leaf."""
    rng = np.random.default_rng(0)
    x, y = make_regression(rng, n=120, q=2, d=2)
    model = JSGPR(x, y, num_inducing=10, seed=0)
    model.fit(max_iters=40)
    xs = rng.uniform(-2.0, 2.0, size=(200, 2))
    js = model.predictive_state()
    leaves = {"hyp": {k: np.asarray(v) for k, v in js.hyp.items()},
              **{f: np.asarray(getattr(js, f)) for f in _ARRAY_FIELDS}}
    return js, convert.state_from_numpy(leaves, CPU), np.asarray(y), xs


def _leaves(state):
    return [*(state.hyp[k] for k in sorted(state.hyp)),
            *(getattr(state, f) for f in _ARRAY_FIELDS)]


def _bits(a) -> np.ndarray:
    """The raw bits of an array or tensor, as unsigned integers."""
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu()
        if a.dtype == torch.bfloat16:
            return a.view(torch.int16).numpy().view(np.uint16)
        a = a.numpy()
    a = np.asarray(a)
    return a.view({2: np.uint16, 4: np.uint32, 8: np.uint64}[a.itemsize])


@pytest.mark.parametrize("dtype", ["bfloat16", "float16", "float32"])
def test_astype_gives_jax_bits_on_a_million_normals(dtype):
    a = np.random.default_rng(0).standard_normal(1_000_000)
    state = rt.PredictiveState(
        hyp={"log_sf2": torch.tensor(0.3, dtype=torch.float64),
             "log_ell": torch.zeros(1, dtype=torch.float64),
             "log_beta": torch.tensor(1.0, dtype=torch.float64)},
        z=torch.from_numpy(a.reshape(-1, 1)),
        **{f: torch.zeros((1, 1), dtype=torch.float64)
           for f in _ARRAY_FIELDS[1:]})
    got = state.astype(DTYPES[dtype])
    assert got.z.dtype == DTYPES[dtype] and got.z.shape == (1_000_000, 1)
    want = jnp.asarray(a.reshape(-1, 1)).astype(jnp.dtype(dtype))
    np.testing.assert_array_equal(_bits(got.z), _bits(want))
    if dtype == "float16":
        # torch's own cast rounds f64 -> f16 through f32: astype must not.
        plain = torch.from_numpy(a).to(torch.float16)
        assert int((_bits(plain) != _bits(want).reshape(-1)).sum()) > 0


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_astype_of_a_fitted_state_gives_jax_bits(fitted, dtype):
    js, ts, _, _ = fitted
    jq, tq = js.astype(dtype), ts.astype(DTYPES[dtype])
    assert tq.dtype == DTYPES[dtype] and tq.kernel == ts.kernel
    for got, want in zip(_leaves(tq), _leaves(jq)):
        assert got.dtype == DTYPES[dtype]
        np.testing.assert_array_equal(_bits(got), _bits(want))
    # the stored state is left as it was
    assert all(t.dtype == torch.float64 for t in _leaves(ts))


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_nbytes_matches_jax(fitted, dtype):
    js, ts, _, _ = fitted
    assert ts.astype(DTYPES[dtype]).nbytes == js.astype(dtype).nbytes
    if dtype == "bfloat16":
        assert ts.astype(torch.bfloat16).nbytes * 4 == ts.nbytes


@pytest.mark.parametrize("dtype", ["bfloat16", "float16", "float32"])
def test_engine_on_quantized_state_matches_jax_engine(fitted, dtype):
    js, ts, _, xs = fitted
    jm, jv = JEngine(js.astype(dtype), block_size=64).predict(jnp.asarray(xs))
    eng = rt.PredictEngine(ts.astype(DTYPES[dtype]), block_size=64,
                           device=CPU)
    assert eng.compute_dtype == torch.float32
    tm, tv = eng.predict(xs)
    assert tm.dtype == tv.dtype == torch.float32
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), rtol=2e-4,
                               atol=2e-5)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=2e-4,
                               atol=2e-5)


@pytest.mark.parametrize("dtype", ["bfloat16", "float16", "float32"])
def test_quantized_serving_within_budget(fitted, dtype):
    """tests/test_serving_quant.py's bf16 budgets on its fixed problem,
    against the f64 engine, for every storage dtype."""
    _, ts, y, xs = fitted
    m64, v64 = rt.PredictEngine(ts, block_size=64, device=CPU).predict(xs)
    mq, vq = rt.PredictEngine(ts.astype(DTYPES[dtype]), block_size=64,
                              device=CPU).predict(xs, include_noise=False)
    mean_rmse = float(torch.sqrt(torch.mean((mq.double() - m64) ** 2))) \
        / float(np.std(y))
    var_rmse = float(torch.sqrt(torch.mean((vq.double() - v64) ** 2)))
    assert mean_rmse < MEAN_BUDGET and var_rmse < VAR_BUDGET, \
        (mean_rmse, var_rmse)


def test_compute_dtype_resolution(fitted):
    """tests/test_serving_quant.py:83-97: f32/f64 states keep their width,
    sub-f32 states lift to f32, an explicit compute_dtype wins, and the
    stored artifact keeps its own dtype."""
    _, ts, _, _ = fitted
    assert rt.PredictEngine(ts, device=CPU).compute_dtype == torch.float64
    for dt, want in [(torch.float32, torch.float32),
                     (torch.bfloat16, torch.float32),
                     (torch.float16, torch.float32)]:
        assert rt.PredictEngine(ts.astype(dt),
                                device=CPU).compute_dtype == want
    eng = rt.PredictEngine(ts.astype(torch.bfloat16),
                           compute_dtype=torch.float64, device=CPU)
    assert eng.compute_dtype == torch.float64
    assert eng.state.z.dtype == torch.bfloat16


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_quantized_state_roundtrips_through_jax_files(fitted, tmp_path,
                                                       dtype):
    """A quantized state saved by the port loads in JAX with the same bits,
    and the JAX package's file of the same state loads in the port."""
    from repro.serve import load_state as j_load_state
    from repro.serve import save_state as j_save_state

    js, ts, _, _ = fitted
    rt.save_state(tmp_path / "port", ts.astype(DTYPES[dtype]))
    back, _ = j_load_state(tmp_path / "port")
    for got, want in zip(jax.tree.leaves(back), jax.tree.leaves(
            js.astype(dtype))):
        np.testing.assert_array_equal(_bits(got), _bits(want))
    j_save_state(tmp_path / "jax", js.astype(dtype))
    loaded, md = rt.load_state(tmp_path / "jax", device=CPU)
    assert md["dtype"] == dtype
    for got, want in zip(_leaves(loaded), _leaves(ts.astype(DTYPES[dtype]))):
        np.testing.assert_array_equal(_bits(got), _bits(want))
