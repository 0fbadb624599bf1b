"""The port's CUDA kernels on the card (marker ``cuda``; skipped elsewhere).

This file imports no JAX, so it runs on a machine with the card and no JAX:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Each kernel is held against its plain PyTorch version in f64 on the same
values, with a forward-error bound at the kernel's dtype tier:
``|err| <= rtol |plain| + atol |plain on |operands||``, the f32 tier
(2e-4, 1e-5) or an f64 tier (1e-10, 1e-11) that a double instantiation
computing partly in f32 would miss.
"""
import numpy as np
import pytest
import torch

import repro_torch as rt
from repro_torch.kernels.predict import ops as p_ops
from repro_torch.kernels.predict import ref as p_ref
from repro_torch.kernels.reg_stats import ops as rs_ops
from repro_torch.kernels.reg_stats import ref as rs_ref

pytestmark = pytest.mark.cuda

DTYPES = [torch.float32, torch.float64]
TIERS = {torch.float32: (2e-4, 1e-5), torch.float64: (1e-10, 1e-11)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


def _t(a, device, dtype=torch.float64):
    return torch.from_numpy(np.array(a, dtype=np.float64)).to(device, dtype)


def _within(got, plain, plain_abs):
    rtol, atol = TIERS[got.dtype]
    return bool((got.double() - plain).abs()
                .le(rtol * plain.abs() + atol * plain_abs.abs()).all())


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n,m,q,d", [(64, 16, 2, 1), (100, 37, 3, 2),
                                     (257, 64, 10, 5), (32, 130, 1, 3),
                                     (5000, 200, 8, 4)])
def test_reg_stats_matches_plain(cuda, n, m, q, d, dtype):
    rng = np.random.default_rng(n + m)
    hyp = {"log_sf2": _t(rng.uniform(-0.5, 0.8), cuda),
           "log_ell": _t(rng.uniform(-0.4, 0.4, q), cuda)}
    z, x, y = (_t(rng.standard_normal(s), cuda, dtype)
               for s in ((m, q), (n, q), (n, d)))
    w = _t(rng.uniform(size=n) > 0.15, cuda, dtype)
    name = str(dtype).removeprefix("torch.")
    before = rs_ops.LAUNCHES[name]
    got = rs_ops.reg_stats(hyp, z, x, y, w)
    assert rs_ops.LAUNCHES[name] == before + 1
    assert all(g.dtype == dtype for g in got)
    z, x, y, w = (v.double() for v in (z, x, y, w))
    plain = rs_ref.reg_stats_ref(hyp["log_sf2"], hyp["log_ell"], z, x, y, w)
    plain_abs = rs_ref.reg_stats_ref(hyp["log_sf2"], hyp["log_ell"], z, x,
                                     y.abs(), w)
    for g, p, pa in zip(got, plain, plain_abs):
        assert _within(g, p, pa)
    assert torch.equal(got[2], got[2].T)


def test_reg_stats_refuses_grad(cuda):
    z, x, y = (torch.randn(s, dtype=torch.float64, device=cuda)
               for s in ((8, 2), (40, 2), (40, 1)))
    hyp = {"log_sf2": torch.zeros((), dtype=torch.float64, device=cuda),
           "log_ell": torch.zeros(2, dtype=torch.float64, device=cuda)}
    z.requires_grad_(True)
    with pytest.raises(RuntimeError, match="no backward"):
        rs_ops.reg_stats(hyp, z, x, y, torch.ones_like(x[:, 0]))


def _predict_inputs(seed, t, m, q, d, device, dtype):
    rng = np.random.default_rng(seed)
    hyp = {"log_sf2": _t(rng.uniform(-0.5, 0.8), device, dtype),
           "log_ell": _t(rng.uniform(-0.4, 0.4, q), device, dtype)}
    g = rng.standard_normal((m, m))
    return (hyp, _t(rng.standard_normal((m, q)), device, dtype),
            _t(rng.standard_normal((m, d)), device, dtype),
            _t(g + g.T, device, dtype),
            _t(rng.standard_normal((t, q)), device, dtype))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("t,m,q,d", [(64, 16, 2, 1), (100, 37, 3, 2),
                                     (33, 130, 9, 5), (1000, 512, 8, 4)])
def test_predict_matches_plain(cuda, t, m, q, d, dtype):
    hyp, z, a_mean, g, x = _predict_inputs(t + m, t, m, q, d, cuda, dtype)
    name = str(dtype).removeprefix("torch.")
    before = p_ops.LAUNCHES[name]
    got = p_ops.predict_stats(hyp, z, a_mean, g, x)
    assert p_ops.LAUNCHES[name] == before + 1
    h64 = [v.double() for v in (hyp["log_sf2"], hyp["log_ell"])]
    z, a_mean, g, x = (v.double() for v in (z, a_mean, g, x))
    plain = p_ref.predict_ref(*h64, z, a_mean, g, x)
    plain_abs = p_ref.predict_ref(*h64, z, a_mean.abs(), g.abs(), x)
    for r, p, pa in zip(got, plain, plain_abs):
        assert _within(r, p, pa)


@pytest.mark.parametrize("dtype", DTYPES)
def test_predict_rows_do_not_depend_on_padding(cuda, dtype):
    """Output rows are bitwise the same whatever batch they arrive in."""
    hyp, z, a_mean, g, x = _predict_inputs(9, 45, 130, 3, 2, cuda, dtype)
    mean, quad = p_ops.predict_stats(hyp, z, a_mean, g, x)
    padded = torch.cat([x.flip(0), x, torch.zeros_like(x)])
    mean_p, quad_p = p_ops.predict_stats(hyp, z, a_mean, g, padded)
    assert torch.equal(mean_p[45:90], mean) and torch.equal(quad_p[45:90], quad)


def test_slice_on_cuda_matches_cpu(cuda):
    """SGPR -> state -> engine on the card (f64 instantiations) against the
    same slice on the CPU (plain versions)."""
    rng = np.random.default_rng(0)
    x = rng.uniform(-2.0, 2.0, (3000, 3))
    y = np.sin(x @ rng.standard_normal((3, 2))) + 0.1 * rng.standard_normal(
        (3000, 2))
    xs = rng.uniform(-2.0, 2.0, (777, 3))
    outs = []
    for device in (cuda, "cpu"):
        model = rt.SGPR(x, y, num_inducing=40, device=device)
        eng = model.serve_engine(block_size=64)
        outs.append((model.log_bound(), *eng.predict(xs, include_noise=True)))
    (lb0, m0, v0), (lb1, m1, v1) = outs
    assert abs(lb0 - lb1) <= 1e-9 * abs(lb1)
    torch.testing.assert_close(m0.cpu(), m1, rtol=1e-8, atol=1e-10)
    torch.testing.assert_close(v0.cpu(), v1, rtol=1e-8, atol=1e-10)
