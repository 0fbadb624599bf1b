"""The port's CUDA kernels on the card (marker ``cuda``; skipped elsewhere).

This file imports no JAX, so it runs on a machine with the card and no JAX:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Each GP kernel is held against its plain PyTorch version in f64 on the
same values, with a forward-error bound at the kernel's dtype tier:
``|err| <= rtol |plain| + atol |plain on |operands||``, the f32 tier
(2e-4, 1e-5) or an f64 tier (1e-10, 1e-11) that a double instantiation
computing partly in f32 would miss.  Flash attention is held to the tiers
of ``tests/test_kernels_pallas.py`` (``|err| <= tol (1 + |plain|)``, tol
2e-5 in f32, 2e-2 in bf16) against its plain version in f64.
"""
import numpy as np
import pytest
import torch

import repro_torch as rt
from repro_torch.configs import get_config
from repro_torch.data import sines_dataset
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention import ref as fa_ref
from repro_torch.kernels.predict import ops as p_ops
from repro_torch.kernels.predict import ref as p_ref
from repro_torch.kernels.psi_stats import ops as ps_ops
from repro_torch.kernels.psi_stats import ref as ps_ref
from repro_torch.kernels.reg_stats import ops as rs_ops
from repro_torch.kernels.reg_stats import ref as rs_ref
from test_torch_spawn import spawn_ranks

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


F64 = torch.float64
RS_CASES = [(*shape, dtype) for shape in [
    (64, 16, 2, 1), (100, 37, 3, 2), (257, 64, 10, 5), (32, 130, 1, 3),
    (5000, 200, 8, 4),
    # edges of the f64 kernel's 128-tiles, ragged n (15% zero weights)
    (1037, 130, 8, 4), (4099, 512, 8, 4), (2053, 600, 3, 2)]
    for dtype in DTYPES] + [
    # f64 past one 16-feature chunk and with wide y: any q and d fit (at
    # these q the kernel values sit near f32's underflow, so f64 only)
    (1037, 130, 40, 1, F64), (1037, 130, 8, 64, F64), (517, 130, 200, 3, F64)]


@pytest.mark.parametrize("n,m,q,d,dtype", RS_CASES)
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


@pytest.mark.parametrize("n,m,q,d,dtype", [
    (300, 23_200, 3, 2, torch.float32),   # 66,066 upper tiles: past gridDim.y
    (2053, 2048, 8, 4, F64)])             # 136 units on 132 SMs
def test_reg_stats_takes_any_m(cuda, n, m, q, d, dtype):
    """The (slice, upper tile) units on gridDim.x, one block each: past
    the old 65,535-tile limit in f32, and more units than SMs in f64 (136
    blocks of one per SM run in two waves), against the plain version at
    the dtype's tier."""
    rng = np.random.default_rng(n + m)
    hyp = {"log_sf2": _t(rng.uniform(-0.5, 0.8), cuda),
           "log_ell": _t(rng.uniform(-0.4, 0.4, q) + 0.5 * np.log(q), cuda)}
    z, x, y = (_t(rng.standard_normal(s), cuda, dtype)
               for s in ((m, q), (n, q), (n, d)))
    w = _t(rng.uniform(size=n) > 0.15, cuda, dtype)
    got = rs_ops.reg_stats(hyp, z, x, y, w)
    z, x, y, w = (v.double() for v in (z, x, y, w))
    plain = rs_ref.reg_stats_ref(hyp["log_sf2"], hyp["log_ell"], z, x, y, w)
    plain_abs = rs_ref.reg_stats_ref(hyp["log_sf2"], hyp["log_ell"], z, x,
                                     y.abs(), w)
    for g, p, pa in zip(got, plain, plain_abs):
        assert _within(g, p, pa)
    assert torch.equal(got[2], got[2].T)


def _grads(fn, inputs, cotangents):
    """Gradients of <cotangents, fn(*inputs)> with respect to every input."""
    leaves = [t.detach().requires_grad_(True) for t in inputs]
    outs = fn(*leaves)
    outs = outs if isinstance(outs, tuple) else (outs,)
    return torch.autograd.grad(outs, leaves, cotangents)


def _assert_grads_close(got, want):
    """The backward recomputes a plain f64 formulation, so the Function's
    gradients equal plain autograd's up to f64 rounding (the recompute's
    row chunks, and for reg_stats the dense expanded-square form): rtol
    1e-10."""
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-10, atol=1e-12)


def test_reg_stats_gradient(cuda):
    """The Function's backward (chunked dense recompute) against autograd
    of the plain version, f64, on every input."""
    rng = np.random.default_rng(4)
    n, m, q, d = 300, 37, 3, 2
    inputs = [_t(rng.uniform(-0.5, 0.8), cuda), _t(rng.uniform(-0.4, 0.4, q), cuda),
              _t(rng.standard_normal((m, q)), cuda),
              _t(rng.standard_normal((n, q)), cuda),
              _t(rng.standard_normal((n, d)), cuda),
              _t(rng.uniform(size=n) > 0.15, cuda)]
    cts = (_t(rng.standard_normal(()), cuda), _t(rng.standard_normal((m, d)), cuda),
           _t(rng.standard_normal((m, m)), cuda))

    def kernel(log_sf2, log_ell, z, x, y, w):
        return rs_ops.reg_stats({"log_sf2": log_sf2, "log_ell": log_ell},
                                z, x, y, w)

    _assert_grads_close(_grads(kernel, inputs, cts),
                        _grads(rs_ref.reg_stats_ref, inputs, cts))


def _psi_inputs(seed, n, m, q, device, dtype=torch.float64):
    rng = np.random.default_rng(seed)
    hyp = {"log_sf2": _t(rng.uniform(-0.5, 0.8), device),
           "log_ell": _t(rng.uniform(-0.4, 0.4, q), device)}
    z, mu = (_t(rng.standard_normal(sh), device, dtype)
             for sh in ((m, q), (n, q)))
    s = _t(rng.uniform(0.05, 0.8, (n, q)), device, dtype)
    w = _t(rng.uniform(size=n) > 0.15, device, dtype)
    return hyp, z, mu, s, w


PSI_CASES = [(*shape, dtype) for shape in [
    (64, 16, 2), (100, 37, 3), (257, 64, 10), (32, 130, 1), (1003, 37, 3),
    (5000, 150, 10)] for dtype in DTYPES] + [
    (1003, 37, 160, F64)]    # ten 16-feature chunks


@pytest.mark.parametrize("n,m,q,dtype", PSI_CASES)
def test_psi2_matches_plain(cuda, n, m, q, dtype):
    hyp, z, mu, s, w = _psi_inputs(n + m, n, m, q, cuda, dtype)
    name = str(dtype).removeprefix("torch.")
    before = ps_ops.LAUNCHES[f"psi2_{name}"]
    got = ps_ops.psi2(hyp, z, mu, s, w)
    assert ps_ops.LAUNCHES[f"psi2_{name}"] == before + 1
    assert got.dtype == dtype and got.shape == (m, m)
    assert torch.equal(got, got.T)
    args = [hyp["log_sf2"], hyp["log_ell"], *(v.double() for v in (z, mu, s, w))]
    plain = ps_ref.psi2_ref(*args, chunk=256)
    assert _within(got, plain, plain)     # every term is positive


@pytest.mark.parametrize("n,m,q,dtype", PSI_CASES)
def test_psi1_matches_plain(cuda, n, m, q, dtype):
    hyp, z, mu, s, _ = _psi_inputs(2 * n + m, n, m, q, cuda, dtype)
    name = str(dtype).removeprefix("torch.")
    before = ps_ops.LAUNCHES[f"psi1_{name}"]
    got = ps_ops.psi1(hyp, z, mu, s)
    assert ps_ops.LAUNCHES[f"psi1_{name}"] == before + 1
    assert got.dtype == dtype and got.shape == (n, m)
    plain = ps_ref.psi1_ref(hyp["log_sf2"], hyp["log_ell"],
                            *(v.double() for v in (z, mu, s)))
    assert _within(got, plain, plain)


PSI1_CASES = [(n, m, q, dtype) for n, m, q in [
    (4649, 150, 10), (1003, 37, 160), (1003, 63, 10), (1003, 65, 10),
    (1003, 151, 10), (0, 37, 3), (1, 37, 3), (1, 1, 2), (77, 1000, 5),
    (100_000, 100, 2)] for dtype in DTYPES]


@pytest.mark.parametrize("n,m,q,dtype", PSI1_CASES)
def test_psi1_units_match_plain(cuda, n, m, q, dtype):
    """psi1's units (rows by 16-byte runs of columns, all of m <= 256 in
    one) at gplvm-usps and gplvm-synth-100k, past one 16-feature chunk, at
    the run and 64-column edges, odd m (scalar stores), m past one unit,
    and n = 0, 1; lengthscales grow as sqrt(q), so values stay above f32's
    underflow at any q."""
    rng = np.random.default_rng(3 * n + m + q)
    hyp = {"log_sf2": _t(rng.uniform(-0.5, 0.8), cuda),
           "log_ell": _t(rng.uniform(-0.4, 0.4, q) + 0.5 * np.log(q), cuda)}
    z, mu = (_t(rng.standard_normal(sh), cuda, dtype) for sh in ((m, q), (n, q)))
    s = _t(rng.uniform(0.05, 0.8, (n, q)), cuda, dtype)
    got = ps_ops.psi1(hyp, z, mu, s)
    assert got.dtype == dtype and got.shape == (n, m)
    plain = ps_ref.psi1_ref(hyp["log_sf2"], hyp["log_ell"],
                            *(v.double() for v in (z, mu, s)))
    assert _within(got, plain, plain)


# psi2's packed patches across the 64-point tile and 4-point patch edges,
# one and ten 16-feature chunks, 15% zero weights (f32 only up to q 10:
# past that the values sit near f32's underflow at these inputs).
PSI2_EDGE_CASES = [(m, q, dtype) for m in (1, 63, 64, 65, 150, 151)
                   for q in (1, 2, 10, 160) for dtype in DTYPES
                   if dtype == F64 or q <= 10]


@pytest.mark.parametrize("m,q,dtype", PSI2_EDGE_CASES)
def test_psi2_patch_edges_match_plain(cuda, m, q, dtype):
    hyp, z, mu, s, w = _psi_inputs(7 * m + q, 300, m, q, cuda, dtype)
    assert bool((w == 0).any())
    got = ps_ops.psi2(hyp, z, mu, s, w)
    assert got.dtype == dtype and got.shape == (m, m)
    assert torch.equal(got, got.T)
    args = [hyp["log_sf2"], hyp["log_ell"], *(v.double() for v in (z, mu, s, w))]
    plain = ps_ref.psi2_ref(*args, chunk=64)
    assert _within(got, plain, plain)


@pytest.mark.parametrize("n,m,q", [(4649, 150, 10), (1003, 37, 160),
                                   (100_000, 100, 2)])
def test_psi2_is_exactly_symmetric_and_repeatable(cuda, n, m, q):
    """D is exactly symmetric and bitwise the same across runs: the slice
    partials and the thread groups' sums are added in a fixed order."""
    hyp, z, mu, s, w = _psi_inputs(n + q, n, m, q, cuda)
    first = ps_ops.psi2(hyp, z, mu, s, w)
    assert torch.equal(first, first.T)
    for _ in range(2):
        assert torch.equal(ps_ops.psi2(hyp, z, mu, s, w), first)


def test_psi2_midway_meets_the_f64_tier(cuda):
    """Rows whose means lie midway between far-apart inducing points (pairs
    at +-70 d_j, l^2 = q): the centred exponent's terms (~120) are largest
    against their sum there; D reaches down to exp(-490)."""
    rng = np.random.default_rng(12)
    n, m, q = 1003, 150, 10
    d = rng.standard_normal((m // 2, q))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    z = _t(np.concatenate([70.0 * d, -70.0 * d]), cuda)
    mu = _t(1e-3 * rng.standard_normal((n, q)), cuda)
    s = _t(rng.uniform(0.05, 1.0, (n, q)), cuda)
    w = _t(rng.uniform(size=n) > 0.15, cuda)
    hyp = {"log_sf2": _t(0.3, cuda), "log_ell": _t(np.full(q, 0.5 * np.log(q)),
                                                   cuda)}
    got = ps_ops.psi2(hyp, z, mu, s, w)
    plain = ps_ref.psi2_ref(hyp["log_sf2"], hyp["log_ell"], z, mu, s, w)
    assert float(plain.min()) > 0.0
    assert torch.equal(got, got.T)
    assert _within(got, plain, plain)


def test_psi2_zero_weights_and_tiles_do_not_leak(cuda):
    """Zero-weight rows contribute nothing: D over the rows with w = 1
    equals D over all rows with the rest masked, to f64 rounding."""
    hyp, z, mu, s, w = _psi_inputs(3, 1003, 70, 3, cuda)
    keep = w > 0
    full = ps_ops.psi2(hyp, z, mu, s, w)
    kept = ps_ops.psi2(hyp, z, mu[keep], s[keep], w[keep])
    torch.testing.assert_close(full, kept, rtol=1e-12, atol=0)


def test_psi_gradients(cuda):
    """Both Functions' backward (chunked plain recompute) against autograd
    of the plain version, f64, on every input."""
    hyp, z, mu, s, w = _psi_inputs(5, 300, 37, 3, cuda)
    rng = np.random.default_rng(6)

    def psi2(log_sf2, log_ell, z, mu, s, w):
        return ps_ops.psi2({"log_sf2": log_sf2, "log_ell": log_ell}, z, mu, s, w)

    def psi1(log_sf2, log_ell, z, mu, s):
        return ps_ops.psi1({"log_sf2": log_sf2, "log_ell": log_ell}, z, mu, s)

    inputs = [hyp["log_sf2"], hyp["log_ell"], z, mu, s, w]
    ct2 = (_t(rng.standard_normal((37, 37)), cuda),)
    _assert_grads_close(_grads(psi2, inputs, ct2),
                        _grads(ps_ref.psi2_ref, inputs, ct2))
    ct1 = (_t(rng.standard_normal((300, 37)), cuda),)
    _assert_grads_close(_grads(psi1, inputs[:5], ct1),
                        _grads(ps_ref.psi1_ref, inputs[:5], ct1))


def test_predict_refuses_grad(cuda):
    hyp, z, a_mean, g, x = _predict_inputs(2, 40, 8, 2, 1, cuda, torch.float64)
    x.requires_grad_(True)
    with pytest.raises(RuntimeError, match="no backward"):
        p_ops.predict_stats(hyp, z, a_mean, g, x)
    with torch.no_grad():
        p_ops.predict_stats(hyp, z, a_mean, g, x)


def _predict_inputs(seed, t, m, q, d, device, dtype, symmetric=True):
    """Queries, state and SE-ARD hyper-parameters; lengthscales grow as
    sqrt(q), so kernel values stay O(1) (and above f32's underflow) at any
    q."""
    rng = np.random.default_rng(seed)
    hyp = {"log_sf2": _t(rng.uniform(-0.5, 0.8), device, dtype),
           "log_ell": _t(rng.uniform(-0.4, 0.4, q) + 0.5 * np.log(q), device,
                         dtype)}
    g = rng.standard_normal((m, m))
    return (hyp, _t(rng.standard_normal((m, q)), device, dtype),
            _t(rng.standard_normal((m, d)), device, dtype),
            _t(g + g.T if symmetric else g, device, dtype),
            _t(rng.standard_normal((t, q)), device, dtype))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("t,m,q,d,symmetric", [
    (64, 16, 2, 1, True), (100, 37, 3, 2, True), (33, 130, 9, 5, True),
    (1000, 512, 8, 4, True),
    (1000, 512, 8, 4, False),     # g as given, not symmetric
    # m past one block's slab, q past one 16-feature chunk
    (300, 1024, 8, 4, True), (200, 2048, 3, 2, True), (200, 130, 300, 2, True)])
def test_predict_matches_plain(cuda, t, m, q, d, symmetric, dtype):
    hyp, z, a_mean, g, x = _predict_inputs(t + m, t, m, q, d, cuda, dtype,
                                           symmetric)
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
@pytest.mark.parametrize("m", [130, 1030, 2048])
def test_predict_past_a_block_edge_matches_plain(cuda, m, dtype):
    """t = 129, one row past the f32 kernel's 128-row block (and two f64
    blocks), q = 300 (19 feature chunks), m past one and several 128-point
    tiles; its rows bitwise the same inside a padded batch that puts them
    across block edges."""
    t, q, d = 129, 300, 2
    hyp, z, a_mean, g, x = _predict_inputs(t + m, t, m, q, d, cuda, dtype)
    got = p_ops.predict_stats(hyp, z, a_mean, g, x)
    h64 = [v.double() for v in (hyp["log_sf2"], hyp["log_ell"])]
    z64, a64, g64, x64 = (v.double() for v in (z, a_mean, g, x))
    plain = p_ref.predict_ref(*h64, z64, a64, g64, x64)
    plain_abs = p_ref.predict_ref(*h64, z64, a64.abs(), g64.abs(), x64)
    for r, p, pa in zip(got, plain, plain_abs):
        assert _within(r, p, pa)
    padded = torch.cat([x[:100], x, x.flip(0)])
    mean_p, quad_p = p_ops.predict_stats(hyp, z, a_mean, g, padded)
    assert torch.equal(mean_p[100:229], got[0])
    assert torch.equal(quad_p[100:229], got[1])


@pytest.mark.parametrize("m", [130, 1030])
@pytest.mark.parametrize("dtype", DTYPES)
def test_predict_rows_do_not_depend_on_padding(cuda, dtype, m):
    """Output rows are bitwise the same whatever batch they arrive in."""
    hyp, z, a_mean, g, x = _predict_inputs(9, 45, m, 3, 2, cuda, dtype)
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


def test_gplvm_slice_on_cuda_matches_cpu(cuda):
    """BayesianGPLVM -> bound and gradient -> state -> engine on the card
    (psi kernels, f64) against the same slice on the CPU, at the same
    params: the init, then the card's fitted params.  The two sides sum the
    statistics in other orders and factor Sigma = Kmm + beta D with
    cuSOLVER and with the CPU's LAPACK; the bound's cancellation amplifies
    that f64 rounding (on an H100: value 2.2e-10, gradient 1.3e-8
    normwise): value and fitted bound 1e-9, gradient 1e-7, served latents
    rtol 1e-7.  SCG itself is not compared across devices: its
    finite-difference curvature probe turns 1e-8 gradient differences into
    different step sizes within a few iterations."""
    y, _ = sines_dataset(np.random.default_rng(1), n=400, noise=0.1)
    gpu = rt.BayesianGPLVM(y, q=2, num_inducing=20, device=cuda)
    cpu = rt.BayesianGPLVM(y, q=2, num_inducing=20, device="cpu")
    (v0, g0), (v1, g1) = gpu._neg_vg(), cpu._neg_vg()
    assert abs(v0 - v1) <= 1e-9 * abs(v1)
    assert np.linalg.norm(g0 - g1) <= 1e-7 * np.linalg.norm(g1)
    b0 = gpu.log_bound()
    gpu.fit(max_iters=5)
    assert gpu.log_bound() > b0
    cpu.params = {k: ({kk: vv.cpu() for kk, vv in v.items()}
                      if isinstance(v, dict) else v.cpu())
                  for k, v in gpu.params.items()}
    lb0, lb1 = gpu.log_bound(), cpu.log_bound()
    assert abs(lb0 - lb1) <= 1e-9 * abs(lb1)
    outs = [m.serve_engine(block_size=64).predict(m.params["mu"],
                                                  include_noise=True)
            for m in (gpu, cpu)]
    for a, b in zip(*outs):
        torch.testing.assert_close(a.cpu(), b, rtol=1e-7, atol=1e-9)


def test_f32_psi_statistics_break_the_factorisation_at_gplvm_usps(cuda):
    """Why the GPLVM takes the double instantiations: at gplvm-usps (n =
    4649, d = 256, q = 10, m = 150, the model's init) the f32 psi kernels'
    statistics (D within 1e-6 of the f64 ones) leave
    I + beta L^-1 D L^-T indefinite, so extract_state's Cholesky fails;
    the f64 statistics serve."""
    from repro_torch.core import stats as st
    from repro_torch.data import usps_like

    y, _ = usps_like(np.random.default_rng(0), 4649)
    model = rt.BayesianGPLVM(y, q=10, num_inducing=150, device=cuda)
    p = model.params
    s = torch.exp(p["log_s"])
    f32 = torch.float32
    s64 = st.partial_stats(p["hyp"], p["z"], model.y, p["mu"], s, latent=True)
    s32 = st.partial_stats(p["hyp"], p["z"].to(f32), model.y.to(f32),
                           p["mu"].to(f32), s.to(f32), latent=True)
    s32 = st.Stats(*(t.double() for t in s32))
    assert float((s32.D - s64.D).abs().max() / s64.D.abs().max()) < 1e-6
    rt.extract_state(p["hyp"], p["z"], s64, jitter=model.jitter, device=cuda)
    with pytest.raises(torch.linalg.LinAlgError, match="positive-definite"):
        rt.extract_state(p["hyp"], p["z"], s32, jitter=model.jitter,
                         device=cuda)


FA_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
# The sweep of tests/test_kernels_pallas.py, a causal T > S case whose first
# T - S rows see no key, and llama3.2-1b's prefill attention (B 4, H 32,
# Hkv 8, T = S = 2048, Dh 64).
FA_SHAPES = [(2, 4, 2, 64, 64, 64, True), (1, 8, 1, 70, 70, 64, True),
             (1, 4, 4, 33, 90, 128, True), (2, 2, 2, 96, 48, 64, False),
             (1, 4, 2, 64, 64, 64, True), (1, 4, 4, 1, 57, 64, True),
             (1, 2, 1, 96, 48, 64, True), (4, 32, 8, 2048, 2048, 64, True),
             # across the bf16 kernel's 128-row and 128-key tile edges:
             # group 1, 4 and 8, Dh 64 and 128, causal T > S and T < S, T = 1
             (1, 4, 4, 127, 127, 64, True), (1, 8, 2, 129, 129, 128, True),
             (2, 8, 1, 255, 255, 64, True), (1, 8, 1, 255, 129, 128, True),
             (1, 4, 1, 129, 255, 64, True), (1, 4, 4, 1, 255, 128, True),
             (1, 8, 2, 127, 255, 64, False), (1, 8, 8, 255, 127, 128, False)]


def _fa_inputs(seed, b, h, hkv, t, s, dh, device, dtype):
    rng = np.random.default_rng(seed)
    return tuple(_t(rng.standard_normal(sh), device, dtype)
                 for sh in ((b, h, t, dh), (b, hkv, s, dh), (b, hkv, s, dh)))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,hkv,t,s,dh,causal", FA_SHAPES)
def test_flash_attention_matches_plain(cuda, b, h, hkv, t, s, dh, causal,
                                       dtype):
    q, k, v = _fa_inputs(t + s, b, h, hkv, t, s, dh, cuda, dtype)
    name = str(dtype).removeprefix("torch.")
    before = fa_ops.LAUNCHES[name]
    got = fa_ops.flash_attention(q, k, v, causal=causal)
    assert fa_ops.LAUNCHES[name] == before + 1
    assert got.dtype == dtype and got.shape == (b, h, t, dh)
    plain = fa_ref.attention_ref(q.double(), k.double(), v.double(),
                                 causal=causal, chunk=256)
    tol = FA_TOL[dtype]
    assert bool(((got.double() - plain).abs()
                 <= tol * (1 + plain.abs())).all())
    if causal and t > s:
        assert bool((got[:, :, :t - s] == 0).all())
        assert bool((got[:, :, t - s:].abs().amax(-1) > 0).all())


# Across the f32 kernel's blocks: 128 query rows packed from the heads of
# one kv group (group 1, 3, 4, 6, 8, 16: 1, 1, 4, 2, 8, 8 heads a block),
# 64-key tiles at Dh 64, 32-key at Dh 128; T = 1, T < S, T > S (rows
# without a visible key), non-causal.
FA32_SHAPES = [(1, 4, 1, 257, 257, 64, True), (2, 8, 1, 33, 300, 64, True),
               (2, 2, 2, 300, 100, 64, True), (1, 8, 8, 1, 70, 64, False),
               (1, 8, 8, 1, 70, 64, True), (1, 8, 1, 129, 65, 128, True),
               (1, 4, 2, 200, 333, 128, False), (1, 6, 2, 100, 100, 64, True),
               (1, 12, 2, 70, 130, 64, True), (1, 16, 1, 65, 65, 128, True),
               (1, 4, 1, 513, 513, 64, False)]


@pytest.mark.parametrize("b,h,hkv,t,s,dh,causal", FA32_SHAPES)
def test_flash_attention_f32_tiles_and_groups(cuda, b, h, hkv, t, s, dh,
                                              causal):
    q, k, v = _fa_inputs(3 * t + s, b, h, hkv, t, s, dh, cuda, torch.float32)
    got = fa_ops.flash_attention(q, k, v, causal=causal)
    plain = fa_ref.attention_ref(q.double(), k.double(), v.double(),
                                 causal=causal, chunk=256)
    assert bool(((got.double() - plain).abs()
                 <= FA_TOL[torch.float32] * (1 + plain.abs())).all())
    if causal and t > s:      # rows without a visible key: exactly 0
        assert bool((got[:, :, :t - s] == 0).all())


@pytest.mark.parametrize("offset", [0, 1])
def test_flash_attention_f32_reads_unaligned_views(cuda, offset):
    """f32 q, k and v views whose bases or strides are not 16-byte aligned
    (a 65-wide buffer sliced to 64) are read in place, bitwise as their
    contiguous copies."""
    rng = np.random.default_rng(8)
    q, k, v = (_t(rng.standard_normal(sh), cuda, torch.float32)[..., offset:offset + 64]
               for sh in ((2, 100, 8, 65), (2, 100, 2, 65), (2, 100, 2, 65)))
    views = [x.transpose(1, 2) for x in (q, k, v)]
    got = fa_ops.flash_attention(*views)
    want = fa_ops.flash_attention(*(x.contiguous() for x in views))
    assert torch.equal(got, want)


@pytest.mark.parametrize("t,dh", [(100, 64), (129, 128)])
def test_flash_attention_reads_strided_views(cuda, t, dh):
    """The model passes (B,T,H,Dh) tensors transposed to (B,H,T,Dh): the
    kernel reads them in place and gives the contiguous result bitwise."""
    rng = np.random.default_rng(7)
    q, k, v = (_t(rng.standard_normal(sh), cuda, torch.bfloat16)
               for sh in ((2, t, 8, dh), (2, t, 2, dh), (2, t, 2, dh)))
    views = [x.transpose(1, 2) for x in (q, k, v)]
    assert not views[0].is_contiguous()
    got = fa_ops.flash_attention(*views)
    want = fa_ops.flash_attention(*(x.contiguous() for x in views))
    assert torch.equal(got, want)


def test_flash_attention_refuses_what_it_cannot_run(cuda):
    q, k, v = _fa_inputs(1, 1, 4, 2, 16, 16, 64, cuda, torch.float32)
    for dh in (16, 96):
        args = _fa_inputs(1, 1, 4, 2, 16, 16, dh, cuda, torch.float32)
        with pytest.raises(ValueError, match="head dim"):
            fa_ops.flash_attention(*args)
    for dtype in (torch.float16, torch.float64):
        with pytest.raises(ValueError, match="bfloat16"):
            fa_ops.flash_attention(*(x.to(dtype) for x in (q, k, v)))
    with pytest.raises(ValueError, match="multiple"):
        fa_ops.flash_attention(q, k[:, :1].expand(1, 3, 16, 64), v)
    with pytest.raises(ValueError, match="contiguous"):
        fa_ops.flash_attention(*(torch.cat([x, x], -1)[..., ::2]
                                 for x in (q, k, v)))
    with pytest.raises(ValueError, match="one CUDA device"):
        fa_ops.flash_attention(q, k.cpu(), v)
    # bf16 goes through TMA: 16-byte aligned bases and strides, or refused
    qb, kb, vb = (x.to(torch.bfloat16) for x in (q, k, v))
    shifted = torch.zeros(qb.numel() + 1, dtype=torch.bfloat16,
                          device=cuda)[1:].view(qb.shape)
    with pytest.raises(ValueError, match="base address is not 16-byte"):
        fa_ops.flash_attention(shifted, kb, vb)
    padded = torch.zeros((1, 2, 16, 68), dtype=torch.bfloat16,
                         device=cuda)[..., :64]     # rows of 136 bytes
    with pytest.raises(ValueError, match="stride over T is not a multiple"):
        fa_ops.flash_attention(qb, padded, vb)
    q.requires_grad_(True)
    with pytest.raises(RuntimeError, match="no backward"):
        fa_ops.flash_attention(q, k, v)
    with torch.no_grad():
        fa_ops.flash_attention(q, k, v)


def test_lm_prefill_and_decode_on_cuda_match_cpu(cuda):
    """llama3.2-1b reduced, with head dim 64 (a kernel instantiation), in
    f32: prefill logits and caches, then one decode step into a grown
    cache, on the card (flash kernel) against the CPU (plain version).
    The card and the CPU sum in other orders: rtol/atol 1e-4, as the CPU
    parity against the JAX package."""
    import dataclasses

    from repro_torch.models import transformer as tf
    from repro_torch.models.common import tree_map
    from repro_torch.train import steps

    cfg = dataclasses.replace(get_config("llama3.2-1b").reduced(),
                              head_dim=64)
    params = tf.init_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu")
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 77)))
    pos = torch.full((2,), 76, dtype=torch.int32)
    outs = []
    for device in (cuda, "cpu"):
        p = tree_map(lambda a, d=device: a.to(d), params)
        before = fa_ops.LAUNCHES["float32"]
        logits, caches = steps.make_prefill_step(cfg)(
            p, {"tokens": tokens[:, :76].to(device)})
        launched = fa_ops.LAUNCHES["float32"] - before
        grown = tf.init_decode_cache(cfg, 2, 77, device=device)
        for name, c in caches["g0"].items():
            grown["g0"][name][:, :, :76] = c
        logits2, _ = steps.make_serve_step(cfg)(
            p, grown, tokens[:, 76:].to(device), pos.to(device))
        outs.append((launched, logits.cpu(), caches["g0"]["k"].cpu(),
                     logits2.cpu()))
    (n_gpu, *gpu), (n_cpu, *cpu) = outs
    assert n_gpu == cfg.num_layers and n_cpu == 0
    for a, b in zip(gpu, cpu):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)


# -- the distributed engine on the card --------------------------------------

def _dist_inputs(n=3001, m=40, q=3, d=2):
    rng = np.random.default_rng(5)
    x = rng.uniform(-2.0, 2.0, (n, q))
    y = np.sin(x @ rng.standard_normal((q, d))) + 0.1 * rng.standard_normal(
        (n, d))
    z = x[rng.choice(n, m, replace=False)]
    hyp = {"log_sf2": np.float64(0.2), "log_ell": np.full(q, 0.1),
           "log_beta": np.float64(2.0)}
    return x, y, z, hyp


def _dist_args(eng, x, y, z, hyp):
    data, w = eng.put_data(y=y, mu=x)
    params = ({k: _t(v, eng.device) for k, v in hyp.items()},
              _t(z, eng.device))
    return params, data, w


def test_distributed_world_of_one_over_nccl_matches_sgpr(cuda):
    """A world of one over NCCL: value and gradient against
    ``SGPR._neg_vg`` at the same params (value 1e-9, gradient 1e-8
    relative), the map through the reg_stats kernel."""
    import torch.distributed as dist

    from repro_torch.core.flat import Flat
    from repro_torch.launch import make_data_group

    x, y, z, hyp = _dist_inputs()
    group = make_data_group(cuda)
    try:
        assert dist.get_backend(group) == "nccl"
        eng = rt.DistributedGP(group, device=cuda)
        (h, zz), data, w = _dist_args(eng, x, y, z, hyp)
        before = rs_ops.LAUNCHES["float64"]
        v, (gh, gz) = eng.make_value_and_grad(y.shape[1])(
            h, zz, data["mu"], None, data["y"], w, np.ones(1), float(len(x)))
        assert rs_ops.LAUNCHES["float64"] == before + 1
    finally:
        dist.destroy_process_group()
    model = rt.SGPR(x, y, hyp=hyp, z=z, device=cuda)
    v_ref, g_ref = model._neg_vg()
    g = Flat(model.params).ravel({"hyp": gh, "z": gz})
    assert abs(float(v) - v_ref) <= 1e-9 * abs(v_ref)
    assert np.linalg.norm(g - g_ref) <= 1e-8 * np.linalg.norm(g_ref)


def _gloo_rank_on_card(rank, world, store_path, out_dir):
    import datetime
    import pathlib

    import torch.distributed as dist

    from repro_torch.launch import make_data_group

    group = make_data_group("cuda:0", backend="gloo",
                            store=dist.FileStore(store_path, world),
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=60))
    x, y, z, hyp = _dist_inputs()
    eng = rt.DistributedGP(group, device="cuda:0")
    (h, zz), data, w = _dist_args(eng, x, y, z, hyp)
    v, (gh, gz) = eng.make_value_and_grad(y.shape[1])(
        h, zz, data["mu"], None, data["y"], w, np.array([1.0, 0.0]),
        float(len(x)))
    np.savez(pathlib.Path(out_dir) / f"rank{rank}.npz", v=v.cpu().numpy(),
             gz=gz.cpu().numpy(),
             **{k: g.cpu().numpy() for k, g in gh.items()})
    dist.destroy_process_group()


def test_distributed_two_gloo_ranks_on_one_card_with_a_failed_rank(
        cuda, tmp_path):
    """Two ranks on the one card over gloo (NCCL refuses two ranks on one
    GPU), fmask (1, 0) under drop: every rank's value and gradient equal a
    single process's with rank 1's rows weighted 0 (value 1e-9, gradient
    1e-8 relative), and the ranks agree bitwise."""
    from repro_torch.core import bound as bound_mod
    from repro_torch.core.distributed import pad_and_shard
    from repro_torch.core.stats import partial_stats

    codes, _ = spawn_ranks(_gloo_rank_on_card, 2, tmp_path)
    assert codes == [0, 0], codes
    got = [dict(np.load(tmp_path / f"rank{r}.npz")) for r in range(2)]
    for k in got[0]:
        np.testing.assert_array_equal(got[0][k], got[1][k], err_msg=k)

    x, y, z, hyp = _dist_inputs()
    padded, w = pad_and_shard({"y": y, "mu": x}, 2)
    w[w.shape[0] // 2:] = 0.0                     # rank 1 failed
    h = {k: _t(v, cuda).requires_grad_() for k, v in hyp.items()}
    zz = _t(z, cuda).requires_grad_()
    st = partial_stats(h, zz, _t(padded["y"], cuda), _t(padded["mu"], cuda),
                       weights=_t(w, cuda))
    neg = -bound_mod.collapsed_bound(h, zz, st._replace(
        n=torch.tensor(float(len(x)), dtype=torch.float64, device=cuda)),
        y.shape[1])
    grads = torch.autograd.grad(neg, [*h.values(), zz])
    neg = float(neg.detach())
    assert abs(float(got[0]["v"]) - neg) <= 1e-9 * abs(neg)
    want = np.concatenate([g.cpu().numpy().ravel() for g in grads])
    have = np.concatenate([np.ravel(got[0][k]) for k in h]
                          + [got[0]["gz"].ravel()])
    assert np.linalg.norm(have - want) <= 1e-8 * np.linalg.norm(want)
