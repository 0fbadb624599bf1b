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
from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention import ref as fa_ref
from repro_torch.kernels.predict import ops as p_ops
from repro_torch.kernels.predict import ref as p_ref
from repro_torch.kernels.psi_stats import ops as ps_ops
from repro_torch.kernels.psi_stats import ref as ps_ref
from repro_torch.kernels.reg_stats import kernel as rs_k
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
    (1037, 130, 40, 1, F64), (1037, 130, 8, 64, F64), (517, 130, 200, 3, F64)
    ] + [(*shape, dtype) for shape in [
    # past the f64 forward's cluster (8 bands of 64 points) and the
    # backward's (8 column tiles of 128): m 1,030 (a ragged second group)
    # and 2,048 (two full groups)
    (1037, 1030, 3, 2), (517, 2048, 3, 2)] for dtype in DTYPES] + [
    # x and z shifted by +100 in every feature (OFFSETS)
    (4097, 512, 8, 4, F64)]
OFFSETS = {(4097, 512, 8, 4): 100.0}
RS_BWD_CASES = RS_CASES


@pytest.mark.parametrize("n,m,q,d,dtype", RS_CASES)
def test_reg_stats_matches_plain(cuda, n, m, q, d, dtype):
    rng = np.random.default_rng(n + m)
    hyp = {"log_sf2": _t(rng.uniform(-0.5, 0.8), cuda),
           "log_ell": _t(rng.uniform(-0.4, 0.4, q), cuda)}
    off = OFFSETS.get((n, m, q, d), 0.0)
    z, x, y = (_t(rng.standard_normal(s) + o, cuda, dtype)
               for s, o in (((m, q), off), ((n, q), off), ((n, d), 0.0)))
    w = _t(rng.uniform(size=n) > 0.15, cuda, dtype)
    name = str(dtype).removeprefix("torch.")
    before = rs_ops.LAUNCHES[name]
    got = rs_ops.reg_stats(hyp, z, x, y, w)
    again = rs_ops.reg_stats(hyp, z, x, y, w)
    assert rs_ops.LAUNCHES[name] == before + 2
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    assert all(g.dtype == dtype for g in got)
    z, x, y, w = (v.double() for v in (z, x, y, w))
    plain = rs_ref.reg_stats_ref(hyp["log_sf2"], hyp["log_ell"], z, x, y, w)
    plain_abs = rs_ref.reg_stats_ref(hyp["log_sf2"], hyp["log_ell"], z, x,
                                     y.abs(), w)
    for g, p, pa in zip(got, plain, plain_abs):
        assert _within(g, p, pa)
    assert torch.equal(got[2], got[2].T)


@pytest.mark.parametrize("n,m,q,d,dtype", [
    (300, 46_400, 3, 2, torch.float32),   # 66,066 upper 128-tiles: past gridDim.y
    (2053, 2048, 8, 4, F64)])             # 136 units on 132 SMs
def test_reg_stats_takes_any_m(cuda, n, m, q, d, dtype):
    """The (slice, upper tile) units on gridDim.x, one block each: past
    the old 65,535-tile limit in f32, and more units than SMs in f64 (136
    blocks of one per SM run in two waves), against the plain version at
    the dtype's tier.  Every row of D is held, 2,048 rows at a time (the
    whole plain D and its error tensors would not fit the card beside the
    kernel's at m 46,400), each block of rows equal to its block of
    columns."""
    rng = np.random.default_rng(n + m)
    hyp = {"log_sf2": _t(rng.uniform(-0.5, 0.8), cuda),
           "log_ell": _t(rng.uniform(-0.4, 0.4, q) + 0.5 * np.log(q), cuda)}
    z, x, y = (_t(rng.standard_normal(s), cuda, dtype)
               for s in ((m, q), (n, q), (n, d)))
    w = _t(rng.uniform(size=n) > 0.15, cuda, dtype)
    got = rs_ops.reg_stats(hyp, z, x, y, w)
    z, x, y, w = (v.double() for v in (z, x, y, w))
    ell, sf2 = torch.exp(hyp["log_ell"]), torch.exp(hyp["log_sf2"])
    knm = sf2 * torch.exp(-0.5 * (((x[:, None, :] - z[None, :, :]) / ell) ** 2)
                          .sum(-1))
    wknm = w[:, None] * knm
    plain_b = sf2 * w.sum()
    assert _within(got[0], plain_b, plain_b)
    assert _within(got[1], wknm.T @ y, wknm.T @ y.abs())
    for lo in range(0, m, 2048):
        blk = slice(lo, min(m, lo + 2048))
        plain_d = wknm[:, blk].T @ knm
        assert _within(got[2][blk], plain_d, plain_d)
        assert torch.equal(got[2][blk], got[2][:, blk].T)


FOLD_ROWS = 4096   # rows between the f32 kernel's Kahan folds (FOLD_CHUNKS)
F32_RS_CASES = [   # n, m, q, d, whether a slice outlasts one fold
    (20, 127, 3, 2, False),      # n below one 32-row chunk, m below one tile
    (1037, 129, 20, 3, False),   # q past one 16-feature chunk, m past a tile
    (1037, 257, 8, 12, False),   # d past the 8 staged y columns
    (4099, 256, 8, 4, False),    # tiles exactly filled
    (70_003, 300, 8, 4, False),  # 44 slices of 1,600 rows: one fold each
    (20_011, 2_048, 8, 4, True)]  # a slice a tile: five folds, four compensated


@pytest.mark.parametrize("n,m,q,d,long_slice", F32_RS_CASES)
def test_reg_stats_f32_tiles_match_plain(cuda, n, m, q, d, long_slice):
    """The f32 kernel (128-tiles, 8 x 8 FMA micro-tiles, the exponent in
    log2 units, Kahan folds every 4,096 rows) against the plain version in
    f64 on its own f32 values at the f32 tier, with 15% of the rows masked;
    lengthscales grow as sqrt(q), so values stay far from f32's underflow
    at any q.  D is exactly symmetric and every output bitwise the same on
    a second run.  Where the plan gives a slice more rows than one fold,
    the later folds add into the compensated sums in device memory."""
    slots = _build.sm_count(cuda) * rs_k.F32_BLOCKS_PER_SM
    per_slice = _build.fill_plan(n, m, slots, rs_k.TILE, rs_k.ROWS)[2]
    assert (min(n, per_slice) > FOLD_ROWS) == long_slice
    rng = np.random.default_rng(7 * n + m + q)
    hyp = {"log_sf2": _t(rng.uniform(-0.5, 0.8), cuda),
           "log_ell": _t(rng.uniform(-0.4, 0.4, q) + 0.5 * np.log(q), cuda)}
    z, x, y = (_t(rng.standard_normal(s), cuda, torch.float32)
               for s in ((m, q), (n, q), (n, d)))
    w = _t(rng.uniform(size=n) > 0.15, cuda, torch.float32)
    before = rs_ops.LAUNCHES["float32"]
    got = rs_ops.reg_stats(hyp, z, x, y, w)
    again = rs_ops.reg_stats(hyp, z, x, y, w)
    assert rs_ops.LAUNCHES["float32"] == before + 2
    z, x, y, w = (v.double() for v in (z, x, y, w))
    plain = rs_ref.reg_stats_ref(hyp["log_sf2"], hyp["log_ell"], z, x, y, w)
    plain_abs = rs_ref.reg_stats_ref(hyp["log_sf2"], hyp["log_ell"], z, x,
                                     y.abs(), w)
    for g, p, pa in zip(got, plain, plain_abs):
        assert g.dtype == torch.float32 and _within(g, p, pa)
    assert torch.equal(got[2], got[2].T)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


def _grads(fn, inputs, cotangents):
    """Gradients of <cotangents, fn(*inputs)> with respect to every input."""
    leaves = [t.detach().requires_grad_(True) for t in inputs]
    outs = fn(*leaves)
    outs = outs if isinstance(outs, tuple) else (outs,)
    return torch.autograd.grad(outs, leaves, cotangents)


def _assert_grads_close(got, want):
    """The backward kernels compute the closed form in f64, so the
    Functions' gradients equal plain autograd's up to f64 rounding
    (summation order, and for reg_stats autograd's expanded-square form):
    rtol 1e-10."""
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-10, atol=1e-12)


def test_reg_stats_gradient(cuda):
    """The Function's backward (the backward kernel,
    ``csrc/reg_stats_bwd.cu``) against autograd of the plain version, f64,
    on every input; one backward launch."""
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

    before = rs_ops.LAUNCHES["bwd_float64"]
    got = _grads(kernel, inputs, cts)
    assert rs_ops.LAUNCHES["bwd_float64"] == before + 1
    _assert_grads_close(got, _grads(rs_ref.reg_stats_ref, inputs, cts))


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


F32_PSI2_CASES = [
    (20, 65, 3),       # n below one 32-row chunk, across a tile edge
    (300, 63, 10),     # inside one tile, a ragged patch
    (1003, 151, 14),   # past the rows staged at a time for q <= 16
    (1003, 65, 20),    # q past one 16-feature chunk
    (1003, 37, 160)]   # ten 16-feature chunks


@pytest.mark.parametrize("n,m,q", F32_PSI2_CASES)
def test_psi2_f32_kernel_matches_plain(cuda, n, m, q):
    """The f32 kernel (staged u and v, the exponent in log2 units, two
    launches) against the plain version in f64 on its own f32 values at the
    f32 tier, with 15% of the rows masked; lengthscales grow as sqrt(q), so
    values stay far from f32's underflow.  D is exactly symmetric and
    bitwise the same on a second run."""
    rng = np.random.default_rng(5 * n + m + q)
    hyp = {"log_sf2": _t(rng.uniform(-0.5, 0.8), cuda),
           "log_ell": _t(rng.uniform(-0.4, 0.4, q) + 0.5 * np.log(q), cuda)}
    z, mu = (_t(rng.standard_normal(sh), cuda, torch.float32)
             for sh in ((m, q), (n, q)))
    s = _t(rng.uniform(0.05, 0.8, (n, q)), cuda, torch.float32)
    w = _t(rng.uniform(size=n) > 0.15, cuda, torch.float32)
    before = ps_ops.LAUNCHES["psi2_float32"]
    got = ps_ops.psi2(hyp, z, mu, s, w)
    again = ps_ops.psi2(hyp, z, mu, s, w)
    assert ps_ops.LAUNCHES["psi2_float32"] == before + 2
    assert got.dtype == torch.float32 and got.shape == (m, m)
    assert torch.equal(got, got.T) and torch.equal(got, again)
    plain = ps_ref.psi2_ref(hyp["log_sf2"], hyp["log_ell"],
                            *(v.double() for v in (z, mu, s, w)), chunk=64)
    assert _within(got, plain, plain)


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
    """Both Functions' backward (the backward kernels ``csrc/psi2_bwd.cu``
    and ``csrc/psi1_bwd.cu``, one launch each) against autograd of the
    plain version, f64, on every input."""
    hyp, z, mu, s, w = _psi_inputs(5, 300, 37, 3, cuda)
    rng = np.random.default_rng(6)

    def psi2(log_sf2, log_ell, z, mu, s, w):
        return ps_ops.psi2({"log_sf2": log_sf2, "log_ell": log_ell}, z, mu, s, w)

    def psi1(log_sf2, log_ell, z, mu, s):
        return ps_ops.psi1({"log_sf2": log_sf2, "log_ell": log_ell}, z, mu, s)

    inputs = [hyp["log_sf2"], hyp["log_ell"], z, mu, s, w]
    ct2 = (_t(rng.standard_normal((37, 37)), cuda),)
    before = ps_ops.LAUNCHES["psi2_bwd_float64"]
    got = _grads(psi2, inputs, ct2)
    assert ps_ops.LAUNCHES["psi2_bwd_float64"] == before + 1
    _assert_grads_close(got, _grads(ps_ref.psi2_ref, inputs, ct2))
    ct1 = (_t(rng.standard_normal((300, 37)), cuda),)
    before = ps_ops.LAUNCHES["psi1_bwd_float64"]
    got = _grads(psi1, inputs[:5], ct1)
    assert ps_ops.LAUNCHES["psi1_bwd_float64"] == before + 1
    _assert_grads_close(got, _grads(ps_ref.psi1_ref, inputs[:5], ct1))


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


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_operator_at_the_tensor_parallel_shape(cuda, dtype):
    """``torch.ops.repro_torch.flash_attention`` (what the wrapper calls
    on the card) at a rank's heads of llama3.2-1b on a (1, 4) mesh: B 4,
    H 8, Hkv 2, T 2,048, Dh 64, against the plain version in f64, one
    launch of the hand-written kernel."""
    q, k, v = _fa_inputs(3, 4, 8, 2, 2048, 2048, 64, cuda, dtype)
    before = fa_ops.LAUNCHES[str(dtype).removeprefix("torch.")]
    with torch.no_grad():
        got = torch.ops.repro_torch.flash_attention(q, k, v, True)
    assert fa_ops.LAUNCHES[str(dtype).removeprefix("torch.")] == before + 1
    plain = fa_ref.attention_ref(q.double(), k.double(), v.double(),
                                 causal=True, chunk=256)
    assert got.shape == q.shape and got.dtype == dtype
    assert bool(((got.double() - plain).abs()
                 <= FA_TOL[dtype] * (1 + plain.abs())).all())


def test_flash_operator_fake_and_flop_formula(cuda):
    """Under ``FakeTensorMode`` the operator gives the kernel's output
    shape and dtype without launching it, and ``FlopCounterMode`` counts
    4 Dh FLOPs a visible pair, ``chip_smoke.py::visible_pairs``'s count."""
    import pathlib
    import sys

    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils.flop_counter import FlopCounterMode

    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
    import chip_smoke

    before = dict(fa_ops.LAUNCHES)
    for (b, h, hkv, t, s_len, causal) in ((4, 8, 2, 2048, 2048, True),
                                          (2, 4, 1, 100, 300, True),
                                          (1, 2, 2, 96, 48, False)):
        with FakeTensorMode(), torch.no_grad():
            q = torch.empty((b, h, t, 64), dtype=torch.bfloat16,
                            device=cuda)
            k = torch.empty((b, hkv, s_len, 64), dtype=torch.bfloat16,
                            device=cuda)
            counter = FlopCounterMode(display=False)
            with counter:
                out = fa_ops.flash_attention(q, k, k, causal=causal)
            assert tuple(out.shape) == (b, h, t, 64)
            assert out.dtype == torch.bfloat16
        assert counter.get_total_flops() == 4 * 64 * \
            chip_smoke.visible_pairs(b, h, t, s_len, causal)
    assert fa_ops.LAUNCHES == before


def _tp_rank_on_card(rank, world, store_path, out_dir):
    import dataclasses
    import datetime
    import pathlib

    import torch.distributed as dist

    from repro_torch.core.flat import tree_items
    from repro_torch.distributed import sharding
    from repro_torch.launch import make_compat_mesh
    from repro_torch.models import transformer as tf
    from repro_torch.train import steps

    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = make_compat_mesh((1, world), ("data", "model"), "cuda:0",
                            backend="gloo",
                            store=dist.FileStore(store_path, world),
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=60))
    cfg = dataclasses.replace(get_config("llama3.2-1b").reduced(),
                              num_heads=4, num_kv_heads=2, head_dim=64,
                              use_flash=True)
    whole = tf.init_params(cfg, torch.Generator().manual_seed(0),
                           device="cpu")
    logical = tf.param_logical_axes(cfg)
    tokens = torch.from_numpy(np.random.default_rng(41).integers(
        0, cfg.vocab_size, (2, 24), dtype=np.int32))
    out = {}
    for dev in ("cuda:0", "cpu"):
        p = _local(whole, logical, mesh, dev)
        toks = tokens.to(dev)
        with sharding.use_mesh(mesh):
            logits, caches = steps.make_prefill_step(cfg)(
                p, {"tokens": toks[:, :20]})
            caches = tf.grow_decode_cache(cfg, caches, 24)
            lg, _ = steps.make_serve_step(cfg)(
                p, caches, toks[:, 20:21],
                torch.full((2,), 20, dtype=torch.int32, device=dev))
            _, grads = steps.loss_and_grads(
                dataclasses.replace(cfg, use_flash=False), p,
                {"tokens": toks[:, :20], "labels": toks[:, 1:21]})
        tag = dev[:3]
        out[tag + "/logits"] = logits.cpu().numpy()
        out[tag + "/decode"] = lg.cpu().numpy()
        for path, g in tree_items(grads):
            out[f"{tag}/grad/{'/'.join(map(str, path))}"] = g.cpu().numpy()
    np.savez(pathlib.Path(out_dir) / f"rank{rank}.npz", **out)
    dist.destroy_process_group()


def _local(whole, logical, mesh, dev):
    from repro_torch.distributed import sharding

    if isinstance(whole, dict):
        return {k: _local(v, logical[k], mesh, dev) for k, v in whole.items()}
    return sharding.local_shard(whole, logical, mesh).to(dev)


def test_tensor_parallel_on_two_gloo_ranks_on_one_card(cuda, tmp_path):
    """llama3.2-1b reduced (4 heads, kv 2, head dim 64) split over a
    (1, 2) mesh of 2 gloo ranks on the card (the flash kernel on each
    rank's 2 heads, collectives through host copies) against the same
    mesh on the CPU: prefill and decode logits and every gradient leaf
    within 1e-5 of the largest entry (f32, TF32 off), the ranks' logits
    bitwise."""
    codes, _ = spawn_ranks(_tp_rank_on_card, 2, tmp_path)
    assert codes == [0, 0], codes
    got = [dict(np.load(tmp_path / f"rank{r}.npz")) for r in range(2)]
    for k in ("cud/logits", "cud/decode"):
        np.testing.assert_array_equal(got[0][k], got[1][k])
    for r in got:
        for k in r:
            if k.startswith("cud/"):
                want = r[k.replace("cud/", "cpu/", 1)]
                assert np.abs(r[k] - want).max() <= \
                    1e-5 * np.abs(want).max(), k


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
                              head_dim=64, use_flash=True)
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


def _lm_loss_and_grads(cfg, params, batch):
    from repro_torch.core.flat import tree_items, tree_unflatten
    from repro_torch.models import transformer as tf

    paths, leaves = zip(*tree_items(params))
    leaves = [a.detach().clone().requires_grad_(True) for a in leaves]
    loss, _ = tf.forward_train(cfg, tree_unflatten(paths, leaves), batch)
    return loss, dict(zip(paths, torch.autograd.grad(loss, leaves)))


def _lm_train_inputs(arch="llama3.2-1b"):
    from repro_torch.models import transformer as tf

    cfg = get_config(arch).reduced()
    params = tf.init_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu")
    rng = np.random.default_rng(0)
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 40),
                                              dtype=np.int32))
             for k in ("tokens", "labels")}
    batch["labels"][0, :3] = -1
    return cfg, params, batch


def _rel(got, want) -> float:
    got, want = got.detach().double().cpu(), want.detach().double().cpu()
    return float(torch.linalg.norm(got - want) / torch.linalg.norm(want))


@pytest.mark.parametrize("arch", ["llama3.2-1b", "starcoder2-3b"])
def test_lm_train_step_on_cuda_matches_cpu(cuda, arch):
    """The reduced config in f32 (TF32 off) on the card against the CPU:
    forward_train's loss and every gradient leaf, then 2 train steps'
    losses and grad norms, within 1e-4 relative; no flash launch."""
    from repro_torch.models.common import tree_map
    from repro_torch.optim.adam import AdamConfig, init_opt_state
    from repro_torch.train import steps

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg, params, batch = _lm_train_inputs(arch)
    before = dict(fa_ops.LAUNCHES)
    out = {}
    for device in (cuda, "cpu"):
        p = tree_map(lambda a, d=device: a.to(d), params)
        b = {k: v.to(device) for k, v in batch.items()}
        loss, grads = _lm_loss_and_grads(cfg, p, b)
        state = {"params": p, "opt": init_opt_state(p)}
        step = steps.make_train_step(cfg, AdamConfig(warmup_steps=2))
        ms = []
        for _ in range(2):
            state, m = step(state, b)
            ms.append((m["loss"].item(), m["grad_norm"].item()))
        out[str(device)] = (loss, grads, ms)
    assert dict(fa_ops.LAUNCHES) == before
    (loss, grads, ms), (loss_c, grads_c, ms_c) = out["cuda"], out["cpu"]
    assert _rel(loss, loss_c) <= 1e-4
    for path, g in grads_c.items():
        assert _rel(grads[path], g) <= 1e-4, path
    np.testing.assert_allclose(ms, ms_c, rtol=1e-4)


@pytest.mark.parametrize("policy", ["full", "dots"])
def test_lm_remat_on_cuda_matches_no_remat(cuda, policy):
    """Remat on a stacked group against remat off, on the card: the loss
    bitwise and every gradient within 1e-6."""
    import dataclasses

    from repro_torch.models.common import tree_map

    cfg, params, batch = _lm_train_inputs()
    p = tree_map(lambda a: a.to(cuda), params)
    b = {k: v.to(cuda) for k, v in batch.items()}
    off = _lm_loss_and_grads(cfg, p, b)
    on = _lm_loss_and_grads(dataclasses.replace(cfg, remat=True,
                                                remat_policy=policy), p, b)
    assert on[0].item() == off[0].item()
    for path, g in off[1].items():
        torch.testing.assert_close(on[1][path], g, rtol=1e-6, atol=1e-6,
                                   msg=str(path))


NEW_ARCHS = ["whisper-medium", "deepseek-v2-236b", "qwen3-moe-235b-a22b",
             "recurrentgemma-9b", "mamba2-370m"]


def _mixer_case(name):
    """(function of (params, x) -> output tree, params, x) of one mixer at
    its config's reduced widths, every leaf drawn N(0, 1/fan_in)."""
    from repro_torch.models import attention as attn
    from repro_torch.models import common
    from repro_torch.models import moe, rglru, ssm

    arch, init, fn = {
        "ssd": ("mamba2-370m", ssm.init_ssd,
                lambda c, p, x: ssm.ssd_forward(c, p, x)),
        "rglru": ("recurrentgemma-9b", rglru.init_rglru,
                  lambda c, p, x: rglru.rglru_forward(c, p, x)),
        "lattn": ("recurrentgemma-9b", attn.init_gqa,
                  lambda c, p, x: attn.gqa_forward(
                      c, p, x, _positions(x), window=c.local_window)),
        "mla": ("deepseek-v2-236b", attn.init_mla,
                lambda c, p, x: attn.mla_forward(c, p, x, _positions(x))),
        "cross": ("whisper-medium", attn.init_cross,
                  lambda c, p, x: attn.cross_forward(
                      c, p, x, attn.encode_kv(c, p, x[:, :16]))),
        "moe": ("qwen3-moe-235b-a22b", moe.init_moe,
                lambda c, p, x: moe.moe_dense(c, p, x)),
    }[name]
    cfg = get_config(arch).reduced()
    rng = np.random.default_rng(0)
    params = common.tree_map(lambda leaf: torch.from_numpy(
        rng.standard_normal(leaf.shape) * leaf.normal_std).float(),
        init(cfg))
    x = torch.from_numpy(rng.standard_normal((2, 70, cfg.d_model))).float()
    return (lambda p, xx: fn(cfg, p, xx)), params, x


def _positions(x):
    b, t = x.shape[:2]
    return torch.arange(t, dtype=torch.int32, device=x.device).expand(b, t)


def _out_and_grads(fn, params, x, device):
    """The mixer's outputs and the gradient of their sum of squares in x
    and every parameter, on ``device``."""
    from repro_torch.core.flat import tree_items, tree_unflatten

    paths, leaves = zip(*tree_items(params))
    leaves = [a.to(device).requires_grad_(True) for a in leaves]
    xx = x.to(device).requires_grad_(True)
    out = fn(tree_unflatten(paths, leaves), xx)
    flat = [o for o in (out if isinstance(out, tuple) else (out,))]
    flat = [v for o in flat for v in (o.values() if isinstance(o, dict)
                                      else (o,))]
    scalar = sum(torch.sum(o.float() ** 2) for o in flat)
    grads = torch.autograd.grad(scalar, [xx, *leaves])
    return [o.detach() for o in flat], grads


@pytest.mark.parametrize("mixer", ["ssd", "rglru", "lattn", "mla", "cross",
                                   "moe"])
def test_lm_mixer_on_cuda_matches_cpu(cuda, mixer):
    """Each mixer the slice adds (SSD, RG-LRU's log-depth scan, local
    attention, MLA, cross-attention, the dense MoE) at reduced widths in
    f32 (TF32 off), T 70: its outputs and the gradient of their sum of
    squares in x and every parameter, on the card against the CPU, within
    1e-4 relative; no flash launch."""
    torch.backends.cuda.matmul.allow_tf32 = False
    fn, params, x = _mixer_case(mixer)
    before = dict(fa_ops.LAUNCHES)
    outs, grads = _out_and_grads(fn, params, x, cuda)
    outs_c, grads_c = _out_and_grads(fn, params, x, "cpu")
    assert dict(fa_ops.LAUNCHES) == before
    for a, b in zip(outs + list(grads), outs_c + list(grads_c)):
        assert _rel(a, b) <= 1e-4


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_lm_arch_on_cuda_matches_cpu(cuda, arch):
    """Each new architecture reduced, in f32 (TF32 off): forward_train's
    total and every gradient leaf, then the prefill's logits and one
    decode step into caches grown to one more position (the query-chunked
    attention), on the card against the CPU, within 1e-4 relative."""
    from repro_torch.models import transformer as tf
    from repro_torch.models.common import tree_map
    from repro_torch.train import steps

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg, params, batch = _lm_train_inputs(arch)
    if cfg.family == "encdec":
        batch["frames"] = torch.from_numpy(np.random.default_rng(1)
                                           .standard_normal((2, 16, 64))).float()
    out = []
    for device in (cuda, "cpu"):
        p = tree_map(lambda a, d=device: a.to(d), params)
        b = {k: v.to(device) for k, v in batch.items()}
        loss, grads = _lm_loss_and_grads(cfg, p, b)
        prompt = {k: v for k, v in b.items() if k != "labels"}
        logits, caches = steps.make_prefill_step(cfg)(p, prompt)
        grown = tf.grow_decode_cache(cfg, caches, 41)
        pos = torch.full((2,), 40, dtype=torch.int32, device=device)
        logits2, _ = steps.make_serve_step(cfg)(p, grown, b["tokens"][:, :1],
                                                pos)
        out.append((loss, grads, logits, logits2))
    (loss, grads, logits, logits2), (loss_c, grads_c, logits_c, logits2_c) = out
    assert _rel(loss, loss_c) <= 1e-4
    for path, g in grads_c.items():
        assert _rel(grads[path], g) <= 1e-4, path
    assert _rel(logits, logits_c) <= 1e-4
    assert _rel(logits2, logits2_c) <= 1e-4


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


def test_overlapped_reduce_world_of_one_over_nccl_is_serial(cuda):
    """``reduce_mode`` "overlap" and "overlap_eager" in a world of one over
    NCCL (each block's async all_reduce on NCCL's stream, waited on one
    block later): value and gradient bitwise the serial step's, one
    reg_stats launch a block."""
    import torch.distributed as dist

    from repro_torch.launch import make_data_group

    x, y, z, hyp = _dist_inputs()
    group = make_data_group(cuda)
    out = {}
    try:
        for mode in ("serial", "overlap", "overlap_eager"):
            eng = rt.DistributedGP(group, device=cuda, chunk_size=512,
                                   reduce_mode=mode)
            (h, zz), data, w = _dist_args(eng, x, y, z, hyp)
            before = rs_ops.LAUNCHES["float64"]
            out[mode] = eng.make_value_and_grad(y.shape[1])(
                h, zz, data["mu"], None, data["y"], w, np.ones(1),
                float(len(x)))
            assert rs_ops.LAUNCHES["float64"] == before + 6   # 3,072 rows
    finally:
        dist.destroy_process_group()
    v0, (gh0, gz0) = out["serial"]
    for mode in ("overlap", "overlap_eager"):
        v, (gh, gz) = out[mode]
        assert torch.equal(v, v0) and torch.equal(gz, gz0), mode
        for k in gh0:
            assert torch.equal(gh[k], gh0[k]), (mode, k)


def test_async_engine_all_fresh_on_the_card_matches_cpu(cuda):
    """``AsyncEngine`` all fresh on the card (the maps through reg_stats)
    against the same engine on the CPU (plain map): value 1e-9, gradient
    1e-8 relative; and its exact reference likewise."""
    from repro_torch.distributed import AsyncEngine

    x, y, z, hyp = _dist_inputs()
    shards = [{"y": y[i::4], "mu": x[i::4]} for i in range(4)]
    res = {}
    for device in (cuda, "cpu"):
        eng = AsyncEngine(shards, y.shape[1], staleness=4, refresh=4,
                          chunk_size=256, device=device)
        h = {k: _t(v, device) for k, v in hyp.items()}
        before = rs_ops.LAUNCHES["float64"]
        step = eng.step(h, _t(z, device))
        launched = rs_ops.LAUNCHES["float64"] - before
        res[device if device == "cpu" else "cuda"] = (
            step, eng.exact_value_and_grad(h, _t(z, device)), launched)
    assert res["cuda"][2] == 4 * 3 and res["cpu"][2] == 0
    for i in (0, 1):
        (v, (gh, gz)), (vc, (ghc, gzc)) = res["cuda"][i], res["cpu"][i]
        assert abs(float(v) - float(vc)) <= 1e-9 * abs(float(vc))
        g = torch.cat([gz.cpu().reshape(-1)]
                      + [gh[k].cpu().reshape(-1) for k in sorted(gh)])
        gc = torch.cat([gzc.reshape(-1)]
                       + [ghc[k].reshape(-1) for k in sorted(ghc)])
        assert float((g - gc).norm()) <= 1e-8 * float(gc.norm())


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


# -- SVI and host streaming on the card ------------------------------------------

def test_streamed_equals_in_memory_bitwise_on_the_card(cuda):
    """A stream staged chunk by chunk (pinned memory, a side stream) folds
    to the in-memory engine's Stats, bound and predictive state bitwise,
    through the reg_stats kernel: one launch a block a pass."""
    from repro_torch.data import flight_like

    n, chunk, m = 20_000, 512, 32
    rows = flight_like(n=n, seed=0).read(0, n)
    rng = np.random.default_rng(0)
    z = _t(rows["mu"][rng.choice(n, m, replace=False)], cuda)
    hyp = {"log_sf2": _t(0.0, cuda), "log_ell": _t(np.zeros(8), cuda),
           "log_beta": _t(1.0, cuda)}
    eng = rt.DistributedGP(chunk_size=chunk, device=cuda)
    data, w = eng.put_data(**rows)
    ones = np.ones(1)
    stream = eng.put_data(stream=flight_like(n=n, seed=0), blocks_per_chunk=3)
    before = rs_ops.LAUNCHES["float64"]
    st = eng.streamed_stats(hyp, z, stream)
    # the tail chunk tops up with zero-weight blocks
    assert rs_ops.LAUNCHES["float64"] - before \
        == stream.n_chunks * stream.blocks_per_chunk
    st_mem = eng.reduced_stats(1)(hyp, z, data["y"], data["mu"], None, w, ones)
    for a, b in zip(st, st_mem):
        assert torch.equal(a, b)
    assert float(eng.streamed_bound(hyp, z, stream, d=1)) == float(
        eng.bound_fn(1)(hyp, z, data["y"], data["mu"], None, w, ones,
                        float(n)))
    ps = eng.streamed_predictive_state(hyp, z, stream)
    pm = eng.predictive_state(hyp, z, data["y"], data["mu"], None, w)
    for f in ("chol_kmm", "chol_sigma", "c2", "a_mean", "g"):
        assert torch.equal(getattr(ps, f), getattr(pm, f)), f
    serve = rt.PredictEngine(ps, device=cuda)
    batches = [rows["mu"][i:i + 700] for i in range(0, 2800, 700)]
    for xb, (mean, var) in zip(batches, serve.predict_stream(iter(batches))):
        m_ref, v_ref = serve.predict(xb)
        assert torch.equal(mean, m_ref) and torch.equal(var, v_ref)


def test_staged_chunk_unchanged_while_the_consumer_stream_is_busy(cuda):
    """A long kernel holds the consumer's stream while more chunks are
    staged than there are pinned buffers: no buffer is refilled before its
    copy completes, no staged tensor's memory is handed out before the
    consumer's work on it, so every chunk arrives as it was."""
    from repro_torch.data.stream import prefetch, stage_to_device

    chunks = [({"y": np.full((4096, 3), float(i))}, np.full(4096, float(i)))
              for i in range(16)]
    stager = stage_to_device(cuda, depth=2)
    torch.cuda._sleep(int(5e8))            # spins the current stream
    outs = []
    for staged in prefetch(iter(chunks), stager, depth=2):
        arrs, w = stager.ready(staged)
        outs.append((arrs["y"].sum(), w.sum()))   # queued behind the sleep
        del arrs, w
    torch.cuda.synchronize()
    for i, (y, w) in enumerate(outs):
        assert float(y) == 3 * 4096 * i and float(w) == 4096 * i


def test_fit_svi_on_the_card(cuda):
    """SGPR and GPLVM fit_svi on the card: the same draws (a CPU generator)
    as on the CPU, so 5 steps match the CPU's history to 1e-9; the exact
    bound rises; the map runs the kernels."""
    x, y = _dist_inputs()[:2]
    hist = {}
    for dev in ("cpu", cuda):
        gp = rt.SGPR(x, y, num_inducing=16, seed=0, chunk_size=64,
                     batch_blocks=3, device=dev)
        b0 = gp.log_bound()
        before = rs_ops.LAUNCHES["float64"]
        hist[str(dev)] = gp.fit_svi(steps=5, lr=2e-2, seed=0).history
        launched = rs_ops.LAUNCHES["float64"] - before
        assert gp.log_bound() > b0
    assert launched == 5 * 3                # the card's: 3 blocks a step
    np.testing.assert_allclose(hist[str(cuda)], hist["cpu"], rtol=1e-9)
    yl = np.random.default_rng(0).standard_normal((200, 5))
    lv = rt.BayesianGPLVM(yl, q=2, num_inducing=8, chunk_size=32,
                          batch_blocks=2, device=cuda)
    b0 = lv.log_bound()
    before = ps_ops.LAUNCHES["psi2_float64"]
    lv.fit_svi(steps=10, lr=2e-2, seed=0)
    assert ps_ops.LAUNCHES["psi2_float64"] - before == 10 * 2
    assert lv.log_bound() > b0


# -- sharded and quantized serving, reconstruct on the card ----------------------

def _serving_state(device):
    x, y = _dist_inputs()[:2]
    return rt.SGPR(x, y, num_inducing=24, seed=0,
                   device=device).predictive_state()


def test_sharded_engine_world_of_one_over_nccl_is_the_plain_engine(cuda):
    """``DistributedGP.predict_engine`` in a world of one over NCCL: every
    batch bitwise ``PredictEngine``'s, one predict launch a batch."""
    import torch.distributed as dist

    from repro_torch.launch import make_data_group

    state = _serving_state(cuda)
    rng = np.random.default_rng(1)
    group = make_data_group(cuda)
    try:
        eng = rt.DistributedGP(group, device=cuda).predict_engine(state)
        plain = rt.PredictEngine(state, device=cuda)
        for t in (1, 257, 4096):
            xq = rng.uniform(-2, 2, (t, state.q))
            before = p_ops.LAUNCHES["float64"]
            got = eng.predict(xq, include_noise=True)
            assert p_ops.LAUNCHES["float64"] == before + 1
            for a, b in zip(got, plain.predict(xq, include_noise=True)):
                assert torch.equal(a, b)
    finally:
        dist.destroy_process_group()


def _serving_rank_on_card(rank, world, store_path, out_dir):
    import datetime
    import pathlib

    import torch.distributed as dist

    from repro_torch.launch import make_data_group

    group = make_data_group("cuda:0", backend="gloo",
                            store=dist.FileStore(store_path, world),
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=60))
    state = _serving_state("cuda:0")
    xq = np.random.default_rng(2).uniform(-2, 2, (1001, state.q))
    eng = rt.PredictEngine(state, device="cuda:0", group=group)
    before = p_ops.LAUNCHES["float64"]
    mean, var = eng.predict(xq)
    np.savez(pathlib.Path(out_dir) / f"rank{rank}.npz",
             mean=mean.cpu().numpy(), var=var.cpu().numpy(),
             launches=p_ops.LAUNCHES["float64"] - before)
    dist.destroy_process_group()


def test_sharded_engine_on_two_gloo_ranks_on_one_card(cuda, tmp_path):
    """Two gloo ranks on the card: each launches the kernel once on its half
    of the rows, and every rank returns all 1,001 rows bitwise equal to one
    engine's."""
    codes, _ = spawn_ranks(_serving_rank_on_card, 2, tmp_path)
    assert codes == [0, 0], codes
    got = [dict(np.load(tmp_path / f"rank{r}.npz")) for r in range(2)]
    state = _serving_state(cuda)
    xq = np.random.default_rng(2).uniform(-2, 2, (1001, state.q))
    mean, var = rt.PredictEngine(state, device=cuda).predict(xq)
    for r in got:
        assert int(r["launches"]) == 1
        np.testing.assert_array_equal(r["mean"], mean.cpu().numpy())
        np.testing.assert_array_equal(r["var"], var.cpu().numpy())


def _ep_rank_on_card(rank, world, store_path, out_dir):
    """The expert-parallel MoE on a (1, 2) mesh of gloo ranks on the card
    and, on the same mesh, on the CPU: y, the kept pairs and the gradients
    of sum y**2, at capacity factors 4 (no drop) and 1.25."""
    import dataclasses
    import datetime
    import pathlib

    import torch.distributed as dist

    from repro_torch.distributed import sharding
    from repro_torch.launch import make_compat_mesh
    from repro_torch.models import moe

    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = make_compat_mesh((1, world), ("data", "model"), "cuda:0",
                            backend="gloo",
                            store=dist.FileStore(store_path, world),
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=60))
    base = get_config("qwen3-moe-235b-a22b").reduced()
    spec = moe.init_moe(base)
    rng = np.random.default_rng(40)
    x = rng.standard_normal((2, 24, base.d_model)).astype(np.float32)
    p = {k: (rng.standard_normal(leaf.shape) * leaf.normal_std).astype(
        np.float32) for k, leaf in spec.items()}
    packed = []
    real = moe._pack_local

    def recording(cfg, xs, gates, eids, cap):
        buf, meta = real(cfg, xs, gates, eids, cap)
        packed.append(moe.kept_pairs(meta, *eids.shape).cpu().numpy())
        return buf, meta
    moe._pack_local = recording
    out = {}
    for cf in (4.0, 1.25):
        cfg = dataclasses.replace(base, moe_impl="sharded", capacity_factor=cf)
        for dev in ("cuda:0", "cpu"):
            xt = torch.from_numpy(x).to(dev).requires_grad_()
            pt = {k: sharding.local_shard(torch.from_numpy(v).to(dev),
                                          spec[k].logical, mesh,
                                          moe.EXPERT_RULES).requires_grad_()
                  for k, v in p.items()}
            packed.clear()
            with sharding.use_mesh(mesh):
                y, _ = moe.moe_forward(cfg, pt, xt)
                grads = torch.autograd.grad((y ** 2).sum(),
                                            [xt] + list(pt.values()))
            tag = f"{cf}/{dev[:3]}"
            out[tag + "/y"] = y.detach().cpu().numpy()
            out[tag + "/kept"] = np.stack(packed)
            for k, g in zip(["x"] + list(pt), grads):
                out[f"{tag}/grad/{k}"] = g.cpu().numpy()
            if cf == 4.0 and dev == "cuda:0":
                with torch.no_grad():
                    out["dense"] = moe.moe_dense(
                        cfg, {k: torch.from_numpy(v).to(dev)
                              for k, v in p.items()},
                        xt)[0].cpu().numpy()
    np.savez(pathlib.Path(out_dir) / f"rank{rank}.npz", **out)
    dist.destroy_process_group()


def test_moe_sharded_on_two_gloo_ranks_on_one_card(cuda, tmp_path):
    """The expert-parallel MoE on the card (2 gloo ranks, each 4 of 8
    experts, collectives through host copies) against the same schedule
    on the CPU: y and every gradient within 1e-5 of the largest entry
    (f32, TF32 off), the kept pairs identical, the ranks' y bitwise; with
    no drop, y within 1e-5 of the dense path on the card."""
    codes, _ = spawn_ranks(_ep_rank_on_card, 2, tmp_path)
    assert codes == [0, 0], codes
    got = [dict(np.load(tmp_path / f"rank{r}.npz")) for r in range(2)]
    for cf in (4.0, 1.25):
        np.testing.assert_array_equal(got[0][f"{cf}/cud/y"],
                                      got[1][f"{cf}/cud/y"])
        for r in got:
            for k in r:
                if k.startswith(f"{cf}/cud/"):
                    want = r[k.replace("/cud/", "/cpu/")]
                    if k.endswith("/kept"):
                        np.testing.assert_array_equal(r[k], want)
                    else:
                        assert np.abs(r[k] - want).max() <= \
                            1e-5 * np.abs(want).max(), k
    assert np.abs(got[0]["4.0/cud/y"] - got[0]["dense"]).max() <= 1e-5


def test_astype_float16_on_the_card_rounds_once(cuda):
    """f64 -> f16 of a state on the card gives numpy's correctly rounded
    bits (torch's own cast rounds through f32), and serves through the f32
    predict kernel."""
    a = np.random.default_rng(0).standard_normal(1_000_000)
    state = _serving_state(cuda)
    big = rt.PredictiveState(hyp=state.hyp, z=_t(a.reshape(-1, 1), cuda),
                             chol_kmm=state.chol_kmm,
                             chol_sigma=state.chol_sigma, c2=state.c2,
                             a_mean=state.a_mean, g=state.g)
    got = big.astype(torch.float16).z
    assert got.device.type == "cuda"
    want = a.reshape(-1, 1).astype(np.float16)
    np.testing.assert_array_equal(got.cpu().numpy().view(np.uint16),
                                  want.view(np.uint16))
    eng = rt.PredictEngine(state.astype(torch.float16), device=cuda)
    before = p_ops.LAUNCHES["float32"]
    mean, _ = eng.predict(np.zeros((5, state.q)))
    assert p_ops.LAUNCHES["float32"] == before + 1
    assert mean.dtype == torch.float32


def test_reconstruct_on_the_card_matches_cpu(cuda):
    """``reconstruct`` on the card (objective through the plain
    composition, the final prediction through the predict kernel) against
    the same model on the CPU, its parameters fitted there: 1e-8 relative
    after 20 SCG iterations."""
    y_all, _ = sines_dataset(np.random.default_rng(0), n=200, noise=0.05)
    observed = np.array([True, True, False])
    ytest, _ = sines_dataset(np.random.default_rng(1), n=10, noise=0.0)
    fitted = rt.BayesianGPLVM(y_all, q=2, num_inducing=12, seed=1,
                              device="cpu")
    fitted.fit(max_iters=20)
    rec = {}
    for dev in ("cpu", cuda):
        lv = rt.BayesianGPLVM(y_all, q=2, num_inducing=12, seed=1,
                              device=dev)
        lv.params = {k: ({kk: vv.to(dev) for kk, vv in v.items()}
                         if isinstance(v, dict) else v.to(dev))
                     for k, v in fitted.params.items()}
        before = p_ops.LAUNCHES["float64"]
        rec[str(dev)] = lv.reconstruct(ytest * observed, observed, iters=20)
        launched = p_ops.LAUNCHES["float64"] - before
    assert launched == 1
    np.testing.assert_allclose(rec[str(cuda)], rec["cpu"], rtol=1e-8,
                               atol=1e-10)


# -- the kernel zoo and online updates on the card ---------------------------------

@pytest.mark.parametrize("m,k", [(64, 100), (130, 7), (512, 256)])
def test_rank_k_sweep_on_the_card_matches_cpu(cuda, m, k):
    """The rank-k update, then the downdate of the same columns, on the
    card against the CPU: the same flags, factors within 1e-12 relative;
    an indefinite downdate flags on both."""
    from repro_torch.core import chol_update as cu

    rng = np.random.default_rng(m + k)
    a = rng.standard_normal((m, m))
    L = np.linalg.cholesky(a @ a.T + m * np.eye(m))
    V = rng.standard_normal((m, k))
    up, ok = cu.chol_update_rank_k(_t(L, cuda), _t(V, cuda))
    up_cpu, ok_cpu = cu.chol_update_rank_k(_t(L, "cpu"), _t(V, "cpu"))
    assert bool(ok) and bool(ok_cpu)
    np.testing.assert_allclose(up.cpu().numpy(), up_cpu.numpy(), rtol=1e-12,
                               atol=1e-12 * np.abs(up_cpu.numpy()).max())
    back, ok = cu.chol_downdate_rank_k(up, _t(V, cuda))
    assert bool(ok)
    np.testing.assert_allclose(back.cpu().numpy(), L, rtol=1e-10, atol=1e-11)
    _, ok = cu.chol_downdate_rank_k(_t(L, cuda), _t(10.0 * V, cuda))
    _, ok_cpu = cu.chol_downdate_rank_k(_t(L, "cpu"), _t(10.0 * V, "cpu"))
    assert bool(ok) is bool(ok_cpu) is False


def test_update_and_forget_on_the_card_match_cpu(cuda):
    """``SGPR.update``/``forget`` on the card: one reg_stats f64 launch per
    block, the refreshed engine one predict f64 launch a batch, and the
    answers of the CPU's update within ``test_slice_on_cuda_matches_cpu``'s
    rtol 1e-8 / atol 1e-10 on the same problem; an illegitimate forget
    through ``online.downdate_state`` falls back and raises nothing."""
    from repro_torch.serve import online

    rng = np.random.default_rng(0)
    x = rng.uniform(-2.0, 2.0, (3000, 3))
    y = np.sin(x @ rng.standard_normal((3, 2))) + 0.1 * rng.standard_normal(
        (3000, 2))
    xb, yb = rng.uniform(-2, 2, (300, 3)), rng.standard_normal((300, 2))
    xs = rng.uniform(-2, 2, (257, 3))
    gpu = rt.SGPR(x, y, num_inducing=40, device=cuda)
    cpu = rt.SGPR(x, y, num_inducing=40, device="cpu")
    for mdl in (gpu, cpu):
        mdl.predict(xs)
    rs0, p0 = rs_ops.LAUNCHES["float64"], p_ops.LAUNCHES["float64"]
    assert gpu.update(xb, yb) == cpu.update(xb, yb) == 1
    assert rs_ops.LAUNCHES["float64"] == rs0 + 1
    got, want = gpu.predict(xs, include_noise=True), \
        cpu.predict(xs, include_noise=True)
    assert p_ops.LAUNCHES["float64"] == p0 + 1
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, rtol=1e-8, atol=1e-10)
    gpu.forget(-1)
    cpu.forget(-1)
    for a, b in zip(gpu.predict(xs), cpu.predict(xs)):
        np.testing.assert_allclose(a, b, rtol=1e-8, atol=1e-10)
    res = online.downdate_state(gpu.predictive_state(),
                                rng.standard_normal((50, 3)),
                                5.0 * rng.standard_normal((50, 2)),
                                weights=50.0 * torch.ones(50, device=cuda,
                                                          dtype=torch.float64))
    assert res.fallback is True


def test_zoo_routes_are_counted(cuda):
    """The route by expression on the card: a composite SGPR launches no
    reg_stats and no predict kernel; the full-width SE-ARD launches both; a
    GPLVM over ``Sum(SEARD(), Linear(dims=(1,)))`` reaches the psi1 kernel
    through its full-width SE child and no psi2 (quadrature), and one over
    disjoint children reaches no psi kernel."""
    from repro_torch.core.covariance import SEARD, Linear, Sum

    rng = np.random.default_rng(4)
    x = rng.uniform(-2, 2, (500, 2))
    y = np.concatenate([np.sin(x[:, :1]) + 0.5 * x[:, 1:], np.cos(x[:, :1])],
                       1)
    counts = {"reg_stats": rs_ops.LAUNCHES, "predict": p_ops.LAUNCHES,
              "psi": ps_ops.LAUNCHES}

    def launched(fn):
        before = {n: dict(c) for n, c in counts.items()}
        fn()
        return {f"{n}_{k}": c[k] - before[n][k] for n, c in counts.items()
                for k in c if c[k] != before[n][k]}

    zoo = rt.SGPR(x, y, num_inducing=16, kernel=Sum(SEARD(dims=(0,)),
                                                    Linear(dims=(1,))),
                  device=cuda)
    assert launched(lambda: zoo.predict(x[:64])) == {}
    se = rt.SGPR(x, y, num_inducing=16, kernel="se", device=cuda)
    assert launched(lambda: se.predict(x[:64])) == {
        "reg_stats_float64": 1, "predict_float64": 1}
    child = rt.BayesianGPLVM(y, q=2, num_inducing=8,
                             kernel=Sum(SEARD(), Linear(dims=(1,))),
                             device=cuda)
    assert launched(child.log_bound) == {"psi_psi1_float64": 1}
    disjoint = rt.BayesianGPLVM(y, q=2, num_inducing=8,
                                kernel=Sum(SEARD(dims=(0,)),
                                           Linear(dims=(1,))), device=cuda)
    assert launched(disjoint.log_bound) == {}


# -- posterior sampling, the fleet engine and the front-end on the card -----------

def _fleet_states(device, n_models=3):
    """Same-shape states of three hyper-parameter settings (a fleet)."""
    x, y = _dist_inputs()[:2]
    base = rt.SGPR(x, y, num_inducing=24, seed=0, device=device)
    states = []
    for k in range(n_models):
        hyp = {kk: v.clone() for kk, v in base.params["hyp"].items()}
        hyp["log_sf2"] = hyp["log_sf2"] + 0.1 * k
        hyp["log_beta"] = hyp["log_beta"] + 0.2 * k
        states.append(rt.SGPR(x, y, hyp=hyp, z=base.params["z"],
                              device=device).predictive_state())
    return states


def test_sample_on_the_card_matches_cpu_through_the_same_normals(cuda):
    """``_sample_from_normals`` on the card against the CPU on the same
    normals (1e-10 relative to the draws' scale); ``PredictEngine.sample``
    repeats its bits for a seed, ``sample_stream`` over whole blocks gives
    the one-shot bits, an f32 engine samples and a bf16 state is refused."""
    from repro_torch.serve import posterior

    state = _fleet_states(cuda, 1)[0]
    cpu_state = state._to(device="cpu")
    rng = np.random.default_rng(5)
    xb = rng.uniform(-2, 2, (256, state.q))
    eps = rng.standard_normal((64, 256, state.d))
    got = posterior._sample_from_normals(state, _t(xb, cuda), _t(eps, cuda))
    want = posterior._sample_from_normals(cpu_state, _t(xb, "cpu"),
                                          _t(eps, "cpu"))
    scale = float(want.abs().max())
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), rtol=1e-10,
                               atol=1e-10 * scale)
    eng = rt.PredictEngine(state, block_size=256, device=cuda)
    xq = rng.uniform(-2, 2, (1024, state.q))
    one = eng.sample(xq, 16, 7)
    assert one.shape == (16, 1024, state.d) and one.device.type == "cuda"
    assert torch.equal(one, eng.sample(xq, 16, 7))
    assert not torch.equal(one, eng.sample(xq, 16, 8))
    streamed = torch.cat(list(eng.sample_stream(
        [xq[:512], xq[512:768], xq[768:]], 16, 7)), 1)
    assert torch.equal(streamed, one)
    assert torch.equal(eng.sample(xq[:300], 16, 7), one[:, :300])
    eng32 = rt.PredictEngine(state, device=cuda, compute_dtype=torch.float32)
    s32 = eng32.sample(xq, 4, 7)
    assert s32.dtype == torch.float32 and bool(torch.isfinite(s32).all())
    with pytest.raises(ValueError, match="storage"):
        rt.PredictEngine(state.astype(torch.bfloat16), device=cuda).sample(
            xq, 2, 0)


def test_fleet_rows_bitwise_single_engines_on_the_card(cuda):
    """``MultiPredictEngine`` on the card: one predict f64 launch per model
    a batch, every model's rows bitwise its own ``PredictEngine``'s, noise
    included; after ``swap_slot`` the slot answers as the new state and the
    others do not move."""
    from repro_torch.serve import MultiPredictEngine

    states = _fleet_states(cuda)
    eng = MultiPredictEngine(states, device=cuda)
    singles = [rt.PredictEngine(s, device=cuda) for s in states]
    rng = np.random.default_rng(6)
    for t in (1, 257, 4096):
        xq = rng.uniform(-2, 2, (t, states[0].q))
        before = p_ops.LAUNCHES["float64"]
        mean, var = eng.predict(xq, include_noise=True)
        assert p_ops.LAUNCHES["float64"] == before + len(states)
        for k, one in enumerate(singles):
            m1, v1 = one.predict(xq, include_noise=True)
            assert torch.equal(mean[k], m1) and torch.equal(var[k], v1)
    eng.swap_slot(1, states[2])
    m2, _ = eng.predict(xq)
    assert torch.equal(m2[1], singles[2].predict(xq)[0])
    assert torch.equal(m2[0], mean[0]) and torch.equal(m2[2], mean[2])


def test_frontend_responses_bitwise_on_the_card(cuda):
    """A ``Frontend`` over an engine on the card: every response bitwise a
    direct ``predict`` of its rows (noise included), the predict launches
    equal to the flushes plus the warmup shapes; over the fleet engine the
    (N, t, d) responses bitwise too."""
    import asyncio

    from repro_torch.serve import Frontend, MultiPredictEngine

    states = _fleet_states(cuda)
    rng = np.random.default_rng(7)
    xs = [rng.uniform(-2, 2, (int(t), states[0].q))
          for t in rng.integers(1, 65, 40)]
    for eng, per_batch in ((rt.PredictEngine(states[0], block_size=64,
                                             device=cuda), 1),
                           (MultiPredictEngine(states, block_size=64,
                                               device=cuda), len(states))):
        async def main():
            async with Frontend(eng, max_wait_ms=5.0,
                                max_batch_rows=512) as fe:
                before = p_ops.LAUNCHES["float64"]
                shapes = fe.warmup()
                out = await asyncio.gather(*[
                    fe.submit(x, include_noise=(i % 2 == 0))
                    for i, x in enumerate(xs)])
                return (out, shapes, fe.metrics.summary()["counters"],
                        p_ops.LAUNCHES["float64"] - before)

        out, shapes, counters, launched = asyncio.run(main())
        assert shapes == 8
        assert launched == per_batch * (counters["flushes"] + shapes)
        for i, (x, res) in enumerate(zip(xs, out)):
            m_ref, v_ref = eng.predict(x, include_noise=(i % 2 == 0))
            np.testing.assert_array_equal(res.mean, m_ref.cpu().numpy())
            np.testing.assert_array_equal(res.var, v_ref.cpu().numpy())


GP_OPS = ["reg_stats", "psi2", "psi1"]


def _gp_operands(name, device, dtype):
    """(operator inputs, bare launch) of a GP kernel at a ragged shape."""
    rng = np.random.default_rng(17)
    n, m, q, d = 1037, 130, 8, 4
    log_sf2 = _t(rng.normal(0, 0.1), device, dtype).reshape(())
    log_ell = _t(rng.normal(0, 0.2, q), device, dtype)
    z = _t(rng.normal(size=(m, q)), device, dtype)
    x = _t(rng.normal(size=(n, q)), device, dtype)
    if name == "reg_stats":
        y = _t(rng.normal(size=(n, d)), device, dtype)
        w = _t(rng.uniform(0, 1, n), device, dtype)
        return (log_sf2, log_ell, z, x, y, w), rs_ops._launch
    s = _t(rng.uniform(0.05, 0.5, (n, q)), device, dtype)
    if name == "psi2":
        w = _t(rng.uniform(0, 1, n), device, dtype)
        return (log_sf2, log_ell, z, x, s, w), ps_ops._launch_psi2
    return (log_sf2, log_ell, z, x, s), ps_ops._launch_psi1


def _launches(name, dtype):
    key = str(dtype).removeprefix("torch.")
    return (rs_ops.LAUNCHES[key] if name == "reg_stats"
            else ps_ops.LAUNCHES[f"{name}_{key}"])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", GP_OPS)
def test_gp_operator_is_bitwise_the_bare_launch(cuda, name, dtype):
    """``torch.ops.repro_torch.<name>`` (what the wrapper's Function calls
    on the card since the dry run counts the kernels) against the bare
    launch it wraps, the route before the operator: the same bits, one
    launch each."""
    args, bare = _gp_operands(name, cuda, dtype)
    before = _launches(name, dtype)
    got = getattr(torch.ops.repro_torch, name)(*args)
    want = bare(*args)
    assert _launches(name, dtype) == before + 2
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    for a, b in zip(got, want, strict=True):
        assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.parametrize("name", GP_OPS)
def test_gp_operator_fake_and_flop_formula(cuda, name):
    """Under ``FakeTensorMode`` the wrapper's operator gives the kernel's
    output shapes without launching it, and ``FlopCounterMode`` counts its
    formula (``reg_stats.ops.flops``, ``psi_stats.ops.psi2_flops`` /
    ``psi1_flops``)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils.flop_counter import FlopCounterMode

    n, m, q, d = 1037, 130, 8, 4
    before = (dict(rs_ops.LAUNCHES), dict(ps_ops.LAUNCHES))
    with FakeTensorMode():
        def e(*shape):
            return torch.empty(shape, dtype=torch.float64, device=cuda)
        args = {"reg_stats": (e(), e(q), e(m, q), e(n, q), e(n, d), e(n)),
                "psi2": (e(), e(q), e(m, q), e(n, q), e(n, q), e(n)),
                "psi1": (e(), e(q), e(m, q), e(n, q), e(n, q))}[name]
        counter = FlopCounterMode(display=False)
        with counter:
            out = getattr(torch.ops.repro_torch, name)(*args)
    shapes = {"reg_stats": [(), (m, d), (m, m)], "psi2": [(m, m)],
              "psi1": [(n, m)]}[name]
    out = out if isinstance(out, tuple) else (out,)
    assert [tuple(o.shape) for o in out] == shapes
    want = {"reg_stats": rs_ops.flops(n, m, q, d),
            "psi2": ps_ops.psi2_flops(n, m, q),
            "psi1": ps_ops.psi1_flops(n, m, q)}[name]
    assert counter.get_total_flops() == want
    assert (dict(rs_ops.LAUNCHES), dict(ps_ops.LAUNCHES)) == before


# -- the backward kernels (csrc/reg_stats_bwd.cu, csrc/psi2_bwd.cu) ----------

def _hold_bwd(got, closed, closed_abs, chunked, dtype):
    """Each gradient against the closed form at the kernel's tier
    (|err| <= rtol |plain| + atol |plain on absolute terms|, whatever the
    dtype it comes back in) and against the chunked recompute (f64:
    normwise 1e-8)."""
    rtol, atol = TIERS[dtype]
    for i, (g, p, pa, c) in enumerate(zip(got, closed, closed_abs, chunked)):
        g64 = g.double()
        assert g.shape == p.shape, i
        assert bool((g64 - p).abs().le(rtol * p.abs() + atol * pa).all()), i
        if dtype == F64 and c.numel():
            assert float(torch.linalg.vector_norm(g64 - c)
                         / torch.linalg.vector_norm(c).clamp_min(1e-300)) \
                <= 1e-8, i


def _rs_bwd_inputs(seed, n, m, q, d, device):
    rng = np.random.default_rng(seed)
    ins = [_t(rng.uniform(-0.5, 0.8), device),
           _t(rng.uniform(-0.4, 0.4, q), device),
           _t(rng.standard_normal((m, q)), device),
           _t(rng.standard_normal((n, q)), device),
           _t(rng.standard_normal((n, d)), device),
           _t(rng.uniform(size=n) > 0.15, device)]
    cts = [_t(rng.standard_normal(sh), device)
           for sh in ((), (m, d), (m, m))]      # gD not symmetric
    return ins, cts


@pytest.mark.parametrize("n,m,q,d,dtype", RS_BWD_CASES)
def test_reg_stats_bwd_matches_closed_form_and_recompute(cuda, n, m, q, d,
                                                         dtype):
    """The backward operator (every input's gradient) against
    ``reg_stats_vjp_ref`` and the chunked recompute on the values the
    kernel sees, and bitwise on a second call (x and z shifted by +100 in
    the ``OFFSETS`` case)."""
    ins, cts = _rs_bwd_inputs(n + 3 * m, n, m, q, d, cuda)
    off = OFFSETS.get((n, m, q, d), 0.0)
    ins[2], ins[3] = ins[2] + off, ins[3] + off
    kin = ins[:2] + [t.to(dtype) for t in ins[2:]]
    kct = [t.to(dtype) for t in cts]
    pin, pct = [t.double() for t in kin], [t.double() for t in kct]
    name = "bwd_" + str(dtype).removeprefix("torch.")
    before = rs_ops.LAUNCHES[name]
    got = torch.ops.repro_torch.reg_stats_bwd(*kin, *kct, 7)
    again = torch.ops.repro_torch.reg_stats_bwd(*kin, *kct, 7)
    assert rs_ops.LAUNCHES[name] == before + 2
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    assert [g.dtype for g in got] == [F64, F64, dtype, dtype, dtype, dtype]
    needs = [True] * 6
    _hold_bwd(got, rs_ref.reg_stats_vjp_ref(*pin, *pct, needs),
              rs_ref.reg_stats_vjp_ref(*pin, *pct, needs, absolute=True),
              rs_ops.reg_stats_vjp(*pin, *pct, needs), dtype)


@pytest.mark.parametrize("n,m,q,dtype", PSI_CASES)
def test_psi2_bwd_matches_closed_form_and_recompute(cuda, n, m, q, dtype):
    """psi2's backward operator (every input's gradient) against
    ``psi2_vjp_ref`` and the chunked recompute, for a non-symmetric
    cotangent, and bitwise on a second call."""
    hyp, z, mu, s, w = _psi_inputs(2 * n + m, n, m, q, cuda, dtype)
    g = _t(np.random.default_rng(n).standard_normal((m, m)), cuda, dtype)
    kin = [hyp["log_sf2"], hyp["log_ell"], z, mu, s, w]
    pin, pg = [t.double() for t in kin], g.double()
    name = "psi2_bwd_" + str(dtype).removeprefix("torch.")
    before = ps_ops.LAUNCHES[name]
    got = torch.ops.repro_torch.psi2_bwd(*kin, g, 7)
    again = torch.ops.repro_torch.psi2_bwd(*kin, g, 7)
    assert ps_ops.LAUNCHES[name] == before + 2
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    needs = [True] * 6
    _hold_bwd(got, ps_ref.psi2_vjp_ref(*pin, pg, needs),
              ps_ref.psi2_vjp_ref(*pin, pg, needs, absolute=True),
              ps_ops.psi2_vjp(*pin, pg, needs), dtype)


PSI1_BWD_CASES = [(*shape, dtype) for shape in [
    (64, 16, 2), (100, 37, 3), (257, 64, 10), (1003, 150, 10),
    (4649, 150, 10), (1003, 300, 18), (33, 257, 5), (0, 37, 3), (1, 1, 1)]
    for dtype in DTYPES]


@pytest.mark.parametrize("n,m,q,dtype", PSI1_BWD_CASES)
def test_psi1_bwd_matches_closed_form_and_recompute(cuda, n, m, q, dtype):
    """psi1's backward operator (every input's gradient) against
    ``psi1_vjp_ref`` and the chunked recompute on the values the kernel
    sees, and bitwise on a second call: gplvm-usps, m past one 256-column
    tile, q past 16, an empty n."""
    hyp, z, mu, s, _ = _psi_inputs(3 * n + m, n, m, q, cuda, dtype)
    g = _t(np.random.default_rng(n + 1).standard_normal((n, m)), cuda, dtype)
    kin = [hyp["log_sf2"], hyp["log_ell"], z, mu, s]
    pin, pg = [t.double() for t in kin], g.double()
    pin[:2] = [t.to(dtype).double() for t in pin[:2]]  # as the kernel reads them
    name = "psi1_bwd_" + str(dtype).removeprefix("torch.")
    before = ps_ops.LAUNCHES[name]
    got = torch.ops.repro_torch.psi1_bwd(*kin, g, 3)
    again = torch.ops.repro_torch.psi1_bwd(*kin, g, 3)
    assert ps_ops.LAUNCHES[name] == before + 2
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    assert [t.dtype for t in got] == [F64, F64, dtype, dtype, dtype]
    needs = [True] * 5
    _hold_bwd(got, ps_ref.psi1_vjp_ref(*pin, pg, needs),
              ps_ref.psi1_vjp_ref(*pin, pg, needs, absolute=True),
              ps_ops.psi1_vjp(*pin, pg, needs), dtype)


@pytest.mark.parametrize("kernel", ["psi2", "psi1"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_psi_bwd_holds_offset_inputs(cuda, kernel, dtype):
    """mu and z shifted by +100 in every feature, at gplvm-usps's q and m
    off the patches: psi2's backward expands (mu - zbar)^2 after centring
    both on the mean of z, psi1's forms r directly; each holds the closed
    form at its tier and the chunked recompute (f64 normwise 1e-8), and
    is bitwise on a second call."""
    n, m, q = 1003, 151, 10
    hyp, z, mu, s, w = _psi_inputs(21, n, m, q, cuda, dtype)
    z, mu = z + 100.0, mu + 100.0
    rng = np.random.default_rng(22)
    if kernel == "psi2":
        g = _t(rng.standard_normal((m, m)), cuda, dtype)
        kin = [hyp["log_sf2"], hyp["log_ell"], z, mu, s, w]
        op, flags, needs = torch.ops.repro_torch.psi2_bwd, 7, [True] * 6
        closed, chunked = ps_ref.psi2_vjp_ref, ps_ops.psi2_vjp
    else:
        g = _t(rng.standard_normal((n, m)), cuda, dtype)
        kin = [hyp["log_sf2"], hyp["log_ell"], z, mu, s]
        op, flags, needs = torch.ops.repro_torch.psi1_bwd, 3, [True] * 5
        closed, chunked = ps_ref.psi1_vjp_ref, ps_ops.psi1_vjp
    pin, pg = [t.double() for t in kin], g.double()
    if kernel == "psi1":   # psi1 reads the log hyper-parameters in its dtype
        pin[:2] = [t.to(dtype).double() for t in pin[:2]]
    got, again = op(*kin, g, flags), op(*kin, g, flags)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    _hold_bwd(got, closed(*pin, pg, needs), closed(*pin, pg, needs, absolute=True),
              chunked(*pin, pg, needs), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_backward_zero_weight_rows_do_not_leak(cuda, dtype):
    """Rows of weight 0 get exactly zero d x, d y (reg_stats) and d mu,
    d s (psi2), and the shared gradients equal those over the kept rows
    alone to rounding."""
    ins, cts = _rs_bwd_inputs(11, 1037, 130, 3, 2, cuda)
    kin = ins[:2] + [t.to(dtype) for t in ins[2:]]
    kct = [t.to(dtype) for t in cts]
    keep = kin[5] > 0
    full = torch.ops.repro_torch.reg_stats_bwd(*kin, *kct, 7)
    kept = torch.ops.repro_torch.reg_stats_bwd(
        *kin[:3], *(t[keep] for t in kin[3:]), *kct, 7)
    assert not bool(full[3][~keep].any()) and not bool(full[4][~keep].any())
    tol = 1e-4 if dtype == torch.float32 else 1e-12
    for a, b in zip(full[:3], kept[:3]):
        torch.testing.assert_close(a, b, rtol=tol, atol=tol * float(b.abs().max()))
    hyp, z, mu, s, w = _psi_inputs(12, 1003, 70, 3, cuda, dtype)
    g = _t(np.random.default_rng(12).standard_normal((70, 70)), cuda, dtype)
    kin = [hyp["log_sf2"], hyp["log_ell"], z, mu, s, w]
    keep = w > 0
    full = torch.ops.repro_torch.psi2_bwd(*kin, g, 7)
    kept = torch.ops.repro_torch.psi2_bwd(*kin[:3], *(t[keep] for t in kin[3:]),
                                          g, 7)
    assert not bool(full[3][~keep].any()) and not bool(full[4][~keep].any())
    for a, b in zip(full[:3], kept[:3]):
        torch.testing.assert_close(a, b, rtol=tol, atol=tol * float(b.abs().max()))


def test_backward_kernels_raise_and_never_recompute(cuda, monkeypatch):
    """On the card the Functions' backward is the kernel or an error: a
    launch that fails raises, and the chunked recompute is never called."""
    from repro_torch.kernels import _vjp

    def refuse(*args, **kwargs):
        raise AssertionError("the chunked recompute ran on the card")
    monkeypatch.setattr(_vjp, "chunked_vjp", refuse)
    ins, cts = _rs_bwd_inputs(13, 300, 37, 3, 2, cuda)

    def kernel(log_sf2, log_ell, z, x, y, w):
        return rs_ops.reg_stats({"log_sf2": log_sf2, "log_ell": log_ell},
                                z, x, y, w)
    _grads(kernel, ins, cts)           # the kernel, no recompute
    hyp, z, mu, s, w = _psi_inputs(14, 300, 37, 3, cuda)

    def psi2(log_sf2, log_ell, z, mu, s, w):
        return ps_ops.psi2({"log_sf2": log_sf2, "log_ell": log_ell}, z, mu,
                           s, w)
    pin = [hyp["log_sf2"], hyp["log_ell"], z, mu, s, w]
    ct = (_t(np.random.default_rng(14).standard_normal((37, 37)), cuda),)
    _grads(psi2, pin, ct)

    def psi1(log_sf2, log_ell, z, mu, s):
        return ps_ops.psi1({"log_sf2": log_sf2, "log_ell": log_ell}, z, mu, s)
    ct1 = (_t(np.random.default_rng(15).standard_normal((300, 37)), cuda),)
    _grads(psi1, pin[:5], ct1)

    def fail(*args, **kwargs):
        raise RuntimeError("CUDA kernel failed to launch")
    monkeypatch.setattr(rs_k, "reg_stats_bwd", fail)
    with pytest.raises(RuntimeError, match="failed to launch"):
        _grads(kernel, ins, cts)
    from repro_torch.kernels.psi_stats import kernel as ps_k
    monkeypatch.setattr(ps_k, "psi2_bwd", fail)
    with pytest.raises(RuntimeError, match="failed to launch"):
        _grads(psi2, pin, ct)
    monkeypatch.setattr(ps_k, "psi1_bwd", fail)
    with pytest.raises(RuntimeError, match="failed to launch"):
        _grads(psi1, pin[:5], ct1)


@pytest.mark.parametrize("n,m,q,d", [(100_003, 130, 8, 4), (20_011, 512, 8, 4)])
def test_reg_stats_bwd_is_repeatable_across_slices(cuda, n, m, q, d):
    """More row tiles than SMs: the slices' partials are summed in a fixed
    order, so the SGPR's gradients (hyper-parameters and z) are bitwise
    the same across runs, in both dtypes."""
    ins, cts = _rs_bwd_inputs(15, n, m, q, d, cuda)
    for dtype in DTYPES:
        kin = ins[:2] + [t.to(dtype) for t in ins[2:]]
        kct = [t.to(dtype) for t in cts]
        first = torch.ops.repro_torch.reg_stats_bwd(*kin, *kct, 0)
        for _ in range(3):
            again = torch.ops.repro_torch.reg_stats_bwd(*kin, *kct, 0)
            assert all(torch.equal(a, b) for a, b in zip(first, again))
