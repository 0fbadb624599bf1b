"""The port's psi statistics against the JAX package's.

The same numpy inputs, made from a seed, go through ``repro`` and through
``repro_torch`` on the CPU, where the wrappers compute the plain versions:

* f64: the port's plain psi1/psi2 against JAX ``gp_kernels.se_psi1``,
  ``psi2_chunked`` and ``psi2_mxu``.  Both sides run the same closed forms
  in f64, so they agree to rounding: rtol 1e-12 (``psi2_mxu`` expands the
  square, whose cancellation at these O(1) inputs stays far below that).
* f32: the port's wrappers on f32 tensors against the JAX Pallas kernels in
  interpret mode (which compute in f32), at the f32 tier of
  ``tests/test_kernels_pallas.py``: rtol 2e-4, atol 2e-5.
* The backward helper of the CUDA Functions (``psi2_vjp``,
  ``reg_stats_vjp``, ``psi1_vjp``), called on CPU tensors, against
  ``torch.autograd.grad`` of the plain version: rtol 1e-10 (the same f64
  math, summed in row chunks, or in the dense form for reg_stats).

The CUDA kernels are held against the plain versions on the card in
``test_torch_cuda.py``.
"""
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import gp_kernels as j_gpk
from repro.kernels.psi_stats import ops as j_ps_ops
from repro_torch.core import covariance
from repro_torch.core import gp_kernels as t_gpk
from repro_torch.kernels import _vjp
from repro_torch.kernels.psi_stats import kernel as ps_k
from repro_torch.kernels.psi_stats import ops as ps_ops
from repro_torch.kernels.psi_stats import ref as ps_ref
from repro_torch.kernels.reg_stats import ops as rs_ops
from repro_torch.kernels.reg_stats import ref as rs_ref

SHAPES = [
    (64, 16, 2),     # exact tile fit after padding
    (100, 37, 3),    # nothing divides anything
    (257, 64, 10),   # q at paper-scale latent dim
    (32, 130, 1),    # m > one tile, q = 1
]


def _inputs(seed, n, m, q, masked=True):
    rng = np.random.default_rng(seed)
    hyp = {"log_sf2": np.asarray(rng.uniform(-0.5, 0.8)),
           "log_ell": rng.uniform(-0.4, 0.4, q)}
    z = rng.standard_normal((m, q))
    mu = rng.standard_normal((n, q))
    s = rng.uniform(0.05, 0.8, (n, q))
    w = ((rng.uniform(size=n) > 0.15).astype(np.float64) if masked
         else np.ones(n))
    return hyp, z, mu, s, w


def _jax(hyp, *arrs):
    return {k: jnp.asarray(v) for k, v in hyp.items()}, *map(jnp.asarray, arrs)


def _torch(hyp, *arrs, dtype=torch.float64):
    def t(a):
        return torch.from_numpy(np.array(a, dtype=np.float64)).to(dtype=dtype)
    return {k: t(v) for k, v in hyp.items()}, *map(t, arrs)


def _close(got, want, rtol=1e-12, atol=1e-14):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=rtol,
                               atol=atol)


@pytest.mark.parametrize("n,m,q", SHAPES)
def test_plain_psi1_matches_jax(n, m, q):
    hyp, z, mu, s, _ = _inputs(n + m, n, m, q)
    want = j_gpk.se_psi1(*_jax(hyp, z, mu, s))
    th, tz, tmu, ts = _torch(hyp, z, mu, s)
    _close(ps_ops.psi1(th, tz, tmu, ts), want)
    _close(ps_ref.psi1_ref(th["log_sf2"], th["log_ell"], tz, tmu, ts,
                           chunk=7), want)
    _close(t_gpk.se_psi1(th, tz, tmu, ts), want)


@pytest.mark.parametrize("n,m,q", SHAPES)
def test_plain_psi2_matches_jax(n, m, q):
    """Unweighted against ``psi2_chunked``; weighted (15% zero weights)
    against ``psi2_mxu``."""
    hyp, z, mu, s, w = _inputs(2 * n + m, n, m, q)
    jh, jz, jmu, js, jw = _jax(hyp, z, mu, s, w)
    th, tz, tmu, ts, tw = _torch(hyp, z, mu, s, w)
    want = j_gpk.psi2_chunked(jh, jz, jmu, js, chunk=64)
    _close(ps_ops.psi2(th, tz, tmu, ts, torch.ones_like(tw)), want)
    _close(t_gpk.psi2_chunked(th, tz, tmu, ts, chunk=64), want)
    want_w = j_gpk.psi2_mxu(jh, jz, jmu, js, jw, chunk=64)
    got_w = ps_ref.psi2_ref(th["log_sf2"], th["log_ell"], tz, tmu, ts, tw,
                            chunk=33)
    _close(got_w, want_w)
    _close(ps_ops.psi2(th, tz, tmu, ts, tw), want_w)


def test_per_point_and_kl_match_jax():
    hyp, z, mu, s, _ = _inputs(3, 20, 9, 2)
    jh, jz, jmu, js = _jax(hyp, z, mu, s)
    th, tz, tmu, ts = _torch(hyp, z, mu, s)
    for got in (t_gpk.psi2_per_point(th, tz, tmu, ts),
                covariance.SE_ARD.psi2_per_point(th, tz, tmu, ts)):
        _close(got, j_gpk.psi2_per_point(jh, jz, jmu, js))
    assert covariance.SE_ARD.analytic_psi()
    _close(t_gpk.kl_to_standard_normal(tmu, ts),
           j_gpk.kl_to_standard_normal(jmu, js))
    _close(t_gpk.se_psi0(th, tmu, ts), j_gpk.se_psi0(jh, jmu, js))


@pytest.mark.parametrize("n,m,q", SHAPES)
def test_f32_wrappers_match_pallas_interpret(n, m, q):
    hyp, z, mu, s, w = _inputs(3 * n + m, n, m, q)
    jh, jz, jmu, js, jw = _jax(hyp, z, mu, s, w)
    th, tz, tmu, ts, tw = _torch(hyp, z, mu, s, w, dtype=torch.float32)
    want2 = j_ps_ops.psi2(jh, jz, jmu, js, jw, block_n=64, block_m=32)
    got2 = ps_ops.psi2(th, tz, tmu, ts, tw)
    assert got2.dtype == torch.float32
    _close(got2, want2, rtol=2e-4, atol=2e-5)
    want1 = j_ps_ops.psi1(jh, jz, jmu, js, block_n=64, block_m=64)
    got1 = ps_ops.psi1(th, tz, tmu, ts)
    assert got1.dtype == torch.float32
    _close(got1, want1, rtol=2e-4, atol=2e-5)


def test_wrappers_take_bf16_through_f32():
    """Sub-f32 inputs run the f32 plain version and come back in bf16."""
    hyp, z, mu, s, w = _inputs(9, 30, 8, 2)
    th, tz, tmu, ts, tw = _torch(hyp, z, mu, s, w, dtype=torch.bfloat16)
    got = ps_ops.psi2(th, tz, tmu, ts, tw)
    assert got.dtype == torch.bfloat16
    want = ps_ref.psi2_ref(*(v.float() for v in (th["log_sf2"], th["log_ell"],
                                                 tz, tmu, ts, tw)))
    torch.testing.assert_close(got, want.bfloat16(), rtol=0, atol=0)


def _plain_grads(fn, inputs, cts):
    leaves = [t.detach().requires_grad_(True) for t in inputs]
    outs = fn(*leaves)
    outs = outs if isinstance(outs, tuple) else (outs,)
    return torch.autograd.grad(outs, leaves, cts)


def _assert_grads(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        _close(g.numpy(), w.numpy(), rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("chunk", [7, 1000])
def test_psi2_vjp_matches_autograd(chunk, monkeypatch):
    """``psi2_vjp``, the CUDA Function's backward, on CPU tensors; a chunk
    that divides nothing, and one chunk holding every row."""
    monkeypatch.setattr(_vjp, "CHUNK_ELEMS", chunk * 37 * 37 * 3)
    hyp, z, mu, s, w = _inputs(5, 100, 37, 3)
    th, tz, tmu, ts, tw = _torch(hyp, z, mu, s, w)
    inputs = [th["log_sf2"], th["log_ell"], tz, tmu, ts, tw]
    ct = torch.from_numpy(np.random.default_rng(1).standard_normal((37, 37)))
    got = ps_ops.psi2_vjp(*inputs, ct, [True] * 6)
    _assert_grads(got, _plain_grads(ps_ref.psi2_ref, inputs, (ct,)))
    partial = ps_ops.psi2_vjp(*inputs, ct, [False, True, False, True, False,
                                            False])
    assert [g is None for g in partial] == [True, False, True, False, True,
                                            True]
    _assert_grads([partial[1], partial[3]], [got[1], got[3]])


def test_psi1_vjp_matches_autograd(monkeypatch):
    monkeypatch.setattr(_vjp, "CHUNK_ELEMS", 11 * 16 * 2)
    hyp, z, mu, s, _ = _inputs(6, 50, 16, 2)
    th, tz, tmu, ts = _torch(hyp, z, mu, s)
    inputs = [th["log_sf2"], th["log_ell"], tz, tmu, ts]
    ct = torch.from_numpy(np.random.default_rng(2).standard_normal((50, 16)))
    _assert_grads(ps_ops.psi1_vjp(*inputs, ct, [True] * 5),
                  _plain_grads(ps_ref.psi1_ref, inputs, (ct,)))


def test_reg_stats_vjp_matches_autograd(monkeypatch):
    """``reg_stats_vjp`` (dense recompute, row chunks of 13) against
    autograd of the plain version."""
    monkeypatch.setattr(_vjp, "CHUNK_ELEMS", 13 * 12)
    rng = np.random.default_rng(7)
    n, m, q, d = 90, 12, 3, 2
    inputs = [torch.from_numpy(np.asarray(a, np.float64)) for a in (
        rng.uniform(-0.5, 0.8), rng.uniform(-0.4, 0.4, q),
        rng.standard_normal((m, q)), rng.standard_normal((n, q)),
        rng.standard_normal((n, d)), (rng.uniform(size=n) > 0.2) * 1.0)]
    cts = tuple(torch.from_numpy(rng.standard_normal(sh))
                for sh in ((), (m, d), (m, m)))
    _assert_grads(rs_ops.reg_stats_vjp(*inputs, *cts, [True] * 6),
                  _plain_grads(rs_ref.reg_stats_ref, inputs, cts))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("kind", ["psi2", "psi1"])
def test_shared_memory_is_fixed_and_fits(kind, dtype):
    """The CUDA blocks' shared memory is one constant per kernel and dtype
    for q >= 16, and no more below: z, mu and 1/(l^2 + c s) are staged 16
    features at a time (psi2: z of both 64-point tiles, the alphas of their
    points for 32 rows, each of the 256 threads' 16 running sums (f32: the
    staged rows' u and v, 16,384 floats, which the sums reuse), 32 rows of
    mu and 1/(2 (l^2 + 2s)) (f32: also their log1p(2 s / l^2), which the
    f32 kernel's units compute themselves), their log-normalisers and
    weights; psi1: z of 256 columns transposed, row stride 256 + one
    16-byte run, for min(q, 16) features, and 32 rows of mu, 1/(l^2 + s)
    and log1p(s / l^2), row stride 17, and the rows' log-normalisers).  It
    fits the card's 227 KB, psi2 f32's twice over an SM's 228 KB; psi1's,
    with its 512-byte exp table, fits the 48 KB a launch gets without an
    attribute call."""
    item = torch.empty((), dtype=dtype).element_size()
    f32 = dtype == torch.float32
    for q in (1, 10, 150, 224, 300, 1000):
        want = item * ((2 * 16 * 64 + 2 * 32 * 64
                        + (16_384 if f32 else 16 * 256)
                        + (3 if f32 else 2) * 32 * 16 + 2 * 32)
                       if kind == "psi2"
                       else (min(q, 16) * (256 + 16 // item) + 3 * 32 * 17
                             + 32))
        assert ps_k.smem_bytes(kind, q, dtype) == want <= ps_k.SMEM_MAX
        if kind == "psi1":
            assert want + 512 <= 48 * 1024
        if (kind, dtype) == ("psi2", torch.float32):
            assert 2 * (want + 1024) <= 233_472 and want == 96_512
    assert ps_k.smem_bytes(kind, 10 ** 6, dtype) == ps_k.smem_bytes(kind, 16,
                                                                    dtype)


def _psi2_centred(log_sf2, log_ell, z, mu, s, w):
    """psi2 through the CUDA kernel's centred exponent, in plain torch.
    Per row i and pair (a, b), with u_a = mu_i - z_a and c = l^2 + 2 s_i:
    lognorm_i + alpha_ia + alpha_ib + sum_q u_a (z_b - mu_i) / (2c), where
    alpha_ia = -sum_q u_a^2 / (4c); times exp(static_ab) and sf2^2."""
    l2 = torch.exp(2.0 * log_ell)
    iv = 1.0 / (4.0 * s + 2.0 * l2)                       # 1 / (2c), (n, q)
    u = mu[:, None, :] - z[None, :, :]                     # (n, m, q)
    alpha = -0.5 * (u * (u * iv[:, None, :])).sum(-1)      # (n, m)
    cross = torch.einsum("iaq,ibq->iab", u, -u * iv[:, None, :])
    lognorm = -0.5 * torch.log1p(2.0 * s / l2).sum(-1)
    static = -0.25 * ((z[:, None, :] - z[None, :, :]) ** 2 / l2).sum(-1)
    e = lognorm[:, None, None] + alpha[:, :, None] + alpha[:, None, :] + cross
    return (torch.exp(2.0 * log_sf2) * torch.exp(static)
            * torch.einsum("i,iab->ab", w, torch.exp(e)))


def _psi2_log2_form(log_sf2, log_ell, z, mu, s, w):
    """psi2 as the f32 CUDA kernel forms it, in f64 numpy: the exponent in
    log2 units, log2(e) folded into 1/(2c) (so into the alphas and the
    cross term) and into the log-normaliser, l^2 = exp(2 log_ell), one 2^x
    a pair; exp(static) and sf2^2 applied after the sum, as its reduce
    does."""
    log2e = 1.0 / np.log(2.0)
    l2 = np.exp(2.0 * log_ell)
    iv = log2e / (4.0 * s + 2.0 * l2)                     # (n, q)
    ln = log2e * (-0.5 * np.log1p(2.0 * s / l2).sum(-1))  # (n,)
    u = mu[:, None, :] - z[None, :, :]                     # (n, m, q)
    alpha = -0.5 * (u * (u * iv[:, None, :])).sum(-1)      # (n, m)
    cross = np.einsum("iaq,ibq->iab", u, -u * iv[:, None, :])
    e = ln[:, None, None] + alpha[:, :, None] + alpha[:, None, :] + cross
    static = -0.25 * ((z[:, None, :] - z[None, :, :]) ** 2 / l2).sum(-1)
    return np.exp(2.0 * log_sf2) * np.exp(static) * np.einsum(
        "i,iab->ab", w, 2.0 ** e)


def _midway(seed, n, m, q, scale):
    """Pairs of inducing points at +-scale d_j (unit d_j, l^2 = q) and
    means near 0, midway between them: there the centred exponent's terms
    (alpha ~ scale^2 / (4 (q + 2 s))) are largest against their sum."""
    rng = np.random.default_rng(seed)
    d = rng.standard_normal((m // 2, q))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    z = np.concatenate([scale * d, -scale * d])
    hyp = {"log_sf2": np.asarray(0.3), "log_ell": np.full(q, 0.5 * np.log(q))}
    mu = 1e-3 * rng.standard_normal((n, q))
    s = rng.uniform(0.05, 1.0, (n, q))
    w = (rng.uniform(size=n) > 0.15).astype(np.float64)
    return hyp, z, mu, s, w


@pytest.mark.parametrize("case", [*SHAPES, (37, 151, 10), "midway"])
def test_centred_exponent_matches_plain(case):
    """The CUDA psi2's exponent form against the direct form of
    ``psi2_ref``, f64, rtol 1e-12: its terms are of the size of the direct
    form's own (u_a^2/c against (mu - zbar)^2/c + (z_a - z_b)^2/(4 l^2)),
    so unlike the Pallas body's expansion in mu^2/c it does not cancel;
    ``midway`` puts every row between far-apart z_a, z_b (terms ~ 120,
    D down to exp(-490))."""
    if case == "midway":
        hyp, z, mu, s, w = _midway(11, 40, 24, 10, 70.0)
    else:
        n, m, q = case
        hyp, z, mu, s, w = _inputs(5 * n + m, n, m, q)
    th, tz, tmu, ts, tw = _torch(hyp, z, mu, s, w)
    args = (th["log_sf2"], th["log_ell"], tz, tmu, ts, tw)
    want = ps_ref.psi2_ref(*args)
    assert float(want.min()) > 0.0
    _close(_psi2_centred(*args), want, rtol=1e-12, atol=0.0)


@pytest.mark.parametrize("case", [*SHAPES, (37, 151, 10), (20, 65, 20),
                                  "midway"])
def test_f32_exponent_in_log2_units_matches_plain(case):
    """The f32 CUDA psi2's arithmetic (centred exponent in log2 units, one
    2^x a pair) in f64 against ``psi2_ref``: rtol 1e-12, the fold of
    log2(e) moves nothing but rounding.  ``midway`` at the f32 check's
    scale (20: D down to exp(-40), inside f32's range)."""
    if case == "midway":
        hyp, z, mu, s, w = _midway(17, 40, 24, 10, 20.0)
    else:
        n, m, q = case
        hyp, z, mu, s, w = _inputs(9 * n + m, n, m, q)
    th, tz, tmu, ts, tw = _torch(hyp, z, mu, s, w)
    want = ps_ref.psi2_ref(th["log_sf2"], th["log_ell"], tz, tmu, ts, tw)
    got = _psi2_log2_form(hyp["log_sf2"], hyp["log_ell"], z, mu, s, w)
    assert float(want.min()) > 0.0
    _close(got, want, rtol=1e-12, atol=0.0)


def _tile_patches(m):
    """The global patch indices the CUDA psi2's tiles give their threads:
    a mirror of ``psi2_tiles``' packing (a diagonal tile's triangle, a
    ragged tile's patches below m) and of ``patch_index``."""
    tm, pp, nt = ps_k.TILE, ps_k.PATCH, ps_k.THREADS
    nts, np_ = -(-m // tm), -(-m // pp)
    seen = []
    for ta in range(nts):
        for tb in range(ta, nts):
            na = min(tm // pp, -(-(m - ta * tm) // pp))
            nb = min(tm // pp, -(-(m - tb * tm) // pp))
            count = na * (na + 1) // 2 if ta == tb else na * nb
            groups = max(1, nt // count)
            assert 1 <= count and groups * count <= nt
            for lt in range(count):
                if ta == tb:
                    pa, r = 0, lt
                    while r >= na - pa:
                        r, pa = r - (na - pa), pa + 1
                    pb = pa + r
                else:
                    pa, pb = divmod(lt, nb)
                ga, gb = ta * tm // pp + pa, tb * tm // pp + pb
                assert ga <= gb < np_
                seen.append(ga * np_ - ga * (ga - 1) // 2 + gb - ga)
    return seen, np_ * (np_ + 1) // 2


@pytest.mark.parametrize("m", [1, 4, 63, 64, 65, 100, 150, 151, 300])
def test_psi2_tiles_pack_each_upper_patch_once(m):
    """Every upper 4x4 patch of D (pa <= pb < ceil(m/4)) belongs to
    exactly one thread of one tile, and nothing past it: the pairs the
    kernel evaluates are D's upper triangle up to the patches' edges."""
    seen, n_patches = _tile_patches(m)
    assert sorted(seen) == list(range(n_patches))
    pairs = 16 * n_patches
    assert pairs >= m * (m + 1) // 2
    if m == 150:     # gplvm-usps: 11,856 pairs evaluated for 11,325
        assert pairs == 11_856


@pytest.mark.parametrize("n,m", [(0, 5), (1, 1), (4649, 150), (100_000, 100),
                                 (1003, 37), (1000, 23_105), (1000, 30_000),
                                 (50, 100_000)])
def test_psi2_plan_covers_every_row_and_refuses_no_m(n, m):
    """psi2's plan covers the n rows once in slices of whole 32-row chunks
    at any m, without a launch: the units go on gridDim.x (and are walked
    grid-stride past it), where the old grid put the tiles on gridDim.y and
    refused m > 23,104."""
    n_tiles, n_slices, rows = ps_k.psi2_plan(n, m, 132)
    nts = -(-m // ps_k.TILE)
    assert n_tiles == nts * (nts + 1) // 2
    assert rows % ps_k.ROWS == 0 and rows >= ps_k.ROWS
    assert n_slices >= 1 and (n_slices - 1) * rows < max(n, 1)
    assert n_slices * rows >= n
    if n_tiles < ps_k.UNITS_PER_SM * 132 and n >= 32 * 132 * 8:
        # about UNITS_PER_SM units per SM, less the rounding to whole chunks
        assert n_tiles * n_slices >= 0.9 * ps_k.UNITS_PER_SM * 132
    np_ = -(-m // 4)
    assert ps_k.psi2_scratch_len(n, m, 10, n_slices) == (
        n_slices * np_ * (np_ + 1) // 2 * 16 + 11 * (n + 1))
    if m >= 23_105:
        assert n_tiles > 65_535


@pytest.mark.parametrize("m", [1, 4, 63, 64, 65, 100, 150, 151, 300])
def test_psi2_f32_partials_are_written_and_read_once(m):
    """The f32 kernel's partials, laid out [slice][entry][patch]: the tiles'
    threads (``_tile_patches``) write each (entry, patch) offset of a slice
    exactly once, and the reduce's threads (a mirror of
    ``psi2_f32_reduce``: thread t takes entry t // np^2 of patch
    divmod(t % np^2, np)) read each pair a <= b < m exactly once, each at
    the offset its patch's thread wrote, and consecutive threads of one
    (entry, patch row) read consecutive offsets (the loads coalesce)."""
    pp = ps_k.PATCH
    seen, n_patches = _tile_patches(m)
    written = {e * n_patches + p for p in seen for e in range(pp * pp)}
    assert written == set(range(pp * pp * n_patches))
    np_ = -(-m // pp)
    t = np.arange(pp * pp * np_ * np_)
    e, rem = t // (np_ * np_), t % (np_ * np_)
    pa, pb = rem // np_, rem % np_
    a, b = pa * pp + e // pp, pb * pp + e % pp
    ok = (pa <= pb) & (a <= b) & (b < m)
    off = e * n_patches + pa * np_ - pa * (pa - 1) // 2 + (pb - pa)
    assert set(off[ok].tolist()) <= written
    pairs = a[ok] * m + b[ok]
    assert len(pairs) == len(set(pairs.tolist())) == m * (m + 1) // 2
    row = (e * np_ + pa)[ok]
    same_row = row[1:] == row[:-1]
    assert np.all(np.diff(off[ok])[same_row] == 1)


@pytest.mark.parametrize("n,m", [(0, 5), (1, 1), (4649, 150), (100_000, 100),
                                 (1003, 37), (20, 65), (1000, 30_000),
                                 (50, 100_000)])
def test_psi2_f32_scratch_is_the_plans_partials(n, m):
    """The f32 kernel takes the f64 plan (about 8 units an SM: at gplvm-usps
    146 slices of one 32-row chunk) and a scratch of the slice partials
    alone, one per upper patch entry: its units compute their rows' terms,
    which the f64 launcher stages after the partials."""
    n_tiles, n_slices, rows = ps_k.psi2_plan(n, m, 132)
    if (n, m) == (4649, 150):
        assert (n_tiles, n_slices, rows) == (6, 146, 32)
    np_ = -(-m // 4)
    partials = n_slices * np_ * (np_ + 1) // 2 * 16
    assert ps_k.psi2_scratch_len(n, m, 10, n_slices, torch.float32) == partials
    assert ps_k.psi2_scratch_len(n, m, 10, n_slices) == (partials
                                                         + 11 * (n + 1))


def _psi1_cover(n, m, dtype):
    """How often the CUDA psi1 writes each (row, column): a mirror of
    ``psi1_tiles``' units, items and runs over :func:`psi1_plan`."""
    rows, rpt, col_tiles = ps_k.psi1_plan(n, m, dtype)
    vec = 16 // torch.empty((), dtype=dtype).element_size()
    runs = -(-m // vec)
    assert 1 <= rows <= ps_k.P1_ROWS and 1 <= rpt * vec <= ps_k.P1_COLS + vec
    assert rows * rpt <= ps_k.THREADS * ps_k.P1_ITEMS
    count = np.zeros(n * m, np.int64)
    unit = np.arange(-(-n // rows) * col_tiles)[:, None]
    it = np.arange(ps_k.THREADS * ps_k.P1_ITEMS)[None, :]
    r0, j0 = unit // col_tiles * rows, unit % col_tiles * rpt
    nr, nj = np.minimum(rows, n - r0), np.minimum(rpt, runs - j0)
    r, j = it // nj, it % nj
    for v in range(vec):
        col = (j0 + j) * vec + v
        ok = (it < nr * nj) & (col < m)
        np.add.at(count, ((r0 + r) * m + col)[ok], 1)
    return count, rows, rpt, col_tiles


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n,m", [(4649, 150), (100_000, 100),
                                 *[(n, m) for n in (0, 1, 31, 33)
                                   for m in (1, 37, 63, 65, 151)],
                                 (40, 257), (5, 1000)])
def test_psi1_plan_covers_every_entry_once(n, m, dtype):
    """psi1's units write every (row, column) of the (n, m) output exactly
    once and nothing past it.  At gplvm-usps a unit is 13 f64 rows of all
    150 columns (358 units for 132 SMs), and 26 f32 rows."""
    count, rows, rpt, col_tiles = _psi1_cover(n, m, dtype)
    assert np.all(count == 1)
    if (n, m) == (4649, 150):
        assert (rows, col_tiles) == ((13, 1) if dtype == torch.float64
                                     else (26, 1))
        assert -(-n // rows) * col_tiles >= 132


def _exp_table():
    """2^(j/32) as hi + lo, read from the CUDA source's kExp2Frac."""
    src = (pathlib.Path(ps_k.__file__).resolve().parents[2] / "csrc"
           / "psi_stats.cu").read_text()
    body = src.split("kExp2Frac[64] = {")[1].split("};")[0]
    vals = [float.fromhex(v.strip()) for v in body.split(",") if v.strip()]
    assert len(vals) == 64
    return np.array(vals[:32]), np.array(vals[32:])


def _exp_pair(x):
    """The CUDA exp_pair in numpy (its fused multiply-adds rounded twice)."""
    hi_t, lo_t = _exp_table()
    x = np.maximum(x, -750.0)
    shift = float.fromhex("0x1.8p+52")
    nd = (x * float.fromhex("0x1.71547652b82fep+5") + shift) - shift
    n = nd.astype(np.int64)
    r = x - nd * float.fromhex("0x1.62e42fef00000p-6")
    r = r - nd * float.fromhex("0x1.473de6af278edp-39")
    p = r * (1.0 / 720) + 1.0 / 120
    for c in (1.0 / 24, 1.0 / 6, 0.5, 1.0):
        p = p * r + c
    hi, lo = hi_t[n & 31], lo_t[n & 31]
    e = hi + (hi * (p * r) + lo)
    mm = n >> 5
    m1 = mm >> 1
    return np.ldexp(np.ldexp(e, m1), mm - m1)


def _psi1_kernel_form(log_sf2, log_ell, z, mu, s):
    """psi1 as the CUDA kernel forms it, f64 numpy: 1/(l^2 + s) multiplied,
    log1p(s / l^2) summed in feature order, exp_pair."""
    l2 = np.exp(2.0 * log_ell)
    inv = 1.0 / (l2 + s)                                  # (n, q)
    ln = np.zeros(mu.shape[0])
    for k in range(mu.shape[1]):
        ln = ln + np.log1p(s[:, k] / l2[k])
    acc = np.zeros((mu.shape[0], z.shape[0]))
    for k in range(mu.shape[1]):
        d = mu[:, k:k + 1] - z[None, :, k]
        acc = (d * inv[:, k:k + 1]) * d + acc
    return np.exp(log_sf2) * _exp_pair(-0.5 * acc + (-0.5 * ln)[:, None])


@pytest.mark.parametrize("case", [*SHAPES, (37, 151, 10), "far"])
def test_psi1_exponent_and_exp_match_plain(case):
    """The CUDA psi1's f64 arithmetic (direct exponent, branch-free exp)
    against ``psi1_ref`` at the f64 tier of the card's checks, 1e-10
    |plain| + 1e-11 |plain|; ``far`` puts rows 25-30 lengthscales from
    every inducing point (psi1 down to ~1e-200, still normal f64) and one
    row so far that both give exactly 0."""
    if case == "far":
        hyp, z, mu, s, _ = _inputs(13, 40, 24, 10)
        direction = mu / np.linalg.norm(mu, axis=1, keepdims=True)
        mu = np.concatenate([z[:8] + 0.1 * mu[:8],
                             (25.0 + 5.0 * np.linspace(0, 1, 31))[:, None]
                             * direction[8:39] * np.exp(hyp["log_ell"]),
                             400.0 * direction[39:]])
    else:
        n, m, q = case
        hyp, z, mu, s, _ = _inputs(7 * n + m, n, m, q)
    th, tz, tmu, ts = _torch(hyp, z, mu, s)
    want = ps_ref.psi1_ref(th["log_sf2"], th["log_ell"], tz, tmu, ts).numpy()
    got = _psi1_kernel_form(hyp["log_sf2"], hyp["log_ell"], z, mu, s)
    err = np.abs(got - want)
    assert np.all(err <= 1e-10 * np.abs(want) + 1e-11 * np.abs(want))
    if case == "far":
        assert want[8:39].min() > 1e-300 and want[8:39].max() < 1e-60
        assert np.all(want[39:] == 0.0) and np.all(got[39:] == 0.0)
