"""The port's regression map step against the JAX package's.

The same numpy inputs, made from a seed, go through ``repro`` (the fused
Pallas kernel in interpret mode, f64, and the dense XLA formulation) and
through ``repro_torch`` on the CPU, where the wrapper computes the plain
version.  Both run the same f64 math, so they agree to rounding: rtol 1e-12.
The CUDA kernel is held against the plain version on the card in
``test_torch_cuda.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import stats as j_stats
from repro.kernels.reg_stats import ops as j_rs_ops
from repro_torch.core import stats as t_stats
from repro_torch.kernels.reg_stats import ops as rs_ops
from repro_torch.kernels.reg_stats import ref as rs_ref

SHAPES = [
    (64, 16, 2, 1),     # exact tile fit after padding
    (100, 37, 3, 2),    # nothing divides anything
    (257, 64, 10, 5),   # q at paper-scale latent dim, multi-output
    (32, 130, 1, 3),    # m > one tile, q=1
]


def _inputs(seed, n, m, q, d, masked=True):
    rng = np.random.default_rng(seed)
    hyp = {"log_sf2": np.asarray(rng.uniform(-0.5, 0.8)),
           "log_ell": rng.uniform(-0.4, 0.4, q),
           "log_beta": np.asarray(1.0)}
    z = rng.standard_normal((m, q))
    x = rng.standard_normal((n, q))
    y = rng.standard_normal((n, d))
    w = ((rng.uniform(size=n) > 0.15).astype(np.float64) if masked
         else np.ones(n))
    return hyp, z, x, y, w


def _jax(hyp, *arrs):
    return {k: jnp.asarray(v) for k, v in hyp.items()}, *map(jnp.asarray, arrs)


def _torch(hyp, *arrs, device="cpu"):
    def t(a):
        return torch.from_numpy(np.array(a, dtype=np.float64)).to(device)
    return {k: t(v) for k, v in hyp.items()}, *map(t, arrs)


def _close(got, want, rtol=1e-12, atol=1e-14, name=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol, err_msg=name)


@pytest.mark.parametrize("n,m,q,d", SHAPES)
def test_plain_matches_pallas_interpret(n, m, q, d):
    hyp, z, x, y, w = _inputs(n + m, n, m, q, d)
    jh, jz, jx, jy, jw = _jax(hyp, z, x, y, w)
    want = j_rs_ops.reg_stats(jh, jz, jx, jy, jw, block_n=64, block_m=32)
    th, tz, tx, ty, tw = _torch(hyp, z, x, y, w)
    got = rs_ops.reg_stats(th, tz, tx, ty, tw)
    for name, g, e in zip("bCD", got, want):
        assert g.dtype == torch.float64
        _close(g, e, name=name)


@pytest.mark.parametrize("n,m,q,d", SHAPES)
def test_plain_and_dense_match_jax_dense(n, m, q, d):
    hyp, z, x, y, w = _inputs(2 * n + m, n, m, q, d)
    want = j_stats.reg_stats_dense(*_jax(hyp, z, x, y, w))
    th, tz, tx, ty, tw = _torch(hyp, z, x, y, w)
    for got in (rs_ref.reg_stats_ref(th["log_sf2"], th["log_ell"], tz, tx,
                                     ty, tw),
                t_stats.reg_stats_dense(th, tz, tx, ty, tw)):
        for name, g, e in zip("bCD", got, want):
            _close(g, e, name=name)


@pytest.mark.parametrize("block_size", [13, 1000])
def test_chunked_equals_monolithic(block_size):
    """Zero-weight padding and the left-to-right fold: a block size that
    divides nothing gives the monolithic statistics, as in the JAX package."""
    n, m, q, d = 53, 9, 2, 2
    hyp, z, x, y, w = _inputs(7, n, m, q, d)
    th, tz, tx, ty, tw = _torch(hyp, z, x, y, w)
    full = t_stats.partial_stats(th, tz, ty, tx, weights=tw)
    ch = t_stats.partial_stats_chunked(th, tz, ty, tx, weights=tw,
                                       block_size=block_size)
    jh, jz, jx, jy, jw = _jax(hyp, z, x, y, w)
    jch = j_stats.partial_stats_chunked(jh, jz, jy, jx, s=None, weights=jw,
                                        latent=False, block_size=block_size)
    for name, a, b, c in zip(full._fields, full, ch, jch):
        _close(b, a, rtol=1e-10, atol=1e-12, name=name)
        _close(b, c, rtol=1e-12, atol=1e-12, name=name)


def test_partial_stats_matches_jax():
    hyp, z, x, y, w = _inputs(11, 77, 12, 2, 3)
    th, tz, tx, ty, tw = _torch(hyp, z, x, y, w)
    jh, jz, jx, jy, jw = _jax(hyp, z, x, y, w)
    got = t_stats.partial_stats(th, tz, ty, tx, weights=tw)
    want = j_stats.partial_stats(jh, jz, jy, jx, s=None, weights=jw,
                                 latent=False)
    for name, g, e in zip(got._fields, got, want):
        _close(g, e, atol=1e-12, name=name)
    total = t_stats.reduce_stats([got, got.scale(2.0)])
    _close(total.D, 3.0 * got.D, name="reduce")
    _close((total - got).C, 2.0 * got.C, name="sub")


def test_latent_branch_is_queued():
    """The latent branch, for SE-ARD and (since the kernel zoo, ROADMAP
    Queue 1 item 6, which this test once found queued) for another
    expression, Matern-3/2 by quadrature: JAX's Stats at 1e-12."""
    hyp, z, x, y, _ = _inputs(3, 10, 4, 2, 1)
    th, tz, tx, ty = _torch(hyp, z, x, y)
    jh, jz, jx, jy = _jax(hyp, z, x, y)
    st = t_stats.partial_stats(th, tz, ty, tx, s=torch.ones_like(tx),
                               latent=True)
    assert bool(torch.isfinite(st.D).all()) and float(st.KL) > 0.0
    spec = '{"kind": "matern32"}'
    got = t_stats.partial_stats(th, tz, ty, tx, s=0.1 * torch.ones_like(tx),
                                latent=True, kernel=spec)
    want = j_stats.partial_stats(jh, jz, jy, jx, s=0.1 * jnp.ones_like(jx),
                                 latent=True, kernel=spec)
    for name, g, e in zip(got._fields, got, want):
        _close(g, e, atol=1e-12, name=name)


# -- host-side helpers of the CUDA kernels (f64 DMMA, f32 FMA tiles) ------------

from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.reg_stats import kernel as rs_k  # noqa: E402


@pytest.mark.parametrize("n,m,sms", [(1_000_000, 512, 132), (1_000_003, 130, 132),
                                     (1_000_000, 600, 132), (64, 16, 132),
                                     (5000, 200, 132), (10**6, 4096, 132),
                                     (100, 37, 1)])
def test_fill_plan_fills_the_sms_once_and_covers_every_row(n, m, sms):
    """One block per SM: (upper tiles) x (n-slices) blocks, at most one per
    SM unless a single slice already needs more; the slices are whole
    chunks and together cover n exactly once."""
    tile, rows = rs_k.TILE, rs_k.ROWS
    n_tiles, n_slices, per_slice = _build.fill_plan(n, m, sms, tile, rows)
    nts = -(-m // tile)
    assert n_tiles == nts * (nts + 1) // 2
    assert per_slice % rows == 0
    assert (n_slices - 1) * per_slice < n <= n_slices * per_slice
    assert n_slices == 1 or n_tiles * n_slices <= sms


def test_fill_plan_at_sgpr_synth_1m():
    """sgpr-synth-1m on an H100 (132 SMs): 10 upper 128-tiles x 13 slices,
    130 blocks."""
    assert _build.fill_plan(1_000_000, 512, 132, 128, 32) == (10, 13, 76_928)


def test_f32_fill_plan_at_sgpr_synth_1m():
    """sgpr-synth-1m's f32 plan on an H100: two blocks an SM (264 slots), 10
    upper 128-tiles x 26 slices, 260 blocks in one wave."""
    slots = 132 * rs_k.F32_BLOCKS_PER_SM
    assert _build.fill_plan(1_000_000, 512, slots, rs_k.TILE, rs_k.ROWS) == (
        10, 26, 38_464)


@pytest.mark.parametrize("q,d", [(8, 4), (1, 1), (10, 5), (3, 5)])
def test_f64_shared_memory_fits_at_the_repos_shapes(q, d):
    """The f64 block's shared memory (double-buffered 32 x 132 slabs, one
    16-feature chunk of z for both sides and of 1/ell^2, three buffers of
    one chunk of x rows, of 8 columns of y rows and of w, 8 columns of the
    C rows) is one constant, 195,456 bytes, at the shapes the repo runs and
    at any other q and d, and fits the card's 227 KB."""
    want = 8 * (4 * 32 * 132 + 2 * 16 * 128 + 3 * 32 * 16 + 3 * 32 * 8
                + 3 * 32 + 16 + 128 * 8)
    assert rs_k.smem_bytes_f64(q, d) == want == 195_456
    for qq in (1, 8, 300, 1000):
        for dd in (1, 8, 300, 1000):
            assert rs_k.smem_bytes_f64(qq, dd) == want <= rs_k.SMEM_LIMIT


@pytest.mark.parametrize("q,d", [(8, 4), (1, 1), (10, 5), (3, 5), (40, 1),
                                 (8, 64)])
def test_f32_shared_memory_is_fixed_and_fits(q, d):
    """The f32 block's shared memory (``FMA_SMEM_BYTES``: the f64 layout in
    floats with unpadded 32 x 128 slab rows) is one constant, 95,680 bytes,
    whatever q and d: q is staged 16 features at a time and, past d = 8,
    C accumulates in device memory.  Two blocks fit an SM, as the plan
    runs them (``F32_BLOCKS_PER_SM``)."""
    want = 4 * (4 * 32 * 128 + 2 * 16 * 128 + 3 * 32 * 16 + 3 * 32 * 8
                + 3 * 32 + 16 + 128 * 8)
    assert rs_k.smem_bytes_f32(q, d) == want == 95_680
    for qq in (1, 16, 17, 300, 1000):
        for dd in (1, 8, 9, 300):
            assert rs_k.smem_bytes_f32(qq, dd) == want <= rs_k.SMEM_LIMIT
    assert 2 * want <= rs_k.SMEM_LIMIT


@pytest.mark.parametrize("n,m,q,d", [*SHAPES, (300, 129, 20, 3)])
def test_f32_slab_exponent_in_log2_units_matches_plain(n, m, q, d):
    """The f32 kernel's slab entry, sf2 2^(sum_q (x_q - z_q)^2 s_q) with
    s = -log2(e) / (2 ell^2) as the wrapper folds it (``ops._NEG_HALF_LOG2E``),
    evaluated in f64, against the plain version's knm: rtol 1e-12 (the
    fold moves nothing but rounding), and so D, C and b."""
    hyp, z, x, y, w = _inputs(3 * n + m, n, m, q, d)
    s = rs_ops._NEG_HALF_LOG2E * np.exp(-2.0 * hyp["log_ell"])
    knm = np.exp(hyp["log_sf2"]) * 2.0 ** (
        ((x[:, None, :] - z[None, :, :]) ** 2 * s).sum(-1))
    th, tz, tx, ty, tw = _torch(hyp, z, x, y, w)
    b, c, dd = rs_ref.reg_stats_ref(th["log_sf2"], th["log_ell"], tz, tx, ty,
                                    tw)
    _close((knm * w[:, None]).T @ knm, dd, name="D")
    _close(knm.T @ (w[:, None] * y), c, name="C")
    _close(np.exp(hyp["log_sf2"]) * w.sum(), b, name="b")


# -- the f64 plan: the cluster kernel's (m <= 512), the per-tile one past it --

F64_PLAN_MS = [37, 128, 130, 512, 600, 1_030, 2_048]
F64_PLAN_NS = [(1_000_000, 15), (1_000_000, 132), (100_003, 16), (2_048, 132),
               (31, 1), (0, 15)]   # (n, cluster or block slots)


def _cluster_read(a, b, nb):
    """Where the cluster kernel's reduce reads D's entry (a, b): a mirror of
    ``reg_stats_cluster_reduce``: the diagonal 8 x 8 block of its group,
    else its band's staircase (slot: the band) or its pair's region (slot
    ``pair_slot``), at (row, column) within the slot's 64 x 64 partial."""
    lo, hi = min(a, b), max(a, b)
    if lo // 8 == hi // 8:
        return ("g", lo // 8, lo % 8, hi % 8)
    bl, bh = lo // rs_k.BAND, hi // rs_k.BAND
    slot = bl if bl == bh else rs_k.pair_slot(bl, bh, nb)
    return ("d", slot, lo % rs_k.BAND, hi % rs_k.BAND)


def _cluster_writes(m):
    """Every partial entry the plan's warps write, a mirror of the
    kernel's fold: {entry: (rank, warp)}, each entry written once; and
    each rank's DMMA fragments (16 x 8) besides its diagonal blocks."""
    nb = rs_k.cluster_bands(m)
    written, frags = {}, []
    for h, row in enumerate(rs_k.cluster_plan(m)):
        bands = [h] + [b for b in row[:rs_k.COPY_SLOTS] if b >= 0]
        count = 0
        for wp in range(rs_k.WARPS):
            kind, a_slot, b_slot, b_col, out, out_col = \
                row[rs_k.COPY_SLOTS + rs_k.TASK_INTS * wp:][:rs_k.TASK_INTS]
            for r in range(8):        # the warp's diagonal 8 x 8 block
                for c in range(8):
                    key = ("g", h * 8 + wp, r, c)
                    assert key not in written
                    written[key] = (h, wp)
            if kind == 0:
                continue
            a, b = bands[a_slot], bands[b_slot]
            if kind == 2:
                assert a == b == h == out and b_col == out_col == 0
                cells = rs_k.STAIR
            else:
                assert a < b and out == rs_k.pair_slot(a, b, nb)
                assert b_col == out_col in (0, 32)
                cells = [(i, j) for i in range(4) for j in range(4)]
            assert len(cells) == 16
            count += len(cells)
            for i, j in cells:
                for r in range(16):
                    for c in range(8):
                        key = ("d", out, 16 * i + r, out_col + 8 * j + c)
                        assert key not in written, key
                        written[key] = (h, wp)
        frags.append(count)
    return written, frags


@pytest.mark.parametrize("n,slots", F64_PLAN_NS)
@pytest.mark.parametrize("m", F64_PLAN_MS)
def test_f64_plan_covers_every_upper_entry_and_row_once(m, n, slots):
    """The f64 kernel's plan covers D's upper triangle and the n rows once.
    m <= 512 (the cluster kernel): every entry (a <= b < m) is read by the
    reduce from a partial entry that exactly one (rank, warp) writes, no
    entry is written twice, and the slices are whole 32-row chunks that
    cover n once.  Past 512 (the per-tile kernel, ``fill_plan`` over the
    SMs): every upper 128-tile once, n once."""
    if rs_k.takes_cluster(m, torch.float64):
        nb = rs_k.cluster_bands(m)
        written, _ = _cluster_writes(m)
        a, b = np.triu_indices(m)
        for ea, eb in zip(a, b):
            assert _cluster_read(int(ea), int(eb), nb) in written
        n_slices, per = rs_k.cluster_slices(n, slots)
        assert per % rs_k.CLUSTER_ROWS == 0 and n_slices <= max(1, slots)
    else:
        n_tiles, n_slices, per = _build.fill_plan(n, m, slots, rs_k.TILE,
                                                  rs_k.ROWS)
        nts = -(-m // rs_k.TILE)
        ta, tb = zip(*(_kernel_tile(t, nts) for t in range(n_tiles)))
        assert sorted(zip(ta, tb)) == sorted(zip(*np.triu_indices(nts)))
        assert per % rs_k.ROWS == 0
    assert (n_slices - 1) * per < max(n, 1) <= n_slices * per


@pytest.mark.parametrize("m", F64_PLAN_MS)
def test_f64_plan_is_balanced_and_clusters_fit(m):
    """Balance and width.  The cluster kernel (m <= 512): ceil(m/64) <= 8
    blocks a cluster, every block the same multiply-adds (16 DMMA
    fragments for each of its nb tasks, besides one diagonal 8 x 8 block
    a warp), every warp at most one task of 16 fragments (its
    accumulators fit its registers), at most 4 bands copied a block.  Past
    512, the per-tile kernel: one block a unit, each the full 128 x 128
    tile's fragments (128), width 1."""
    if rs_k.takes_cluster(m, torch.float64):
        nb = rs_k.cluster_bands(m)
        assert 1 <= nb <= rs_k.CLUSTER_BANDS == 8
        _, frags = _cluster_writes(m)
        assert frags == [16 * nb] * nb
        plan = rs_k.cluster_plan(m)
        assert len(plan) == nb and all(len(r) == rs_k.PLAN_INTS for r in plan)
        for row in plan:
            kinds = row[rs_k.COPY_SLOTS::rs_k.TASK_INTS]
            assert sum(k > 0 for k in kinds) == nb <= rs_k.WARPS
            assert sum(c >= 0 for c in row[:rs_k.COPY_SLOTS]) <= 4
        tasks = [t for r in rs_k.cluster_tasks(nb) for t in r]
        assert len(tasks) == nb * nb    # nb staircases, nb (nb - 1) regions
    else:
        assert rs_k.cluster_bands(m) > rs_k.CLUSTER_BANDS
        with pytest.raises(ValueError):
            rs_k.cluster_plan(m)


def test_f64_plan_at_sgpr_synth_1m():
    """sgpr-synth-1m: m 512 is 8 bands, a cluster of 8 blocks, each 8
    warps of 16 fragments (1,024 in all, with the 64 diagonal 8 x 8 blocks
    beside them); the H100 holds 15 such clusters at once (measured), so
    15 slices of 66,688 rows."""
    assert rs_k.cluster_bands(512) == 8
    assert rs_k.cluster_slices(1_000_000, 15) == (15, 66_688)
    _, frags = _cluster_writes(512)
    assert sum(frags) == 1_024


def test_cluster_shared_memory_is_fixed_and_fits():
    """The cluster block's shared memory (``CLUSTER_SMEM_BYTES``: its band
    of three 32-row chunks and 4 copied bands of two, row stride 68; x, y
    and w of four chunks; z of its band and 1/ell^2) is one constant,
    225,408 bytes, and fits an sm_90 block beside the exp's table."""
    want = 8 * (3 * 32 * 68 + 2 * 4 * 32 * 68 + 4 * 32 * (16 + 8 + 1)
                + 16 * 64 + 16)
    assert rs_k.cluster_smem_bytes() == want == 225_408
    assert want + 512 <= rs_k.SMEM_LIMIT


def _kernel_tile(tile, nts):
    """The upper tile (a, b) of unit index ``tile``: a mirror of the CUDA
    kernels' decode."""
    a, rem = 0, tile
    while rem >= nts - a:
        rem, a = rem - (nts - a), a + 1
    return a, a + rem


@pytest.mark.parametrize("dtype,n,m", [
    (torch.float32, 1_000, 46_400),   # 66,066 upper 128-tiles: past gridDim.y
    (torch.float64, 1_000, 46_400),   # 66,066 upper 128-tiles
    (torch.float64, 1_000_000, 2_048),   # 136 units on 132 SMs
    (torch.float32, 1_000_000, 512), (torch.float64, 1_000_000, 512),
    (torch.float32, 1_000_000, 2_048),   # 136 units on 132 SMs
    (torch.float32, 20_011, 127), (torch.float32, 20_011, 129),
    (torch.float32, 20_011, 257),        # ragged across the 128 edge
    (torch.float32, 20, 130)])           # n below one 32-row chunk
def test_plans_refuse_no_m_and_units_cover_every_tile_and_row(dtype, n, m):
    """The plan takes any m.  Units (slice, upper tile) go on gridDim.x,
    one block each: unit = slice * tiles + tile, decoded as the kernels
    decode it, covers every upper tile once per slice, and the slices
    cover the n rows once.  The per-tile kernels share the plan
    (``fill_plan``, 128-tiles, 32-row chunks) over their block slots: 132
    SMs of one f64 block, or of two f32 blocks.  f64 at m <= 512 takes
    the cluster kernel instead: a cluster a slice on gridDim.x, its slices
    whole chunks covering n once (its tiles: the f64 plan tests above)."""
    if rs_k.takes_cluster(m, dtype):
        n_slices, per = rs_k.cluster_slices(n, 15)
        assert per % rs_k.CLUSTER_ROWS == 0
        assert (n_slices - 1) * per < n <= n_slices * per
        assert n_slices * rs_k.cluster_bands(m) < 2 ** 31   # gridDim.x
        return
    sms = 132 * (rs_k.F32_BLOCKS_PER_SM if dtype == torch.float32 else 1)
    tile_edge, rows = rs_k.TILE, rs_k.ROWS
    n_tiles, n_slices, per_slice = _build.fill_plan(n, m, sms, tile_edge, rows)
    nts = -(-m // tile_edge)
    assert n_tiles == nts * (nts + 1) // 2
    # every upper tile once: the reduce's index of (a, b) is a bijection
    # onto the units' tile indices, and the kernels' decode inverts it
    a, b = np.triu_indices(nts)
    index = a * nts - a * (a - 1) // 2 + (b - a)
    assert np.array_equal(np.sort(index), np.arange(n_tiles))
    for t in {0, 1, nts - 1, nts, n_tiles // 2, n_tiles - 2, n_tiles - 1,
              *range(0, n_tiles, 997)} & set(range(n_tiles)):
        ka, kb = _kernel_tile(t, nts)
        assert ka <= kb < nts
        assert index[np.flatnonzero((a == ka) & (b == kb))[0]] == t
    # every row once
    assert per_slice % rows == 0
    assert (n_slices - 1) * per_slice < n <= n_slices * per_slice
    n_units = n_tiles * n_slices
    assert n_units < 2 ** 31          # gridDim.x
    if m >= 46_400:
        assert n_tiles > 65_535       # past the old gridDim.y limit
    if m == 2_048:   # more units than SMs: f64 runs them in two waves
        assert n_units == 136 > 132
        assert n_slices == 1
