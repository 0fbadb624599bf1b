"""ctypes binding of ``csrc/reg_stats.cu`` (built at first use).

All tensors must already be on one CUDA device, contiguous, the inputs and
scratch of one dtype (float32 or float64) and the outputs float64;
``ops.py`` checks that before it calls in here.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from .. import _build

TILE = 128     # D tile edge of both instantiations (FT, DT)
ROWS = 32      # rows staged per chunk (FRC, DRC)
FEATURES = 16  # features of z, x and 1/ell^2 staged at a time (QC)
COLUMNS = 8    # y columns staged and C columns held when d <= 8 (DC)
SMEM_LIMIT = 232_448   # bytes of shared memory a block may use (sm_90)
F32_BLOCKS_PER_SM = 2  # f32 blocks an SM holds (__launch_bounds__(FNT, 2))


def _smem_elems(pad: int) -> int:
    """Elements of one block's shared memory: double-buffered slabs (row
    stride TILE + ``pad``), one q-chunk of z for both tile sides and of
    the scales, three buffers of one q-chunk of x rows, of 8 columns of y
    rows and of w, and 8 columns of C rows."""
    return (4 * ROWS * (TILE + pad) + 2 * FEATURES * TILE
            + 3 * ROWS * FEATURES + 3 * ROWS * COLUMNS + 3 * ROWS + FEATURES
            + TILE * COLUMNS)


def smem_bytes_f64(q: int, d: int) -> int:
    """Shared memory of one f64 block (``DMMA_SMEM_BYTES`` in the source):
    slab rows padded by 4 doubles for the DMMA fragments' loads.  The
    kernel stages q in chunks and, past d = 8, accumulates C in device
    memory and reads y from there, so neither ``q`` nor ``d`` changes
    it."""
    return 8 * _smem_elems(4)


def smem_bytes_f32(q: int, d: int) -> int:
    """Shared memory of one f32 block (``FMA_SMEM_BYTES``): the f64 layout
    in floats, slab rows unpadded (a warp reads one row).  Neither ``q``
    nor ``d`` changes it."""
    return 4 * _smem_elems(0)


# -- the f64 cluster kernel (m <= 512): csrc/reg_stats.cu -------------------

BAND = 64            # inducing points a band; one block of a cluster builds one (BW)
CLUSTER_ROWS = 32    # rows a chunk (CR)
COPY_SLOTS = 4       # other blocks' bands a block copies, at most (NR)
CLUSTER_BANDS = 8    # bands, i.e. blocks a cluster, at most (NBMAX): m <= 512
WARPS = 8            # warps a block, one task each
TASK_INTS = 6        # ints of a warp's task in the plan (TASK)
PLAN_INTS = COPY_SLOTS + TASK_INTS * WARPS   # ints of a rank's plan (PLAN)
STAIR = [(0, j) for j in range(1, 8)] + [(1, j) for j in range(3, 8)] \
    + [(2, j) for j in range(5, 8)] + [(3, 7)]
"""A band's staircase: its 16 DMMA fragments (row fragment i of 16 points,
column fragment j of 8) of the band's own 64 x 64 block, j >= 2i + 1:
everything strictly above its diagonal 8 x 8 blocks (``stair_i`` /
``stair_j`` in the source)."""


def cluster_bands(m: int) -> int:
    """Bands of 64 inducing points for m points: the cluster's width, when
    at most ``CLUSTER_BANDS``."""
    return -(-m // BAND)


def takes_cluster(m: int, dtype) -> bool:
    """Whether the f64 cluster kernel runs (f64, m <= 512); else the
    per-tile kernel of the dtype."""
    return dtype == torch.float64 and cluster_bands(m) <= CLUSTER_BANDS


def pair_slot(lo: int, hi: int, nb: int) -> int:
    """The partial's task slot of band pair lo < hi (slot t < nb: band t's
    staircase), as the reduce kernel indexes it."""
    return nb + lo * nb - lo * (lo + 1) // 2 + (hi - lo - 1)


def cluster_tasks(nb: int) -> list[list[tuple[int, int, int, int]]]:
    """Each rank's warp tasks, (kind, A band, B band, B half): kind 2 the
    rank's own staircase, kind 1 a 64 x 32 region, A = band lo (64 rows of
    D), B = half ``half`` of band hi (32 columns), lo < hi.  Rank h takes
    the pairs (h, h + k mod nb) for k = 1 .. (nb - 1) / 2, both halves,
    and for even nb one half of (h, h + nb/2): every pair once, nb tasks a
    rank, at most 4 other bands a rank."""
    out = []
    for h in range(nb):
        tasks = [(2, h, h, 0)]
        for k in range(1, (nb - 1) // 2 + 1):
            lo, hi = sorted((h, (h + k) % nb))
            tasks += [(1, lo, hi, 0), (1, lo, hi, 1)]
        if nb % 2 == 0:
            half = nb // 2
            tasks.append((1, h, h + half, 0) if h < half
                         else (1, h - half, h, 1))
        out.append(tasks)
    return out


def cluster_plan(m: int) -> list[list[int]]:
    """The cluster kernel's plan for m points, ``PLAN_INTS`` ints a rank:
    the ranks whose bands it copies (-1: none), then each warp's task:
    kind (0 none, 1 region, 2 staircase), A's slot and B's slot (0 the
    rank's own band, s its copy of the s-th band listed), B's first
    column, the partial's task slot (``pair_slot``; a staircase: its
    band) and its first column."""
    nb = cluster_bands(m)
    if not 1 <= nb <= CLUSTER_BANDS:
        raise ValueError(f"cluster_plan: m {m} needs {nb} bands, "
                         f"at most {CLUSTER_BANDS}")
    rows = []
    for h, tasks in enumerate(cluster_tasks(nb)):
        others = sorted({b for t in tasks for b in t[1:3]} - {h})
        slot = {h: 0, **{b: 1 + i for i, b in enumerate(others)}}
        row = others + [-1] * (COPY_SLOTS - len(others))
        for kind, a, b, half in tasks:
            out = a if kind == 2 else pair_slot(a, b, nb)
            row += [kind, slot[a], slot[b], 32 * half, out, 32 * half]
        rows.append(row + [0] * (TASK_INTS * (WARPS - len(tasks))))
    return rows


def cluster_smem_bytes() -> int:
    """Dynamic shared memory of one cluster block (``CLUSTER_SMEM_BYTES``):
    its band of three chunks and the copied bands of two (32 rows, row
    stride 68 doubles), x (16 columns), y (8) and w of four chunks, z of
    its band and 1/ell^2 (16 features).  Neither q nor d changes it; the
    exp's table adds 512 static bytes."""
    lds = BAND + 4
    return 8 * (3 * CLUSTER_ROWS * lds + 2 * COPY_SLOTS * CLUSTER_ROWS * lds
                + 4 * CLUSTER_ROWS * (FEATURES + COLUMNS + 1)
                + FEATURES * BAND + FEATURES)


def cluster_slices(n: int, slots: int) -> tuple[int, int]:
    """(n-slices, rows per slice) of the cluster kernel: one cluster a
    slice of whole 32-row chunks, as many slices as fill ``slots``
    cluster slots once (at least one)."""
    chunks = max(1, -(-n // CLUSTER_ROWS))
    per = -(-chunks // max(1, min(chunks, slots))) * CLUSTER_ROWS
    return max(1, -(-n // per)), per


@functools.lru_cache(maxsize=None)
def _clusters(nb: int, chunked: bool, index: int) -> int:
    fn = _build.load("reg_stats").reg_stats_f64_clusters
    fn.argtypes = [_I, _I, ctypes.POINTER(ctypes.c_int)]
    fn.restype = _I
    out = ctypes.c_int(0)
    with torch.cuda.device(index):
        _build.check("reg_stats_f64_clusters",
                     fn(nb, FEATURES + 1 if chunked else 1, ctypes.byref(out)))
    return max(1, out.value)


def _index(device) -> int:
    index = torch.device(device).index
    return torch.cuda.current_device() if index is None else index


def cluster_slots(m: int, q: int, device) -> int:
    """Clusters of the f64 kernel the card holds at once for m points and
    q features (``cudaOccupancyMaxActiveClusters``, looked up once per
    width, variant and device)."""
    return _clusters(cluster_bands(m), q > FEATURES, _index(device))


@functools.lru_cache(maxsize=None)
def _plan_on(m: int, index: int) -> torch.Tensor:
    return torch.tensor(cluster_plan(m), dtype=torch.int32,
                        device=torch.device("cuda", index))


def plan_tensor(m: int, device) -> torch.Tensor:
    """``cluster_plan(m)`` on the card, copied there once per m and
    device."""
    return _plan_on(m, _index(device))


_P = ctypes.c_void_p
_I = ctypes.c_int
_FN = {torch.float32: "reg_stats_f32", torch.float64: "reg_stats_f64"}
_CLUSTER_FN = "reg_stats_f64_cluster"


def reg_stats(x, y, w, z, hp, n_slices, rows_per_slice,
              part_d, part_comp, part_c, part_b, *rest) -> None:
    """Launch the kernel for x's dtype and m on the current stream, then
    its fixed-order reduce: ``rest`` is ``(d_out, c_out, b_out)`` for the
    per-tile kernels (one block per (slice, upper tile) unit on
    gridDim.x), ``(plan, part_g, part_gcomp, d_out, c_out, b_out)`` for
    the f64 cluster kernel (a cluster a slice).  ``part_comp`` (and
    ``part_gcomp``) are the Kahan compensation scratch, shaped as
    ``part_d`` (``part_g``)."""
    lib = _build.load("reg_stats")
    name = _CLUSTER_FN if len(rest) == 6 else _FN[x.dtype]
    fn = getattr(lib, name)
    if fn.argtypes is None:
        fn.argtypes = [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                       *([_P] * (11 if len(rest) == 6 else 8))]
        fn.restype = _I
    n, q = x.shape
    m, d = z.shape[0], y.shape[1]
    if len(rest) == 6:
        plan, part_g, part_gcomp, d_out, c_out, b_out = rest
        scratch = (plan, part_d, part_comp, part_g, part_gcomp, part_c, part_b)
    else:
        d_out, c_out, b_out = rest
        scratch = (part_d, part_comp, part_c, part_b)
    err = fn(
        x.data_ptr(), y.data_ptr(), w.data_ptr(), z.data_ptr(), hp.data_ptr(),
        n, m, q, d, n_slices, rows_per_slice,
        *(t.data_ptr() for t in scratch),
        d_out.data_ptr(), c_out.data_ptr(), b_out.data_ptr(),
        _build.stream_handle(x.device))
    _build.check(name, err)


# -- the backward: csrc/reg_stats_bwd.cu -------------------------------------

BWD_ROWS = 64        # rows per row tile of the backward (BR)
BWD_COLUMNS = 128    # columns per column tile; z, S and gC padded to it (BC)
BWD_STEP = 32        # inducing points per k-step (KS)
BWD_CLUSTER = 8      # blocks a cluster, at most: one a column tile (CMAX)
BWD_S_STAGES = 2     # stages of S's rows: double-buffered (SS)
BWD_BLOCKS_PER_SM = {torch.float32: 2, torch.float64: 1}
_BWD_FN = {torch.float32: "reg_stats_bwd_f32", torch.float64: "reg_stats_bwd_f64"}
_BWD_CLUSTERS_FN = {torch.float32: "reg_stats_bwd_clusters_f32",
                    torch.float64: "reg_stats_bwd_clusters_f64"}


def bwd_smem_bytes(dtype) -> int:
    """Dynamic shared memory of one backward block (``smem_elems`` in the
    source): the own tile (128 points x 64 rows, row stride 68 f64, 64
    f32); the buffers, the larger of the k-loop's two slabs and two
    stages of S rows (row stride 132 f64, 128 f32) and the epilogue's E
    tile (64 x 129), z (128 x 17), 8 columns of gC, the passes' scratch
    (the larger of 128 x 17 and 3 x 64 x 9) and the warps' sums (17 x 8);
    x (64 x 17), w and 1/ell^2.  Neither q nor d changes it; the f64 exp's
    table adds 512 static bytes."""
    item = torch.empty((), dtype=dtype).element_size()
    pad = 4 if dtype == torch.float64 else 0
    lda, lds = BWD_ROWS + pad, BWD_COLUMNS + pad
    qp = FEATURES + 1
    loop = 2 * BWD_STEP * lda + BWD_S_STAGES * BWD_STEP * lds
    epilogue = (BWD_ROWS * (BWD_COLUMNS + 1) + BWD_COLUMNS * qp
                + BWD_COLUMNS * COLUMNS
                + max(BWD_COLUMNS * qp, 3 * BWD_ROWS * (1 + COLUMNS)) + 8 * qp)
    return item * (BWD_COLUMNS * lda + max(loop, epilogue) + BWD_ROWS * qp
                   + BWD_ROWS + FEATURES)


def bwd_cluster(m: int) -> tuple[int, int]:
    """(blocks a cluster, column groups) of the backward for m points: one
    block a 128-point column tile, at most ``BWD_CLUSTER``; block r of the
    cluster takes the tiles r, r + width, ... (group g: tile g width + r),
    and the inducing points are built once per group of output tiles."""
    tiles = -(-m // BWD_COLUMNS)
    width = min(tiles, BWD_CLUSTER)
    return width, -(-tiles // width)


@functools.lru_cache(maxsize=None)
def _bwd_clusters(dtype, width: int, grouped: bool, chunked: bool,
                  index: int) -> int:
    fn = getattr(_build.load("reg_stats_bwd"), _BWD_CLUSTERS_FN[dtype])
    fn.argtypes = [_I, _I, ctypes.POINTER(ctypes.c_int)]
    fn.restype = _I
    out = ctypes.c_int(0)
    with torch.cuda.device(index):
        _build.check(_BWD_CLUSTERS_FN[dtype],
                     fn(width * BWD_COLUMNS * (2 if grouped else 1),
                        FEATURES + 1 if chunked else 1, ctypes.byref(out)))
    return max(1, out.value)


def bwd_slots(dtype, m: int, q: int, device) -> int:
    """Clusters of the backward the card holds at once for m points and q
    features (``cudaOccupancyMaxActiveClusters``, looked up once per
    cluster width, variant and device)."""
    width, groups = bwd_cluster(m)
    return _bwd_clusters(dtype, width, groups > 1, q > FEATURES, _index(device))


def bwd_plan(n: int, slots: int) -> tuple[int, int]:
    """(n-slices, row tiles per slice) of the backward: one cluster a slice
    of consecutive 64-row tiles, as many slices as fill ``slots`` cluster
    slots once (at least one, so an empty n still zeroes its partials)."""
    row_tiles = -(-n // BWD_ROWS)
    per = max(1, -(-row_tiles // max(1, min(row_tiles, slots))))
    return max(1, -(-row_tiles // per)), per


def reg_stats_bwd(x, y, w, zp, sp, gcp, hp, m, n_slices, tiles_per_slice,
                  flags, part_z, part_ell, part_sf2, dz, dell, dsf2, rp_x,
                  rp_y, rp_w, dx, dy, dw) -> None:
    """Launch the backward for x's dtype (the clusters' tile pass, the
    fixed-order reduce, and where ``flags`` (1 x, 2 y, 4 w) asks, the row
    outputs from the ranks' row partials) on the current stream."""
    fn = getattr(_build.load("reg_stats_bwd"), _BWD_FN[x.dtype])
    if fn.argtypes is None:
        fn.argtypes = [*([_P] * 7), *([_I] * 8), *([_P] * 13)]
        fn.restype = _I
    n, q = x.shape
    err = fn(x.data_ptr(), y.data_ptr(), w.data_ptr(), zp.data_ptr(),
             sp.data_ptr(), gcp.data_ptr(), hp.data_ptr(), n, m, q,
             y.shape[1], zp.shape[0], n_slices, tiles_per_slice, flags,
             part_z.data_ptr(), part_ell.data_ptr(), part_sf2.data_ptr(),
             dz.data_ptr(), dell.data_ptr(), dsf2.data_ptr(), rp_x.data_ptr(),
             rp_y.data_ptr(), rp_w.data_ptr(), dx.data_ptr(), dy.data_ptr(),
             dw.data_ptr(), _build.stream_handle(x.device))
    _build.check(_BWD_FN[x.dtype], err)
