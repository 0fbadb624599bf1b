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


_P = ctypes.c_void_p
_I = ctypes.c_int
_FN = {torch.float32: "reg_stats_f32", torch.float64: "reg_stats_f64"}


def reg_stats(x, y, w, z, hp, n_slices, rows_per_slice,
              part_d, part_comp, part_c, part_b, d_out, c_out, b_out) -> None:
    """Launch the instantiation for x's dtype (one block per (slice, upper
    tile) unit on gridDim.x, then the fixed-order reduce) on the current
    stream.  ``part_comp`` is the Kahan compensation scratch, shaped as
    ``part_d``."""
    fn = getattr(_build.load("reg_stats"), _FN[x.dtype])
    if fn.argtypes is None:
        fn.argtypes = [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                       *([_P] * 8)]
        fn.restype = _I
    n, q = x.shape
    m, d = z.shape[0], y.shape[1]
    err = fn(
        x.data_ptr(), y.data_ptr(), w.data_ptr(), z.data_ptr(), hp.data_ptr(),
        n, m, q, d, n_slices, rows_per_slice, part_d.data_ptr(),
        part_comp.data_ptr(), part_c.data_ptr(), part_b.data_ptr(),
        d_out.data_ptr(), c_out.data_ptr(), b_out.data_ptr(),
        _build.stream_handle(x.device))
    _build.check(_FN[x.dtype], err)


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
    index = torch.device(device).index
    width, groups = bwd_cluster(m)
    return _bwd_clusters(dtype, width, groups > 1, q > FEATURES,
                         torch.cuda.current_device() if index is None else index)


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
