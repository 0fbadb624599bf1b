"""ctypes binding of ``csrc/reg_stats.cu`` (built at first use).

All tensors must already be on one CUDA device, contiguous, the inputs and
scratch of one dtype (float32 or float64) and the outputs float64;
``ops.py`` checks that before it calls in here.
"""
from __future__ import annotations

import ctypes

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
