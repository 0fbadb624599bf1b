"""ctypes binding of ``csrc/reg_stats.cu`` (built at first use).

All tensors must already be on one CUDA device, contiguous, the inputs and
scratch of one dtype (float32 or float64) and the outputs float64;
``ops.py`` checks that before it calls in here.
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build

TILE = 64      # D tile edge of the f32 instantiation (TM)
ROWS = 32      # rows staged per chunk of the f32 instantiation (RC)
TILE_F64 = 128   # D tile edge of the f64 (DMMA) instantiation (DT)
ROWS_F64 = 32    # rows per chunk of the f64 instantiation (DRC)
FEATURES_F64 = 16   # features of z, x and 1/ell^2 staged at a time (QC)
COLUMNS_F64 = 8     # y columns staged and C columns held when d <= 8 (DC)
SMEM_LIMIT = 232_448   # bytes of shared memory a block may use (sm_90)


def smem_bytes_f64(q: int, d: int) -> int:
    """Shared memory of one f64 block (``DMMA_SMEM_BYTES`` in the source):
    double-buffered slabs, one q-chunk of z for both tile sides and of
    1/ell^2, three buffers of one q-chunk of x rows, of 8 columns of y rows
    and of w, and 8 columns of C rows.  The kernel stages q in chunks and,
    past d = 8, accumulates C in device memory and reads y from there, so
    neither ``q`` nor ``d`` changes it."""
    ld, qc, dc = TILE_F64 + 4, FEATURES_F64, COLUMNS_F64
    return 8 * (4 * ROWS_F64 * ld + 2 * qc * TILE_F64 + 3 * ROWS_F64 * qc
                + 3 * ROWS_F64 * dc + 3 * ROWS_F64 + qc + TILE_F64 * dc)


_P = ctypes.c_void_p
_I = ctypes.c_int
_FN = {torch.float32: "reg_stats_f32", torch.float64: "reg_stats_f64"}


def reg_stats(x, y, w, z, hp, n_slices, rows_per_slice,
              part_d, part_c, part_b, d_out, c_out, b_out,
              part_comp=None) -> None:
    """Launch the instantiation for x's dtype (one block per (slice, upper
    tile) unit on gridDim.x, then the fixed-order reduce) on the current
    stream; the f64 one also takes the Kahan compensation scratch
    ``part_comp`` (shaped as ``part_d``)."""
    fn = getattr(_build.load("reg_stats"), _FN[x.dtype])
    f64 = x.dtype == torch.float64
    if fn.argtypes is None:
        fn.argtypes = [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                       *([_P] * (8 if f64 else 7))]
        fn.restype = _I
    n, q = x.shape
    m, d = z.shape[0], y.shape[1]
    scratch = [part_d.data_ptr()]
    if f64:
        scratch.append(part_comp.data_ptr())
    err = fn(
        x.data_ptr(), y.data_ptr(), w.data_ptr(), z.data_ptr(), hp.data_ptr(),
        n, m, q, d, n_slices, rows_per_slice, *scratch,
        part_c.data_ptr(), part_b.data_ptr(), d_out.data_ptr(),
        c_out.data_ptr(), b_out.data_ptr(), _build.stream_handle(x.device))
    _build.check(_FN[x.dtype], err)
