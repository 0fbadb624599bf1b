"""ctypes binding of ``csrc/reg_stats.cu`` (built at first use).

All tensors must already be on one CUDA device, contiguous, the inputs and
scratch of one dtype (float32 or float64) and the outputs float64;
``ops.py`` checks that before it calls in here.
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build

TILE = 64      # D tile edge in the CUDA source (TM)
ROWS = 32      # rows staged per chunk in the CUDA source (RC)

_P = ctypes.c_void_p
_I = ctypes.c_int
_FN = {torch.float32: "reg_stats_f32", torch.float64: "reg_stats_f64"}


def reg_stats(x, y, w, z, hp, n_slices, rows_per_slice,
              part_d, part_c, part_b, d_out, c_out, b_out) -> None:
    """Launch the instantiation for x's dtype (tile pass, then the
    fixed-order reduce) on the current stream."""
    fn = getattr(_build.load("reg_stats"), _FN[x.dtype])
    if fn.argtypes is None:
        fn.argtypes = [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                       _P, _P, _P, _P, _P, _P, _P]
        fn.restype = _I
    n, q = x.shape
    m, d = z.shape[0], y.shape[1]
    err = fn(
        x.data_ptr(), y.data_ptr(), w.data_ptr(), z.data_ptr(), hp.data_ptr(),
        n, m, q, d, n_slices, rows_per_slice, part_d.data_ptr(),
        part_c.data_ptr(), part_b.data_ptr(), d_out.data_ptr(),
        c_out.data_ptr(), b_out.data_ptr(), _build.stream_handle(x.device))
    _build.check(_FN[x.dtype], err)
