"""ctypes binding of ``csrc/psi_stats.cu`` (built at first use).

All tensors must already be on one CUDA device, contiguous, the inputs and
scratch of one dtype (float32 or float64) and psi2's output float64;
``ops.py`` checks that before it calls in here.
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build

TILE = 64        # psi2 D tile edge in the CUDA source (TM)
ROWS = 32        # psi2 rows staged per chunk in the CUDA source (RC)
P1_ROWS = 32     # psi1 rows per block (PR)
P1_COLS = 64     # psi1 columns per block (PC)
FEATURES = 16    # features staged at a time in the CUDA source (QC)
SMEM_MAX = 232_448   # dynamic shared memory a block may use on sm_90

_P = ctypes.c_void_p
_I = ctypes.c_int
_NAMES = {torch.float32: "f32", torch.float64: "f64"}


def smem_bytes(kind: str, q: int, dtype) -> int:
    """Dynamic shared memory one block of ``psi1``/``psi2`` needs (the
    launcher's ``psi2_smem``/``psi1_smem``).  The kernels stage q in chunks
    of ``FEATURES``, so ``q`` does not change it."""
    item = torch.empty((), dtype=dtype).element_size()
    if kind == "psi2":
        return item * (2 * FEATURES * TILE + 2 * ROWS * FEATURES + 2 * ROWS
                       + FEATURES)
    return item * (FEATURES * P1_COLS + 2 * P1_ROWS * FEATURES + P1_ROWS)


def _fn(kind: str, dtype, argtypes):
    name = f"{kind}_{_NAMES[dtype]}"
    fn = getattr(_build.load("psi_stats"), name)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = _I
    return name, fn


def psi2(mu, s, w, z, hp, n_slices, rows_per_slice, part, d_out) -> None:
    """Launch psi2's instantiation for mu's dtype (tile pass, then the
    fixed-order reduce) on the current stream."""
    name, fn = _fn("psi2", mu.dtype, [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                                      _P, _P, _P])
    n, q = mu.shape
    err = fn(mu.data_ptr(), s.data_ptr(), w.data_ptr(), z.data_ptr(),
             hp.data_ptr(), n, z.shape[0], q, n_slices, rows_per_slice,
             part.data_ptr(), d_out.data_ptr(), _build.stream_handle(mu.device))
    _build.check(name, err)


def psi1(mu, s, z, hp, out) -> None:
    """Launch psi1's instantiation for mu's dtype on the current stream."""
    name, fn = _fn("psi1", mu.dtype, [_P, _P, _P, _P, _I, _I, _I, _P, _P])
    n, q = mu.shape
    err = fn(mu.data_ptr(), s.data_ptr(), z.data_ptr(), hp.data_ptr(), n,
             z.shape[0], q, out.data_ptr(), _build.stream_handle(mu.device))
    _build.check(name, err)
