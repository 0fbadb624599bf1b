"""ctypes binding of ``csrc/predict.cu`` (built at first use).

All tensors must already be on one CUDA device, contiguous and of one dtype
(float32 or float64); ``ops.py`` checks that before it calls in here.
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build

ROWS = 32        # query rows per block in the CUDA source (BT)
COLS = 128       # g columns per tile (BN): the slab is padded to a multiple
GTILE = 32 * 128  # elements of one staged g tile (BK * BN)
SMEM_MAX = 232_448   # dynamic shared memory a block may use on sm_90

_P = ctypes.c_void_p
_I = ctypes.c_int
_FN = {torch.float32: "predict_f32", torch.float64: "predict_f64"}


def smem_bytes(m: int, q: int, dtype) -> int:
    """Dynamic shared memory one block needs (the launcher's formula)."""
    m_pad = -(-m // COLS) * COLS
    item = torch.empty((), dtype=dtype).element_size()
    return item * (ROWS * (m_pad + 1) + GTILE + ROWS * q + q)


def predict(x, z, hp, a_mean, g, mean, quad) -> None:
    """Launch the instantiation for x's dtype on the current stream."""
    lib = _build.load("predict")
    fn = getattr(lib, _FN[x.dtype])
    if fn.argtypes is None:
        fn.argtypes = [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P, _P, _P]
        fn.restype = _I
    t, q = x.shape
    m, d = a_mean.shape
    err = fn(x.data_ptr(), z.data_ptr(), hp.data_ptr(), a_mean.data_ptr(),
             g.data_ptr(), t, m, q, d, mean.data_ptr(), quad.data_ptr(),
             _build.stream_handle(x.device))
    _build.check(_FN[x.dtype], err)
