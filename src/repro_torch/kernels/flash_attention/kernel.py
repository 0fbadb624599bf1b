"""ctypes binding of ``csrc/flash_attention.cu`` (built at first use).

q (B,H,T,Dh), k/v (B,Hkv,S,Dh) on one CUDA device, one dtype (bfloat16 or
float32), the last axis contiguous (the other axes go in as strides), and
o (B,H,T,Dh) contiguous; ``ops.py`` checks that before it calls in here.
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build

HEAD_DIMS = (64, 128)   # the Dh instantiations of the CUDA source

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_FN = {torch.bfloat16: "flash_attention_bf16",
       torch.float32: "flash_attention_f32"}


def flash_attention(q, k, v, o, causal: bool, scale: float) -> None:
    """Launch the instantiation for q's dtype on the current stream."""
    lib = _build.load("flash_attention")
    fn = getattr(lib, _FN[q.dtype])
    if fn.argtypes is None:
        fn.argtypes = [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                       _L, _L, _L, _L, _L, _L, _L, _L, _L,
                       _I, ctypes.c_float, _P]
        fn.restype = _I
    b, h, t, dh = q.shape
    hkv, s_len = k.shape[1], k.shape[2]
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
             b, h, hkv, t, s_len, dh, *q.stride()[:3], *k.stride()[:3],
             *v.stride()[:3], int(causal), scale,
             _build.stream_handle(q.device))
    _build.check(_FN[q.dtype], err)
