"""ctypes binding of ``csrc/flash_attention.cu`` (built at first use).

q (B,H,T,Dh), k/v (B,Hkv,S,Dh) on one CUDA device, one dtype (bfloat16 or
float32), the last axis contiguous (the other axes go in as strides), and
o (B,H,T,Dh) contiguous; ``ops.py`` checks that before it calls in here.
The bf16 instantiation reads q, k and v through TMA tensor maps, which
need what :func:`tma_refusal` checks; :func:`tma_strides` gives the strides
it is handed.
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build

HEAD_DIMS = (64, 128)   # the Dh instantiations of the CUDA source
TMA_ALIGN = 16          # bytes: TMA's rule for base addresses and strides

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_FN = {torch.bfloat16: "flash_attention_bf16",
       torch.float32: "flash_attention_f32"}


def tma_strides(shape, strides) -> tuple[int, int, int]:
    """Element strides over (B, H, L) of a (B, H, L, Dh) view as the bf16
    kernel's tensor map takes them.  TMA never steps along an axis of size
    1, so such an axis gets the stride a contiguous layout would give it,
    whatever stride the view carries there."""
    b, h, length, dh = shape
    sb, sh, st = strides[:3]
    st = st if length > 1 else dh
    sh = sh if h > 1 else st * length
    sb = sb if b > 1 else sh * h
    return sb, sh, st


def tma_refusal(ptr: int, shape, strides, itemsize: int) -> str | None:
    """Why TMA cannot read the (B, H, L, Dh) view at address ``ptr`` with
    these element strides, or None: its base address and the byte strides
    of its axes must be multiples of 16 bytes, and its last axis
    contiguous."""
    if strides[3] != 1:
        return "its last axis is not contiguous"
    if ptr % TMA_ALIGN:
        return f"its base address is not {TMA_ALIGN}-byte aligned"
    bad = [ax for ax, st in zip("BHT", tma_strides(shape, strides))
           if st * itemsize % TMA_ALIGN]
    if bad:
        return (f"its stride over {', '.join(bad)} is not a multiple of "
                f"{TMA_ALIGN} bytes")
    return None


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
    strides = [tma_strides(x.shape, x.stride()) for x in (q, k, v)]
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
             b, h, hkv, t, s_len, dh, *strides[0], *strides[1], *strides[2],
             int(causal), scale, _build.stream_handle(q.device))
    _build.check(_FN[q.dtype], err)
