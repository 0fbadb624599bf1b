"""Wrapper of the flash-attention kernel: ``flash_attention``.

The tensor's device decides the path.  On the CPU the wrapper computes the
plain version (``ref.py``).  On CUDA it always launches the hand-written
kernel (``csrc/flash_attention.cu``) and raises where the kernel cannot
run; there is no fallback.  The kernel has no backward (the Pallas kernel
has none either), so the CUDA path refuses inputs that require grad rather
than drop their gradient silently.

Layout and masking are those of ``repro.kernels.flash_attention.ops``:
q (B,H,T,Dh), k/v (B,Hkv,S,Dh) with H % Hkv == 0, causal queries
suffix-aligned to the keys.  The kernel masks the ragged T and S edges
itself, so nothing is padded; q, k and v may be strided views whose last
axis is contiguous (the model passes (B,T,H,Dh) tensors transposed).  The
bf16 kernel reads them through TMA, so their base addresses and strides
must also be multiples of 16 bytes; it raises ``ValueError`` on a view that
breaks that (there is no second route).  A query row that sees no key
returns 0.  Scores, softmax and sums run in f32 whatever the input dtype
(the bf16 kernel rounds the probabilities to bf16 for the second product,
as SDPA does); the output comes back in q's dtype.

For every tensor but a real CPU one (a CUDA tensor, or a fake tensor of
the dry run) the wrapper calls the operator
``torch.ops.repro_torch.flash_attention`` (a ``torch.library.custom_op``),
whose implementation is the checks and the launch above.  Its fake
implementation gives the output's shape and dtype, and its FLOP formula
(``flop_count``) the kernel's work, so the dry run (``launch.dryrun``)
traces it under ``FakeTensorMode`` and ``FlopCounterMode``.
"""
from __future__ import annotations

import numpy as np
import torch
from torch._subclasses.fake_tensor import is_fake
from torch.utils.flop_counter import register_flop_formula

from . import kernel as _k
from . import ref as _ref

#: launches of the CUDA kernel since the counts were last reset, by dtype
LAUNCHES = {"bfloat16": 0, "float32": 0}


def flash_attention(q, k, v, causal: bool = True):
    """Attention of q (B,H,T,Dh) over k/v (B,Hkv,S,Dh) -> (B,H,T,Dh)."""
    if q.device.type == "cpu" and not is_fake(q):
        return _ref.attention_ref(q, k, v, causal=causal)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError(
            "flash_attention on CUDA has no backward; call it under "
            "torch.no_grad() or on detached tensors")
    return torch.ops.repro_torch.flash_attention(q, k, v, causal)


def visible_pairs(b, h, t, s, causal) -> int:
    """(query, key) pairs the mask lets through: row r sees keys
    <= r + (S - T) when causal."""
    if not causal:
        return b * h * t * s
    seen = np.clip(np.arange(t) + (s - t) + 1, 0, s)
    return b * h * int(seen.sum())


@torch.library.custom_op("repro_torch::flash_attention", mutates_args=())
def _flash_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              causal: bool) -> torch.Tensor:
    operands = (q, k, v)
    if q.device.type != "cuda" or any(t.device != q.device for t in operands):
        raise ValueError("flash_attention: q, k and v must be on one CUDA "
                         f"device, got {[str(t.device) for t in operands]}")
    if q.dtype not in (torch.bfloat16, torch.float32) \
            or any(t.dtype != q.dtype for t in operands):
        raise ValueError("flash_attention: q, k and v must all be bfloat16 "
                         "or all float32, got "
                         f"{[str(t.dtype) for t in operands]}")
    if any(t.ndim != 4 for t in operands):
        raise ValueError("flash_attention: q, k and v must be 4-D")
    b, h, t, dh = q.shape
    hkv, s_len = k.shape[1], k.shape[2]
    if k.shape != (b, hkv, s_len, dh) or v.shape != k.shape or hkv < 1 \
            or h % hkv:
        raise ValueError(
            f"flash_attention: shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
            f"v {tuple(v.shape)} do not agree (k and v (B, Hkv, S, Dh) with "
            "H a multiple of Hkv)")
    if dh not in _k.HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {dh} is not one of the "
                         f"kernel's {_k.HEAD_DIMS}")
    if any(x.stride(3) != 1 for x in operands):
        raise ValueError("flash_attention: the last axis of q, k and v must "
                         "be contiguous")
    if q.dtype == torch.bfloat16:
        for name, x in zip("qkv", operands):
            why = _k.tma_refusal(x.data_ptr(), x.shape, x.stride(),
                                 x.element_size())
            if why:
                raise ValueError(f"flash_attention: TMA cannot read {name}: "
                                 f"{why}")
    out = torch.empty((b, h, t, dh), dtype=q.dtype, device=q.device)
    _k.flash_attention(q, k, v, out, causal, dh ** -0.5)
    LAUNCHES[str(q.dtype).removeprefix("torch.")] += 1
    return out


@_flash_op.register_fake
def _(q, k, v, causal):
    return q.new_empty(q.shape)


@register_flop_formula(torch.ops.repro_torch.flash_attention)
def flop_count(q_shape, k_shape, v_shape, causal, *args, **kwargs) -> int:
    """4 Dh FLOPs a visible (query, key) pair: QK^T and PV."""
    b, h, t, dh = q_shape
    return 4 * dh * visible_pairs(b, h, t, k_shape[2], causal)
