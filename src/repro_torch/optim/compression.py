"""int8 error-feedback gradient compression (port of
``repro.optim.compression``).

Before the data-parallel all-reduce, gradients are quantised to int8 with a
per-tensor scale ``max|x| / 127`` (round half to even, as ``jnp.round``);
the quantisation residual is carried to the next step (error feedback,
Seide et al. 2014 / Karimireddy et al. 2019).  :func:`compress_with_feedback`
simulates the wire format (quantise, then dequantise) and returns the new
error state beside the gradients, as the JAX package does.
"""
from __future__ import annotations

import torch

from ..core.flat import tree_leaves, tree_map


def quantize_int8(x: torch.Tensor):
    scale = torch.clamp(torch.max(torch.abs(x)), min=1e-12) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def init_error_state(params: dict) -> dict:
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)


def compress_with_feedback(grads: dict, err: dict):
    """Returns (wire-equivalent grads, new error state)."""
    def one(g, e):
        g32 = g.float() + e
        q, scale = quantize_int8(g32)
        deq = dequantize_int8(q, scale)
        return deq.to(g.dtype), g32 - deq

    pairs = tree_map(one, grads, err)
    return (tree_map(lambda pair: pair[0], pairs),
            tree_map(lambda pair: pair[1], pairs))


def wire_bytes(grads: dict, compressed: bool) -> int:
    return sum(g.numel() * (1 if compressed else 4)
               for g in tree_leaves(grads))
