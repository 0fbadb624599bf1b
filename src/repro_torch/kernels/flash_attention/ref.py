"""Plain PyTorch version of the flash-attention kernel (materialised softmax).

``repro.kernels.flash_attention.ref.attention_ref`` with two changes:

* a query row that sees no key (causal with T > S) returns 0, as the
  kernel does, where the JAX oracle returns NaN;
* ``chunk`` query rows at a time, so the (chunk, S) scores of long
  sequences fit in memory; the result does not depend on it.

It computes in f32, or in f64 for f64 inputs, and returns q's dtype.
"""
from __future__ import annotations

import torch


def attention_ref(q, k, v, *, causal: bool = True, scale: float | None = None,
                  chunk: int | None = None):
    """q: (B,H,T,Dh); k/v: (B,Hkv,S,Dh) with H % Hkv == 0 -> (B,H,T,Dh).
    Causal queries are suffix-aligned: row r sees keys <= r + (S - T)."""
    b, h, t, dh = q.shape
    hkv, s_len = k.shape[1], k.shape[2]
    group = h // hkv
    scale = (dh ** -0.5) if scale is None else scale
    cd = torch.float64 if q.dtype == torch.float64 else torch.float32
    kr = k.to(cd).repeat_interleave(group, dim=1)
    vr = v.to(cd).repeat_interleave(group, dim=1)
    col = torch.arange(s_len, device=q.device)
    chunk = t if chunk is None else chunk
    outs = []
    for lo in range(0, t, chunk):
        qc = q[:, :, lo:lo + chunk].to(cd)
        s = torch.einsum("bhtd,bhsd->bhts", qc, kr) * scale
        if causal:
            row = torch.arange(lo, lo + qc.shape[2], device=q.device)
            visible = col[None, :] <= row[:, None] + (s_len - t)
            s = s.masked_fill(~visible, float("-inf"))
        m = s.amax(dim=-1, keepdim=True)
        p = torch.exp(s - torch.where(torch.isinf(m), 0.0, m))
        l = p.sum(dim=-1, keepdim=True)
        o = torch.einsum("bhts,bhsd->bhtd", p, vr)
        outs.append(o / torch.where(l == 0, 1.0, l))
    return torch.cat(outs, dim=2).to(q.dtype)
