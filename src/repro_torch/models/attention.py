"""GQA attention: train and prefill (query-chunked, or the flash kernel),
single-token decode.

Port of the GQA part of ``repro.models.attention``.  Train/prefill
attention takes one of two routes, as in the JAX package:

* ``use_flash=False`` (every registered config): ``_attend_chunked``, plain
  torch under autograd, in query chunks so no (T, S) score tensor is made
  whole; scores, softmax and PV in f32, the output in q's dtype.  This is
  the training path.
* ``use_flash=True``: ``kernels/flash_attention/ops.py``, the hand-written
  kernel for CUDA tensors, its plain version for CPU tensors.  The kernel
  has no backward (neither has the JAX package's Pallas op) and no local
  window; a window there is refused, where the JAX package drops it
  (ROADMAP Queue 3 item 18).

Decode attention is plain torch in f32 over the cache, as the JAX package
computes it outside any kernel.  Not ported yet (ROADMAP Queue 1 item 12):
the rolling local-window cache, MLA and cross-attention.  The JAX
package's sharding constraints have no counterpart on one card.
"""
from __future__ import annotations

import torch

from ..kernels.flash_attention import ops as fa
from .common import Leaf, apply_rope

NEG_INF = -1.0e30


def head_dim(cfg) -> int:
    return cfg.head_dim or cfg.d_model // cfg.num_heads


def _not_ported(what: str):
    return NotImplementedError(
        f"{what} is not ported to repro_torch yet (ROADMAP Queue 1 item 12)")


def init_gqa(cfg) -> dict:
    dh = head_dim(cfg)
    spec = {"wq": Leaf((cfg.d_model, cfg.num_heads * dh)),
            "wk": Leaf((cfg.d_model, cfg.num_kv_heads * dh)),
            "wv": Leaf((cfg.d_model, cfg.num_kv_heads * dh)),
            "wo": Leaf((cfg.num_heads * dh, cfg.d_model))}
    if cfg.qkv_bias:
        spec["bq"] = Leaf((cfg.num_heads * dh,), "zeros")
        spec["bk"] = Leaf((cfg.num_kv_heads * dh,), "zeros")
        spec["bv"] = Leaf((cfg.num_kv_heads * dh,), "zeros")
    return spec


def _heads(cfg, p, x, positions, name: str):
    """x (B,T,D) projected by ``w{name}`` (+ ``b{name}``) into heads
    (B,T,heads,Dh), RoPE'd unless it is ``v``; in x's dtype."""
    b, t, _ = x.shape
    y = x @ p[f"w{name}"].to(x.dtype)
    if cfg.qkv_bias:
        y = y + p[f"b{name}"].to(x.dtype)
    y = y.reshape(b, t, -1, head_dim(cfg))
    if cfg.rope_theta and name != "v":
        y = apply_rope(y, positions, cfg.rope_theta)
    return y


def _qkv(cfg, p, x, positions):
    return tuple(_heads(cfg, p, x, positions, n) for n in "qkv")


def _attend_chunked(q, k, v, *, causal: bool, window: int | None,
                    chunk: int = 512):
    """q: (B,T,H,Dh); k/v: (B,S,Hkv,Dh).  Suffix-aligned causal (query row
    i sits at absolute position i + S - T).  -> (B,T,H,Dh) in q's dtype.

    Queries go in chunks of ``chunk`` rows (a ragged last chunk is padded,
    then sliced off), each against every key: scores, the masked softmax
    (``NEG_INF``) and PV in f32.  Query head h reads K/V head
    h // (H / Hkv), the JAX package's fused-head order; the grouped einsum
    reads each K/V head in place instead of broadcasting it to H heads."""
    b, t, h, dh = q.shape
    s_len, hkv = k.shape[1], k.shape[2]
    dv = v.shape[-1]
    group = h // hkv
    scale = dh ** -0.5
    offset = s_len - t
    c = min(chunk, t)
    pad = (-t) % c
    if pad:
        q = torch.nn.functional.pad(q, (0, 0, 0, 0, 0, pad))
    k32, v32 = k.float(), v.float()
    col = torch.arange(s_len, device=q.device)
    outs = []
    for start in range(0, t + pad, c):
        qi = q[:, start:start + c].float().reshape(b, c, hkv, group, dh)
        sc = torch.einsum("bcngd,bsnd->bngcs", qi, k32) * scale
        row = start + torch.arange(c, device=q.device) + offset
        valid = torch.ones((c, s_len), dtype=torch.bool, device=q.device)
        if causal:
            valid &= col[None, :] <= row[:, None]
        if window is not None:
            valid &= col[None, :] > row[:, None] - window
        sc = torch.where(valid, sc, NEG_INF)
        p = torch.softmax(sc, dim=-1)
        o = torch.einsum("bngcs,bsnd->bcngd", p, v32)
        outs.append(o.reshape(b, c, h, dv).to(q.dtype))
    return torch.cat(outs, dim=1)[:, :t]


def gqa_forward(cfg, p, x, positions, *, causal=True, window=None):
    """Train/prefill GQA: x (B,T,D), positions (B,T) -> (B,T,D)."""
    b, t, _ = x.shape
    q, k, v = _qkv(cfg, p, x, positions)
    if cfg.use_flash:
        if window is not None:
            raise NotImplementedError(
                "local-window attention through the flash kernel: the "
                "kernel has no window, and the JAX package's flash route "
                "drops it (ROADMAP Queue 3 item 18)")
        # (B,T,H,Dh) -> (B,H,T,Dh) views: the kernel reads them in place.
        out = fa.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                                 v.transpose(1, 2), causal=causal)
        out = out.transpose(1, 2)
    else:
        out = _attend_chunked(q, k, v, causal=causal, window=window)
    out = out.reshape(b, t, cfg.num_heads * head_dim(cfg))
    return out @ p["wo"].to(x.dtype)


def init_gqa_cache(cfg, batch: int, max_len: int, dtype, device) -> dict:
    if cfg.local_window:
        raise _not_ported("the rolling local-window cache")
    dh = head_dim(cfg)
    return {
        "k": torch.zeros((batch, max_len, cfg.num_kv_heads, dh), dtype=dtype,
                         device=device),
        "v": torch.zeros((batch, max_len, cfg.num_kv_heads, dh), dtype=dtype,
                         device=device),
        "pos": torch.full((batch, max_len), -1, dtype=torch.int32,
                          device=device),
    }


def gqa_decode(cfg, p, x_t, cache: dict, pos):
    """x_t: (B, 1, D); pos: (B,) current absolute position.  Writes the new
    K/V at slot min(pos, S - 1), as the JAX package does, into new cache
    tensors (the input cache is left as it was)."""
    if cfg.local_window:
        raise _not_ported("the rolling local-window cache")
    b = x_t.shape[0]
    dh = head_dim(cfg)
    q, k, v = _qkv(cfg, p, x_t, pos[:, None])

    s_len = cache["k"].shape[1]
    slot = torch.clamp(pos, max=s_len - 1).long()
    bidx = torch.arange(b, device=x_t.device)
    ck = cache["k"].index_put((bidx, slot), k[:, 0])
    cv = cache["v"].index_put((bidx, slot), v[:, 0])
    cpos = cache["pos"].index_put((bidx, slot), pos.to(torch.int32))

    group = cfg.num_heads // cfg.num_kv_heads
    qb = q.reshape(b, cfg.num_kv_heads, group, dh)
    sc = torch.einsum("bhgd,bshd->bhgs", qb.float(), ck.float()) * dh ** -0.5
    valid = (cpos >= 0) & (cpos <= pos[:, None])
    sc = torch.where(valid[:, None, None, :], sc, NEG_INF)
    pr = torch.softmax(sc, dim=-1)
    o = torch.einsum("bhgs,bshd->bhgd", pr, cv.float())
    o = o.reshape(b, 1, cfg.num_heads * dh).to(x_t.dtype)
    return o @ p["wo"].to(x_t.dtype), {"k": ck, "v": cv, "pos": cpos}
