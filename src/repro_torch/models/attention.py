"""Attention variants: GQA (+ local window), MLA (DeepSeek),
cross-attention.  Train/prefill (query-chunked, or the flash kernel) and
single-token decode.

Port of ``repro.models.attention``.  Train/prefill GQA attention takes one
of two routes, as in the JAX package:

* ``use_flash=False`` (every registered config): ``_attend_chunked``, plain
  torch under autograd, in query chunks so no (T, S) score tensor is made
  whole; scores, softmax and PV in f32, the output in q's dtype.  This is
  the training path.
* ``use_flash=True``: ``kernels/flash_attention/ops.py``, the hand-written
  kernel for CUDA tensors, its plain version for CPU tensors.  The kernel
  has no backward (neither has the JAX package's Pallas op) and no local
  window; a window there is refused, where the JAX package drops it
  (ROADMAP Queue 3 item 18).

MLA (head dims 192 / 128) and cross-attention always take the
query-chunked route, as in the JAX package.  Decode attention is plain
torch in f32 over the cache, as the JAX package computes it outside any
kernel: a local-window layer keeps a rolling cache of ``window`` slots
(position p at slot p % window), and MLA decodes in the absorbed form
against its compressed ``c_kv`` cache.  The JAX package's sharding
constraints stay at their sites through ``distributed.sharding.constrain``,
the identity in the port (the layers are held whole on each rank).
"""
from __future__ import annotations

import torch

from ..distributed.sharding import axis_divides, constrain
from ..kernels.flash_attention import ops as fa
from .common import Leaf, apply_rope, rmsnorm

NEG_INF = -1.0e30


def head_dim(cfg) -> int:
    return cfg.head_dim or cfg.d_model // cfg.num_heads


def _projections(cfg) -> dict:
    """wq, wk, wv, wo of GQA and cross-attention; their head dims split
    only in whole heads (``heads:Dh``)."""
    dh, d = head_dim(cfg), cfg.d_model
    hq, hkv = f"heads:{dh}", f"kv_heads:{dh}"
    return {"wq": Leaf((d, cfg.num_heads * dh), logical=("embed", hq)),
            "wk": Leaf((d, cfg.num_kv_heads * dh), logical=("embed", hkv)),
            "wv": Leaf((d, cfg.num_kv_heads * dh), logical=("embed", hkv)),
            "wo": Leaf((cfg.num_heads * dh, d), logical=(hq, "embed"))}


def init_gqa(cfg) -> dict:
    spec = _projections(cfg)
    if cfg.qkv_bias:
        dh = head_dim(cfg)
        hq, hkv = f"heads:{dh}", f"kv_heads:{dh}"
        spec["bq"] = Leaf((cfg.num_heads * dh,), "zeros", logical=(hq,))
        spec["bk"] = Leaf((cfg.num_kv_heads * dh,), "zeros", logical=(hkv,))
        spec["bv"] = Leaf((cfg.num_kv_heads * dh,), "zeros", logical=(hkv,))
    return spec


def init_mla(cfg) -> dict:
    h, d = cfg.num_heads, cfg.d_model
    qk = cfg.qk_nope_head_dim + cfg.qk_rope_head_dim
    nope, dv = cfg.qk_nope_head_dim, cfg.v_head_dim
    return {"wq_a": Leaf((d, cfg.q_lora_rank), logical=("embed", "rank")),
            "q_norm": Leaf((cfg.q_lora_rank,), "zeros", logical=(None,)),
            "wq_b": Leaf((cfg.q_lora_rank, h * qk),
                         logical=("rank", f"heads:{qk}")),
            "wkv_a": Leaf((d, cfg.kv_lora_rank + cfg.qk_rope_head_dim),
                          logical=("embed", "rank")),
            "kv_norm": Leaf((cfg.kv_lora_rank,), "zeros", logical=(None,)),
            "wk_b": Leaf((cfg.kv_lora_rank, h * nope),
                         logical=("rank", f"heads:{nope}")),
            "wv_b": Leaf((cfg.kv_lora_rank, h * dv),
                         logical=("rank", f"heads:{dv}")),
            "wo": Leaf((h * dv, d), logical=(f"heads:{dv}", "embed"))}


def init_cross(cfg) -> dict:
    return _projections(cfg)


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
    # The reference's constraint sites (asserted only when H divides the
    # tensor-parallel extent); ``constrain`` is the identity here.
    tp_ok = axis_divides("heads", h)
    cst = constrain if tp_ok else (lambda x_, _ax: x_)
    outs = []
    for start in range(0, t + pad, c):
        qi = cst(q[:, start:start + c], ("batch", None, "heads", None))
        qi = qi.float().reshape(b, c, hkv, group, dh)
        sc = torch.einsum("bcngd,bsnd->bngcs", qi, k32) * scale
        row = start + torch.arange(c, device=q.device) + offset
        valid = torch.ones((c, s_len), dtype=torch.bool, device=q.device)
        if causal:
            valid &= col[None, :] <= row[:, None]
        if window is not None:
            valid &= col[None, :] > row[:, None] - window
        sc = torch.where(valid, sc, NEG_INF)
        p = torch.softmax(sc, dim=-1)
        o = torch.einsum("bngcs,bsnd->bcngd", p, v32).reshape(b, c, h, dv)
        outs.append(cst(o, ("batch", None, "heads", None)).to(q.dtype))
    return torch.cat(outs, dim=1)[:, :t]


def gqa_forward(cfg, p, x, positions, *, causal=True, window=None):
    """Train/prefill GQA: x (B,T,D), positions (B,T) -> (B,T,D)."""
    b, t, _ = x.shape
    q, k, v = _qkv(cfg, p, x, positions)
    q = constrain(q, ("batch", None, "heads", None))
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


def cross_forward(cfg, p, x, enc_kv):
    """Cross-attention of x (B,T,D) against precomputed encoder K/V
    (B,S,Hkv,Dh): no RoPE, not causal, always query-chunked."""
    b, t, _ = x.shape
    dh = head_dim(cfg)
    q = (x @ p["wq"].to(x.dtype)).reshape(b, t, cfg.num_heads, dh)
    k, v = enc_kv
    out = _attend_chunked(q, k, v, causal=False, window=None)
    return out.reshape(b, t, cfg.num_heads * dh) @ p["wo"].to(x.dtype)


def encode_kv(cfg, p, enc_out):
    """The encoder output (B,S,D) projected into cross-attention K and V
    (B,S,Hkv,Dh)."""
    b, s_len, _ = enc_out.shape
    dh = head_dim(cfg)
    k = (enc_out @ p["wk"].to(enc_out.dtype)).reshape(
        b, s_len, cfg.num_kv_heads, dh)
    v = (enc_out @ p["wv"].to(enc_out.dtype)).reshape(
        b, s_len, cfg.num_kv_heads, dh)
    return k, v


def init_gqa_cache(cfg, batch: int, max_len: int, dtype, device) -> dict:
    """Empty K/V (pos -1) with room for ``max_len`` positions, or for
    min(window, max_len) with a local window (a rolling cache)."""
    dh = head_dim(cfg)
    w = cfg.local_window
    s_len = min(w, max_len) if w else max_len
    return {
        "k": torch.zeros((batch, s_len, cfg.num_kv_heads, dh), dtype=dtype,
                         device=device),
        "v": torch.zeros((batch, s_len, cfg.num_kv_heads, dh), dtype=dtype,
                         device=device),
        "pos": torch.full((batch, s_len), -1, dtype=torch.int32,
                          device=device),
    }


def gqa_decode(cfg, p, x_t, cache: dict, pos):
    """x_t: (B, 1, D); pos: (B,) current absolute position.  Writes the new
    K/V at slot min(pos, S - 1), as the JAX package does, or at pos % S
    with a local window (a rolling cache, which also masks positions that
    fell out of the window), into new cache tensors (the input cache is
    left as it was)."""
    b = x_t.shape[0]
    dh = head_dim(cfg)
    q, k, v = _qkv(cfg, p, x_t, pos[:, None])

    s_len = cache["k"].shape[1]
    slot = ((pos % s_len) if cfg.local_window
            else torch.clamp(pos, max=s_len - 1)).long()
    bidx = torch.arange(b, device=x_t.device)
    ck = cache["k"].index_put((bidx, slot), k[:, 0])
    cv = cache["v"].index_put((bidx, slot), v[:, 0])
    cpos = cache["pos"].index_put((bidx, slot), pos.to(torch.int32))

    group = cfg.num_heads // cfg.num_kv_heads
    qb = q.reshape(b, cfg.num_kv_heads, group, dh)
    sc = torch.einsum("bhgd,bshd->bhgs", qb.float(), ck.float()) * dh ** -0.5
    sc = constrain(sc, ("batch", "kv_heads", "heads_group", None))
    valid = (cpos >= 0) & (cpos <= pos[:, None])
    if cfg.local_window:
        valid &= cpos > (pos[:, None] - cfg.local_window)
    sc = torch.where(valid[:, None, None, :], sc, NEG_INF)
    pr = torch.softmax(sc, dim=-1)
    o = torch.einsum("bhgs,bshd->bhgd", pr, cv.float())
    o = constrain(o, ("batch", "kv_heads", "heads_group", None))
    o = o.reshape(b, 1, cfg.num_heads * dh).to(x_t.dtype)
    return o @ p["wo"].to(x_t.dtype), {"k": ck, "v": cv, "pos": cpos}


# ---------------------------------------------------------------------------
# MLA (DeepSeek-V2): train + absorbed decode over the compressed cache
# ---------------------------------------------------------------------------

def _mla_qkv(cfg, p, x, positions):
    """(q_nope (B,T,H,nope), q_rope (B,T,H,rope), c_kv (B,T,lora), k_rope
    (B,T,rope), the one RoPE'd key shared by every head)."""
    b, t, _ = x.shape
    h = cfg.num_heads
    nope, rope = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
    cq = rmsnorm(x @ p["wq_a"].to(x.dtype), p["q_norm"])
    q = (cq @ p["wq_b"].to(x.dtype)).reshape(b, t, h, nope + rope)
    q_nope, q_rope = q[..., :nope], q[..., nope:]
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta)
    kv_a = x @ p["wkv_a"].to(x.dtype)                        # (B,T,lora+rope)
    c_kv = rmsnorm(kv_a[..., :cfg.kv_lora_rank], p["kv_norm"])
    k_rope = apply_rope(kv_a[..., cfg.kv_lora_rank:], positions,
                        cfg.rope_theta)
    return q_nope, q_rope, c_kv, k_rope


def mla_forward(cfg, p, x, positions):
    """Train/prefill MLA: keys and values decompressed from c_kv, the
    query-chunked causal attention over qk head dim nope + rope and value
    head dim v_head_dim."""
    b, t, _ = x.shape
    h = cfg.num_heads
    nope, rope = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
    q_nope, q_rope, c_kv, k_rope = _mla_qkv(cfg, p, x, positions)
    k_nope = (c_kv @ p["wk_b"].to(x.dtype)).reshape(b, t, h, nope)
    v = (c_kv @ p["wv_b"].to(x.dtype)).reshape(b, t, h, cfg.v_head_dim)
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, k_rope[:, :, None, :].expand(b, t, h, rope)],
                  dim=-1)
    out = _attend_chunked(q, k, v, causal=True, window=None)
    out = out.reshape(b, t, h * cfg.v_head_dim)
    return out @ p["wo"].to(x.dtype)


def init_mla_cache(cfg, batch: int, max_len: int, dtype, device) -> dict:
    return {
        "c_kv": torch.zeros((batch, max_len, cfg.kv_lora_rank), dtype=dtype,
                            device=device),
        "k_rope": torch.zeros((batch, max_len, cfg.qk_rope_head_dim),
                              dtype=dtype, device=device),
        "pos": torch.full((batch, max_len), -1, dtype=torch.int32,
                          device=device),
    }


def mla_decode(cfg, p, x_t, cache: dict, pos):
    """Absorbed MLA decode: scores and values against the compressed c_kv
    cache, W_kb folded into the query and W_vb into the output (f32).
    Writes at slot min(pos, S - 1) into new cache tensors."""
    b = x_t.shape[0]
    h = cfg.num_heads
    nope, rope = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
    q_nope, q_rope, c_kv_t, k_rope_t = _mla_qkv(cfg, p, x_t, pos[:, None])

    bidx = torch.arange(b, device=x_t.device)
    slot = torch.clamp(pos, max=cache["c_kv"].shape[1] - 1).long()
    ck = cache["c_kv"].index_put((bidx, slot), c_kv_t[:, 0])
    kr = cache["k_rope"].index_put((bidx, slot), k_rope_t[:, 0])
    cpos = cache["pos"].index_put((bidx, slot), pos.to(torch.int32))

    wk_b = p["wk_b"].reshape(cfg.kv_lora_rank, h, nope)
    q_eff = torch.einsum("bhd,lhd->bhl", q_nope[:, 0].float(), wk_b.float())
    sc = torch.einsum("bhl,bsl->bhs", q_eff, ck.float())
    sc = sc + torch.einsum("bhd,bsd->bhs", q_rope[:, 0].float(), kr.float())
    sc = sc * (nope + rope) ** -0.5
    valid = (cpos >= 0) & (cpos <= pos[:, None])
    sc = torch.where(valid[:, None, :], sc, NEG_INF)
    pr = torch.softmax(sc, dim=-1)
    ctx = torch.einsum("bhs,bsl->bhl", pr, ck.float())       # (B,H,lora)
    wv_b = p["wv_b"].reshape(cfg.kv_lora_rank, h, cfg.v_head_dim)
    o = torch.einsum("bhl,lhv->bhv", ctx, wv_b.float())
    o = o.reshape(b, 1, h * cfg.v_head_dim).to(x_t.dtype)
    return o @ p["wo"].to(x_t.dtype), {"c_kv": ck, "k_rope": kr,
                                       "pos": cpos}
