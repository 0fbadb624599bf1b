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
the identity in the port.

Tensor parallelism of GQA (``head_layout``): under a mesh whose ``model``
axis splits ``heads`` (H divisible by it), each rank computes its H /
model query heads, column-parallel ``wq`` (and ``bq``) on the replicated
input (``copy_to_model``), and its share of the output through a
row-parallel ``wo`` whose partial sums are added over ``model``
(``row_parallel``); the flash route launches the kernel on the
rank's (B, H / model, T, Dh) heads.  Where ``kv_heads`` divides too, the
rank holds its Hkv / model kv heads; where it does not, ``wk`` / ``wv``
are whole on every rank and the rank uses only the kv heads its query
heads read (their gradient summed over ``model``), expanded to one a
query head where the rank's heads do not fall into whole groups.  Where
``heads`` does not divide, every rank computes the whole attention (the
rules' fallback; no collective).  The decode cache holds the rank's kv
heads over the whole sequence: the reference's cache rule,
``("batch", "seq_shard", "kv_heads", None)``, lets XLA put the sequence
over ``model`` instead, a layout choice that changes no value.  Weights
cut over ``data`` (``embed``, FSDP) are gathered just before use.

A local-window layer is GQA with a window: the same split (recurrentgemma's
MQA keeps its one kv head whole on every rank), its rolling cache the
rank's kv heads.  Cross-attention splits as GQA does: ``wq`` by heads on
the replicated decoder input, ``wk`` / ``wv`` by kv heads on the
replicated encoder output (or whole, the rank slicing its kv heads), its
``xk`` / ``xv`` cache the rank's kv heads, ``wo`` row-parallel.  MLA
(``mla_forward``, ``mla_decode``) keeps ``wq_a`` / ``wkv_a`` and the norms
whole over ``model`` (the rules' ``rank``: cut only over ``data``) and
splits ``wq_b``, ``wk_b`` and ``wv_b`` column-parallel in whole heads and
``wo`` row-parallel; the compressed ``cq``, ``c_kv`` and ``k_rope``, the
same on every rank, go through ``copy_to_model`` before the rank's heads
read them, so their gradient is the sum over ``model``.  The absorbed
decode is per head, so it is local.  The latent cache (``c_kv``,
``k_rope``) stays whole on every rank: the reference's cache rule puts its
sequence on ``seq_shard`` over ``model``, a layout choice that changes no
value (as for GQA's cache above).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..distributed import tensor_parallel as tp
from ..distributed.sharding import axis_divides, constrain, spec_for
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


class HeadLayout(NamedTuple):
    """One rank's share of a GQA layer: h query heads, kv heads
    [kv_lo, kv_lo + kv) (the ones those query heads read), whether the
    layer is split over ``model`` (``split``) and ``wk`` / ``wv`` with it
    (``kv_split``; else whole, and the rank slices its kv heads), and
    ``expand``: each local query head's local kv head, where they are not
    whole groups (None: query head j reads kv head j // (h / kv))."""
    split: bool
    h: int
    kv_split: bool
    kv_lo: int
    kv: int
    expand: tuple[int, ...] | None


def head_layout(cfg) -> HeadLayout:
    """This rank's heads under the context mesh, from the resolved specs
    of ``wq`` and ``wk`` (the rules' divisibility fallback decides)."""
    dh, h, hkv = head_dim(cfg), cfg.num_heads, cfg.num_kv_heads
    m = tp.model_size()
    split = m > 1 and "model" in spec_for((f"heads:{dh}",), (h * dh,))
    if not split:
        return HeadLayout(False, h, False, 0, hkv, None)
    hl = h // m
    lo = tp.model_index() * hl
    kv_split = "model" in spec_for((f"kv_heads:{dh}",), (hkv * dh,))
    group = h // hkv
    reads = [(lo + j) // group for j in range(hl)]
    kv_lo, kv = reads[0], reads[-1] - reads[0] + 1
    local = [r - kv_lo for r in reads]
    uniform = hl % kv == 0 and local == [j // (hl // kv) for j in range(hl)]
    return HeadLayout(True, hl, kv_split, kv_lo, kv,
                      None if uniform else tuple(local))


def _proj(cfg, p, name: str, d: int, hl: HeadLayout):
    """This rank's ``w{name}`` (D, heads * Dh) and ``b{name}`` (or None):
    its block as held, or, for whole kv weights of a split layer, its kv
    heads' columns (the gradient of the whole summed over ``model``)."""
    w = tp.gather_over_data(p[f"w{name}"], 0, d)
    b = p.get(f"b{name}") if cfg.qkv_bias else None   # cross-attn: none
    if hl.split and name != "q" and not hl.kv_split:
        dh = head_dim(cfg)
        cols = slice(hl.kv_lo * dh, (hl.kv_lo + hl.kv) * dh)
        w = tp.copy_to_model(w)[:, cols]
        b = None if b is None else tp.copy_to_model(b)[cols]
    return w, b


def _heads(cfg, p, x, positions, name: str, hl: HeadLayout | None = None):
    """x (B,T,D) projected by this rank's ``w{name}`` (+ ``b{name}``) into
    its heads (B,T,heads,Dh), RoPE'd unless it is ``v`` or ``positions``
    is None (cross-attention); in x's dtype."""
    b, t, d = x.shape
    w, bias = _proj(cfg, p, name, d, head_layout(cfg) if hl is None else hl)
    y = x @ w.to(x.dtype)
    if bias is not None:
        y = y + bias.to(x.dtype)
    y = y.reshape(b, t, -1, head_dim(cfg))
    if cfg.rope_theta and name != "v" and positions is not None:
        y = apply_rope(y, positions, cfg.rope_theta)
    return y


def _qkv(cfg, p, x, positions, hl: HeadLayout):
    return tuple(_heads(cfg, p, x, positions, n, hl) for n in "qkv")


def _expand(kv, hl: HeadLayout, axis: int):
    """kv heads (along ``axis``) repeated to one a local query head where
    the rank's query heads are not whole groups."""
    if hl.expand is None:
        return kv
    idx = torch.tensor(hl.expand, device=kv.device)
    return kv.index_select(axis, idx)


def _out(cfg, p, o, hl: HeadLayout):
    """o (B,T,h*Dh) through this rank's rows of ``wo``, summed over
    ``model`` where the layer is split."""
    wo = tp.gather_over_data(p["wo"], 1, cfg.d_model).to(o.dtype)
    return tp.row_parallel(o, wo) if hl.split else o @ wo


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


def gqa_forward(cfg, p, x, positions, *, causal=True, window=None,
                return_kv=False):
    """Train/prefill GQA: x (B,T,D), positions (B,T) -> (B,T,D); with
    ``return_kv``, also this rank's (K, V) (B,T,kv,Dh), for a cache."""
    b, t, _ = x.shape
    hl = head_layout(cfg)
    if hl.split:
        x = tp.copy_to_model(x)
    q, k_held, v_held = _qkv(cfg, p, x, positions, hl)
    k, v = _expand(k_held, hl, 2), _expand(v_held, hl, 2)
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
    y = _out(cfg, p, out.reshape(b, t, hl.h * head_dim(cfg)), hl)
    return (y, (k_held, v_held)) if return_kv else y


def cross_forward(cfg, p, x, enc_kv):
    """Cross-attention of x (B,T,D) against precomputed encoder K/V
    (B,S,kv,Dh) of this rank's kv heads: no RoPE, not causal, always
    query-chunked."""
    b, t, _ = x.shape
    hl = head_layout(cfg)
    if hl.split:
        x = tp.copy_to_model(x)
    q = _heads(cfg, p, x, None, "q", hl)
    k, v = (_expand(a, hl, 2) for a in enc_kv)
    out = _attend_chunked(q, k, v, causal=False, window=None)
    return _out(cfg, p, out.reshape(b, t, hl.h * head_dim(cfg)), hl)


def encode_kv(cfg, p, enc_out):
    """The encoder output (B,S,D) projected into cross-attention K and V
    (B,S,kv,Dh) of this rank's kv heads."""
    hl = head_layout(cfg)
    if hl.split:
        enc_out = tp.copy_to_model(enc_out)
    return tuple(_heads(cfg, p, enc_out, None, n, hl) for n in "kv")


def init_gqa_cache(cfg, batch: int, max_len: int, dtype, device) -> dict:
    """Empty K/V (pos -1) of this rank's kv heads with room for
    ``max_len`` positions, or for min(window, max_len) with a local window
    (a rolling cache)."""
    dh = head_dim(cfg)
    w = cfg.local_window
    s_len = min(w, max_len) if w else max_len
    kv = head_layout(cfg).kv
    return {
        "k": torch.zeros((batch, s_len, kv, dh), dtype=dtype, device=device),
        "v": torch.zeros((batch, s_len, kv, dh), dtype=dtype, device=device),
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
    hl = head_layout(cfg)
    if hl.split:
        x_t = tp.copy_to_model(x_t)
    q, k, v = _qkv(cfg, p, x_t, pos[:, None], hl)

    s_len = cache["k"].shape[1]
    slot = ((pos % s_len) if cfg.local_window
            else torch.clamp(pos, max=s_len - 1)).long()
    bidx = torch.arange(b, device=x_t.device)
    ck = cache["k"].index_put((bidx, slot), k[:, 0])
    cv = cache["v"].index_put((bidx, slot), v[:, 0])
    cpos = cache["pos"].index_put((bidx, slot), pos.to(torch.int32))

    ek, ev = _expand(ck, hl, 2), _expand(cv, hl, 2)
    kv = ek.shape[2]
    qb = q.reshape(b, kv, hl.h // kv, dh)
    sc = torch.einsum("bhgd,bshd->bhgs", qb.float(), ek.float()) * dh ** -0.5
    sc = constrain(sc, ("batch", "kv_heads", "heads_group", None))
    valid = (cpos >= 0) & (cpos <= pos[:, None])
    if cfg.local_window:
        valid &= cpos > (pos[:, None] - cfg.local_window)
    sc = torch.where(valid[:, None, None, :], sc, NEG_INF)
    pr = torch.softmax(sc, dim=-1)
    o = torch.einsum("bhgs,bshd->bhgd", pr, ev.float())
    o = constrain(o, ("batch", "kv_heads", "heads_group", None))
    o = o.reshape(b, 1, hl.h * dh).to(x_t.dtype)
    return _out(cfg, p, o, hl), {"k": ck, "v": cv, "pos": cpos}


# ---------------------------------------------------------------------------
# MLA (DeepSeek-V2): train + absorbed decode over the compressed cache
# ---------------------------------------------------------------------------

def mla_heads(cfg, p) -> int:
    """This rank's MLA heads: all of them, or H / model where ``wq_b`` is
    cut over ``model``."""
    return p["wq_b"].shape[-1] // (cfg.qk_nope_head_dim
                                   + cfg.qk_rope_head_dim)


def mla_latent(cfg, p, x, positions):
    """(c_kv (B,T,lora), k_rope (B,T,rope)): the compressed keys and values
    and the one RoPE'd key shared by every head, the same on every rank."""
    wkv_a = tp.gather_over_data(p["wkv_a"], 0, x.shape[-1])
    kv_a = x @ wkv_a.to(x.dtype)                             # (B,T,lora+rope)
    c_kv = rmsnorm(kv_a[..., :cfg.kv_lora_rank], p["kv_norm"])
    k_rope = apply_rope(kv_a[..., cfg.kv_lora_rank:], positions,
                        cfg.rope_theta)
    return c_kv, k_rope


def _mla_qkv(cfg, p, x, positions):
    """(q_nope (B,T,h,nope), q_rope (B,T,h,rope) of this rank's h heads,
    c_kv, k_rope); with the heads split, the shared tensors go through
    ``copy_to_model`` (module doc)."""
    b, t, _ = x.shape
    h = mla_heads(cfg, p)
    split = h != cfg.num_heads
    nope, rope = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
    wq_a = tp.gather_over_data(p["wq_a"], 0, x.shape[-1])
    cq = rmsnorm(x @ wq_a.to(x.dtype), p["q_norm"])
    c_kv, k_rope = mla_latent(cfg, p, x, positions)
    if split:
        cq, c_kv, k_rope = (tp.copy_to_model(a) for a in (cq, c_kv, k_rope))
    q = (cq @ p["wq_b"].to(x.dtype)).reshape(b, t, h, nope + rope)
    q_nope, q_rope = q[..., :nope], q[..., nope:]
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta)
    return q_nope, q_rope, c_kv, k_rope


def _mla_out(cfg, p, o):
    """o (B,T,h*v) through this rank's rows of ``wo``, summed over
    ``model`` where the heads are split."""
    wo = tp.gather_over_data(p["wo"], 1, cfg.d_model).to(o.dtype)
    return tp.row_parallel(o, wo) if wo.shape[0] != cfg.num_heads * \
        cfg.v_head_dim else o @ wo


def mla_forward(cfg, p, x, positions):
    """Train/prefill MLA: keys and values decompressed from c_kv, the
    query-chunked causal attention over qk head dim nope + rope and value
    head dim v_head_dim, on this rank's heads."""
    b, t, _ = x.shape
    h = mla_heads(cfg, p)
    nope, rope = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
    q_nope, q_rope, c_kv, k_rope = _mla_qkv(cfg, p, x, positions)
    k_nope = (c_kv @ p["wk_b"].to(x.dtype)).reshape(b, t, h, nope)
    v = (c_kv @ p["wv_b"].to(x.dtype)).reshape(b, t, h, cfg.v_head_dim)
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, k_rope[:, :, None, :].expand(b, t, h, rope)],
                  dim=-1)
    out = _attend_chunked(q, k, v, causal=True, window=None)
    return _mla_out(cfg, p, out.reshape(b, t, h * cfg.v_head_dim))


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
    h = mla_heads(cfg, p)
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
    return _mla_out(cfg, p, o), {"c_kv": ck, "k_rope": kr, "pos": cpos}
