"""Mixture-of-Experts with expert parallelism.

Port of ``repro.models.moe``.  Two code paths sharing the router math:

* ``moe_dense``   — every expert applied to every token, combined by the
  renormalised top-k gates: exact, and E / k times the routed FLOPs.  The
  experts run one at a time (a loop over E of three products each), and
  the combine accumulates in f32 and rounds once, as the JAX package's
  combining einsum does; no (E, tokens, D) tensor is made.
* ``moe_sharded`` — the expert-parallel schedule over the ``model`` axis
  of the context mesh (``distributed.sharding.use_mesh``, a
  ``DeviceMesh``): each rank of a ``model`` group holds E / model experts
  and 1 / model of its data shard's tokens; route -> sort-based pack into
  a fixed-capacity (E, C, D) buffer -> all_to_all (dispatch) -> the local
  experts -> all_to_all (return) -> unpack/combine -> all_gather of the
  tokens over ``model``.  With no mesh, no ``model`` axis, or E not
  divisible by its size, it is ``moe_dense``, as in the reference; the
  mesh decides, not the process group.

Capacity C = ceil(topk * tokens / E * capacity_factor), rounded up to a
multiple of 4 and at least 4, tokens are kept per expert, in arrival order
(a stable sort of the expert ids); the gate mass of overflow tokens is
dropped (standard token-dropping MoE).  ``moe_dispatch_dtype="int8"`` sends
both all_to_alls as int8 with a per-(expert, slot) scale, forward and
backward (``_QuantAllToAll``).

Gradients match the dense path's for one replicated loss a ``model``
group: the all_gather's backward keeps the rank's own slice (no sum), the
token slice's backward all_gathers the slices' cotangents into the full
cotangent of x, the router's gradient is summed over ``model``, and each
rank's expert gradients are complete.  The collectives are
``distributed.tensor_parallel``'s (over gloo with CUDA tensors each goes
through host copies).  Under a mesh whose ``model`` axis splits the
experts, ``moe_dense`` runs the rank's experts on every token and sums
their outputs over ``model``; either path gathers leaves cut over
``data`` (FSDP, ``moe_mlp`` and the router's ``embed``) just before use.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..distributed import sharding as shlib
from ..distributed import tensor_parallel as tp
from .common import Leaf

# The reference's shard_map in_specs, P("model"): the expert axis over
# ``model``, every other axis whole.  The schedule also takes the leaves
# under ``DEFAULT_RULES`` (``moe_mlp`` over ``data`` as well: gathered
# per layer, ``tensor_parallel.gather_over_data``).
EXPERT_RULES = {"experts": ("model",)}


def init_moe(cfg) -> dict:
    e, d, dff = cfg.num_experts, cfg.d_model, cfg.moe_d_ff
    return {"router": Leaf((d, e), logical=("embed", None)),
            "w_gate": Leaf((e, d, dff), logical=("experts", "moe_mlp", None)),
            "w_up": Leaf((e, d, dff), logical=("experts", "moe_mlp", None)),
            "w_down": Leaf((e, dff, d), logical=("experts", None, "moe_mlp"))}


def _route(cfg, router_w, x_flat, over_batch: bool = False):
    """x_flat (n, D) -> (gates (n,k) in x's dtype, eids (n,k), aux losses:
    the load-balance loss E * sum_e f_e P_e and the router z-loss, f32).
    Equal probabilities go to the lower expert id first, as ``lax.top_k``
    orders them (a stable sort; ``torch.topk`` leaves ties unordered).
    ``over_batch``: x_flat is this rank's data shard, and the losses' means
    are over the global batch (sums added over the batch axes), as the
    reference's are under ``jit``."""
    logits = (x_flat @ router_w.to(x_flat.dtype)).float()
    probs = torch.softmax(logits, dim=-1)
    k = cfg.experts_per_token
    ranked, order = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, eids = ranked[:, :k], order[:, :k]
    gates = gates / torch.sum(gates, dim=-1, keepdim=True)
    e = cfg.num_experts
    if over_batch and any(tp.axis(a) for a in tp.BATCH_AXES):
        sums = tp.reduce_over_batch(torch.cat([
            torch.sum(F.one_hot(eids, e).float(), dim=(0, 1)),
            torch.sum(probs, dim=0),
            torch.sum(torch.logsumexp(logits, dim=-1) ** 2)[None],
            logits.new_full((1,), x_flat.shape[0])]))
        n = sums[-1]
        f, pmean, zloss = sums[:e] / (n * k), sums[e:2 * e] / n, sums[-2] / n
    else:
        f = torch.mean(F.one_hot(eids, e).float(), dim=(0, 1))
        pmean = torch.mean(probs, dim=0)
        zloss = torch.mean(torch.logsumexp(logits, dim=-1) ** 2)
    aux = e * torch.sum(f * pmean)
    return gates.to(x_flat.dtype), eids, {"load_balance": aux,
                                          "router_z": zloss}


def _whole_d(p, d):
    """The router and expert leaves with their ``data`` shards gathered:
    (router (D, E), w_gate, w_up (E', D, F), w_down (E', F, D))."""
    return (tp.gather_over_data(p["router"], 0, d),
            tp.gather_over_data(p["w_gate"], 1, d),
            tp.gather_over_data(p["w_up"], 1, d),
            tp.gather_over_data(p["w_down"], 2, d))


def moe_dense(cfg, p, x):
    """(B,T,D) exact all-experts path -> (y (B,T,D), aux).  With the
    expert leaves cut over ``model`` (E' = E / model of them), each rank
    runs its E' experts on every token and the f32 partial sums are added
    over ``model``."""
    b, t, d = x.shape
    xf = x.reshape(b * t, d)
    router, w_gate, w_up, w_down = _whole_d(p, d)
    gates, eids, aux = _route(cfg, router, xf, over_batch=True)
    el = w_gate.shape[0]
    split = el != cfg.num_experts
    lo = tp.model_index() * el if split else 0
    if split:
        xf, gates = tp.copy_to_model(xf), tp.copy_to_model(gates)
    y = torch.zeros((b * t, d), dtype=torch.float32, device=x.device)
    for j in range(el):
        h = F.silu(xf @ w_gate[j].to(x.dtype)) * (xf @ w_up[j].to(x.dtype))
        y_e = h @ w_down[j].to(x.dtype)
        comb = torch.sum(gates * (eids == lo + j), dim=-1)   # 0 if not routed
        y = y + comb[:, None].float() * y_e.float()
    if split:
        y = tp.reduce_from_model(y)
    return y.to(x.dtype).reshape(b, t, d), aux


# ---------------------------------------------------------------------------
# the expert-parallel schedule
# ---------------------------------------------------------------------------

def _capacity(cfg, n_tokens: int) -> int:
    c = math.ceil(cfg.experts_per_token * n_tokens / cfg.num_experts
                  * cfg.capacity_factor)
    return max(4, -(-c // 4) * 4)


def _pack_local(cfg, xs, gates, eids, cap):
    """Sort-based pack: xs (n,D) -> buf (E*C, D); returns buf and the
    scatter meta (order, flat_tok, flat_gate, dest, keep), each over the
    n*k (token, choice) pairs, ``order`` their stable sort by expert id.
    A pair past its expert's capacity goes to the sentinel row E*C, which
    is cut off."""
    n, d = xs.shape
    k, e = cfg.experts_per_token, cfg.num_experts
    flat_e = eids.reshape(n * k)
    flat_tok = torch.arange(n, device=xs.device).repeat_interleave(k)
    flat_gate = gates.reshape(n * k)
    order = torch.sort(flat_e, stable=True).indices
    e_sorted = flat_e[order]
    # bincount's shape depends on the values: a scatter keeps it static
    counts = torch.zeros(e, dtype=flat_e.dtype, device=xs.device).scatter_add_(
        0, flat_e, torch.ones_like(flat_e))
    starts = torch.cumsum(counts, 0) - counts
    rank = torch.arange(n * k, device=xs.device) - starts[e_sorted]
    keep = rank < cap
    dest = torch.where(keep, e_sorted * cap + rank, e * cap)
    buf = xs.new_zeros((e * cap + 1, d)).index_add(0, dest,
                                                   xs[flat_tok[order]])
    return buf[:-1], (order, flat_tok, flat_gate, dest, keep)


def kept_pairs(meta, n: int, k: int) -> torch.Tensor:
    """(n, k) bool: which of each token's top-k choices kept a slot."""
    order, _, _, _, keep = meta
    out = torch.empty_like(keep)
    out[order] = keep
    return out.reshape(n, k)


def _unpack_local(cfg, y_buf, meta, n, d):
    """y_buf (E*C, D) -> y (n, D): each token's k slots weighted by their
    gates (0 where dropped), summed in f32 and rounded once.  The
    reference scatter-adds the weighted slots in the compute dtype; this
    gathers them (no atomics on the card, so every run gives the same
    bits), and at f32 the two differ only in summation order."""
    order, _, flat_gate, dest, _ = meta
    k = cfg.experts_per_token
    slot = torch.empty_like(dest)
    slot[order] = dest                       # pair (token-major) -> its slot
    w = torch.where(kept_pairs(meta, n, k).reshape(n * k), flat_gate,
                    torch.zeros_like(flat_gate))
    y_ext = torch.cat([y_buf, y_buf.new_zeros((1, d))], 0)
    y_pairs = y_ext[slot].reshape(n, k, d).float()
    y = torch.bmm(w.reshape(n, 1, k).float(), y_pairs)
    return y.reshape(n, d).to(y_buf.dtype)


def _expert_ffn(w_gate, w_up, w_down, xb, dtype):
    """xb (E_loc, C', D) through the rank's E_loc experts, one at a time
    (the dense path's products, at its shapes where C' is its token
    count)."""
    out = torch.empty_like(xb)
    for e in range(xb.shape[0]):
        h = (F.silu(xb[e] @ w_gate[e].to(dtype))
             * (xb[e] @ w_up[e].to(dtype)))
        out[e] = h @ w_down[e].to(dtype)
    return out


def _exchange(v, split: int, concat: int, group, em: int):
    """``lax.all_to_all(v, "model", split, concat, tiled=True)`` of a
    (E or E_loc, C or em*C, ...) buffer: (0, 1) sends expert block j to
    rank j and stacks what arrives on the slot axis, source-major; (1, 0)
    is its inverse, slot block j back to rank j, stacked on the expert
    axis."""
    if (split, concat) == (0, 1):
        e, c, *rest = v.shape
        out = tp.all_to_all(v.reshape(em, e // em, c, *rest), group)
        return out.transpose(0, 1).reshape(e // em, em * c, *rest)
    el, mc, *rest = v.shape
    src = v.reshape(el, em, mc // em, *rest).transpose(0, 1)
    return tp.all_to_all(src.contiguous(), group).reshape(el * em, mc // em,
                                                        *rest)


class _AllToAll(torch.autograd.Function):
    """The plain all_to_all (the reference's ``_plain_a2a``); its backward
    is the same exchange with split and concat swapped."""

    @staticmethod
    def forward(ctx, v, split, concat, group, em):
        ctx.args = (split, concat, group, em)
        return _exchange(v, split, concat, group, em)

    @staticmethod
    def backward(ctx, g):
        split, concat, group, em = ctx.args
        return _exchange(g, concat, split, group, em), None, None, None, None


def _quant_pair(v, split, concat, group, em):
    """v quantised to int8 per (expert, slot) row (scale max|row| / 127,
    floored at 1e-12 / 127, in v's dtype; round half to even, clip ±127),
    the values and scales exchanged, dequantised in f32, cast to v's
    dtype."""
    sc = torch.clamp(v.abs().amax(-1, keepdim=True), min=1e-12) / 127.0
    q = torch.clamp(torch.round(v / sc), -127, 127).to(torch.int8)
    q_r = _exchange(q, split, concat, group, em)
    sc_r = _exchange(sc, split, concat, group, em)
    return (q_r.float() * sc_r.float()).to(v.dtype)


class _QuantAllToAll(torch.autograd.Function):
    """int8-on-the-wire all_to_all (the reference's ``_qa2a``): the
    forward and the backward (the cotangent, split and concat swapped)
    each quantised, so both directions move ~2x (vs bf16) / ~4x (vs f32)
    fewer bytes."""

    @staticmethod
    def forward(ctx, v, split, concat, group, em):
        ctx.args = (split, concat, group, em)
        return _quant_pair(v, split, concat, group, em)

    @staticmethod
    def backward(ctx, g):
        split, concat, group, em = ctx.args
        return _quant_pair(g, concat, split, group, em), None, None, None, None


class _TokenSlice(torch.autograd.Function):
    """Rank i's token rows [i*per, (i+1)*per) of the group's replicated
    (n_p, D) tokens; the backward gathers every rank's slice cotangent into
    the full cotangent of the tokens."""

    @staticmethod
    def forward(ctx, xf, i, per, group):
        ctx.group = group
        return xf[i * per:(i + 1) * per].clone()

    @staticmethod
    def backward(ctx, g):
        return tp.all_gather(g, ctx.group), None, None, None


class _GatherTokens(torch.autograd.Function):
    """The ranks' (per, D) outputs gathered into the (n_p, D) tokens, the
    same on every rank; every rank's loss is the same replicated loss, so
    the backward keeps the rank's own slice of the cotangent, unsummed."""

    @staticmethod
    def forward(ctx, y_s, i, group):
        ctx.i, ctx.per = i, y_s.shape[0]
        return tp.all_gather(y_s, group)

    @staticmethod
    def backward(ctx, g):
        return g[ctx.i * ctx.per:(ctx.i + 1) * ctx.per], None, None


class _PMean(torch.autograd.Function):
    """``lax.pmean`` over the group of a value computed from each rank's
    slice; the backward gives each slice 1/em of the replicated cotangent."""

    @staticmethod
    def forward(ctx, a, group, em):
        ctx.em = em
        return tp.all_reduce(a, group) / em

    @staticmethod
    def backward(ctx, g):
        return g / ctx.em, None, None


def _local_experts(w, e: int, em: int, i: int):
    """The rank's E/em experts of an expert leaf held whole (E leading) or
    already as its ``local_shard`` (E/em leading)."""
    el = e // em
    if w.shape[0] == e:
        return w[i * el:(i + 1) * el]
    if w.shape[0] == el:
        return w
    raise ValueError(f"moe_sharded: an expert leaf leads with {w.shape[0]}, "
                     f"neither E = {e} (whole) nor E / model = {el} (this "
                     "rank's shard)")


def moe_sharded(cfg, p, x):
    """Expert-parallel MoE over the context mesh's ``model`` axis (module
    doc); ``moe_dense`` with no mesh, no ``model`` axis, or E not divisible
    by its size.  ``x`` (B/data, T, D) is this rank's data shard, the same
    on every rank of its ``model`` group; the router is whole or cut over
    ``data``, the expert leaves whole or this rank's ``local_shard``
    (``EXPERT_RULES`` or ``DEFAULT_RULES``).
    Returns (y (B/data, T, D), aux): y the same on every rank of the group,
    aux the mean over ``model`` of each token slice's router losses.  With
    whole expert leaves, their gradient holds this rank's experts' rows
    (zeros elsewhere)."""
    mesh = shlib._CTX["mesh"]
    sizes = shlib.mesh_sizes(mesh) if mesh is not None else {}
    em = sizes.get("model")
    if em is None or cfg.num_experts % em != 0:
        return moe_dense(cfg, p, x)
    group = mesh.get_group("model")
    i = mesh.get_local_rank("model")
    e = cfg.num_experts
    b_loc, t, d = x.shape
    n = b_loc * t
    pad = (-n) % em
    xf = x.reshape(n, d)
    if pad:
        xf = F.pad(xf, (0, 0, 0, pad))
    per = xf.shape[0] // em
    xs = _TokenSlice.apply(xf, i, per, group)                  # (per, D)

    router, *w = _whole_d(p, d)
    gates, eids, aux = _route(cfg, tp.copy_to_model(router), xs)
    if pad:  # zero the gates of padded tokens
        tok_id = i * per + torch.arange(per, device=x.device)
        gates = torch.where((tok_id < n)[:, None], gates,
                            torch.zeros_like(gates))
    cap = _capacity(cfg, per)
    buf, meta = _pack_local(cfg, xs, gates, eids, cap)          # (E*C, D)
    buf = buf.reshape(e, cap, d)
    a2a = (_QuantAllToAll if cfg.moe_dispatch_dtype == "int8"
           else _AllToAll).apply
    recv = a2a(buf, 0, 1, group, em)                           # (E_loc, em*C, D)
    w = [_local_experts(leaf, e, em, i) for leaf in w]
    y_loc = _expert_ffn(*w, recv, x.dtype)
    back = a2a(y_loc, 1, 0, group, em)                          # (E, C, D)
    y_s = _unpack_local(cfg, back.reshape(e * cap, d), meta, per, d)
    y_full = _GatherTokens.apply(y_s, i, group)                 # (n_p, D)
    y = y_full[:n].reshape(b_loc, t, d)
    aux = {k: _PMean.apply(v, group, em) for k, v in aux.items()}
    return y, aux


def moe_forward(cfg, p, x):
    if cfg.moe_impl == "dense":
        return moe_dense(cfg, p, x)
    return moe_sharded(cfg, p, x)
