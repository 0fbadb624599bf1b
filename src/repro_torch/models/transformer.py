"""Model assembly: init, train forward, prefill and decode for all families.

Port of ``repro.models.transformer``.  Layers are organised in BlockGroups
(``configs/base.py``).  The parameter and cache trees are the JAX
package's: a group with ``scan=True`` and more than one layer holds its
params and caches stacked on a leading ``layers`` axis, and a Python loop
over that axis takes the place of ``lax.scan``; a group with ``scan=False``
and more than one layer holds them as ``{"unstacked": [layer, ...]}`` (its
caches as a list).  Per layer, pre-norm residual:

    x += mixer(norm1(x));  [x += xattn(normx(x))];  x += ffn(norm2(x))

The mixer is GQA attention (``attn``), local-window attention (``lattn``),
MLA (``mla``), Mamba-2 SSD (``ssd``) or RG-LRU (``rglru``); the FFN an MLP,
a MoE (plus a shared MLP) or none.  Whisper (family ``encdec``) runs a
non-causal encoder over stub frame embeddings first and gives every
decoder layer a cross-attention reading the encoder output; its K/V are
cached at prefill (``xk``/``xv``) and never recomputed in decode.

Training (``forward_train``) runs under torch autograd through the
query-chunked attention and the chunked cross-entropy; with ``cfg.remat``
each layer of a stacked group (and of the encoder) is recomputed in the
backward (``torch.utils.checkpoint``), as ``jax.checkpoint`` does in the
JAX package's scan body.  MoE layers add their load-balance and router
z-losses to the total.

A local-window layer's prefill cache holds position p at slot
p % window, the slot decode writes it to, so decoding straight after a
prefill of any length matches a longer prefill; the JAX package keeps the
last ``window`` positions at slots 0..window-1 instead, which agrees only
when the window divides the prompt length (ROADMAP Queue 3 item 19).

Under a mesh (``distributed.sharding.use_mesh``) each rank takes its data
shard of the batch and its block of every leaf (``train.steps.
init_params_sharded``): the attention and MLP split over ``model`` as
``attention`` and ``mlp`` say, the vocabulary too (``_embed``: a masked
lookup of the rank's rows, summed over ``model``, exact since one term is
non-zero; ``_logits``: the rank's (B, V / model) block in f32, gathered;
``forward_train``: the cross-entropy over vocab shards).  Norms stay
whole.  Every mixer splits: GQA, local windows, MLA and the enc-dec
cross-attention by heads (``attention``), SSD by heads (``ssm``), RG-LRU
by channels (``rglru``); where ``model`` does not divide a mixer's heads
or channels, that mixer runs whole on every rank (the rules' fallback).
"""
from __future__ import annotations

import functools

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from .._device import resolve_device
from ..configs.base import BlockGroup
from ..distributed import tensor_parallel as tp
from . import attention as attn
from . import moe as moe_mod
from . import rglru as rglru_mod
from . import ssm as ssm_mod
from .common import (Leaf, apply_norm, cross_entropy_chunked, make_norm,
                     materialize, tree_map)
from .mlp import init_mlp, mlp_forward


def _dtype(name: str) -> torch.dtype:
    return {"float32": torch.float32, "bfloat16": torch.bfloat16,
            "float16": torch.float16}[name]


def _stacked(g) -> bool:
    return g.scan and g.count > 1


def _unstacked(g) -> bool:
    return not g.scan and g.count > 1


def _encoder_group(cfg) -> BlockGroup:
    return BlockGroup("attn", "mlp", cfg.encoder_layers, True)


def _unstack(tree, count: int) -> list:
    """The ``count`` per-layer trees of a stacked tree, by one ``unbind`` a
    leaf: its backward stacks the layers' gradients once, where indexing
    layer by layer would add a full stacked-size gradient per layer."""
    parts = tree_map(lambda a: a.unbind(0), tree)
    return [tree_map(lambda u, i=i: u[i], parts) for i in range(count)]


def _stack(trees: list):
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def _layer_spec(cfg, mixer: str, ffn: str, cross: bool) -> dict:
    layer = {"norm1": make_norm(cfg, cfg.d_model)}
    if mixer in ("attn", "lattn"):
        layer["attn"] = attn.init_gqa(cfg)
    elif mixer == "mla":
        layer["attn"] = attn.init_mla(cfg)
    elif mixer == "ssd":
        layer["ssd"] = ssm_mod.init_ssd(cfg)
    elif mixer == "rglru":
        layer["rglru"] = rglru_mod.init_rglru(cfg)
    else:
        raise ValueError(mixer)
    if cross:
        layer["normx"] = make_norm(cfg, cfg.d_model)
        layer["xattn"] = attn.init_cross(cfg)
    if ffn != "none":
        layer["norm2"] = make_norm(cfg, cfg.d_model)
    if ffn == "mlp":
        layer["mlp"] = init_mlp(cfg)
    elif ffn == "moe":
        layer["moe"] = moe_mod.init_moe(cfg)
        if cfg.num_shared_experts:
            layer["shared_mlp"] = init_mlp(
                cfg, d_ff=cfg.num_shared_experts * cfg.moe_d_ff)
    return layer


def _group_spec(cfg, g, cross: bool):
    layer = _layer_spec(cfg, g.mixer, g.ffn, cross)
    if _stacked(g):
        return tree_map(lambda leaf, n=g.count: leaf.stacked(n), layer)
    if _unstacked(g):
        return {"unstacked": [layer] * g.count}
    return layer


def param_spec(cfg) -> dict:
    """The parameter tree of ``cfg`` as :class:`~.common.Leaf` specs: the
    shapes and inits of ``repro.models.transformer.init_params``."""
    spec = {"embed": Leaf((cfg.vocab_size, cfg.d_model), std=0.02,
                          logical=("vocab", "embed"))}
    if not cfg.tie_embeddings:
        spec["lm_head"] = Leaf((cfg.d_model, cfg.vocab_size),
                               logical=("embed", "vocab"))
    spec["final_norm"] = make_norm(cfg, cfg.d_model)
    cross = cfg.family == "encdec"
    if cross:
        spec["encoder"] = {
            "layers": _group_spec(cfg, _encoder_group(cfg), cross=False),
            "final_norm": make_norm(cfg, cfg.d_model)}
    spec["groups"] = {f"g{gi}": _group_spec(cfg, g, cross)
                      for gi, g in enumerate(cfg.blocks)}
    return spec


def param_logical_axes(cfg) -> dict:
    """The logical-axes spec tree of ``cfg``'s params: the second value of
    ``repro.models.transformer.init_params``, leaf for leaf (an unstacked
    group's list included), for ``distributed.sharding``."""
    return tree_map(lambda leaf: leaf.logical, param_spec(cfg))


def init_params(cfg, generator: torch.Generator, device=None) -> dict:
    """Random params of ``cfg`` drawn from ``generator`` (on its device) and
    placed on ``device`` (None: the card) in ``cfg.param_dtype``.  The
    logical-axes spec tree, which the JAX package returns beside them, is
    ``param_logical_axes(cfg)``."""
    dev = resolve_device(device)
    return materialize(param_spec(cfg), generator, _dtype(cfg.param_dtype),
                       dev)


# ---------------------------------------------------------------------------
# forward (train / prefill)
# ---------------------------------------------------------------------------

def _ffn(cfg, ffn, p, x):
    """x += ffn(norm2(x)); returns (x, aux: the MoE losses, or {})."""
    aux = {}
    if ffn == "mlp":
        x = x + mlp_forward(cfg, p["mlp"], apply_norm(cfg, x, p["norm2"]))
    elif ffn == "moe":
        h2 = apply_norm(cfg, x, p["norm2"])
        y_moe, aux = moe_mod.moe_forward(cfg, p["moe"], h2)
        if cfg.num_shared_experts:
            y_moe = y_moe + mlp_forward(
                cfg, p["shared_mlp"], h2,
                d_ff=cfg.num_shared_experts * cfg.moe_d_ff)
        x = x + y_moe
    return x, aux


def _layer_fwd(cfg, mixer, ffn, cross, p, x, positions, enc_out,
               collect_cache: bool):
    """One layer: (x, its decode cache or None, its aux losses)."""
    h = apply_norm(cfg, x, p["norm1"])
    cache = None
    if mixer in ("attn", "lattn"):
        window = cfg.local_window if mixer == "lattn" else None
        y, kv = attn.gqa_forward(cfg, p["attn"], h, positions, causal=True,
                                 window=window, return_kv=True)
        if collect_cache:
            cache = _gqa_cache_from_seq(cfg, p["attn"], h, positions,
                                        window=window, kv=kv)
    elif mixer == "mla":
        y = attn.mla_forward(cfg, p["attn"], h, positions)
        if collect_cache:
            cache = _mla_cache_from_seq(cfg, p["attn"], h, positions)
    elif mixer == "ssd":
        y, st = ssm_mod.ssd_forward(cfg, p["ssd"], h)
        cache = st if collect_cache else None
    elif mixer == "rglru":
        y, st = rglru_mod.rglru_forward(cfg, p["rglru"], h)
        cache = st if collect_cache else None
    else:
        raise ValueError(mixer)
    x = x + y
    if cross:
        hx = apply_norm(cfg, x, p["normx"])
        kv = attn.encode_kv(cfg, p["xattn"], enc_out)
        x = x + attn.cross_forward(cfg, p["xattn"], hx, kv)
        if collect_cache:
            cache = {**cache, "xk": kv[0], "xv": kv[1]}
    x, aux = _ffn(cfg, ffn, p, x)
    return x, cache, aux


def _gqa_cache_from_seq(cfg, p, h, positions, window=None, kv=None):
    """A decode cache from a prefilled sequence: its K/V (``kv``, as the
    forward computed them, or projected from ``h`` again).  With a
    window, the last min(window, T) positions, position p at slot
    p % min(window, T): the JAX package's slots rolled by T % window
    (ROADMAP Queue 3 item 19)."""
    k, v = kv if kv is not None else (
        attn._heads(cfg, p, h, positions, "k"),
        attn._heads(cfg, p, h, positions, "v"))
    pos = positions.to(torch.int32)
    if window:
        t = h.shape[1]
        w = min(window, t)
        k, v, pos = (torch.roll(a[:, -w:], shifts=t % w, dims=1)
                     for a in (k, v, pos))
    return {"k": k, "v": v, "pos": pos}


def _mla_cache_from_seq(cfg, p, h, positions):
    c_kv, k_rope = attn.mla_latent(cfg, p, h, positions)
    return {"c_kv": c_kv, "k_rope": k_rope, "pos": positions.to(torch.int32)}


def _save_weight_products(ctx, op, *args, **kwargs):
    """Selective-checkpoint policy of ``remat_policy="dots"``: keep the
    outputs of the 2-D products (``x @ W`` reaches ``aten.mm``), recompute
    the rest -- ``dots_with_no_batch_dims_saveable``'s counterpart (the
    attention's batched products, ``aten.bmm``, are recomputed)."""
    if op == torch.ops.aten.mm.default:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _remat(cfg, fn):
    """``fn`` recomputed in the backward: the whole layer (``"full"``), or
    all but its weight products (``"dots"``)."""
    kw = {"use_reentrant": False, "preserve_rng_state": False}
    if cfg.remat_policy == "dots":
        kw["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, _save_weight_products)
    return lambda *args: checkpoint(fn, *args, **kw)


def _run_groups(cfg, params, x, positions, enc_out, collect_cache=False):
    """Run all block groups; returns (x, caches per group, aux sums).  The
    caches are None without ``collect_cache``.  With ``cfg.remat``, each
    layer of a stacked group is recomputed in the backward (no effect
    without a gradient)."""
    caches = {}
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    aux_tot = {"load_balance": zero, "router_z": zero}
    cross = cfg.family == "encdec"
    for gi, g in enumerate(cfg.blocks):
        p_g = params["groups"][f"g{gi}"]
        one = functools.partial(_layer_fwd, cfg, g.mixer, g.ffn, cross,
                                positions=positions, enc_out=enc_out,
                                collect_cache=collect_cache)
        if _stacked(g):
            if cfg.remat and torch.is_grad_enabled():
                one = _remat(cfg, one)
            layers = _unstack(p_g, g.count)
        else:
            layers = p_g["unstacked"] if _unstacked(g) else [p_g]
        layer_caches = []
        for p in layers:
            x, c, aux = one(p, x)
            layer_caches.append(c)
            aux_tot = {k: v + aux[k] if k in aux else v
                       for k, v in aux_tot.items()}
        if not collect_cache:
            caches[f"g{gi}"] = None
        elif _stacked(g):
            caches[f"g{gi}"] = _stack(layer_caches)
        else:
            caches[f"g{gi}"] = (layer_caches if _unstacked(g)
                                else layer_caches[0])
    return x, caches, aux_tot


def _embed(cfg, params, tokens):
    """Token embeddings (B, T, D) in the compute dtype.  With the vocab
    over ``model``, a rank looks up only its rows (zeros for the other
    tokens) and the ranks' rows are summed."""
    w = tp.gather_over_data(params["embed"], 1, cfg.d_model)
    cd = _dtype(cfg.compute_dtype)
    v_loc = w.shape[0]
    if v_loc == cfg.vocab_size:
        return w[tokens].to(cd)
    local = tokens - tp.model_index() * v_loc
    mine = (local >= 0) & (local < v_loc)
    x = w[torch.where(mine, local, 0)].to(cd)
    return tp.reduce_from_model(torch.where(mine[..., None], x, 0))


def _unembed_weight(cfg, params):
    """This rank's (D, V or V / model) unembedding, gathered over
    ``data``."""
    if cfg.tie_embeddings:
        return tp.gather_over_data(params["embed"], 1, cfg.d_model).T
    return tp.gather_over_data(params["lm_head"], 0, cfg.d_model)


def _logits(cfg, params, x_last):
    """f32 logits (B, V) of the last position's hidden state (B, 1, D);
    with the vocab over ``model``, the ranks' blocks gathered."""
    x = apply_norm(cfg, x_last, params["final_norm"])
    w = _unembed_weight(cfg, params)
    if w.shape[1] == cfg.vocab_size:
        return x[:, 0].float() @ w.float()
    local = tp.copy_to_model(x[:, 0].float()) @ w.float()
    return tp.gather_from_model(local, -1)


def _encoder_layer(cfg, p, x, pos):
    h = apply_norm(cfg, x, p["norm1"])
    x = x + attn.gqa_forward(cfg, p["attn"], h, pos, causal=False)
    return x + mlp_forward(cfg, p["mlp"], apply_norm(cfg, x, p["norm2"]))


def _encode(cfg, params, frames):
    """The non-causal encoder over frame embeddings (B,F,D) -> (B,F,D).
    With ``cfg.remat`` each layer is recomputed in the backward, as in the
    JAX package's encoder scan (which recomputes it whole whatever
    ``remat_policy``: the values are the same)."""
    x = frames.to(_dtype(cfg.compute_dtype))
    b, f, _ = x.shape
    pos = torch.arange(f, dtype=torch.int32, device=x.device).expand(b, f)
    enc = params["encoder"]
    g = _encoder_group(cfg)
    one = functools.partial(_encoder_layer, cfg, pos=pos)
    if cfg.remat and torch.is_grad_enabled():
        one = _remat(cfg, one)
    layers = _unstack(enc["layers"], g.count) if _stacked(g) \
        else [enc["layers"]]
    for p in layers:
        x = one(p, x)
    return apply_norm(cfg, x, enc["final_norm"])


def _positions(tokens):
    b, t = tokens.shape
    return torch.arange(t, dtype=torch.int32, device=tokens.device).expand(b, t)


def forward_train(cfg, params, batch):
    """batch: tokens (B,T), labels (B,T) [, frames (B,F,D) for enc-dec] ->
    (total, metrics), both f32 and differentiable in ``params``.  Labels < 0
    are masked.  The metrics are ``loss`` and the MoE layers' summed
    ``load_balance`` and ``router_z`` (0 without MoE); the total adds
    0.01 load_balance + 1e-4 router_z to the loss for a MoE config.  Trains
    through the query-chunked attention: the flash kernel has no backward,
    so ``cfg.use_flash`` raises."""
    if cfg.use_flash:
        raise NotImplementedError(
            "forward_train with use_flash=True: the flash kernel has no "
            "backward (nor has the JAX package's); train with "
            "use_flash=False, the query-chunked attention")
    tokens = batch["tokens"]
    enc_out = (_encode(cfg, params, batch["frames"])
               if cfg.family == "encdec" else None)
    x = _embed(cfg, params, tokens)
    x, _, aux = _run_groups(cfg, params, x, _positions(tokens), enc_out)
    x = apply_norm(cfg, x, params["final_norm"])
    w = _unembed_weight(cfg, params)
    if w.shape[1] != cfg.vocab_size:
        x = tp.copy_to_model(x)
    loss = cross_entropy_chunked(x, w, batch["labels"],
                                 vocab_size=cfg.vocab_size)
    total = loss
    if cfg.num_experts:
        total = total + 0.01 * aux["load_balance"] + 1e-4 * aux["router_z"]
    return total, {"loss": loss, **aux}


def forward_prefill(cfg, params, batch):
    """Prefill: full-sequence pass that returns (last-token logits, caches)."""
    tokens = batch["tokens"]
    enc_out = (_encode(cfg, params, batch["frames"])
               if cfg.family == "encdec" else None)
    x = _embed(cfg, params, tokens)
    x, caches, _ = _run_groups(cfg, params, x, _positions(tokens), enc_out,
                               collect_cache=True)
    return _logits(cfg, params, x[:, -1:, :]), caches


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------

def _layer_cache(cfg, mixer, batch, max_len, dtype, device) -> dict:
    if mixer in ("attn", "lattn"):
        c = attn.init_gqa_cache(cfg, batch, max_len, dtype, device)
    elif mixer == "mla":
        c = attn.init_mla_cache(cfg, batch, max_len, dtype, device)
    elif mixer == "ssd":
        c = ssm_mod.init_ssd_cache(cfg, batch, dtype, device)
    elif mixer == "rglru":
        c = rglru_mod.init_rglru_cache(cfg, batch, dtype, device)
    else:
        raise ValueError(mixer)
    if cfg.family == "encdec":
        shape = (batch, cfg.num_frames, attn.head_layout(cfg).kv,
                 attn.head_dim(cfg))
        c["xk"] = torch.zeros(shape, dtype=dtype, device=device)
        c["xv"] = torch.zeros(shape, dtype=dtype, device=device)
    return c


def init_decode_cache(cfg, batch: int, max_len: int, device=None):
    """Empty decode caches (pos -1, zero states) with room for ``max_len``
    positions (a window layer: min(window, max_len)), in the layout
    ``forward_prefill`` returns (under a mesh: ``batch`` this rank's data
    shard, the attention leaves its kv heads), on ``device`` (None: the
    card)."""
    dev = resolve_device(device)
    cd = _dtype(cfg.compute_dtype)
    caches = {}
    for gi, g in enumerate(cfg.blocks):
        layers = [_layer_cache(cfg, g.mixer, batch, max_len, cd, dev)
                  for _ in range(g.count)]
        if _stacked(g):
            caches[f"g{gi}"] = _stack(layers)
        else:
            caches[f"g{gi}"] = layers if _unstacked(g) else layers[0]
    return caches


# The cache leaves of each mixer that hold one slot a position; every other
# leaf (SSD and RG-LRU states, cross K/V) has no sequence axis.
_SEQ_LEAVES = {"attn": ("k", "v", "pos"), "lattn": ("k", "v", "pos"),
               "mla": ("c_kv", "k_rope", "pos")}


def grow_decode_cache(cfg, caches, max_len: int):
    """``forward_prefill``'s caches of T positions copied into empty caches
    with room for ``max_len``: each attention leaf into the first T slots of
    its sequence axis, every other leaf whole.  A window cache of a prompt
    of T >= window positions already holds its window, position p at slot
    p % window, and is copied whole.  Decoding straight into the prefill's
    caches would overwrite token T-1 (ROADMAP Queue 3 item 5)."""
    first = caches["g0"]
    first = first[0] if isinstance(first, list) else first
    stacked0 = _stacked(cfg.blocks[0])
    leaf = next(iter(first.values()))
    empty = init_decode_cache(cfg, leaf.shape[1 if stacked0 else 0], max_len,
                              device=leaf.device)

    for gi, g in enumerate(cfg.blocks):
        ax = 2 if _stacked(g) else 1
        seq = _SEQ_LEAVES.get(g.mixer, ())

        def grow(old, new):
            for name, a in old.items():
                if name in seq:
                    new[name][(slice(None),) * ax
                              + (slice(0, a.shape[ax]),)] = a
                else:
                    new[name] = a
            return new
        old, new = caches[f"g{gi}"], empty[f"g{gi}"]
        empty[f"g{gi}"] = ([grow(o, n) for o, n in zip(old, new)]
                           if _unstacked(g) else grow(old, new))
    return empty


def _layer_decode(cfg, mixer, ffn, cross, p, x_t, cache, pos):
    h = apply_norm(cfg, x_t, p["norm1"])
    if cross:   # cross K/V were cached at prefill, never recomputed
        xkv = (cache["xk"], cache["xv"])
        cache = {k: v for k, v in cache.items() if k not in ("xk", "xv")}
    if mixer in ("attn", "lattn"):
        y, cache = attn.gqa_decode(cfg, p["attn"], h, cache, pos)
    elif mixer == "mla":
        y, cache = attn.mla_decode(cfg, p["attn"], h, cache, pos)
    elif mixer == "ssd":
        y, cache = ssm_mod.ssd_decode(cfg, p["ssd"], h, cache)
    elif mixer == "rglru":
        y, cache = rglru_mod.rglru_decode(cfg, p["rglru"], h, cache)
    else:
        raise ValueError(mixer)
    x_t = x_t + y
    if cross:
        hx = apply_norm(cfg, x_t, p["normx"])
        x_t = x_t + attn.cross_forward(cfg, p["xattn"], hx, xkv)
        cache = {**cache, "xk": xkv[0], "xv": xkv[1]}
    x_t, _ = _ffn(cfg, ffn, p, x_t)
    return x_t, cache


def decode_step(cfg, params, caches, tokens_t, pos):
    """One decode step: tokens_t (B,1), pos (B,) -> (logits (B,V), caches).
    The caches passed in are left as they were."""
    x = _embed(cfg, params, tokens_t)
    cross = cfg.family == "encdec"
    new_caches = {}
    for gi, g in enumerate(cfg.blocks):
        p_g = params["groups"][f"g{gi}"]
        c_g = caches[f"g{gi}"]
        if _stacked(g):
            pairs = zip(_unstack(p_g, g.count), _unstack(c_g, g.count))
        elif _unstacked(g):
            pairs = zip(p_g["unstacked"], c_g)
        else:
            pairs = [(p_g, c_g)]
        outs = []
        for p, c in pairs:
            x, c = _layer_decode(cfg, g.mixer, g.ffn, cross, p, x, c, pos)
            outs.append(c)
        if _stacked(g):
            new_caches[f"g{gi}"] = _stack(outs)
        else:
            new_caches[f"g{gi}"] = outs if _unstacked(g) else outs[0]
    return _logits(cfg, params, x), new_caches
