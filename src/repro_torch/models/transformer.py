"""Model assembly: init, train forward, prefill and decode of dense GQA
transformers.

Port of ``repro.models.transformer`` for groups of ``attn`` mixers with
``mlp`` FFNs (the dense configs).  The parameter and cache trees are the
JAX package's: a group with ``scan=True`` and more than one layer holds its
params and caches stacked on a leading ``layers`` axis, and a Python loop
over that axis takes the place of ``lax.scan``.  Per layer, pre-norm
residual:

    x += attn(norm1(x));  x += mlp(norm2(x))

Training (``forward_train``) runs under torch autograd through the
query-chunked attention and the chunked cross-entropy; with ``cfg.remat``
each layer of a stacked group is recomputed in the backward
(``torch.utils.checkpoint``), as ``jax.checkpoint`` does in the JAX
package's scan body.  Not ported yet (ROADMAP Queue 1 item 12): the other
mixers (``mla``, ``ssd``, ``rglru``, ``lattn``), MoE FFNs, enc-dec,
unstacked groups and sharding.  Each raises ``NotImplementedError``.
"""
from __future__ import annotations

import functools

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from .._device import resolve_device
from . import attention as attn
from .common import (Leaf, apply_norm, cross_entropy_chunked, make_norm,
                     materialize, tree_map)
from .mlp import init_mlp, mlp_forward


def _dtype(name: str) -> torch.dtype:
    return {"float32": torch.float32, "bfloat16": torch.bfloat16,
            "float16": torch.float16}[name]


def _check_ported(cfg):
    if cfg.family == "encdec":
        raise attn._not_ported("the enc-dec family")
    for g in cfg.blocks:
        if g.mixer != "attn" or g.ffn != "mlp":
            raise attn._not_ported(f"a {g.mixer}/{g.ffn} block")
        if g.count > 1 and not g.scan:
            raise attn._not_ported("an unstacked block group")


def _stacked(g) -> bool:
    return g.scan and g.count > 1


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

def param_spec(cfg) -> dict:
    """The parameter tree of ``cfg`` as :class:`~.common.Leaf` specs: the
    shapes and inits of ``repro.models.transformer.init_params``."""
    _check_ported(cfg)
    spec = {"embed": Leaf((cfg.vocab_size, cfg.d_model), std=0.02)}
    if not cfg.tie_embeddings:
        spec["lm_head"] = Leaf((cfg.d_model, cfg.vocab_size))
    spec["final_norm"] = make_norm(cfg, cfg.d_model)
    layer = {"norm1": make_norm(cfg, cfg.d_model), "attn": attn.init_gqa(cfg),
             "norm2": make_norm(cfg, cfg.d_model), "mlp": init_mlp(cfg)}
    spec["groups"] = {
        f"g{gi}": (tree_map(lambda leaf, n=g.count: leaf.stacked(n), layer)
                   if _stacked(g) else layer)
        for gi, g in enumerate(cfg.blocks)}
    return spec


def init_params(cfg, generator: torch.Generator, device=None) -> dict:
    """Random params of ``cfg`` drawn from ``generator`` (on its device) and
    placed on ``device`` (None: the card) in ``cfg.param_dtype``.  Unlike
    the JAX package, no logical-axis spec tree comes back."""
    dev = resolve_device(device)
    return materialize(param_spec(cfg), generator, _dtype(cfg.param_dtype),
                       dev)


# ---------------------------------------------------------------------------
# forward (train / prefill)
# ---------------------------------------------------------------------------

def _layer_fwd(cfg, p, x, positions, collect_cache: bool):
    h = apply_norm(cfg, x, p["norm1"])
    y = attn.gqa_forward(cfg, p["attn"], h, positions, causal=True)
    cache = (_gqa_cache_from_seq(cfg, p["attn"], h, positions)
             if collect_cache else None)
    x = x + y
    h2 = apply_norm(cfg, x, p["norm2"])
    return x + mlp_forward(cfg, p["mlp"], h2), cache


def _gqa_cache_from_seq(cfg, p, h, positions):
    """Build a decode cache from a prefilled sequence (train-path K/V)."""
    return {"k": attn._heads(cfg, p, h, positions, "k"),
            "v": attn._heads(cfg, p, h, positions, "v"),
            "pos": positions.to(torch.int32)}


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


def _run_groups(cfg, params, x, positions, collect_cache: bool = False):
    """Run all block groups; returns (x, caches per group), the caches
    None without ``collect_cache``.  With ``cfg.remat``, each layer of a
    stacked group is recomputed in the backward (no effect without a
    gradient)."""
    caches = {}
    for gi, g in enumerate(cfg.blocks):
        p_g = params["groups"][f"g{gi}"]
        one = functools.partial(_layer_fwd, cfg, positions=positions,
                                collect_cache=collect_cache)
        if not _stacked(g):
            x, caches[f"g{gi}"] = one(p_g, x)
            continue
        if cfg.remat and torch.is_grad_enabled():
            one = _remat(cfg, one)
        layer_caches = []
        for p in _unstack(p_g, g.count):
            x, c = one(p, x)
            layer_caches.append(c)
        caches[f"g{gi}"] = _stack(layer_caches) if collect_cache else None
    return x, caches


def _embed(cfg, params, tokens):
    return params["embed"][tokens].to(_dtype(cfg.compute_dtype))


def _unembed_weight(cfg, params):
    if cfg.tie_embeddings:
        return params["embed"].T
    return params["lm_head"]


def _logits(cfg, params, x_last):
    """f32 logits (B, V) of the last position's hidden state (B, 1, D)."""
    x = apply_norm(cfg, x_last, params["final_norm"])
    return x[:, 0].float() @ _unembed_weight(cfg, params).float()


def forward_train(cfg, params, batch):
    """batch: tokens (B,T), labels (B,T) -> (loss, metrics), both f32 and
    differentiable in ``params``.  Labels < 0 are masked.  The metrics are
    the JAX package's for a dense config: ``loss``, and ``load_balance``
    and ``router_z`` at 0.  Trains through the query-chunked attention:
    the flash kernel has no backward, so ``cfg.use_flash`` raises."""
    _check_ported(cfg)
    if cfg.use_flash:
        raise NotImplementedError(
            "forward_train with use_flash=True: the flash kernel has no "
            "backward (nor has the JAX package's); train with "
            "use_flash=False, the query-chunked attention")
    tokens = batch["tokens"]
    b, t = tokens.shape
    positions = torch.arange(t, dtype=torch.int32,
                             device=tokens.device).expand(b, t)
    x = _embed(cfg, params, tokens)
    x, _ = _run_groups(cfg, params, x, positions)
    x = apply_norm(cfg, x, params["final_norm"])
    loss = cross_entropy_chunked(x, _unembed_weight(cfg, params),
                                 batch["labels"])
    zero = torch.zeros((), device=loss.device)
    return loss, {"loss": loss, "load_balance": zero, "router_z": zero}


def forward_prefill(cfg, params, batch):
    """Prefill: full-sequence pass that returns (last-token logits, caches)."""
    _check_ported(cfg)
    tokens = batch["tokens"]
    b, t = tokens.shape
    positions = torch.arange(t, dtype=torch.int32,
                             device=tokens.device).expand(b, t)
    x = _embed(cfg, params, tokens)
    x, caches = _run_groups(cfg, params, x, positions, collect_cache=True)
    return _logits(cfg, params, x[:, -1:, :]), caches


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------

def init_decode_cache(cfg, batch: int, max_len: int, device=None):
    """Empty decode caches (pos -1) with room for ``max_len`` positions, in
    the layout ``forward_prefill`` returns, on ``device`` (None: the
    card)."""
    _check_ported(cfg)
    dev = resolve_device(device)
    cd = _dtype(cfg.compute_dtype)
    caches = {}
    for gi, g in enumerate(cfg.blocks):
        c = attn.init_gqa_cache(cfg, batch, max_len, cd, dev)
        caches[f"g{gi}"] = _stack([c] * g.count) if _stacked(g) else c
    return caches


def _layer_decode(cfg, p, x_t, cache, pos):
    h = apply_norm(cfg, x_t, p["norm1"])
    y, cache = attn.gqa_decode(cfg, p["attn"], h, cache, pos)
    x_t = x_t + y
    h2 = apply_norm(cfg, x_t, p["norm2"])
    return x_t + mlp_forward(cfg, p["mlp"], h2), cache


def decode_step(cfg, params, caches, tokens_t, pos):
    """One decode step: tokens_t (B,1), pos (B,) -> (logits (B,V), caches).
    The caches passed in are left as they were."""
    _check_ported(cfg)
    x = _embed(cfg, params, tokens_t)
    new_caches = {}
    for gi, g in enumerate(cfg.blocks):
        p_g = params["groups"][f"g{gi}"]
        c_g = caches[f"g{gi}"]
        if not _stacked(g):
            x, new_caches[f"g{gi}"] = _layer_decode(cfg, p_g, x, c_g, pos)
            continue
        outs = []
        for p, c in zip(_unstack(p_g, g.count), _unstack(c_g, g.count)):
            x, c = _layer_decode(cfg, p, x, c, pos)
            outs.append(c)
        new_caches[f"g{gi}"] = _stack(outs)
    return _logits(cfg, params, x), new_caches
