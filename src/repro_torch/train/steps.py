"""Step builders (port of ``repro.train.steps``): the distributed GP train,
barrier-free async and online-update steps, the train, prefill and serve
steps of the LM substrate, and the abstract inputs and logical-axes trees
the sharding rules read.

The LM ``make_*_step`` functions return plain functions over the
caller's tensors.  The train state is the JAX package's tree,
``{"params", "opt": {"m", "v", "step"}}``, so ``checkpoint`` reads and
writes either package's files; the train step updates it in place
(``optim.adam``).  Prefill and serve run under ``torch.no_grad()``:
serving takes no gradient, and the flash kernel has no backward.  Run
under ``distributed.sharding.use_mesh(mesh)``, the steps take the MoE
layers through the expert-parallel schedule over the mesh's ``model``
axis (``models.moe.moe_sharded``); the mean of the gradients over the
``data`` axis stays the caller's, as with ``launch.make_data_group``.
"""
from __future__ import annotations

from typing import Any

import torch

from .._device import resolve_device
from ..configs.base import ModelConfig, ShapeSpec
from ..core.flat import tree_items, tree_unflatten
from ..distributed import sharding as shlib
from ..models import moe as moe_mod
from ..models import transformer as tf
from ..models.common import materialize, tree_map
from ..optim import adam as adam_mod


def init_train_state(cfg: ModelConfig, generator: torch.Generator,
                     device=None) -> dict:
    """Random params drawn from ``generator`` and zero Adam moments on
    ``device`` (None: the card).  The spec tree, which the JAX package
    returns beside the state, is ``abstract_state(cfg)[1]``."""
    params = tf.init_params(cfg, generator, device=device)
    return {"params": params, "opt": adam_mod.init_opt_state(params)}


def init_params_sharded(cfg: ModelConfig, generator: torch.Generator, mesh,
                        device=None) -> dict:
    """``tf.init_params``'s params (the same draws), each expert leaf cut
    to this rank's block over ``mesh``'s ``model`` axis
    (``moe.EXPERT_RULES``) as soon as it is drawn, so no rank holds every
    expert at once; every other leaf whole."""
    def keep(leaf, t):
        if "experts" not in leaf.logical:
            return t
        return shlib.local_shard(t, leaf.logical, mesh, moe_mod.EXPERT_RULES)
    return materialize(tf.param_spec(cfg), generator,
                       tf._dtype(cfg.param_dtype), resolve_device(device),
                       keep=keep)


def make_train_step(cfg: ModelConfig,
                    adam_cfg: adam_mod.AdamConfig | None = None,
                    compression=None):
    """``train_step(state, batch) -> (state, metrics)``: the loss's
    gradient in every param (autograd through ``forward_train``), passed
    through ``compression`` (grads -> grads) when given, then one AdamW
    update, in place.  Metrics: ``loss``, ``load_balance``, ``router_z``,
    ``grad_norm``, ``lr``, as 0-d tensors on the params' device."""
    adam_cfg = adam_cfg or adam_mod.AdamConfig()

    def train_step(state, batch):
        paths, leaves = zip(*tree_items(state["params"]))
        for p in leaves:
            p.requires_grad_(True)
        loss, metrics = tf.forward_train(cfg, state["params"], batch)
        grads = tree_unflatten(paths, torch.autograd.grad(loss, leaves))
        if compression is not None:
            grads = compression(grads)
        params, opt, opt_metrics = adam_mod.adam_update(
            adam_cfg, state["params"], grads, state["opt"])
        metrics = {k: v.detach() for k, v in {**metrics, **opt_metrics}.items()}
        return {"params": params, "opt": opt}, metrics

    return train_step


def make_gp_train_step(group, d: int, *, latent: bool = False,
                       failure_mode: str = "drop",
                       chunk_size: int | None = None, argnums=(0, 1),
                       kernel=None, device=None, batch_blocks=None,
                       reduce_mode: str = "serial", psi2_fn=None,
                       reg_stats_fn=None):
    """Distributed GP map-reduce step: ``(engine, step)``, ``step`` the
    (value, grad) of the negative collapsed bound,
    ``step(hyp, z, mu, s, y, w, fmask, n_full)`` with ``mu``, ``s``, ``y``,
    ``w`` this rank's rows from ``engine.put_data``, ``fmask`` (n_shards,)
    the same on every rank and ``n_full`` the unpadded n.

    ``group`` is the process group of the data shards
    (``launch.make_data_group``; None: the default group, or a world of
    one).  ``batch_blocks`` (with ``chunk_size``) makes it the SVI step,
    which takes a trailing per-step ``draw`` (a ``torch.Generator``, or
    this rank's block indices).  ``psi2_fn`` replaces the kernel's psi2 in
    the latent map, ``reg_stats_fn`` the regression map (default: the
    shims of the engine's ``kernel``).  ``reduce_mode`` ``"overlap"`` /
    ``"overlap_eager"`` (with ``chunk_size``) reduces each block's Stats
    as it is mapped, the collective riding behind the next block's map
    (``core.distributed.DistributedGP``).
    """
    from ..core.distributed import DistributedGP

    eng = DistributedGP(group, latent=latent, failure_mode=failure_mode,
                        chunk_size=chunk_size, kernel=kernel, device=device,
                        batch_blocks=batch_blocks, reduce_mode=reduce_mode,
                        psi2_fn=psi2_fn, reg_stats_fn=reg_stats_fn)
    return eng, eng.make_value_and_grad(d, argnums=argnums)


def make_gp_async_step(shards, d: int, *, staleness: int = 2,
                       reweight: str = "drop", refresh: int = 1,
                       failure=None, timer=None,
                       chunk_size: int | None = None,
                       batch_blocks: int | None = None,
                       latent: bool = False, kernel=None,
                       clip: float | None = None, device=None):
    """Barrier-free async analogue of :func:`make_gp_train_step`:
    ``(engine, step)``, ``engine`` a ``distributed.AsyncEngine`` over
    ``shards`` (a list of ``{"y", "mu", optional "s"/"w"}`` dicts, ragged
    row counts allowed, moved to ``device``) and ``step(hyp, z, draw=None)
    -> (neg_bound, (g_hyp, g_z))``.  Each step refreshes only ``refresh``
    alive shards (round-robin; ``failure``, a ``FailureSimulator``, vetoes
    dead ones) and folds the others' stale contributions, at most
    ``staleness`` steps old, reweighted by ``reweight`` ("drop",
    "rescale" or "probs"; ``distributed.async_stats``): the map costs
    O(refresh · n_k m²) a step instead of O(K · n_k m²).  ``clip`` bounds
    the returned gradient's global norm (recommended for plain SGD on
    stale folds); ``None`` returns it raw."""
    from ..distributed.async_stats import AsyncEngine

    eng = AsyncEngine(shards, d, staleness=staleness, reweight=reweight,
                      refresh=refresh, failure=failure, timer=timer,
                      chunk_size=chunk_size, batch_blocks=batch_blocks,
                      latent=latent, kernel=kernel, clip=clip, device=device)
    return eng, eng.step


def make_gp_update_step(group, d: int, *, latent: bool = False,
                        psi2_fn=None, reg_stats_fn=None,
                        chunk_size: int | None = None, kernel=None,
                        device=None):
    """Distributed online-update step: ``(engine, fold_step)``,
    ``fold_step(base_stats, hyp, z, y_new, mu_new, s_new, w_new, fmask) ->
    Stats`` absorbing a new sharded block (this rank's slice from
    ``engine.put_data``) into reduced Stats: each rank maps its slice with
    the exact fold, one all_reduce, the base added
    (``DistributedGP.update_stats_fn``).  Pair it with
    ``engine.update_predictive_state`` for the serving factors and with
    ``core.stats.downdate_stats`` to forget.  No ``batch_blocks``: fold and
    downdate need the exact block statistics."""
    from ..core.distributed import DistributedGP

    eng = DistributedGP(group, latent=latent, chunk_size=chunk_size,
                        kernel=kernel, device=device, psi2_fn=psi2_fn,
                        reg_stats_fn=reg_stats_fn)
    return eng, eng.update_stats_fn(d)


def make_prefill_step(cfg: ModelConfig):
    def prefill_step(params, batch):
        with torch.no_grad():
            return tf.forward_prefill(cfg, params, batch)

    return prefill_step


def make_serve_step(cfg: ModelConfig):
    def serve_step(params, caches, tokens_t, pos):
        with torch.no_grad():
            return tf.decode_step(cfg, params, caches, tokens_t, pos)

    return serve_step


# ---------------------------------------------------------------------------
# abstract inputs and logical-axes trees (meta tensors, no allocation)
# ---------------------------------------------------------------------------

def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg: ModelConfig, shape: ShapeSpec) -> dict[str, Any]:
    """Abstract batch for (cfg, shape), as ``meta`` tensors (the
    reference's ``ShapeDtypeStruct``s).  Training/prefill: full sequences;
    decode: one new token + the KV/state cache at shape.seq_len."""
    b, t = shape.global_batch, shape.seq_len
    if shape.kind in ("train", "prefill"):
        batch = {"tokens": _meta((b, t), torch.int32),
                 "labels": _meta((b, t), torch.int32)}
        if cfg.family == "encdec":
            batch["frames"] = _meta((b, cfg.num_frames, cfg.d_model),
                                    torch.bfloat16)
        if shape.kind == "prefill":
            del batch["labels"]
        return batch
    return {"tokens_t": _meta((b, 1), torch.int32),
            "pos": _meta((b,), torch.int32),
            "caches": tf.init_decode_cache(cfg, b, t, device="meta")}


_CACHE_LOGICAL = {
    # decode-cache leaf name -> logical axes (rank-matched, padded with None)
    "k": ("batch", "seq_shard", "kv_heads", None),
    "v": ("batch", "seq_shard", "kv_heads", None),
    "pos": ("batch", None),
    "c_kv": ("batch", "seq_shard", None),
    "k_rope": ("batch", "seq_shard", None),
    "ssd": ("batch", "heads", None, None),
    "conv": ("batch", None, "inner"),
    "h": ("batch", "lru"),
    "xk": ("batch", None, "kv_heads", None),
    "xv": ("batch", None, "kv_heads", None),
}


def cache_specs(cfg: ModelConfig, caches) -> Any:
    """Logical-axes tree matching a (meta or real) decode-cache tree: each
    leaf by its name (the nearest dict key above it), with a leading
    ``layers`` axis where it is stacked."""

    def walk(node, name):
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v, name) for v in node]
        base = _CACHE_LOGICAL.get(name, ())
        if node.ndim == len(base):
            return tuple(base)
        if node.ndim == len(base) + 1:      # stacked over layers
            return ("layers",) + tuple(base)
        return (None,) * node.ndim
    return walk(caches, None)


def batch_specs(cfg: ModelConfig, batch) -> Any:
    """Logical axes for a train/prefill/decode input batch."""
    out = {}
    for k, v in batch.items():
        if k == "caches":
            out[k] = cache_specs(cfg, v)
        elif k == "frames":
            out[k] = ("batch", None, None)
        elif k == "pos":
            out[k] = ("batch",)
        else:  # tokens / labels / tokens_t
            out[k] = ("batch", None)[:v.ndim] + (None,) * max(v.ndim - 2, 0)
    return out


def abstract_state(cfg: ModelConfig) -> tuple[dict, dict]:
    """(the train state as ``meta`` tensors, its logical spec tree): the
    reference's ``ShapeDtypeStruct`` state and spec tree."""
    params = tree_map(lambda leaf: _meta(leaf.shape,
                                         tf._dtype(cfg.param_dtype)),
                      tf.param_spec(cfg))
    pspecs = tf.param_logical_axes(cfg)
    state = {"params": params, "opt": adam_mod.init_opt_state(params)}
    specs = {"params": pspecs, "opt": {"m": pspecs, "v": pspecs, "step": ()}}
    return state, specs
