"""Step builders (port of ``repro.train.steps``): the distributed GP train,
barrier-free async and online-update steps, the train, prefill and serve
steps of the LM substrate, and the abstract inputs and logical-axes trees
the sharding rules read.

The LM ``make_*_step`` functions return plain functions over the
caller's tensors.  The train state is the JAX package's tree,
``{"params", "opt": {"m", "v", "step"}}``, so ``checkpoint`` reads and
writes either package's files; the train step updates it in place
(``optim.adam``).  Prefill and serve run under ``torch.no_grad()``:
serving takes no gradient, and the flash kernel has no backward.

Under ``distributed.sharding.use_mesh(mesh)`` each rank passes its data
shard of the batch (``local_batch``) and its block of every leaf
(``init_params_sharded``): the attention, MLP and vocab split over the
mesh's ``model`` axis, weights cut over ``data`` (FSDP) gathered a layer
at a time, the MoE layers through the expert-parallel schedule
(``models.moe.moe_sharded``).  The loss is the mean over the global
batch on every rank, and ``loss_and_grads`` sums each leaf's gradient
over the batch axes the leaf is replicated on, so every rank holds the
whole gradient of its blocks; the train step clips by the norm of the
whole gradient.
"""
from __future__ import annotations

import contextlib
from typing import Any

import torch

from .._device import resolve_device
from ..configs.base import ModelConfig, ShapeSpec
from ..core.flat import tree_items, tree_unflatten
from ..distributed import sharding as shlib
from ..distributed import tensor_parallel as tp
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
    """``tf.init_params``'s params (the same draws), each leaf cut to this
    rank's block on ``mesh`` under ``sharding.DEFAULT_RULES`` as soon as it
    is drawn, so no rank holds a whole stacked leaf longer than its draw
    (``sharding.param_layout`` gives the blocks' shapes)."""
    def keep(leaf, t):
        return shlib.local_shard(t, leaf.logical, mesh, shlib.DEFAULT_RULES)
    return materialize(tf.param_spec(cfg), generator,
                       tf._dtype(cfg.param_dtype), resolve_device(device),
                       keep=keep)


def make_train_step(cfg: ModelConfig,
                    adam_cfg: adam_mod.AdamConfig | None = None,
                    compression=None):
    """``train_step(state, batch) -> (state, metrics)``: the loss's
    gradient in every param (``loss_and_grads``), passed through
    ``compression`` (grads -> grads) when given, then one AdamW update, in
    place (under a mesh, clipped by the whole gradient's norm).  Metrics:
    ``loss``, ``load_balance``, ``router_z``, ``grad_norm``, ``lr``, as 0-d
    tensors on the params' device."""
    adam_cfg = adam_cfg or adam_mod.AdamConfig()

    def train_step(state, batch):
        metrics, grads = loss_and_grads(cfg, state["params"], batch)
        if compression is not None:
            grads = compression(grads)
        norm = (None if shlib._CTX["mesh"] is None
                else grad_norm(cfg, grads))
        params, opt, opt_metrics = adam_mod.adam_update(
            adam_cfg, state["params"], grads, state["opt"], grad_norm=norm)
        metrics = {k: v.detach() for k, v in {**metrics, **opt_metrics}.items()}
        return {"params": params, "opt": opt}, metrics

    return train_step


def _leaf_axes(cfg) -> dict:
    """Path -> the mesh axes that the context mesh shards the leaf over."""
    mesh = shlib._CTX["mesh"]
    layout = tf.param_spec(cfg)
    return {path: shlib.block_axes(leaf.logical, leaf.shape, mesh)
            for path, leaf in tree_items(layout)}


def loss_and_grads(cfg: ModelConfig, params: dict, batch: dict):
    """(metrics, grads): ``forward_train``'s metrics (``loss`` the total)
    and its gradient in every leaf (autograd).  Under a mesh each leaf's
    gradient is then summed over the batch axes it is not sharded over
    (its blocks on the other data ranks hold the other shards' part)."""
    paths, leaves = zip(*tree_items(params))
    for p in leaves:
        p.requires_grad_(True)
    loss, metrics = tf.forward_train(cfg, params, batch)
    grads = torch.autograd.grad(loss, leaves)
    if shlib._CTX["mesh"] is not None:
        axes = _leaf_axes(cfg)
        grads = [_sum_over_batch(g, axes[path])
                 for path, g in zip(paths, grads)]
    return metrics, tree_unflatten(paths, grads)


def _sum_over_batch(g, sharded: set):
    for name in tp.BATCH_AXES:
        ax = tp.axis(name)
        if ax is not None and name not in sharded:
            g = tp.all_reduce(g, ax.group)
    return g


def grad_norm(cfg: ModelConfig, grads: dict) -> torch.Tensor:
    """The norm of the whole gradient from each rank's blocks (after
    ``loss_and_grads``): the squares of the leaves cut over the same axes
    summed, then over those axes, in f32."""
    axes = _leaf_axes(cfg)
    sums: dict = {}
    for path, g in tree_items(grads):
        key = tuple(sorted(axes[path]))
        sq = torch.sum(torch.square(g.float()))
        sums[key] = sq if key not in sums else sums[key] + sq
    total = 0.0
    for key, sq in sorted(sums.items()):
        for name in key:
            ax = tp.axis(name)
            if ax is not None:
                sq = tp.all_reduce(sq, ax.group)
        total = total + sq
    return torch.sqrt(total)


def local_batch(batch: dict, mesh=None) -> dict:
    """This rank's data shard of a global batch (tokens, labels, frames:
    the leading axis over the batch axes), on ``mesh`` (the context mesh
    if None)."""
    mesh = shlib._CTX["mesh"] if mesh is None else mesh
    coord = shlib.mesh_coordinate(mesh)
    return {k: v[shlib.shard_slices(("batch",) + (None,) * (v.ndim - 1),
                                    v.shape, mesh, coord)]
            for k, v in batch.items()}


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


def _on(mesh):
    """``use_mesh(mesh)`` keeping the context's rules, or nothing."""
    if mesh is None:
        return contextlib.nullcontext()
    return shlib.use_mesh(mesh, shlib._CTX["rules"])


def input_specs(cfg: ModelConfig, shape: ShapeSpec,
                mesh=None) -> dict[str, Any]:
    """Abstract batch for (cfg, shape), as ``meta`` tensors (the
    reference's ``ShapeDtypeStruct``s).  Training/prefill: full sequences;
    decode: one new token + the KV/state cache at shape.seq_len.  With a
    ``mesh``: one rank's local shapes (its data shard, its kv heads)."""
    b, t = shape.global_batch, shape.seq_len
    if mesh is not None:
        b = shlib.local_shape(("batch",), (b,), mesh)[0]
    if shape.kind in ("train", "prefill"):
        batch = {"tokens": _meta((b, t), torch.int32),
                 "labels": _meta((b, t), torch.int32)}
        if cfg.family == "encdec":
            batch["frames"] = _meta((b, cfg.num_frames, cfg.d_model),
                                    torch.bfloat16)
        if shape.kind == "prefill":
            del batch["labels"]
        return batch
    with _on(mesh):
        caches = tf.init_decode_cache(cfg, b, t, device="meta")
    return {"tokens_t": _meta((b, 1), torch.int32),
            "pos": _meta((b,), torch.int32), "caches": caches}


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


def abstract_state(cfg: ModelConfig, mesh=None) -> tuple[dict, dict]:
    """(the train state as ``meta`` tensors, its logical spec tree): the
    reference's ``ShapeDtypeStruct`` state and spec tree; with a ``mesh``,
    one rank's blocks."""
    def meta(leaf):
        shape = (leaf.shape if mesh is None else
                 shlib.local_shape(leaf.logical, leaf.shape, mesh))
        return _meta(shape, tf._dtype(cfg.param_dtype))
    params = tree_map(meta, tf.param_spec(cfg))
    pspecs = tf.param_logical_axes(cfg)
    state = {"params": params, "opt": adam_mod.init_opt_state(params)}
    specs = {"params": pspecs, "opt": {"m": pspecs, "v": pspecs, "step": ()}}
    return state, specs
