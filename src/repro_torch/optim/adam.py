"""AdamW (port of ``repro.optim.adam``): f32 moments, bf16-safe.

The state tree is the JAX package's, ``{"m", "v", "step"}``: ``m`` and
``v`` f32 trees shaped like the params, ``step`` a 0-d int32 tensor, so a
train state checkpointed by either package restores in the other.

:func:`adam_update` updates the params and moments **in place** (under
``torch.no_grad()``) and returns the same trees: the JAX package returns new
arrays, but at full width a functional copy of the params and both moments
costs another ~15 GB of card memory (llama3.2-1b: 1.24e9 params, 12 bytes
each).  The arithmetic is the JAX package's, step for step, in f32:
global-norm clipping, warmup from the step before the increment, bias
corrections from the step after it, and decoupled weight decay on every
leaf with ``ndim >= 2`` -- which includes a stacked group's norm scales and
biases, (layers, D), as in the JAX package.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..core.flat import tree_leaves, tree_map


class AdamConfig(NamedTuple):
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100


def init_opt_state(params: dict) -> dict:
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    device = tree_leaves(params)[0].device
    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def _schedule(cfg: AdamConfig, step: torch.Tensor) -> torch.Tensor:
    warm = torch.clamp((step + 1) / max(cfg.warmup_steps, 1), max=1.0)
    return cfg.lr * warm


def global_norm(tree: dict) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf in f32, leaves summed in
    the JAX package's (sorted-key) order."""
    return torch.sqrt(sum(torch.sum(torch.square(g.float()))
                          for g in tree_leaves(tree)))


@torch.no_grad()
def adam_update(cfg: AdamConfig, params: dict, grads: dict, state: dict,
                grad_norm: torch.Tensor | None = None):
    """Returns (params, state, metrics): ``params`` and the moments updated
    in place, a new ``step``, metrics ``grad_norm`` and ``lr`` (0-d f32
    tensors on the params' device).  ``grad_norm``: the norm to clip by
    (None: ``global_norm(grads)``; a rank holding blocks of the leaves
    passes the norm of the whole gradient)."""
    step = state["step"] + 1
    gnorm = global_norm(grads) if grad_norm is None else grad_norm
    scale = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
    lr = _schedule(cfg, state["step"])
    b1c = 1.0 - torch.pow(cfg.b1, step.float())
    b2c = 1.0 - torch.pow(cfg.b2, step.float())

    def upd(p, g, m, v):
        g32 = g.float() * scale
        m.mul_(cfg.b1).add_((1 - cfg.b1) * g32)
        v.mul_(cfg.b2).add_((1 - cfg.b2) * g32 * g32)
        delta = (m / b1c) / (torch.sqrt(v / b2c) + cfg.eps)
        if cfg.weight_decay and p.ndim >= 2:   # decay matrices only
            delta = delta + cfg.weight_decay * p.float()
        p.copy_(p.float() - lr * delta)

    tree_map(upd, params, grads, state["m"], state["v"])
    return params, {"m": state["m"], "v": state["v"], "step": step}, {
        "grad_norm": gnorm, "lr": lr}
