"""Stochastic (SVI) optimisation of the minibatch-reweighted bound: a small
Adam over a (nested) dict of tensors, the port of ``repro.train.svi``,
shared by ``SGPR.fit_svi``, ``BayesianGPLVM.fit_svi`` and the examples.

GP hyper-parameters live in f64 and stay there: the moments keep each
leaf's dtype and nothing round-trips through f32.  No weight decay: decay
on log-hyper-parameters or inducing inputs would bias the model.

The objective is ``neg_vg(params, generator) -> (value, grads)``, ``value``
an unbiased estimate of the negative bound drawn with ``generator``
(``core.stats.partial_stats_chunked(batch_blocks=...)``).  SCG cannot drive
it: its line searches compare values across calls, which a resampled
objective breaks (Hensman et al., arXiv:1309.6835).
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from ..core.flat import tree_map
from ..core.stats import fold_in


class SVIResult(NamedTuple):
    params: dict        # the optimised parameter dict
    history: list       # per-step estimates of the NEGATIVE bound
    n_steps: int


def adam_init(params: dict) -> dict:
    """Zero first and second moments of each leaf's shape, dtype and device."""
    return {"m": tree_map(torch.zeros_like, params),
            "v": tree_map(torch.zeros_like, params), "step": 0}


@torch.no_grad()
def adam_step(params: dict, grads: dict, opt: dict, lr: float,
              b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
    """One dtype-preserving Adam update: ``(new_params, new_opt)``."""
    t = opt["step"] + 1
    b1c = 1.0 - b1 ** float(t)
    b2c = 1.0 - b2 ** float(t)

    def upd(p, g, m, v):
        m2 = b1 * m + (1.0 - b1) * g
        v2 = b2 * v + (1.0 - b2) * g * g
        delta = (lr * (m2 / b1c) / (torch.sqrt(v2 / b2c) + eps)).to(p.dtype)
        return p - delta, m2, v2

    out = tree_map(upd, params, grads, opt["m"], opt["v"])
    new, m2, v2 = (tree_map(lambda o, i=i: o[i], out) for i in range(3))
    return new, {"m": m2, "v": v2, "step": t}


def value_and_grad(neg: Callable, params: dict):
    """``neg(params)`` (a scalar tensor) and its gradient with respect to
    every leaf of ``params``, as a dict of the same structure."""
    leaves = tree_map(lambda p: p.detach().requires_grad_(), params)
    with torch.enable_grad():
        value = neg(leaves)
    flat = []
    tree_map(flat.append, leaves)
    got = iter(torch.autograd.grad(value, flat, allow_unused=True))

    def grad_of(p):
        g = next(got)
        return torch.zeros_like(p) if g is None else g
    return value.detach(), tree_map(grad_of, leaves)


def svi_fit(neg_vg: Callable, params: dict, generator: torch.Generator,
            steps: int = 200, lr: float = 1e-2,
            callback: Callable | None = None) -> SVIResult:
    """``steps`` Adam updates on a stochastic objective.

    ``neg_vg(params, generator) -> (value, grads)``; step i draws with its
    own generator, ``fold_in(generator, i)``, so a run is reproducible from
    the generator's state.  ``callback(step, value, params)`` sees each
    step.
    """
    opt = adam_init(params)
    history = []
    for i in range(steps):
        v, g = neg_vg(params, fold_in(generator, i))
        params, opt = adam_step(params, g, opt, lr=lr)
        history.append(float(v))
        if callback is not None:
            callback(i, float(v), params)
    return SVIResult(params=params, history=history, n_steps=steps)
