"""Flat parameter vectors for SCG, the value-and-gradient oracle, the SCG
fit over a parameter dict, and maps over nested parameter dicts (a
combinator's hyper-parameters nest each child's under ``"k0"``, ...).

The JAX models flatten their parameter dicts with
``jax.flatten_util.ravel_pytree``: dict keys sorted, depth first, each leaf
raveled in row-major order.  :class:`Flat` uses the same order, so the
port's SCG walks the same coordinates as the JAX package's and the two
trajectories compare coordinate for coordinate.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from .scg import SCGResult, scg


def tree_items(tree, prefix: tuple = ()):
    """``(path, leaf)`` of nested dicts and lists, dict keys sorted, list
    entries in order (their index in the path), depth first: the
    ``ravel_pytree`` order."""
    kids = sorted(tree.items()) if isinstance(tree, dict) else enumerate(tree)
    for k, v in kids:
        if isinstance(v, (dict, list)):
            yield from tree_items(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _child(node, key, empty):
    """``node[key]``, made ``empty`` first where it is missing: a list's
    entries come in order, so a missing one is the next."""
    if isinstance(node, list):
        if key == len(node):
            node.append(empty)
        return node[key]
    return node.setdefault(key, empty)


def tree_unflatten(paths, leaves) -> dict:
    """The nested dicts and lists holding ``leaves`` at ``paths``: the
    inverse of :func:`tree_items` (an int in a path indexes a list, whose
    entries come in order)."""
    out: dict = {}
    for path, leaf in zip(paths, leaves):
        node = out
        for key, nxt in zip(path[:-1], path[1:]):
            node = _child(node, key, [] if isinstance(nxt, int) else {})
        if isinstance(node, list):
            node.append(leaf)
        else:
            node[path[-1]] = leaf
    return out


def tree_map(fn, *trees):
    """``fn`` over the leaves of nested dicts and lists of the same
    structure, in a tree of that structure."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in first}
    if isinstance(first, list):
        return [tree_map(fn, *(t[i] for t in trees))
                for i in range(len(first))]
    return fn(*trees)


def tree_leaves(tree: dict) -> list:
    """The leaves of nested dicts and lists in the ``ravel_pytree``
    order."""
    return [v for _, v in tree_items(tree)]


def _get(tree: dict, path: tuple):
    for k in path:
        tree = tree[k]
    return tree


class Flat:
    """The layout of a (nested) dict of tensors as one f64 numpy vector."""

    def __init__(self, tree: dict):
        items = list(tree_items(tree))
        self.paths = [p for p, _ in items]
        self.shapes = [tuple(t.shape) for _, t in items]
        self.size = sum(math.prod(s) for s in self.shapes)
        self.device = items[0][1].device

    def ravel(self, tree: dict) -> np.ndarray:
        return torch.cat([_get(tree, p).detach().reshape(-1).double()
                          for p in self.paths]).cpu().numpy()

    def unravel(self, x, requires_grad: bool = False) -> dict:
        """A dict of f64 leaves on the layout's device (fresh autograd leaves
        when ``requires_grad``)."""
        flat = torch.from_numpy(np.array(x, np.float64)).to(self.device)
        parts = flat.split([math.prod(s) for s in self.shapes])
        return tree_unflatten(self.paths, [
            p.reshape(s).detach().requires_grad_(requires_grad)
            for p, s in zip(parts, self.shapes)])

    def value_and_grad(self, neg, x, fixed: dict | None = None
                       ) -> tuple[float, np.ndarray]:
        """``neg(params)`` at the flat point ``x`` and its gradient in these
        coordinates; ``fixed`` params join as constants.  A Cholesky that
        fails at a wild SCG step gives NaN value and gradient, which SCG
        counts as a failed step, as the JAX package's NaN factor does."""
        params = self.unravel(x, requires_grad=True)
        try:
            value = neg({**(fixed or {}), **params})
        except torch.linalg.LinAlgError:
            return float("nan"), np.full(self.size, np.nan)
        grads = torch.autograd.grad(value, [_get(params, p)
                                            for p in self.paths])
        return float(value.detach()), torch.cat(
            [g.reshape(-1) for g in grads]).cpu().numpy()


def neg_value_and_grad(neg, params: dict) -> tuple[float, np.ndarray]:
    """``neg(params)`` and its flat gradient at ``params``."""
    flat = Flat(params)
    return flat.value_and_grad(neg, flat.ravel(params))


def fit_scg(neg, params: dict, max_iters: int, fixed: dict | None = None
            ) -> tuple[SCGResult, dict]:
    """Minimise ``neg`` over ``params`` by SCG, ``fixed`` params held as
    constants; returns the SCG result and the fitted params."""
    flat = Flat(params)
    res = scg(lambda xf: flat.value_and_grad(neg, xf, fixed=fixed),
              flat.ravel(params), max_iters=max_iters)
    return res, flat.unravel(res.x)
