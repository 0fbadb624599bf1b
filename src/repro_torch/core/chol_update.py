"""Rank-k Cholesky update/downdate: the O(m²k) serve-refresh primitive
(counterpart of ``repro.core.chol_update``).

Given a lower-triangular ``L`` with ``L Lᵀ = A`` and ``V`` (m, k), compute
the factor of ``A ± V Vᵀ`` without refactorising the m×m matrix: k rank-1
sweeps of Givens (update) or hyperbolic (downdate) rotations, one per
column, as LINPACK's ``dchud``/``dchdd`` do.  No factorisation is called
anywhere in this module.

The JAX package runs the k sweeps of m column steps as one compiled scan.
Eager torch would launch ≈ 8·k·m small ops for that (8 million at m 512
and k 2,048).  Here the column is the outer loop and the k rotations of one
column are a handful of (m, k) tensor ops, so a refresh is m steps of
O(mk) work.  That is exact, not an approximation: rotation (j, i) reads
column j after rotations (j, <i) and vector i after rotations (<j, i), so
either loop order gives the same factor.  Within column j, with pivots
``d_0 = L[j, j]``, entries ``x_i = V_i[j]`` and the rows below it ``l``
(column) and ``X`` (vectors), rotation i gives

    d_{i+1}² = d_i² ± x_i²                       a prefix sum over i
    d_{i+1} l^{(i+1)} = d_i l^{(i)} ± x_i X_i    so d_k l^{(k)} = d_0 l ± X x
    X_i' = (d_{i+1}/d_i) X_i − x_i l^{(i+1)} / d_i

and the prefix sums run as ``cumsum`` over the k vectors.

Downdates can fail: ``A − V Vᵀ`` may be indefinite (removing a block that
was never folded in), or so ill-conditioned that the sweep loses it.  Both
show as a pivot ``d_{i+1}² ≤ cond_tol · d_i²``.  Each function returns an
``ok`` flag (a 0-d bool tensor, no host synchronisation) beside the
factor instead of raising; a failed column's pivots are clamped at
``cond_tol`` times the last good one, so the sweep finishes with finite
numbers, and the caller (``serve.online``) discards that factor.  Updates
never fail in exact arithmetic; they share the flag for one API.
"""
from __future__ import annotations

import torch

# Relative pivot floor for downdates: the guard trips when a pivot would
# shrink below sqrt(cond_tol) of its current magnitude (the JAX package's).
DEFAULT_COND_TOL = 1e-8


def chol_update_rank_k(L: torch.Tensor, V: torch.Tensor,
                       cond_tol: float = DEFAULT_COND_TOL):
    """``chol(L Lᵀ + V Vᵀ)`` in O(m²k): ``(L', ok)``.  ``V`` is (m, k) or
    (m,); zero columns (zero-weight padding rows) are exact no-ops."""
    return _rank_k(L, V, 1.0, cond_tol)


def chol_downdate_rank_k(L: torch.Tensor, V: torch.Tensor,
                         cond_tol: float = DEFAULT_COND_TOL):
    """``chol(L Lᵀ − V Vᵀ)`` in O(m²k): ``(L', ok)``.  ``ok`` False means
    the downdate is indefinite or too ill-conditioned to trust (a pivot
    ratio under ``cond_tol``); ``L'`` is then a clamped artefact."""
    return _rank_k(L, V, -1.0, cond_tol)


@torch.no_grad()
def _rank_k(L: torch.Tensor, V: torch.Tensor, sign: float, cond_tol: float):
    V = V.to(L.dtype)
    if V.ndim == 1:
        V = V[:, None]
    L, X = L.clone(), V.clone()
    m = L.shape[0]
    ok = torch.ones((), dtype=torch.bool, device=L.device)
    if V.shape[1] == 0:
        return L, ok
    for j in range(m):
        x = X[j]                                        # (k,)
        d0 = L[j, j]
        e = torch.cat([(d0 * d0)[None],
                       d0 * d0 + sign * torch.cumsum(x * x, 0)])
        # Pivot guard, rotation by rotation; exact until the first failure.
        good = torch.cumsum(~(e[1:] > cond_tol * e[:-1]), 0) == 0
        ok = ok & good[-1]
        # Past the first failure, hold cond_tol times the last good pivot².
        first = ~good & torch.cat([good.new_ones(1), good[:-1]])
        held = (cond_tol * e[:-1] * first).sum()
        e = torch.cat([e[:1], torch.where(good, e[1:], held)])
        d = torch.sqrt(e)
        d_prev, d_next = d[:-1], d[1:]
        l0 = L[j + 1:, j]
        xb = X[j + 1:]
        s = torch.cumsum(xb * x, 1)                     # Σ_{i'≤i} x X
        u = (d0 * l0)[:, None] + sign * s               # d_{i+1} l^{(i+1)}
        X[j + 1:] = xb * (d_next / d_prev) - u * (x / (d_prev * d_next))
        L[j + 1:, j] = l0 * (d0 / d[-1]) + sign * s[:, -1] / d[-1]
        L[j, j] = d[-1]
    return L, ok
