"""Incremental ``PredictiveState`` refresh: the serve side of online updates
(counterpart of ``repro.serve.online``).

``core.stats.fold_stats`` makes the statistics of a new (or forgotten)
block an O(m²) add; this module makes the serving factors an O(m²k)
refresh.  With the hyper-parameters and inducing inputs fixed, ``L =
chol(Kmm)`` is unchanged and a block of k points moves the whitened system
by a rank-k term,

    B' = B ± V Vᵀ,      V = √β · L⁻¹ Knmᵀ diag(√w)        (m, k)

so every stored factor refreshes without an m×m factorisation:

    LB'     rank-k Cholesky update/downdate of LB          O(m²k)
    c2'     LB'⁻¹ (LB c2 ± L⁻¹ ΔC)                         O(m²(k+d))
    a_mean' β L⁻ᵀ LB'⁻ᵀ c2'                                O(m²d)
    g'      g ± Z T⁻¹ Zᵀ  (Woodbury on B; T is k×k)        O(m²k + k³)

The happy path factorises only the k×k Woodbury capacitance ``T``.  A
downdate that trips the pivot guard of ``core.chol_update``, or whose
``T`` does not factor, falls back to refactorising ``B'`` from the stored
factors (O(m³)), and says so in ``RefreshResult.fallback``: a slow path,
not an error.  Factorisations go through ``torch.linalg.cholesky_ex``,
whose failure becomes a non-finite factor as JAX's ``cholesky`` returns
one, so nothing here raises on an indefinite matrix: an illegitimate
forget comes back as a NaN state with ``fallback=True``.

Every step runs on the state's device in its dtype.  The guard is read on
the host once a refresh (``bool(ok)``), as the JAX package's is.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from ..core import chol_update
from ..core.chol_update import DEFAULT_COND_TOL


class RefreshResult(NamedTuple):
    """A refresh's new state and whether it took the full refactorisation
    (an ill-conditioned or indefinite downdate)."""

    state: "object"      # serve.posterior.PredictiveState
    fallback: bool


def _lower(a, b):
    return torch.linalg.solve_triangular(a, b, upper=False)


def _upper(a, b):
    return torch.linalg.solve_triangular(a, b, upper=True)


def _cholesky(a: torch.Tensor) -> torch.Tensor:
    """``chol(a)``, NaN everywhere where it fails, as JAX's is."""
    fac, info = torch.linalg.cholesky_ex(a)
    return torch.where(info == 0, fac, torch.full_like(fac, float("nan")))


def block_update_factors(state, x_new, y_new, weights=None):
    """The rank-k quantities a block contributes: ``(V, dC)``.

    ``V = √β L⁻¹ Knmᵀ diag(√w)`` (m, k), the whitened columns whose outer
    product moves ``B``; ``dC = Knmᵀ diag(w) Y`` (m, d).  Zero-weight rows
    give zero columns, which the rank-k sweeps pass over exactly.  ``Knm``
    is the expression's plain ``K``, as in the JAX package."""
    dt, dev = state.z.dtype, state.z.device
    x_new = torch.as_tensor(x_new).to(dev, dt)
    y_new = torch.as_tensor(y_new).to(dev, dt)
    k = x_new.shape[0]
    w = (torch.ones((k,), dtype=dt, device=dev) if weights is None
         else torch.as_tensor(weights).to(dev, dt))
    beta = torch.exp(state.hyp["log_beta"])
    knm = state.kernel.K(state.hyp, x_new, state.z)           # (k, m)
    dC = knm.T @ (w[:, None] * y_new)                         # (m, d)
    U = _lower(state.chol_kmm, knm.T * torch.sqrt(w)[None, :])  # (m, k)
    return torch.sqrt(beta) * U, dC


def _finish(state, LB_new, LiC_new, g_new):
    """The serving contractions re-derived from refreshed factors."""
    beta = torch.exp(state.hyp["log_beta"])
    c2 = _lower(LB_new, LiC_new)
    t1 = _upper(LB_new.T, c2)
    a_mean = beta * _upper(state.chol_kmm.T, t1)
    return dataclasses.replace(state, chol_sigma=LB_new, c2=c2,
                               a_mean=a_mean, g=g_new)


def _woodbury_correction(state, V):
    """``(y1, Y, Z)`` for ``B' = B ± V Vᵀ`` with the pre-update LB:
    ``y1 = LB⁻¹ V``, ``Y = B⁻¹ V`` and ``Z = L⁻ᵀ B⁻¹ V``, the pieces of the
    rank-k change of ``Σ⁻¹`` (hence of ``g = Kmm⁻¹ − Σ⁻¹``)."""
    y1 = _lower(state.chol_sigma, V)
    Y = _upper(state.chol_sigma.T, y1)                        # B⁻¹ V
    Z = _upper(state.chol_kmm.T, Y)                           # L⁻ᵀ B⁻¹ V
    return y1, Y, Z


def _correction_from(y1, Z, sign: float):
    """``(Z T⁻¹ Zᵀ, chol(T))`` with ``T = I ± y1ᵀ y1`` (k×k): the only
    factorisation of the happy path."""
    k = Z.shape[1]
    T = torch.eye(k, dtype=Z.dtype, device=Z.device) + sign * (y1.T @ y1)
    Tc = _cholesky(T)
    S = _lower(Tc, Z.T)                                       # (k, m)
    return S.T @ S, Tc


def _refactorize(state, V, LiC_new, sign: float):
    """The guarded fallback: ``LB' = chol(B ± V Vᵀ)`` and ``g`` rebuilt
    from the stored factors, O(m³); NaN where ``B ± V Vᵀ`` is not
    positive-definite."""
    LB = state.chol_sigma
    m = LB.shape[0]
    Bmat = LB @ LB.T + sign * (V @ V.T)
    LB_new = _cholesky(0.5 * (Bmat + Bmat.T))
    eye = torch.eye(m, dtype=LB.dtype, device=LB.device)
    v1 = _lower(state.chol_kmm, eye).T
    v2 = v1 @ _lower(LB_new, eye).T
    return _finish(state, LB_new, LiC_new, v1 @ v1.T - v2 @ v2.T)


@torch.no_grad()
def refresh_state(state, x_new, y_new, weights=None, sign: float = 1.0,
                  cond_tol: float = DEFAULT_COND_TOL) -> RefreshResult:
    """Refresh every serving factor for a folded (+1) or forgotten (-1)
    block of k points in O(m²(k+d)), with the guarded O(m³) fallback.

    ``(hyp, z, chol_kmm)`` stay: an online update moves data, not
    parameters; after a fit the state is re-extracted."""
    if torch.finfo(state.z.dtype).bits < 32:
        raise ValueError(
            "incremental refresh runs Cholesky-update math on the stored "
            "factors; sub-f32 (quantized) states cannot carry it — refresh "
            "the full-precision master state and re-quantize")
    if sign not in (1.0, -1.0):
        raise ValueError(f"sign must be +1.0 or -1.0, got {sign}")
    V, dC = block_update_factors(state, x_new, y_new, weights)
    LiC = state.chol_sigma @ state.c2 + sign * _lower(state.chol_kmm, dC)
    sweep = (chol_update.chol_update_rank_k if sign > 0
             else chol_update.chol_downdate_rank_k)
    LB_new, ok = sweep(state.chol_sigma, V, cond_tol=cond_tol)
    if bool(ok):
        y1, _, Z = _woodbury_correction(state, V)
        corr, Tc = _correction_from(y1, Z, sign)
        if bool(torch.isfinite(Tc).all() & (torch.diagonal(Tc) > 0).all()):
            return RefreshResult(_finish(state, LB_new, LiC,
                                         state.g + sign * corr), False)
    return RefreshResult(_refactorize(state, V, LiC, sign), True)


def update_state(state, x_new, y_new, weights=None,
                 cond_tol: float = DEFAULT_COND_TOL) -> RefreshResult:
    """Absorb a new block into the serving state (pair with
    ``core.stats.fold_stats`` on the training side)."""
    return refresh_state(state, x_new, y_new, weights, sign=1.0,
                         cond_tol=cond_tol)


def downdate_state(state, x_old, y_old, weights=None,
                   cond_tol: float = DEFAULT_COND_TOL) -> RefreshResult:
    """Forget a previously folded block (pair with
    ``core.stats.downdate_stats``); an ill-conditioned or indefinite removal
    takes the guarded fallback (``RefreshResult.fallback``)."""
    return refresh_state(state, x_old, y_old, weights, sign=-1.0,
                         cond_tol=cond_tol)
