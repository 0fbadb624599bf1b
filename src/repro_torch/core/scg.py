"""Scaled Conjugate Gradient (Moller 1993) — the paper's optimiser.

A copy of ``repro.core.scg`` (numpy only), kept here so the port never
imports the JAX package; the two give bitwise-equal iterates on the same
oracle.  The paper optimises the global parameters G (kernel hypers, noise,
inducing inputs) and the local GPLVM parameters with SCG "following the
original implementation by (Titsias & Lawrence, 2010)" — i.e. the
Netlab/GPy SCG.  It is a host-side loop on flat vectors: each iteration
costs 1-2 oracle calls, each one map step and its backward on the card.

Maximisation is handled by the callers negating their objective.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable

import numpy as np


@dataclass
class SCGResult:
    x: np.ndarray
    f: float
    n_iters: int
    n_evals: int
    history: list = field(default_factory=list)
    converged: bool = False


def scg(
    fg: Callable[[np.ndarray], tuple[float, np.ndarray]],
    x0: np.ndarray,
    max_iters: int = 200,
    xtol: float = 1e-8,
    ftol: float = 1e-8,
    callback: Callable | None = None,
) -> SCGResult:
    """Minimise f via Moller's SCG. ``fg(x) -> (f, grad)``."""
    sigma0 = 1.0e-4
    x = np.asarray(x0, dtype=np.float64).copy()
    fold, gradnew = fg(x)
    fnow = fold
    n_evals = 1
    gradold = gradnew.copy()
    d = -gradnew
    success = True
    nsuccess = 0
    beta, betamin, betamax = 1.0, 1.0e-15, 1.0e100
    history = [float(fold)]
    kappa = mu = theta = 0.0

    for j in range(1, max_iters + 1):
        if success:
            mu = float(d @ gradnew)
            if mu >= 0.0:
                d = -gradnew
                mu = float(d @ gradnew)
            kappa = float(d @ d)
            if kappa < 1.0e-30:
                return SCGResult(x, float(fnow), j, n_evals, history, True)
            sigma = sigma0 / np.sqrt(kappa)
            _, gplus = fg(x + sigma * d)
            n_evals += 1
            theta = float(d @ (gplus - gradnew)) / sigma
            if not np.isfinite(theta):
                # probe landed in a non-finite region: treat as very high
                # curvature so the step shrinks
                theta = beta * kappa

        # Increase effective curvature and evaluate step size alpha.
        delta = theta + beta * kappa
        if delta <= 0.0:
            delta = beta * kappa
            beta = beta - theta / kappa
        alpha = -mu / delta

        # Comparison ratio. Non-finite objective (e.g. Cholesky failure at a
        # wild hyper-parameter step) counts as a failed step and MUST grow
        # beta — NaN comparisons would otherwise freeze the step size.
        fnew, gnew_at_xnew = fg(x + alpha * d)
        n_evals += 1
        if np.isfinite(fnew) and np.all(np.isfinite(gnew_at_xnew)):
            Delta = 2.0 * (fnew - fold) / (alpha * mu)
        else:
            Delta = -1.0
        if Delta >= 0.0:
            success = True
            nsuccess += 1
            x = x + alpha * d
            fnow = fnew
        else:
            success = False
            fnow = fold

        if callback is not None:
            callback(j, x, float(fnow))
        history.append(float(fnow))

        if success:
            if (np.max(np.abs(alpha * d)) < xtol) and (abs(fnew - fold) < ftol):
                return SCGResult(x, float(fnew), j, n_evals, history, True)
            fold = fnew
            gradold = gradnew
            gradnew = gnew_at_xnew
            if float(gradnew @ gradnew) == 0.0:
                return SCGResult(x, float(fnew), j, n_evals, history, True)

        if Delta < 0.25:
            beta = min(4.0 * beta, betamax)
        if Delta > 0.75:
            beta = max(0.5 * beta, betamin)

        if nsuccess == x.size:
            d = -gradnew
            nsuccess = 0
        elif success:
            gamma = float((gradold - gradnew) @ gradnew) / mu
            d = gamma * d - gradnew

    return SCGResult(x, float(fnow), max_iters, n_evals, history, False)
