"""The collapsed variational bound (paper eq. 3.3) and the optimal q(u).

Counterpart of ``repro.core.bound``, forward only.  With L = chol(Kmm) and
Bmat = I + b L^-1 D L^-T (the Cholesky-whitened GPy/GPflow form):

  log p(Y) >= -nd/2 log 2pi + nd/2 log b - d/2 log|Bmat|
              - b/2 A - bd/2 B + bd/2 Tr(L^-1 D L^-T)
              + b^2/2 ||LB^-1 L^-1 C||_F^2 - KL

  q*(u) = N(b Kmm Sigma^-1 C, Kmm Sigma^-1 Kmm),   Sigma = Kmm + b D

All of it runs in the caller's dtype (f64) on the caller's device;
factorisations and solves are ``torch.linalg``'s.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from . import covariance as cov
from .stats import Stats

DEFAULT_JITTER = 1e-6


def _solve_lower(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.linalg.solve_triangular(a, b, upper=False)


def _chol_kmm(hyp: dict, z: torch.Tensor, jitter: float,
              kernel=None) -> torch.Tensor:
    kernel = cov.as_kernel(kernel)
    m = z.shape[0]
    kmm = kernel.K(hyp, z, z)
    # Jitter scaled by the kernel's signal variance (unit-free).
    vs = kernel.variance_scale(hyp)
    eye = torch.eye(m, dtype=z.dtype, device=z.device)
    return torch.linalg.cholesky(kmm + (jitter * vs + 1e-12) * eye)


def _whitened(hyp: dict, z, stats: Stats, jitter: float, kernel):
    """(L, LB, W, c2): the factors the bound, q(u) and the state share."""
    beta = torch.exp(hyp["log_beta"])
    m = z.shape[0]
    L = _chol_kmm(hyp, z, jitter, kernel)
    LiD = _solve_lower(L, stats.D)
    W = _solve_lower(L, LiD.T).T                          # L^-1 D L^-T
    eye = torch.eye(m, dtype=z.dtype, device=z.device)
    LB = torch.linalg.cholesky(eye + beta * W)
    c2 = _solve_lower(LB, _solve_lower(L, stats.C))       # LB^-1 L^-1 C
    return L, LB, W, c2


def collapsed_bound(hyp: dict, z, stats: Stats, d: int,
                    jitter: float = DEFAULT_JITTER, kernel=None):
    """Paper eq. 3.3 from reduced statistics. Returns a scalar lower bound."""
    beta = torch.exp(hyp["log_beta"])
    n = stats.n
    _, LB, W, c2 = _whitened(hyp, z, stats, jitter, kernel)
    logdet_b = 2.0 * torch.log(torch.diagonal(LB)).sum()
    tr_kinv_d = torch.trace(W)
    quad = (c2 * c2).sum()
    return (
        -0.5 * n * d * math.log(2.0 * math.pi)
        + 0.5 * n * d * hyp["log_beta"]
        - 0.5 * d * logdet_b
        - 0.5 * beta * stats.A
        - 0.5 * beta * d * stats.B
        + 0.5 * beta * d * tr_kinv_d
        + 0.5 * beta**2 * quad
        - stats.KL
    )


class QU(NamedTuple):
    """Optimal q(u) = N(mean, cov) plus cached Cholesky factors for prediction."""

    mean: torch.Tensor       # (m, d)
    cov: torch.Tensor        # (m, m)
    L: torch.Tensor          # chol(Kmm)
    LB: torch.Tensor         # chol(I + b L^-1 D L^-T)
    c2: torch.Tensor         # LB^-1 L^-1 C (whitened info vector)


def optimal_qu(hyp: dict, z, stats: Stats, jitter: float = DEFAULT_JITTER,
               kernel=None) -> QU:
    """The analytically-optimal variational distribution over inducing values."""
    beta = torch.exp(hyp["log_beta"])
    L, LB, _, c2 = _whitened(hyp, z, stats, jitter, kernel)
    # mean = b Kmm Sigma^-1 C = b L LB^-T c2
    mean = beta * (L @ torch.linalg.solve_triangular(LB.T, c2, upper=True))
    # cov = Kmm Sigma^-1 Kmm = (L LB^-T)(L LB^-T)^T
    half = _solve_lower(LB, L.T).T                        # L LB^-T
    return QU(mean=mean, cov=half @ half.T, L=L, LB=LB, c2=c2)


def predict(hyp: dict, z, qu: QU, xstar, full_cov: bool = False,
            include_noise: bool = False, kernel=None):
    """SGPR predictive posterior at xstar (t, q) from the per-call solves.

    mean = b K*m Sigma^-1 C ; var = k** - K*m (Kmm^-1 - Sigma^-1) Km*.
    Returns (mean (t,d), var (t,) or cov (t,t)).
    """
    kernel = cov.as_kernel(kernel)
    beta = torch.exp(hyp["log_beta"])
    ksm = kernel.K(hyp, xstar, z)                          # (t, m)
    a1 = _solve_lower(qu.L, ksm.T)                         # L^-1 Km*
    a2 = _solve_lower(qu.LB, a1)                           # LB^-1 L^-1 Km*
    mean = beta * (a2.T @ qu.c2)
    if full_cov:
        covm = kernel.K(hyp, xstar, xstar) - a1.T @ a1 + a2.T @ a2
        if include_noise:
            covm = covm + torch.eye(xstar.shape[0], dtype=covm.dtype,
                                    device=covm.device) / beta
        return mean, covm
    var = kernel.kdiag(hyp, xstar) - (a1 * a1).sum(0) + (a2 * a2).sum(0)
    if include_noise:
        var = var + 1.0 / beta
    return mean, var
