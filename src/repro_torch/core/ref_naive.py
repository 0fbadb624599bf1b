"""Naive O(n³) oracles for tests (counterpart of ``repro.core.ref_naive``).

* ``exact_lml``: the exact GP log marginal likelihood (n×n Cholesky); any
  correct lower bound sits below it.
* ``titsias_bound_direct``: the regression bound in its textbook (Titsias
  2009) form, log N(Y; 0, Qnn + β⁻¹I) − β/2 Tr(Knn − Qnn), computed without
  the paper's re-parametrisation, which must match it to float precision.
* ``exact_predict``: the exact GP posterior mean and variance.

Each takes an optional ``kernel`` expression (``core.covariance``; None:
SE-ARD) and runs plain torch on its inputs' device.
"""
from __future__ import annotations

import math

import torch

from . import covariance as cov


def _eye(n: int, like: torch.Tensor) -> torch.Tensor:
    return torch.eye(n, dtype=like.dtype, device=like.device)


def _lower(a, b):
    return torch.linalg.solve_triangular(a, b, upper=False)


def _gauss_logpdf(L, y) -> torch.Tensor:
    """log N(y; 0, L Lᵀ), summed over y's columns."""
    n, d = y.shape
    alpha = _lower(L, y)
    logdet = 2.0 * torch.log(torch.diagonal(L)).sum()
    return (-0.5 * d * n * math.log(2.0 * math.pi) - 0.5 * d * logdet
            - 0.5 * (alpha * alpha).sum())


def exact_lml(hyp: dict, x, y, jitter: float = 1e-8, kernel=None):
    """log N(Y; 0, K + β⁻¹ I), summed over the d output dims."""
    kernel = cov.as_kernel(kernel)
    n = y.shape[0]
    beta = torch.exp(hyp["log_beta"])
    k = kernel.K(hyp, x, x) + (1.0 / beta + jitter) * _eye(n, x)
    return _gauss_logpdf(torch.linalg.cholesky(k), y)


def titsias_bound_direct(hyp: dict, x, y, z, jitter: float = 1e-6,
                         kernel=None):
    """Titsias (2009) regression bound, computed the pre-paper way."""
    kernel = cov.as_kernel(kernel)
    n, d = y.shape
    m = z.shape[0]
    beta = torch.exp(hyp["log_beta"])
    vs = kernel.variance_scale(hyp)
    kmm = kernel.K(hyp, z, z) + (jitter * vs + 1e-12) * _eye(m, x)
    knm = kernel.K(hyp, x, z)
    v = _lower(torch.linalg.cholesky(kmm), knm.T)          # (m, n); Qnn = vᵀv
    qnn = v.T @ v
    covn = qnn + (1.0 / beta) * _eye(n, x)
    fit = _gauss_logpdf(torch.linalg.cholesky(covn + jitter * _eye(n, x)), y)
    trace_term = -0.5 * beta * d * (kernel.kdiag(hyp, x).sum()
                                    - torch.trace(qnn))
    return fit + trace_term


def exact_predict(hyp: dict, x, y, xstar, jitter: float = 1e-8, kernel=None):
    """Exact GP posterior mean and variance at ``xstar`` (small n)."""
    kernel = cov.as_kernel(kernel)
    n = x.shape[0]
    beta = torch.exp(hyp["log_beta"])
    k = kernel.K(hyp, x, x) + (1.0 / beta + jitter) * _eye(n, x)
    L = torch.linalg.cholesky(k)
    a = _lower(L, kernel.K(hyp, xstar, x).T)
    mean = a.T @ _lower(L, y)
    var = kernel.kdiag(hyp, xstar) - (a * a).sum(0)
    return mean, var
