"""Partial sufficient statistics: the paper's Map step (regression).

Each worker holds a shard ``(Y_k, X_k)`` and computes

    A_k  = Sum_i Y_i Y_i^T            (scalar)
    B_k  = Sum_i k(x_i, x_i)          (scalar)
    C_k  = Knm_k^T Y_k                (m, d)
    D_k  = Knm_k^T Knm_k              (m, m)

whose size is independent of n.  ``weights`` masks rows (padding, failed
nodes) without changing shapes: a zero weight removes row i from every
statistic.  Counterpart of ``repro.core.stats``; the SVI mode, ``init=``,
``block_reduce_fn`` and the latent (GPLVM) branch come in later slices.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..kernels.reg_stats import ops as rs_ops
from . import covariance as cov


def reg_stats_dense(hyp: dict, z, x, y, w, kernel=None):
    """Regression statistics ``(b, C, D)`` from the whole (n, m) kernel slab,
    through the covariance expression's own ``K``/``kdiag``: the dense
    formulation the JAX package's map step uses, kept as the reference the
    fused path is tested against (and, with training, its backward)."""
    kernel = cov.as_kernel(kernel)
    knm = kernel.K(hyp, x, z)                                  # (n, m)
    b = (w * kernel.kdiag(hyp, x)).sum()
    c = knm.T @ (w[:, None] * y)                               # (m, d)
    d_stat = (knm * w[:, None]).T @ knm                        # (m, m)
    return b, c, d_stat


class Stats(NamedTuple):
    """Sufficient statistics of the collapsed bound. All sums over points."""

    A: torch.Tensor   # () Frobenius term  Sum Y_i Y_i^T
    B: torch.Tensor   # () psi0 sum
    C: torch.Tensor   # (m, d) Psi1^T Y
    D: torch.Tensor   # (m, m) Psi2
    KL: torch.Tensor  # () KL(q(X)||p(X)); 0 for regression
    n: torch.Tensor   # () effective number of points contributing

    def __add__(self, other: "Stats") -> "Stats":  # type: ignore[override]
        return Stats(*(a + b for a, b in zip(self, other)))

    def __sub__(self, other: "Stats") -> "Stats":
        return Stats(*(a - b for a, b in zip(self, other)))

    def scale(self, c) -> "Stats":
        return Stats(*(c * t for t in self))


def _require_regression(s) -> None:
    if s is not None:
        raise NotImplementedError(
            "the latent (GPLVM) map step is queued in ROADMAP.md, Queue 1 "
            "('Bayesian GPLVM'); this slice ports regression (s=None)")


def partial_stats(hyp: dict, z, y, mu, s=None, weights=None,
                  latent: bool = False, kernel=None) -> Stats:
    """Shard-local statistics (the map function), regression branch.

    The full-width SE-ARD map (the only expression this slice ports) goes
    through ``kernels.reg_stats``: the CUDA kernel for CUDA tensors, its
    plain version for CPU ones.
    """
    _require_regression(s)
    del latent   # regression has no KL term
    cov.as_kernel(kernel)   # raises for an expression not yet ported
    n_k = y.shape[0]
    w = (torch.ones((n_k,), dtype=y.dtype, device=y.device) if weights is None
         else weights.to(y.dtype))
    a = (w * (y * y).sum(-1)).sum()
    b, c, d_stat = rs_ops.reg_stats(hyp, z, mu, y, w)
    return Stats(A=a, B=b, C=c, D=d_stat, KL=torch.zeros_like(a), n=w.sum())


def zero_stats(m: int, d: int, dtype=torch.float64, device=None) -> Stats:
    """The additive identity of the Stats monoid."""
    zf = torch.zeros((), dtype=dtype, device=device)
    return Stats(A=zf, B=zf, C=torch.zeros((m, d), dtype=dtype, device=device),
                 D=torch.zeros((m, m), dtype=dtype, device=device), KL=zf, n=zf)


def partial_stats_chunked(hyp: dict, z, y, mu, s=None, weights=None,
                          latent: bool = False, block_size: int | None = 1024,
                          kernel=None) -> Stats:
    """Streaming map step: :func:`partial_stats` folded over row blocks.

    Exact mode: rows are padded up to a multiple of ``block_size`` with zero
    weight and every block's Stats are folded left to right into a
    constant-size accumulator, as the JAX package's ``lax.scan`` does, so
    peak memory is O(block_size * m) + O(m^2).  ``block_size=None`` (or
    ``n <= block_size``) computes the statistics in one piece.
    """
    _require_regression(s)
    n_k = y.shape[0]
    if block_size is None or n_k <= block_size:
        return partial_stats(hyp, z, y, mu, s, weights=weights,
                             latent=latent, kernel=kernel)
    w = (torch.ones((n_k,), dtype=y.dtype, device=y.device) if weights is None
         else weights.to(y.dtype))
    pad = (-n_k) % block_size

    def padded(t):
        return torch.cat([t, t.new_zeros((pad,) + t.shape[1:])])

    y_p, mu_p, w_p = padded(y), padded(mu), padded(w)
    acc = zero_stats(z.shape[0], y.shape[1], dtype=y.dtype, device=y.device)
    for lo in range(0, n_k + pad, block_size):
        sl = slice(lo, lo + block_size)
        acc = acc + partial_stats(hyp, z, y_p[sl], mu_p[sl], None,
                                  weights=w_p[sl], latent=latent,
                                  kernel=kernel)
    return acc


def reduce_stats(parts: list[Stats]) -> Stats:
    """Sequential reduce (the single-host analogue of the paper's reduce)."""
    out = parts[0]
    for p in parts[1:]:
        out = out + p
    return out
