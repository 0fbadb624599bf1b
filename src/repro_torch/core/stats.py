"""Partial sufficient statistics: the paper's Map step.

Each worker holds a shard ``(Y_k, mu_k, S_k)`` (regression: ``S_k = 0``,
``mu_k = X_k``) and computes

    A_k  = Sum_i Y_i Y_i^T            (scalar)
    B_k  = Sum_i psi0_i               (scalar)
    C_k  = Psi1_k^T Y_k               (m, d)
    D_k  = Sum_i psi2_i               (m, m)
    KL_k = Sum_i KL(q(X_i) || p(X_i)) (scalar, GPLVM only)

whose size is independent of n.  ``weights`` masks rows (padding, failed
nodes) without changing shapes: a zero weight removes row i from every
statistic.  Counterpart of ``repro.core.stats``; the SVI mode, ``init=``
and ``block_reduce_fn`` come in later slices.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..kernels.reg_stats import ops as rs_ops
from . import covariance as cov


def reg_stats_dense(hyp: dict, z, x, y, w, kernel=None):
    """Regression statistics ``(b, C, D)`` from the whole (n, m) kernel slab,
    through the covariance expression's own ``K``/``kdiag``: the dense
    formulation the JAX package's map step uses, and the recompute behind
    the fused kernel's backward (``kernels.reg_stats``)."""
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


def partial_stats(hyp: dict, z, y, mu, s=None, weights=None,
                  latent: bool = False, kernel=None) -> Stats:
    """Shard-local statistics (the map function).

    ``s`` (n, q) are the q(X) variances, or None for regression.  The
    full-width SE-ARD map (the only expression this slice ports) goes
    through the hand-written kernels on CUDA tensors and their plain
    versions on CPU ones: ``kernels.reg_stats`` for regression,
    ``kernels.psi_stats`` (psi1, psi2) for the latent map, whose C is a
    plain matmul as in the JAX package.  ``latent`` adds the KL of q(X).
    """
    kernel = cov.as_kernel(kernel)   # raises for an expression not yet ported
    n_k = y.shape[0]
    w = (torch.ones((n_k,), dtype=y.dtype, device=y.device) if weights is None
         else weights.to(y.dtype))
    a = (w * (y * y).sum(-1)).sum()
    if s is None:
        b, c, d_stat = rs_ops.reg_stats(hyp, z, mu, y, w)
        return Stats(A=a, B=b, C=c, D=d_stat, KL=torch.zeros_like(a),
                     n=w.sum())
    b = (w * kernel.psi0(hyp, mu, s)).sum()
    c = kernel.psi1(hyp, z, mu, s).T @ (w[:, None] * y)       # (m, d)
    d_stat = kernel.psi2(hyp, z, mu, s, w)
    kl_i = 0.5 * (s + mu * mu - torch.log(s) - 1.0).sum(-1)
    kl = (w * kl_i).sum() if latent else torch.zeros_like(a)
    return Stats(A=a, B=b, C=c, D=d_stat, KL=kl, n=w.sum())


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
    weight (q(X) variances with 1, log-safe for the KL) and every block's
    Stats are folded left to right into a constant-size accumulator, as the
    JAX package's ``lax.scan`` does, so peak memory is O(block_size * m) +
    O(m^2).  ``block_size=None`` (or ``n <= block_size``) computes the
    statistics in one piece.
    """
    n_k = y.shape[0]
    if block_size is None or n_k <= block_size:
        return partial_stats(hyp, z, y, mu, s, weights=weights,
                             latent=latent, kernel=kernel)
    w = (torch.ones((n_k,), dtype=y.dtype, device=y.device) if weights is None
         else weights.to(y.dtype))
    pad = (-n_k) % block_size

    def padded(t, value=0.0):
        return torch.cat([t, t.new_full((pad,) + t.shape[1:], value)])

    y_p, mu_p, w_p = padded(y), padded(mu), padded(w)
    s_p = None if s is None else padded(s, 1.0)
    acc = zero_stats(z.shape[0], y.shape[1], dtype=y.dtype, device=y.device)
    for lo in range(0, n_k + pad, block_size):
        sl = slice(lo, lo + block_size)
        acc = acc + partial_stats(hyp, z, y_p[sl], mu_p[sl],
                                  None if s_p is None else s_p[sl],
                                  weights=w_p[sl], latent=latent,
                                  kernel=kernel)
    return acc


def reduce_stats(parts: list[Stats]) -> Stats:
    """Sequential reduce (the single-host analogue of the paper's reduce)."""
    out = parts[0]
    for p in parts[1:]:
        out = out + p
    return out


# -- online folds: every Stats field is a plain sum over points -------------

def fold_stats(base: Stats, delta: Stats) -> Stats:
    """Fold a block's partial Stats into reduced Stats: ``stats(A ∪ B)``
    from ``stats(A)`` and ``stats(B)``, exact for exact (unscaled)
    statistics, O(m² + md)."""
    return base + delta


def downdate_stats(base: Stats, delta: Stats) -> Stats:
    """Remove a block's partial Stats, the inverse of :func:`fold_stats`
    (``downdate_stats(fold_stats(s, d), d) == s`` up to float addition).
    ``delta`` must be the statistics of a block folded in at the same
    hyper-parameters and inducing inputs."""
    return base - delta
