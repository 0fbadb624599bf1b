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
statistic.  Counterpart of ``repro.core.stats``, with the minibatch (SVI)
mode (``batch_blocks``), the host-fed carry (``init=``) and the
overlapped reduce hook (``block_reduce_fn``) of
:func:`partial_stats_chunked`.  :func:`pack_stats` /
:func:`unpack_stats` flatten the Stats for the distributed reduce
(``core.distributed``).

Randomness: ``jax.random`` keys become CPU generators
(``torch.Generator``).  :func:`sample_block_indices` draws from one, and
:func:`fold_in` derives an independent generator from one and an integer,
as ``jax.random.fold_in`` derives a key.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
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
                  latent: bool = False, kernel=None, psi2_fn=None,
                  reg_stats_fn=None) -> Stats:
    """Shard-local statistics (the map function).

    ``s`` (n, q) are the q(X) variances, or None for regression.  The
    expression picks the route: the full-width SE-ARD map goes through the
    hand-written kernels on CUDA tensors and their plain versions on CPU
    ones (``kernels.reg_stats`` for regression, the psi kernels behind
    ``SEARD.psi1``/``psi2`` for the latent map, whose C is a plain matmul
    as in the JAX package); any other expression takes its own plain
    ``K``/``kdiag`` (:func:`reg_stats_dense`) and psi statistics on any
    device.  ``latent`` adds the KL of q(X).  The hooks replace the
    default accumulations and are expected to be bound to the expression:
    ``psi2_fn(hyp, z, mu, s, w) -> (m, m)`` (e.g.
    ``kernels.psi_stats.psi2_fn_for_engine(kernel=...)`` or
    ``gp_kernels.psi2_mxu``) and ``reg_stats_fn(hyp, z, x, y, w) -> (b, C,
    D)`` (e.g. ``kernels.reg_stats.reg_stats_fn_for_engine(kernel=...)``).
    """
    kernel = cov.as_kernel(kernel)
    n_k = y.shape[0]
    w = (torch.ones((n_k,), dtype=y.dtype, device=y.device) if weights is None
         else weights.to(y.dtype))
    a = (w * (y * y).sum(-1)).sum()
    if s is None:
        fn = (rs_ops.reg_stats_fn_for_engine(kernel=kernel)
              if reg_stats_fn is None else reg_stats_fn)
        b, c, d_stat = fn(hyp, z, mu, y, w)
        return Stats(A=a, B=b, C=c, D=d_stat, KL=torch.zeros_like(a),
                     n=w.sum())
    b = (w * kernel.psi0(hyp, mu, s)).sum()
    c = kernel.psi1(hyp, z, mu, s).T @ (w[:, None] * y)       # (m, d)
    d_stat = (kernel.psi2 if psi2_fn is None else psi2_fn)(hyp, z, mu, s, w)
    kl_i = 0.5 * (s + mu * mu - torch.log(s) - 1.0).sum(-1)
    kl = (w * kl_i).sum() if latent else torch.zeros_like(a)
    return Stats(A=a, B=b, C=c, D=d_stat, KL=kl, n=w.sum())


def zero_stats(m: int, d: int, dtype=torch.float64, device=None) -> Stats:
    """The additive identity of the Stats monoid."""
    zf = torch.zeros((), dtype=dtype, device=device)
    return Stats(A=zf, B=zf, C=torch.zeros((m, d), dtype=dtype, device=device),
                 D=torch.zeros((m, m), dtype=dtype, device=device), KL=zf, n=zf)


def fold_in(generator: torch.Generator, data: int) -> torch.Generator:
    """A new CPU generator seeded by one draw of ``generator`` mixed with
    ``data`` (``numpy.random.SeedSequence``): the counterpart of
    ``jax.random.fold_in``.  Two calls with the same generator state and
    ``data`` give generators of the same stream; other ``data`` give
    independent ones.  The draw advances ``generator``."""
    seed = int(torch.randint(0, 2**62, (1,), generator=generator))
    mixed = np.random.SeedSequence((seed, int(data))).generate_state(
        1, np.uint64)[0]
    return torch.Generator().manual_seed(int(mixed))


def sample_block_indices(generator: torch.Generator, n_blocks: int,
                         batch_blocks: int) -> torch.Tensor:
    """Uniform size-``batch_blocks`` subset of ``range(n_blocks)``, without
    replacement: the SVI block sampler.  Without replacement, the sum over
    the sampled blocks has expectation ``batch_blocks / n_blocks`` times the
    sum over all blocks, which makes the ``n_blocks / batch_blocks``
    reweighting of :func:`partial_stats_chunked` unbiased.  Returns
    ``(batch_blocks,)`` int64 indices on the CPU."""
    return torch.randperm(n_blocks, generator=generator)[:batch_blocks]


def partial_stats_chunked(hyp: dict, z, y, mu, s=None, weights=None,
                          latent: bool = False, block_size: int | None = 1024,
                          kernel=None, force_scan: bool = False,
                          batch_blocks: int | None = None,
                          generator: torch.Generator | None = None,
                          block_indices=None, init: Stats | None = None,
                          psi2_fn=None, reg_stats_fn=None,
                          block_reduce_fn=None,
                          reduce_buffered: bool = True) -> Stats:
    """Streaming map step: :func:`partial_stats` folded over row blocks.

    Exact mode: rows are padded up to a multiple of ``block_size`` with zero
    weight (q(X) variances with 1, log-safe for the KL) and every block's
    Stats are folded left to right into a constant-size accumulator, as the
    JAX package's ``lax.scan`` does, so peak memory is O(block_size * m) +
    O(m^2).  ``block_size=None`` (or ``n <= block_size``) computes the
    statistics in one piece; ``force_scan`` (the distributed engine's
    setting, as in the JAX package) folds even a single block into the
    accumulator.

    ``init``: the accumulator the fold starts from (default zero).  A host
    loop that threads ``init`` through consecutive row chunks adds the same
    bits, in the same order, as one call over all the rows: the streaming
    engine's bitwise contract (``core.distributed``).

    Minibatch (SVI) mode, ``batch_blocks``: only ``batch_blocks`` of the
    ``nb = ceil(n / block_size)`` blocks are folded, drawn without
    replacement from ``generator`` (:func:`sample_block_indices`) or given
    as ``block_indices`` (honoured even when ``batch_blocks >= nb``), and
    every field, ``n`` included, is scaled by ``nb / batch_blocks``: every
    Stats field is a sum over points, so the scaled Stats are unbiased for
    the exact ones.  Only the sampled blocks are read, so a call costs
    O(batch_blocks * block_size) whatever n is.  Without ``block_indices``,
    ``batch_blocks >= nb`` is the exact fold.

    ``psi2_fn``, ``reg_stats_fn``: :func:`partial_stats`' hooks, called
    once a block.

    ``block_reduce_fn``: the overlapped reduce.  Each block's raw Stats go
    through it as soon as the block is mapped, and the accumulator folds
    the reduced values left to right from zero, so the result is already
    reduced (callers must not reduce it again).  It returns the reduced
    Stats, or a zero-argument callable that returns them once a collective
    in flight completes (``core.distributed``'s async ``all_reduce``).
    ``reduce_buffered`` (default) resolves block t's reduce after block
    t+1 is mapped, so the collective rides behind the next block's map;
    False resolves it in its own block.  Both fold the same values in the
    same order, so they are bitwise equal.  Needs ``block_size``, forces
    the fold even for one block, refuses ``init`` (a prior carry is
    unreduced); under ``batch_blocks`` the ``nb / batch_blocks`` scale is
    applied to the reduced accumulator.
    """
    n_k = y.shape[0]
    if batch_blocks is not None:
        if block_size is None:
            raise ValueError(
                "batch_blocks (SVI mode) requires block_size: the minibatch "
                "is a subset of the streaming row blocks")
        if batch_blocks < 1:
            raise ValueError(f"batch_blocks must be >= 1, got {batch_blocks}")
        if init is not None:
            raise ValueError(
                "init cannot be combined with batch_blocks: the SVI "
                "reweighting scales the whole carry, prior chunks included")
    if block_reduce_fn is not None:
        if block_size is None:
            raise ValueError(
                "block_reduce_fn (overlapped reduce) requires block_size: "
                "the per-block collective needs blocks to hide behind")
        if init is not None:
            raise ValueError(
                "init cannot be combined with block_reduce_fn: a prior-"
                "chunk carry is shard-local, the overlapped carry is "
                "already reduced")
        force_scan = True
    if block_size is None or (n_k <= block_size and not force_scan):
        st = partial_stats(hyp, z, y, mu, s, weights=weights,
                           latent=latent, kernel=kernel, psi2_fn=psi2_fn,
                           reg_stats_fn=reg_stats_fn)
        return st if init is None else fold_stats(init, st)
    w = (torch.ones((n_k,), dtype=y.dtype, device=y.device) if weights is None
         else weights.to(y.dtype))
    nb = -(-n_k // block_size)

    def block(i):
        """Rows of block i, the ragged last one padded: the block the JAX
        package's padded (nb, block_size) view holds."""
        lo, hi = i * block_size, min((i + 1) * block_size, n_k)
        pad = block_size - (hi - lo)

        def take(t, value=0.0):
            if not pad:
                return t[lo:hi]
            return torch.cat([t[lo:hi], t.new_full((pad,) + t.shape[1:],
                                                   value)])
        return (take(y), take(mu), None if s is None else take(s, 1.0),
                take(w))

    order, scale = range(nb), 1.0
    if batch_blocks is not None and (batch_blocks < nb
                                     or block_indices is not None):
        if block_indices is None:
            if generator is None:
                raise ValueError("SVI mode needs a generator (or explicit "
                                 "block_indices)")
            block_indices = sample_block_indices(generator, nb, batch_blocks)
        idx = (block_indices if isinstance(block_indices, torch.Tensor)
               else torch.from_numpy(np.array(block_indices, np.int64)))
        if tuple(idx.shape) != (batch_blocks,):
            raise ValueError(f"block_indices must have shape "
                             f"({batch_blocks},), got {tuple(idx.shape)}")
        order, scale = [int(i) for i in idx.tolist()], nb / batch_blocks
    acc = (zero_stats(z.shape[0], y.shape[1], dtype=y.dtype, device=y.device)
           if init is None else init)
    pending = None   # the buffered reduce of the previous block
    for i in order:
        yb, mub, sb, wb = block(i)
        st = partial_stats(hyp, z, yb, mub, sb, weights=wb, latent=latent,
                           kernel=kernel, psi2_fn=psi2_fn,
                           reg_stats_fn=reg_stats_fn)
        if block_reduce_fn is None:
            acc = acc + st
            continue
        reduced = block_reduce_fn(st)
        if reduce_buffered:
            reduced, pending = pending, reduced
        if reduced is not None:
            acc = acc + _resolved(reduced)
    if pending is not None:
        acc = acc + _resolved(pending)
    return acc.scale(scale) if scale != 1.0 else acc


def _resolved(reduced) -> Stats:
    """A ``block_reduce_fn`` result: Stats, or a callable that waits for
    them."""
    return reduced() if callable(reduced) else reduced


def reduce_stats(parts: list[Stats]) -> Stats:
    """Sequential reduce (the single-host analogue of the paper's reduce)."""
    out = parts[0]
    for p in parts[1:]:
        out = out + p
    return out


def pack_stats(st: Stats) -> torch.Tensor:
    """The Stats as one flat buffer ``(A, B, KL, n, C, D)`` of m² + m·d + 4
    numbers: what the distributed reduce sums in one ``all_reduce``."""
    return torch.cat([torch.stack([st.A, st.B, st.KL, st.n]),
                      st.C.reshape(-1), st.D.reshape(-1)])


def unpack_stats(buf: torch.Tensor, m: int, d: int) -> Stats:
    """Inverse of :func:`pack_stats` (views of ``buf``)."""
    return Stats(A=buf[0], B=buf[1], KL=buf[2], n=buf[3],
                 C=buf[4:4 + m * d].reshape(m, d),
                 D=buf[4 + m * d:].reshape(m, m))


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
