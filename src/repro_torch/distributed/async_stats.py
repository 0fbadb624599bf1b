"""Asynchronous stale-update accumulation for the Map-Reduce bound:
counterpart of ``repro.distributed.async_stats``.

The paper's reduce is a barrier: every shard's partial Stats must arrive
before the global step runs.  But the statistics are a plain sum over
points, so the reduce tolerates *stale* contributions: keep each shard's
latest partial Stats in an accumulator and let the global step fold
whatever is there; shards refresh on their own schedule, and stragglers
and failed nodes leave old (or no) contributions behind.  This is the
Peng et al. 2017 asynchronous distributed variational GP (PAPERS.md) on
Gal et al.'s collapsed-bound statistics.

  * :class:`AsyncStatsAccumulator`: the bookkeeping.  Each member shard
    holds one (Stats, stamp, rows) entry, and a running total is kept with
    ``stats.fold_stats`` / ``downdate_stats`` (O(m² + md) a push or leave,
    never a rescan of the members).  A read evicts entries older than the
    staleness bound S and reweights what is left so that its expectation
    is the exact Stats:

      - ``"drop"``: paper §5.2, the surviving sums as they are (noisy);
      - ``"rescale"``: the row ratio n / n_live (the factor of the engine's
        ``failure_mode="rescale"`` and of ``fault.apply_gradient_masking``);
      - ``"probs"``: Horvitz–Thompson, shard k's contribution scaled by
        1 / p_k at push time, p_k its probability of being present, so the
        fold is unbiased over the presence distribution.

    The accumulator is plain tensor adds and scales: autograd runs through
    push and read.

  * :class:`AsyncEngine`: a barrier-free step over K shards held on one
    device, one after another (the reference's single-host simulation).
    Each step refreshes only ``refresh`` alive shards (round-robin; a
    ``fault.FailureSimulator`` vetoes dead ones), folds the rest stale, and
    takes the gradient through the Stats' cotangent: the bound of the
    folded Stats, taken as leaves, gives dF/dS and the direct dF/d(hyp, z)
    (O(m³)); each refreshed shard pulls dF/dS back through its own map
    (``torch.autograd.grad`` with ``grad_outputs``, through the kernels'
    ``autograd.Function``s), and the other members reuse the part they
    pulled back at their last refresh (the stale-gradient scheme).  The map
    costs O(refresh · n_k m²) a step instead of O(K · n_k m²).  Where the
    reference recomputes a refreshed shard's map for the pull-back, the
    port keeps the graph of the map its push ran (the same (hyp, z), the
    same values) and pulls back through it.
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from .._device import as_f64, resolve_device
from ..core import covariance as cov
from ..core.bound import collapsed_bound
from ..core.distributed import DistributedGP, _grads, _leaf
from ..core.flat import tree_items, tree_leaves, tree_map, tree_unflatten
from ..core.stats import (Stats, downdate_stats, fold_in, fold_stats,
                          partial_stats_chunked)


@dataclass
class _Entry:
    stats: Stats          # as folded into the running total (probs: pre-scaled)
    stamp: int
    rows: float
    prob: float


class AsyncStatsAccumulator:
    """Barrier-free Stats accumulator with bounded staleness and
    reweighting.

    Args:
      staleness: the bound S: a :meth:`read` at stamp t evicts the entries
        with ``stamp < t - S`` (downdated from the running total; the shard
        may push again).  ``S=0`` keeps only contributions pushed at the
        read stamp itself.
      reweight: ``"drop"``, ``"rescale"`` or ``"probs"`` (module
        docstring).

    Membership is elastic: :meth:`push` with a new shard id joins it,
    :meth:`leave` downdates its contribution and removes it, each one
    ``fold_stats`` / ``downdate_stats`` on the running total.
    """

    def __init__(self, staleness: int = 1, reweight: str = "drop"):
        if staleness < 0:
            raise ValueError(f"staleness must be >= 0, got {staleness}")
        if reweight not in ("drop", "rescale", "probs"):
            raise ValueError(
                f"reweight must be 'drop', 'rescale' or 'probs', got {reweight!r}")
        self.staleness = staleness
        self.reweight = reweight
        self._entries: dict[Any, _Entry] = {}
        self._total: Stats | None = None

    # -- membership ---------------------------------------------------------
    def members(self) -> list:
        return list(self._entries)

    def __contains__(self, shard) -> bool:
        return shard in self._entries

    def __len__(self) -> int:
        return len(self._entries)

    def _fold(self, st: Stats):
        self._total = st if self._total is None else fold_stats(self._total, st)

    def _downdate(self, st: Stats):
        self._total = downdate_stats(self._total, st)

    def push(self, shard, stats: Stats, *, stamp: int, rows: float | None = None,
             prob: float = 1.0):
        """Replace ``shard``'s contribution (joining it if new).

        ``rows``: the live row count behind it (default ``stats.n``, right
        for an exact map; pass it for SVI-reweighted Stats, whose ``n`` is
        an estimate).  ``prob``: the presence probability of
        ``reweight="probs"``; the contribution is folded scaled by 1 / prob,
        so the running total is the Horvitz–Thompson estimator at all times.
        """
        if rows is None:
            rows = float(stats.n)
        if not (0.0 < prob <= 1.0):
            raise ValueError(f"prob must be in (0, 1], got {prob}")
        if self.reweight == "probs" and prob != 1.0:
            stats = stats.scale(1.0 / prob)
        old = self._entries.get(shard)
        if old is not None:
            self._downdate(old.stats)
        self._entries[shard] = _Entry(stats, int(stamp), float(rows), prob)
        self._fold(stats)

    def leave(self, shard):
        """Elastic departure: downdate the shard's contribution, drop it."""
        entry = self._entries.pop(shard, None)
        if entry is not None:
            self._downdate(entry.stats)

    # -- read ----------------------------------------------------------------
    def evict_stale(self, stamp: int) -> list:
        """Downdate the entries older than the staleness bound at
        ``stamp``.  Never empties the accumulator: if every entry has
        expired, the freshest stamp's entries stay (a fold of nothing has
        no gradient).  Returns the evicted ids."""
        cut = stamp - self.staleness
        expired = [k for k, e in self._entries.items() if e.stamp < cut]
        if expired and len(expired) == len(self._entries):
            newest = max(e.stamp for e in self._entries.values())
            expired = [k for k in expired
                       if self._entries[k].stamp < newest]
        for k in expired:
            self.leave(k)
        return expired

    def rows_live(self) -> float:
        return sum(e.rows for e in self._entries.values())

    def read(self, stamp: int, n_rows: float | None = None) -> Stats:
        """The reweighted fold of every fresh-enough contribution, after
        evicting the stale ones.  ``reweight="rescale"`` needs ``n_rows``
        (the full row count): the sums are scaled by ``n_rows / rows_live``
        and ``n`` set to ``n_rows``, as the engine's rescale does.  The
        other modes return the (HT-weighted) running total as it is."""
        self.evict_stale(stamp)
        if not self._entries:
            raise ValueError("read on an empty accumulator: no shard has "
                             "pushed a contribution yet")
        total = self._total
        if self.reweight == "rescale":
            if n_rows is None:
                raise ValueError("reweight='rescale' needs n_rows (the "
                                 "full-data row count) at read time")
            f = n_rows / self.rows_live()
            total = Stats(A=total.A * f, B=total.B * f, C=total.C * f,
                          D=total.D * f, KL=total.KL * f,
                          n=torch.as_tensor(n_rows, dtype=total.n.dtype,
                                            device=total.n.device))
        return total


def _rows(shard) -> float:
    """A shard's live rows: its weights' sum, or its row count."""
    w = shard.get("w")
    if w is None:
        return float(shard["y"].shape[0])
    return float(w.sum()) if isinstance(w, torch.Tensor) else float(np.sum(w))


class AsyncEngine:
    """Barrier-free async training step over K shards on one device.

    Args:
      shards: per-shard dicts ``{"y": (n_k, d), "mu": (n_k, q), optional
        "s": (n_k, q), optional "w": (n_k,)}`` of arrays or tensors, ragged
        row counts allowed (what elastic membership produces); moved to
        ``device`` in f64.
      d: output dimension.
      staleness / reweight: the accumulator's policy (S; drop, rescale or
        probs).
      refresh: shards refreshed a step (round-robin over the alive ones).
      failure: optional ``fault.FailureSimulator``: a dead shard skips its
        refresh slot (its last contribution goes stale and is evicted; it
        is folded again when it comes back).
      timer: optional ``fault.StepTimer``: each step records the refreshed
        shards' wall times (the card synchronised after each).
      chunk_size: each shard's map folds its rows in blocks of this many
        (None: one piece).
      batch_blocks: each refreshed shard's SVI block subsample (needs
        ``chunk_size``); pass a ``draw`` to :meth:`step`.
      latent / kernel: as on ``DistributedGP``.
      clip: optional bound on the returned gradient's global norm.  Folds
        that mix Stats of different (hyp, z) can break the bound's Nyström
        residual positivity for a while and blow up the raw gradient (a
        real failure mode of stale updates); for plain SGD set ``clip`` to
        about the exact gradient's norm.  ``None`` returns the raw
        gradient.
      device: where the shards live and the maps run (default the card;
        ``"cpu"`` runs the plain versions).

    ``step(hyp, z, draw=None)`` returns ``(neg_bound, (g_hyp, g_z))`` of the
    folded (partly stale) Stats.  ``draw`` (SVI) is a ``torch.Generator``,
    from which refreshed shard k takes ``stats.fold_in(draw, k)`` (JAX's
    ``fold_in(key, k)``), or a dict of each shard's explicit
    ``(batch_blocks,)`` block indices.  :meth:`exact_value_and_grad` is the
    all-fresh reference.
    """

    def __init__(self, shards, d: int, *, staleness: int = 2,
                 reweight: str = "drop", refresh: int = 1,
                 failure=None, timer=None, chunk_size: int | None = None,
                 batch_blocks: int | None = None, latent: bool = False,
                 kernel=None, clip: float | None = None, device=None):
        if refresh < 1:
            raise ValueError(f"refresh must be >= 1, got {refresh}")
        if clip is not None and not clip > 0:
            raise ValueError(f"clip must be positive, got {clip}")
        self.device = resolve_device(device)
        shards = list(shards)
        self._shard_rows = [_rows(sh) for sh in shards]
        self.shards = [{k: as_f64(v, self.device) for k, v in sh.items()
                        if v is not None} for sh in shards]
        self.d = d
        self.refresh = refresh
        self.failure = failure
        self.timer = timer
        self.chunk_size = chunk_size
        self.batch_blocks = batch_blocks
        self.latent = latent
        self.clip = clip
        self.kernel = cov.as_kernel(kernel)
        self.acc = AsyncStatsAccumulator(staleness=staleness, reweight=reweight)
        self.n_full = float(sum(self._shard_rows))
        self._grads: dict[int, Any] = {}   # shard -> (g_hyp, g_z) at its last ct
        self._rr = itertools.cycle(range(len(self.shards)))
        self._step = 0

    # -- the pieces ----------------------------------------------------------
    def _local_stats(self, hyp, z, sh, draw=None, exact=False) -> Stats:
        """A shard's map: the exact fold, or under ``batch_blocks`` the SVI
        fold of ``draw`` (a generator or block indices)."""
        svi = self.batch_blocks is not None and not exact
        gen = draw if svi and isinstance(draw, torch.Generator) else None
        idx = draw if svi and gen is None else None
        return partial_stats_chunked(
            hyp, z, sh["y"], sh["mu"], sh.get("s"), weights=sh.get("w"),
            latent=self.latent, block_size=self.chunk_size,
            kernel=self.kernel, batch_blocks=None if not svi
            else self.batch_blocks, generator=gen, block_indices=idx)

    def _collapse_vg(self, hyp, z, st: Stats):
        """The negative bound of ``st`` taken as leaves: ``(value, (g_hyp,
        g_z, ct))``, ct = d(-F)/dS.  The Stats' own ``n`` enters the bound:
        drop's is the sum over the live contributions (the bound of the
        present subset), rescale and probs set it at read and push.  NaN
        where the Cholesky fails, as in the JAX package."""
        hyp, z = _leaf(hyp, True), _leaf(z, True)
        paths, leaves = zip(*tree_items(hyp))
        st = Stats(*(t.detach().requires_grad_() for t in st))
        inputs = [*leaves, z, *st]
        try:
            with torch.enable_grad():
                neg = -collapsed_bound(hyp, z, st, self.d, kernel=self.kernel)
                grads = _grads([neg], inputs)
        except torch.linalg.LinAlgError:
            neg = torch.full((), float("nan"), dtype=z.dtype, device=z.device)
            grads = [torch.full_like(t, float("nan")) for t in inputs]
        k = len(leaves)
        return neg.detach(), (tree_unflatten(paths, grads[:k]), grads[k],
                              Stats(*grads[k + 1:]))

    @staticmethod
    def _pulled(local: Stats, ct: Stats, paths, theta):
        """ct pulled back through a shard's map: ``(g_hyp, g_z)``."""
        g = DistributedGP._pull(local, ct, theta)
        return tree_unflatten(paths, g[:-1]), g[-1]

    # -- the async step ------------------------------------------------------
    def _alive(self):
        if self.failure is None:
            return [True] * len(self.shards)
        return [m > 0 for m in self.failure.mask()]

    def _pick_refresh(self, alive) -> list[int]:
        picked, seen = [], 0
        while len(picked) < self.refresh and seen < len(self.shards):
            k = next(self._rr)
            seen += 1
            if alive[k] and k not in picked:
                picked.append(k)
        return picked

    @staticmethod
    def _shard_draw(draw, k: int):
        if draw is None:
            return None
        if isinstance(draw, torch.Generator):
            return fold_in(draw, k)
        return draw[k]

    def _push_shard(self, k: int, stamp: int, hyp, z, draw) -> Stats:
        """Map shard k at (hyp, z) with its graph, push the detached Stats;
        returns the Stats with their graph for the pull-back."""
        with torch.enable_grad():
            st = self._local_stats(hyp, z, self.shards[k],
                                   self._shard_draw(draw, k))
        self.acc.push(k, Stats(*(t.detach() for t in st)), stamp=stamp,
                      rows=self._shard_rows[k])
        if self.timer is not None and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)   # the shard's own time
        return st

    def step(self, hyp, z, draw=None):
        """One barrier-free step at (hyp, z): ``(neg_bound, (g_hyp, g_z))``
        of the folded Stats, ``refresh`` shards fresh and the rest stale by
        at most S steps (older ones evicted)."""
        self.hyp, self.z = hyp, z
        t = self._step
        self._step += 1
        picked = self._pick_refresh(self._alive())
        h, zz = _leaf(hyp, True), _leaf(z, True)
        paths, leaves = zip(*tree_items(h))
        theta = [*leaves, zz]

        graphs = {}
        thunks = [lambda k=k: graphs.__setitem__(
            k, self._push_shard(k, t, h, zz, draw)) for k in picked]
        if self.timer is not None and thunks:
            self.timer.time_shards(thunks)
        else:
            for fn in thunks:
                fn()

        st = self.acc.read(t, n_rows=self.n_full)
        val, (gh_d, gz_d, ct) = self._collapse_vg(hyp, z, st)
        # The refreshed shards' parts at the CURRENT cotangent; the other
        # members reuse the part pulled back at their last refresh.
        for k in picked:
            self._grads[k] = self._pulled(graphs.pop(k), ct, paths, theta)
        gsum = None
        for k in [k for k in self.acc.members() if k in self._grads]:
            gsum = self._grads[k] if gsum is None else (
                tree_map(torch.add, gsum[0], self._grads[k][0]),
                gsum[1] + self._grads[k][1])
        if gsum is not None:
            if self.acc.reweight == "rescale":
                f = self.n_full / self.acc.rows_live()
                gsum = (tree_map(lambda g: g * f, gsum[0]), gsum[1] * f)
            # ct is d(-F)/dS: the pulled parts carry the sign already.
            gh_d = tree_map(torch.add, gh_d, gsum[0])
            gz_d = gz_d + gsum[1]
        if self.clip is not None:
            # Global-norm clipping bounds each step's motion, and with it
            # the (hyp, z) span of the staleness window: the standard
            # stale-gradient stabiliser.
            gn = torch.sqrt(sum((g * g).sum()
                                for g in [*tree_leaves(gh_d), gz_d]))
            c = torch.clamp(self.clip / (gn + 1e-30), max=1.0)
            gh_d = tree_map(lambda g: g * c, gh_d)
            gz_d = gz_d * c
        return val, (gh_d, gz_d)

    # -- reference -----------------------------------------------------------
    def exact_value_and_grad(self, hyp, z):
        """The all-fresh (synchronous) value and gradient over every shard,
        bypassing the accumulator: what the async step converges to when
        ``refresh >= K`` and S covers the round."""
        h, zz = _leaf(hyp, True), _leaf(z, True)
        paths, leaves = zip(*tree_items(h))
        theta = [*leaves, zz]
        with torch.enable_grad():
            locals_ = [self._local_stats(h, zz, sh, exact=True)
                       for sh in self.shards]
        total = None
        for st in locals_:
            st = Stats(*(t.detach() for t in st))
            total = st if total is None else fold_stats(total, st)
        val, (gh, gz, ct) = self._collapse_vg(hyp, z, total)
        for local in locals_:
            g_h, g_z = self._pulled(local, ct, paths, theta)
            gh = tree_map(torch.add, gh, g_h)
            gz = gz + g_z
        return val, (gh, gz)
