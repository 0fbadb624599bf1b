"""Fault tolerance and straggler instrumentation (paper §5): copy of
``repro.distributed.fault``.

The paper's robustness mechanism: when a node fails mid-iteration, drop its
partial term and take a noisy gradient rather than stall the iteration
(their fig. 7).

  * ``FailureSimulator`` draws per-shard failure masks at the paper's
    failure frequencies (0/1/2% per iteration).  It stays numpy, so one
    seed gives the same masks here and in the JAX package, and every rank
    of a process group that seeds it alike draws the same mask: the port's
    form of JAX's replicated ``fmask`` argument.
  * ``apply_gradient_masking`` implements drop (paper) and rescale
    (beyond-paper, n/n_live reweighting) for gradient shards: nested dicts
    of tensors (or arrays).
  * ``StepTimer`` records per-shard wall times -> min/mean/max load
    distribution (their fig. 5) and a straggler ratio.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np


class FailureSimulator:
    """Bernoulli node-failure process at ``rate`` per iteration per node.

    ``dtype`` is the mask dtype (default float64).  The distributed engine
    folds the mask into the per-row weights, so callers running an f32
    weight path should request ``dtype=np.float32`` explicitly rather
    than rely on an implicit downcast at the fold.
    """

    def __init__(self, n_shards: int, rate: float, seed: int = 0,
                 dtype=np.float64):
        self.n_shards = n_shards
        self.rate = rate
        self.dtype = np.dtype(dtype)
        self._rng = np.random.default_rng(seed)

    def mask(self) -> np.ndarray:
        """1.0 = alive, 0.0 = failed this iteration.  At least one shard
        is always alive, even at ``rate=1.0`` (a fully-dead iteration has
        no statistics to reduce)."""
        alive = self._rng.uniform(size=self.n_shards) >= self.rate
        if not alive.any():          # never lose every shard
            alive[self._rng.integers(self.n_shards)] = True
        return alive.astype(self.dtype)


def _tree_map(fn, *trees):
    """``fn`` over the leaves of nested dicts of one structure."""
    if isinstance(trees[0], dict):
        return {k: _tree_map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def apply_gradient_masking(grad_shards: list, mask: np.ndarray,
                           mode: str = "drop", rows=None):
    """Combine per-shard gradients under failures.

    grad_shards: list of nested dicts of tensors or arrays (one per shard);
      returns the summed tree.
    rows: per-shard live row counts (len == len(grad_shards)).  None
      assumes equal-sized shards.
    drop    — paper: sum surviving shards (noisy gradient).
    rescale — beyond-paper: scale by n/n_live, the ROW-count ratio, the
      factor ``core.distributed``'s rescale uses.  With ``rows`` omitted
      the shards are assumed equal-sized, where the row ratio reduces to
      the shard-count ratio; pass ``rows`` whenever shards are ragged,
      otherwise the rescale is biased.
    """
    alive = [g for g, m in zip(grad_shards, mask) if m > 0]
    if not alive:
        raise ValueError("all shards masked dead: nothing to combine")
    total = _tree_map(lambda *xs: sum(xs), *alive)
    if mode == "rescale":
        if rows is None:
            c = len(grad_shards) / len(alive)
        else:
            rows = np.asarray(rows, np.float64)
            if rows.shape != (len(grad_shards),):
                raise ValueError(
                    f"rows must have shape ({len(grad_shards)},), "
                    f"got {rows.shape}")
            n_live = float(sum(r for r, m in zip(rows, mask) if m > 0))
            c = float(rows.sum()) / n_live
        total = _tree_map(lambda x: x * c, total)
    return total


@dataclass
class StepTimer:
    """Per-shard timing -> the paper's fig. 5 load-distribution metrics."""

    records: list = field(default_factory=list)

    def record(self, shard_times: list[float]):
        """Append one iteration's per-shard wall times.  Iterations may
        record different shard counts (elastic membership); an empty
        iteration is rejected: it has no min/mean/max."""
        times = list(shard_times)
        if not times:
            raise ValueError(
                "record() needs at least one shard time: an iteration "
                "with no live shards has no load distribution")
        self.records.append(times)

    def summary(self) -> dict:
        # Per-row (per-iteration) reduces: rows may be ragged.
        if not self.records:
            return {}
        mins = np.array([min(r) for r in self.records])
        means = np.array([sum(r) / len(r) for r in self.records])
        maxs = np.array([max(r) for r in self.records])
        return {
            "min": float(mins.mean()),
            "mean": float(means.mean()),
            "max": float(maxs.mean()),
            # rate-limiting overhead: how much the slowest shard exceeds
            # the mean (paper reports 3.7%)
            "straggler_overhead": float(
                (maxs / np.maximum(means, 1e-12) - 1.0).mean()),
        }

    def time_shards(self, fns: list):
        """Run shard thunks sequentially, recording wall time of each
        (single-host simulation of the paper's per-thread measurement)."""
        times = []
        outs = []
        for fn in fns:
            t0 = time.perf_counter()
            outs.append(fn())
            times.append(time.perf_counter() - t0)
        self.record(times)
        return outs
