"""Streaming SLO accounting for the serving front-end, in constant memory.

The port's own copy of ``repro.serve.slo`` (numpy only; the port imports
nothing of ``repro``).  Two pieces:

  * :class:`QuantileSketch`: a geometric-bucket (HDR-style) histogram.
    Values land in buckets whose edges grow by ``1 + 2*rel_err``, so any
    quantile is answered with bounded *relative* error from a fixed-size
    ``int64`` count vector (~1.1k buckets at the 1 us - 10 min / 1%
    default).  Exact count/sum/min/max ride alongside; sketches with the
    same layout ``merge``.
  * :class:`SLOMetrics`: the per-request phase accounting the front-end
    feeds: **wait** (enqueue -> dispatch), **engine** (one entry per flush,
    the engine call's wall time), **e2e** (enqueue -> response), plus
    admission/SLO counters.  ``summary()`` renders the headline numbers
    (p50/p99 per phase, throughput vs goodput); ``snapshot()`` freezes a
    deep copy for offline diffing or merging across servers.

Nothing here imports torch: the accounting stays cheap enough to run in
the event loop between flushes.
"""
from __future__ import annotations

import copy
import math
import time

import numpy as np


class QuantileSketch:
    """Streaming quantiles over non-negative values in constant memory.

    Buckets are geometric: bucket k covers ``[low * g^k, low * g^(k+1))``
    with ``g = 1 + 2*rel_err``; reporting a bucket's geometric midpoint
    bounds the relative error of any in-range quantile by ``~rel_err``.
    Values below ``low`` (including exact zeros) land in an underflow
    bucket reported as the exact running min; values at or above ``high``
    land in an overflow bucket reported as the exact running max.
    """

    def __init__(self, low: float = 1e-6, high: float = 600.0,
                 rel_err: float = 0.01):
        if not 0.0 < low < high:
            raise ValueError(f"need 0 < low < high, got {low}, {high}")
        if not 0.0 < rel_err < 1.0:
            raise ValueError(f"rel_err must be in (0, 1), got {rel_err}")
        self.low, self.high, self.rel_err = float(low), float(high), float(rel_err)
        self._log_g = math.log1p(2.0 * rel_err)
        nbins = int(math.ceil(math.log(self.high / self.low) / self._log_g))
        # [0] underflow, [1..nbins] geometric, [-1] overflow
        self._counts = np.zeros(nbins + 2, dtype=np.int64)
        self._count = 0
        self._sum = 0.0
        self._min = math.inf
        self._max = -math.inf

    def add(self, value: float) -> None:
        v = float(value)
        if not math.isfinite(v) or v < 0.0:
            raise ValueError(f"sketch values must be finite and >= 0, got {v}")
        self._count += 1
        self._sum += v
        self._min = min(self._min, v)
        self._max = max(self._max, v)
        if v < self.low:
            idx = 0
        elif v >= self.high:
            idx = len(self._counts) - 1
        else:
            idx = 1 + int(math.log(v / self.low) / self._log_g)
            idx = min(idx, len(self._counts) - 2)   # fp edge at high
        self._counts[idx] += 1

    @property
    def count(self) -> int:
        return self._count

    @property
    def mean(self) -> float:
        return self._sum / self._count if self._count else math.nan

    @property
    def min(self) -> float:
        return self._min if self._count else math.nan

    @property
    def max(self) -> float:
        return self._max if self._count else math.nan

    def quantile(self, q: float) -> float:
        """Nearest-rank quantile with ``<= rel_err`` relative error (exact
        min/max for the under/overflow buckets); NaN when empty."""
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"quantile must be in [0, 1], got {q}")
        if self._count == 0:
            return math.nan
        rank = max(1, math.ceil(q * self._count))
        idx = int(np.searchsorted(np.cumsum(self._counts), rank))
        if idx == 0:
            return self._min
        if idx == len(self._counts) - 1:
            return self._max
        # geometric midpoint of bucket idx-1, clamped to the observed range
        rep = self.low * math.exp((idx - 0.5) * self._log_g)
        return min(max(rep, self._min), self._max)

    def merge(self, other: "QuantileSketch") -> "QuantileSketch":
        """Fold another sketch (same layout) into this one; returns self."""
        if (self.low, self.high, self.rel_err) != (other.low, other.high,
                                                   other.rel_err):
            raise ValueError("can only merge sketches with identical "
                             "(low, high, rel_err) layouts")
        self._counts += other._counts
        self._count += other._count
        self._sum += other._sum
        self._min = min(self._min, other._min)
        self._max = max(self._max, other._max)
        return self

    def summary(self) -> dict:
        return {"count": self.count, "mean": self.mean,
                "p50": self.quantile(0.50), "p99": self.quantile(0.99),
                "max": self.max}


_COUNTERS = ("submitted", "completed", "late", "rejected_queue_full",
             "expired", "cancelled", "flushes", "flushed_requests",
             "flushed_rows", "padded_rows")


class SLOMetrics:
    """Per-request serving accounting with constant memory.

    Counter semantics: every ``submitted`` (i.e. admitted) request ends as
    exactly one of ``completed`` (a ``late`` completion still completes — it
    missed its deadline *after* dispatch and is flagged, never dropped),
    ``expired`` (deadline passed before dispatch — the typed ``SLOExceeded``
    fail-fast), or ``cancelled``.  ``rejected_queue_full`` counts requests
    turned away at admission (never enqueued, so never ``submitted``).
    Goodput counts completions that met their deadline.
    """

    def __init__(self, low: float = 1e-6, high: float = 600.0,
                 rel_err: float = 0.01):
        self.wait = QuantileSketch(low, high, rel_err)
        self.engine = QuantileSketch(low, high, rel_err)
        self.e2e = QuantileSketch(low, high, rel_err)
        self.counters = dict.fromkeys(_COUNTERS, 0)
        self._t0 = time.monotonic()
        self._frozen_elapsed: float | None = None

    # -- the front-end's feed ----------------------------------------------
    def observe_admit(self) -> None:
        self.counters["submitted"] += 1

    def observe_reject_queue_full(self) -> None:
        self.counters["rejected_queue_full"] += 1

    def observe_expired(self) -> None:
        self.counters["expired"] += 1

    def observe_cancelled(self) -> None:
        self.counters["cancelled"] += 1

    def observe_wait(self, seconds: float) -> None:
        self.wait.add(seconds)

    def observe_flush(self, n_requests: int, rows: int, pad_rows: int,
                      engine_seconds: float) -> None:
        self.counters["flushes"] += 1
        self.counters["flushed_requests"] += n_requests
        self.counters["flushed_rows"] += rows
        self.counters["padded_rows"] += pad_rows
        self.engine.add(engine_seconds)

    def observe_complete(self, e2e_seconds: float, late: bool = False) -> None:
        self.counters["completed"] += 1
        self.counters["late"] += bool(late)
        self.e2e.add(e2e_seconds)

    # -- reading ------------------------------------------------------------
    @property
    def elapsed(self) -> float:
        if self._frozen_elapsed is not None:
            return self._frozen_elapsed
        return time.monotonic() - self._t0

    def snapshot(self) -> "SLOMetrics":
        """A frozen deep copy (sketches included): diff two snapshots for a
        window, or ``merge`` snapshots from several front-ends."""
        snap = copy.deepcopy(self)
        snap._frozen_elapsed = self.elapsed
        return snap

    def merge(self, other: "SLOMetrics") -> "SLOMetrics":
        """Fold another front-end's metrics into this one; returns self."""
        self.wait.merge(other.wait)
        self.engine.merge(other.engine)
        self.e2e.merge(other.e2e)
        for k in self.counters:
            self.counters[k] += other.counters[k]
        return self

    def summary(self) -> dict:
        """Headline numbers: per-phase count/mean/p50/p99/max (seconds),
        the raw counters, and derived throughput (completions/s), goodput
        (in-deadline completions/s), mean batch size, and pad waste."""
        c = self.counters
        el = max(self.elapsed, 1e-12)
        staged = c["flushed_rows"] + c["padded_rows"]
        return {
            "elapsed_s": self.elapsed,
            "counters": dict(c),
            "wait": self.wait.summary(),
            "engine": self.engine.summary(),
            "e2e": self.e2e.summary(),
            "throughput_rps": c["completed"] / el,
            "goodput_rps": (c["completed"] - c["late"]) / el,
            "mean_batch_requests": (c["flushed_requests"] / c["flushes"]
                                    if c["flushes"] else math.nan),
            "pad_fraction": c["padded_rows"] / staged if staged else 0.0,
        }
