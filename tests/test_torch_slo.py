"""The port's constant-memory SLO accounting (``serve.slo``: its own copy of
the numpy-only ``repro.serve.slo``) against the JAX package.

The same observations go into both packages' ``QuantileSketch`` and
``SLOMetrics``; every summary number that does not read the clock (the
counters, each phase's count/mean/p50/p99/max, the mean batch size and
the pad fraction) must be equal, not merely close.  The cases of
``tests/test_slo.py`` then run on the port: bounded relative error of the
sketch, exact moments and edges, merge, counter conservation, snapshots.
"""
import math

import numpy as np
import pytest

from repro.serve import slo as j_slo
from repro_torch.serve import QuantileSketch, SLOMetrics
from repro_torch.serve import slo as t_slo

CLOCKED = ("elapsed_s", "throughput_rps", "goodput_rps")


def _feed(metrics, rng):
    """A front-end's worth of observations, from ``rng``."""
    for _ in range(40):
        metrics.observe_admit()
    for _ in range(3):
        metrics.observe_reject_queue_full()
    for w in rng.lognormal(-6.0, 1.0, 30):
        metrics.observe_wait(w)
    for n, rows, pad, e in zip(rng.integers(1, 9, 6), rng.integers(8, 200, 6),
                               rng.integers(0, 8, 6),
                               rng.lognormal(-7.0, 0.5, 6)):
        metrics.observe_flush(int(n), int(rows), int(pad), float(e))
    for k, e2e in enumerate(rng.lognormal(-5.0, 1.0, 34)):
        metrics.observe_complete(e2e, late=k % 7 == 0)
    for _ in range(4):
        metrics.observe_expired()
    for _ in range(2):
        metrics.observe_cancelled()
    return metrics


def _unclocked(summary):
    return {k: v for k, v in summary.items() if k not in CLOCKED}


@pytest.mark.parametrize("low,high,rel_err", [(1e-6, 600.0, 0.01),
                                              (1e-3, 1.0, 0.05)])
def test_sketch_summary_equals_jax(low, high, rel_err):
    rng = np.random.default_rng(0)
    vals = np.concatenate([rng.lognormal(-4.0, 2.0, 5000), [0.0, 1e-9, 7e3]])
    got, want = (mod.QuantileSketch(low, high, rel_err) for mod in (t_slo,
                                                                    j_slo))
    for v in vals:
        got.add(v)
        want.add(v)
    assert got.summary() == want.summary()
    for q in (0.0, 0.1, 0.5, 0.9, 0.99, 1.0):
        assert got.quantile(q) == want.quantile(q)
    np.testing.assert_array_equal(got._counts, want._counts)


def test_metrics_summary_equals_jax():
    got = _feed(t_slo.SLOMetrics(), np.random.default_rng(1))
    want = _feed(j_slo.SLOMetrics(), np.random.default_rng(1))
    assert _unclocked(got.summary()) == _unclocked(want.summary())
    merged = got.snapshot().merge(_feed(t_slo.SLOMetrics(),
                                        np.random.default_rng(2)))
    merged_ref = want.snapshot().merge(_feed(j_slo.SLOMetrics(),
                                             np.random.default_rng(2)))
    assert _unclocked(merged.summary()) == _unclocked(merged_ref.summary())


# -- the reference's cases, on the port ----------------------------------------------

def test_sketch_quantiles_within_relative_error(rng):
    """p50/p90/p99 of a lognormal stream against np.percentile: relative
    error within the bucket width (plus nearest-rank slack)."""
    vals = rng.lognormal(mean=-4.0, sigma=1.0, size=20_000)
    sk = QuantileSketch(low=1e-6, high=600.0, rel_err=0.01)
    for v in vals:
        sk.add(v)
    for q in (0.5, 0.9, 0.99):
        exact = float(np.percentile(vals, 100 * q))
        assert abs(sk.quantile(q) - exact) / exact < 0.03, q


def test_sketch_exact_moments_and_edges(rng):
    vals = rng.uniform(1e-4, 1.0, size=500)
    sk = QuantileSketch()
    for v in vals:
        sk.add(v)
    assert sk.count == 500
    np.testing.assert_allclose(sk.mean, vals.mean(), rtol=1e-12)
    assert sk.min == vals.min() and sk.max == vals.max()
    assert sk.quantile(0.0) == vals.min()
    assert sk.quantile(1.0) <= vals.max()
    assert sk.quantile(1.0) >= vals.max() * (1 - 2 * sk.rel_err)


def test_sketch_empty_and_invalid():
    sk = QuantileSketch()
    assert sk.count == 0
    assert math.isnan(sk.quantile(0.5)) and math.isnan(sk.mean)
    assert math.isnan(sk.min) and math.isnan(sk.max)
    with pytest.raises(ValueError, match="finite"):
        sk.add(-1.0)
    with pytest.raises(ValueError, match="finite"):
        sk.add(math.nan)
    with pytest.raises(ValueError, match="quantile"):
        sk.quantile(1.5)
    with pytest.raises(ValueError, match="low < high"):
        QuantileSketch(low=1.0, high=0.5)
    with pytest.raises(ValueError, match="rel_err"):
        QuantileSketch(rel_err=1.5)


def test_sketch_under_and_overflow_buckets():
    """Values outside [low, high) land in edge buckets reported as the
    exact running min/max."""
    sk = QuantileSketch(low=1e-3, high=1.0)
    for v in (0.0, 1e-9, 5.0, 7.0):
        sk.add(v)
    assert sk.quantile(0.25) == 0.0
    assert sk.quantile(1.0) == 7.0
    assert sk.count == 4


def test_sketch_merge_equals_combined(rng):
    a_vals = rng.lognormal(-3.0, 0.7, size=3_000)
    b_vals = rng.lognormal(-2.0, 0.7, size=5_000)
    a, b, both = QuantileSketch(), QuantileSketch(), QuantileSketch()
    for v in a_vals:
        a.add(v)
        both.add(v)
    for v in b_vals:
        b.add(v)
        both.add(v)
    assert a.merge(b) is a
    assert a.count == both.count and a.max == both.max
    np.testing.assert_allclose(a.mean, both.mean, rtol=1e-12)
    for q in (0.5, 0.99):
        assert a.quantile(q) == both.quantile(q)
    with pytest.raises(ValueError, match="identical"):
        a.merge(QuantileSketch(rel_err=0.05))


def test_metrics_counter_conservation():
    """submitted == completed + expired + cancelled once every request is
    terminal; rejected requests never count as submitted."""
    m = SLOMetrics()
    for _ in range(6):
        m.observe_admit()
    m.observe_reject_queue_full()
    m.observe_wait(0.002)
    m.observe_flush(n_requests=3, rows=24, pad_rows=8, engine_seconds=0.001)
    for late in (False, False, True):
        m.observe_complete(0.004, late=late)
    m.observe_expired()
    m.observe_expired()
    m.observe_cancelled()
    c = m.summary()["counters"]
    assert c["submitted"] == 6
    assert c["completed"] + c["expired"] + c["cancelled"] == 6
    assert c["late"] == 1 and c["rejected_queue_full"] == 1
    assert c["flushes"] == 1 and c["flushed_rows"] == 24


def test_metrics_summary_derived_numbers():
    m = SLOMetrics()
    for _ in range(4):
        m.observe_admit()
    m.observe_flush(n_requests=4, rows=30, pad_rows=2, engine_seconds=0.003)
    for _ in range(4):
        m.observe_complete(0.01, late=False)
    s = m.snapshot().summary()
    assert s["mean_batch_requests"] == 4.0
    np.testing.assert_allclose(s["pad_fraction"], 2 / 32)
    np.testing.assert_allclose(s["goodput_rps"] * s["elapsed_s"], 4.0,
                               rtol=1e-9)
    assert s["throughput_rps"] == s["goodput_rps"]
    assert s["engine"]["count"] == 1 and s["e2e"]["count"] == 4


def test_metrics_snapshot_is_frozen_and_independent():
    m = SLOMetrics()
    m.observe_admit()
    m.observe_complete(0.5)
    snap = m.snapshot()
    el = snap.elapsed
    m.observe_admit()
    m.observe_complete(0.7)
    assert snap.elapsed == el
    assert snap.counters["completed"] == 1
    assert m.counters["completed"] == 2
    assert snap.e2e.count == 1 and m.e2e.count == 2


def test_metrics_merge_across_frontends():
    a, b = SLOMetrics(), SLOMetrics()
    for m, n in ((a, 3), (b, 5)):
        for _ in range(n):
            m.observe_admit()
            m.observe_complete(0.01)
    a.merge(b)
    assert a.counters["submitted"] == 8 and a.e2e.count == 8
