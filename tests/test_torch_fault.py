"""The port's fault tools (``repro_torch.distributed.fault``) against the JAX
package's (``repro.distributed.fault``), case for case with
``tests/test_fault.py``: the same failure masks for one seed (bitwise),
drop and rescale over nested dicts of tensors, and the ``StepTimer``
summary, ragged records included."""
import numpy as np
import pytest
import torch

from repro.distributed import fault as jfault
from repro_torch.distributed.fault import (FailureSimulator, StepTimer,
                                           apply_gradient_masking)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("rate", [0.0, 0.01, 0.5, 1.0])
def test_masks_bitwise_equal_to_jax_for_one_seed(rate, dtype):
    for seed in (0, 3, 7):
        ours = FailureSimulator(6, rate, seed=seed, dtype=dtype)
        ref = jfault.FailureSimulator(6, rate, seed=seed, dtype=dtype)
        for _ in range(50):
            m, r = ours.mask(), ref.mask()
            assert m.dtype == r.dtype == np.dtype(dtype)
            np.testing.assert_array_equal(m, r)
            assert m.sum() >= 1.0


@pytest.mark.parametrize("rate", [0.0, 0.3, 1.0])
def test_mask_never_all_dead(rate):
    sim = FailureSimulator(n_shards=6, rate=rate, seed=0)
    for _ in range(50):
        m = sim.mask()
        assert m.shape == (6,) and m.dtype == np.float64
        assert set(np.unique(m)) <= {0.0, 1.0}
        assert m.sum() >= 1.0
    if rate == 0.0:
        assert sim.mask().sum() == 6.0
    if rate == 1.0:
        assert sim.mask().sum() == 1.0


def _grad_shards(rng, n_shards=5):
    """(torch shards, the same values as numpy shards for the reference):
    nested dicts, as the engine's hyp gradients are."""
    np_shards = [{"hyp": {"log_ell": rng.standard_normal(4),
                          "log_sf2": rng.standard_normal(())},
                  "z": rng.standard_normal((3, 2))} for _ in range(n_shards)]

    def to_t(t):
        return ({k: to_t(v) for k, v in t.items()} if isinstance(t, dict)
                else torch.from_numpy(np.asarray(t)))
    return [to_t(s) for s in np_shards], np_shards


def _leaves(tree):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k])
    else:
        yield np.asarray(tree)


def _assert_close(got, want, rtol=1e-12):
    got, want = list(_leaves(got)), list(_leaves(want))
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, rtol=rtol, atol=0)


@pytest.mark.parametrize("mode", ["drop", "rescale"])
@pytest.mark.parametrize("rows", [None, np.array([8.0, 8.0, 8.0, 8.0, 3.0])])
def test_masking_matches_jax(rng, mode, rows):
    shards, np_shards = _grad_shards(rng)
    mask = np.array([1.0, 0.0, 1.0, 1.0, 0.0])
    out = apply_gradient_masking(shards, mask, mode=mode, rows=rows)
    ref = jfault.apply_gradient_masking(np_shards, mask, mode=mode, rows=rows)
    assert isinstance(out["z"], torch.Tensor)
    _assert_close(out, ref)


def test_masking_drop_sums_survivors(rng):
    shards, np_shards = _grad_shards(rng)
    mask = np.array([1.0, 0.0, 1.0, 1.0, 0.0])
    out = apply_gradient_masking(shards, mask, mode="drop")
    ref = {"z": sum(s["z"] for s, m in zip(np_shards, mask) if m > 0)}
    np.testing.assert_allclose(out["z"].numpy(), ref["z"], rtol=1e-15)


def test_masking_rescale_is_drop_times_n_over_nlive(rng):
    shards, _ = _grad_shards(rng)
    mask = np.array([1.0, 0.0, 1.0, 0.0, 1.0])
    drop = apply_gradient_masking(shards, mask, mode="drop")
    resc = apply_gradient_masking(shards, mask, mode="rescale")
    c = len(shards) / mask.sum()
    for a, b in zip(_leaves(resc), _leaves(drop)):
        np.testing.assert_allclose(a, b * c, rtol=1e-15)
    full = np.ones(len(shards))
    d0 = apply_gradient_masking(shards, full, mode="drop")
    r0 = apply_gradient_masking(shards, full, mode="rescale")
    for a, b in zip(_leaves(d0), _leaves(r0)):
        np.testing.assert_array_equal(a, b)


def test_masking_rescale_ragged_rows_and_refusals(rng):
    """With ragged shards the factor is the row ratio n / n_live, the
    engine's; wrong ``rows`` and an all-dead mask are refused, as in JAX."""
    shards, np_shards = _grad_shards(rng, n_shards=4)
    rows = np.array([8.0, 8.0, 8.0, 3.0])
    mask = np.array([1.0, 1.0, 0.0, 1.0])
    drop = apply_gradient_masking(shards, mask, mode="drop")
    resc = apply_gradient_masking(shards, mask, mode="rescale", rows=rows)
    c = rows.sum() / (rows * mask).sum()
    for a, b in zip(_leaves(resc), _leaves(drop)):
        np.testing.assert_allclose(a, b * c, rtol=1e-15)
    _assert_close(resc, jfault.apply_gradient_masking(
        np_shards, mask, mode="rescale", rows=rows))
    with pytest.raises(ValueError, match="rows must have shape"):
        apply_gradient_masking(shards, mask, mode="rescale", rows=np.ones(3))
    with pytest.raises(ValueError, match="all shards masked dead"):
        apply_gradient_masking(shards, np.zeros(4), mode="drop")


@pytest.mark.parametrize("records", [
    [[1.0, 2.0, 3.0], [2.0, 2.0, 2.0]],
    [[1.0, 2.0, 3.0], [4.0], [2.0, 4.0]],          # ragged: elastic membership
    [[0.25, 0.5, 0.125, 1.0]],
])
def test_step_timer_summary_matches_jax(records):
    ours, ref = StepTimer(), jfault.StepTimer()
    assert ours.summary() == ref.summary() == {}
    for r in records:
        ours.record(r)
        ref.record(r)
    assert ours.summary() == ref.summary()


def test_step_timer_time_shards_and_refusal():
    t = StepTimer()
    t.record([1.0, 2.0, 3.0])
    t.record([2.0, 2.0, 2.0])
    s = t.summary()
    assert s["min"] == 1.5 and s["max"] == 2.5 and s["mean"] == 2.0
    np.testing.assert_allclose(s["straggler_overhead"], (0.5 + 0.0) / 2)
    outs = t.time_shards([lambda: 1, lambda: 2])
    assert outs == [1, 2] and len(t.records) == 3
    with pytest.raises(ValueError, match="at least one shard time"):
        t.record([])
    assert len(t.records) == 3
