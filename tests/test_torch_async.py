"""The port's barrier-free async accumulation (``repro_torch.distributed.
async_stats``) against the JAX package's, case for case with
``tests/test_async_stats.py``.

Each case runs the same scenario through both packages on the same numpy
inputs: the port must make the reference's own claim (exact folds through
every staleness pattern and churn event, Horvitz–Thompson unbiasedness
over every presence subset, the eviction bound, the all-fresh step equal
to the synchronous one) and read what JAX's accumulator reads, to f64
rounding (Stats rtol 1e-12 / atol 1e-13; the reference's own 1e-10 / 1e-12
where it uses them).  Engine steps: value rtol 1e-12 where the reference
holds that, else each step's value and gradient at rtol 1e-9 / atol 1e-11.
Multi-step descents are teacher-forced: both engines take the same
(hyp, z) at every step (JAX's trajectory), so rounding is not amplified.
SVI steps feed the port JAX's own block indices
(``repro.core.stats.sample_block_indices`` of ``fold_in(key, k)``).
"""
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.bound import collapsed_bound as j_collapsed_bound
from repro.core.stats import partial_stats as j_partial_stats
from repro.core.stats import partial_stats_chunked as j_chunked
from repro.core.stats import sample_block_indices as j_sample_blocks
from repro.distributed.async_stats import AsyncEngine as JEngine
from repro.distributed.async_stats import AsyncStatsAccumulator as JAcc
from repro.distributed.fault import FailureSimulator as JFailureSimulator
from repro_torch.core.bound import collapsed_bound
from repro_torch.core.stats import partial_stats, partial_stats_chunked
from repro_torch.distributed import (AsyncEngine, AsyncStatsAccumulator,
                                     FailureSimulator, StepTimer)

CPU = "cpu"


def _mk_hyp(q):
    return {"log_sf2": 0.2, "log_ell": np.full((q,), 0.1), "log_beta": 1.0}


def _t(tree):
    return {k: torch.as_tensor(np.asarray(v, np.float64))
            for k, v in tree.items()}


def _j(tree):
    return {k: jnp.asarray(np.asarray(v, np.float64)) for k, v in tree.items()}


def _assert_stats_close(a, b, rtol=1e-10, atol=1e-12):
    for name, x, y in zip(a._fields, a, b):
        np.testing.assert_allclose(np.asarray(x), np.asarray(y), rtol=rtol,
                                   atol=atol, err_msg=name)


def _mk_shards(rng, K=3, nk=10, q=2, d=2, ragged=True):
    return [{"y": rng.standard_normal((nk + (2 * k if ragged else 0), d)),
             "mu": rng.standard_normal((nk + (2 * k if ragged else 0), q))}
            for k in range(K)]


def _shard_stats(pkg, hyp, z, sh, block_indices=None, batch_blocks=None,
                 block_size=None):
    """A shard's Stats in ``pkg`` ("jax" or "torch")."""
    if pkg == "jax":
        return j_chunked(_j(hyp), jnp.asarray(z), jnp.asarray(sh["y"]),
                         jnp.asarray(sh["mu"]), s=None, latent=False,
                         block_size=block_size, batch_blocks=batch_blocks,
                         block_indices=None if block_indices is None
                         else jnp.asarray(block_indices),
                         force_scan=block_size is not None)
    return partial_stats_chunked(
        _t(hyp), torch.from_numpy(z), torch.from_numpy(sh["y"]),
        torch.from_numpy(sh["mu"]), None, block_size=block_size,
        batch_blocks=batch_blocks, block_indices=block_indices,
        force_scan=block_size is not None)


ACCS = {"jax": JAcc, "torch": AsyncStatsAccumulator}


# -- the accumulator -------------------------------------------------------------

@pytest.mark.parametrize("S", [1, 2, 4])
def test_staleness_patterns_exact_with_churn(rng, S):
    """Every staleness pattern in {0..S}^K, with a leave/rejoin spliced in:
    the read is the exact fold, and JAX's read."""
    K = 3
    shards = _mk_shards(rng, K=K)
    hyp, z = _mk_hyp(2), rng.standard_normal((5, 2))
    reads = {}
    for pkg, acc_cls in ACCS.items():
        sts = [_shard_stats(pkg, hyp, z, sh) for sh in shards]
        exact = sts[0] + sts[1] + sts[2]
        reads[pkg] = []
        T = S
        for pattern in itertools.product(range(S + 1), repeat=K):
            acc = acc_cls(staleness=S, reweight="drop")
            acc.push(0, sts[1].scale(3.0), stamp=0)
            acc.leave(0)
            for t in range(T + 1):
                for k in range(K):
                    if T - pattern[k] == t:
                        acc.push(k, sts[k], stamp=t)
            acc.push(1, sts[1], stamp=T)
            out = acc.read(T)
            _assert_stats_close(out, exact, rtol=1e-12, atol=1e-13)
            assert sorted(acc.members()) == list(range(K))
            reads[pkg].append(out)
    for got, want in zip(reads["torch"], reads["jax"]):
        _assert_stats_close(got, want, rtol=1e-12, atol=1e-13)


@pytest.mark.parametrize("S", [1, 2, 4])
def test_staleness_eviction_bound(rng, S):
    """S steps old survives a read, S + 1 is evicted, and the never-empty
    guard keeps the freshest entries: as JAX's accumulator does."""
    shards = _mk_shards(rng, K=2, ragged=False)
    hyp, z = _mk_hyp(2), rng.standard_normal((4, 2))
    for pkg, acc_cls in ACCS.items():
        st0, st1 = (_shard_stats(pkg, hyp, z, sh) for sh in shards)
        ref0, ref1 = (_shard_stats("jax", hyp, z, sh) for sh in shards)
        acc = acc_cls(staleness=S, reweight="drop")
        acc.push(0, st0, stamp=0)
        acc.push(1, st1, stamp=1)
        _assert_stats_close(acc.read(S), ref0 + ref1)
        _assert_stats_close(acc.read(S + 1), ref1)
        assert acc.members() == [1]
        _assert_stats_close(acc.read(S + 100), ref1)
        assert acc.evict_stale(S + 200) == []
        acc.leave(1)
        with pytest.raises(ValueError, match="empty accumulator"):
            acc.read(0)


def test_presence_enumeration_probs_unbiased(rng):
    """Horvitz–Thompson: the presence-weighted average of the read over
    all 2^K subsets is the exact Stats, in both packages."""
    K, probs = 3, [0.5, 0.7, 0.3]
    shards = _mk_shards(rng, K=K)
    hyp, z = _mk_hyp(2), rng.standard_normal((5, 2))
    avgs = {}
    for pkg, acc_cls in ACCS.items():
        sts = [_shard_stats(pkg, hyp, z, sh) for sh in shards]
        avg = None
        for pattern in itertools.product([0, 1], repeat=K):
            weight = float(np.prod([p if b else 1.0 - p
                                    for p, b in zip(probs, pattern)]))
            if not any(pattern):
                continue
            acc = acc_cls(staleness=0, reweight="probs")
            for k in range(K):
                if pattern[k]:
                    acc.push(k, sts[k], stamp=0, prob=probs[k])
            contrib = acc.read(0).scale(weight)
            avg = contrib if avg is None else avg + contrib
        _assert_stats_close(avg, sts[0] + sts[1] + sts[2])
        avgs[pkg] = avg
    _assert_stats_close(avgs["torch"], avgs["jax"], rtol=1e-12, atol=1e-13)


@pytest.mark.parametrize("S", [1, 2, 4])
def test_presence_and_svi_enumeration_with_staleness(rng, S):
    """Per-shard SVI block subsets inside a stale, presence-sampled fold,
    enumerated jointly: the expectation is the exact Stats.  Every exact and
    sampled shard Stats folded in is JAX's (the reads are held against
    JAX's accumulator in the staleness and rescale cases)."""
    K, p = 2, 0.5
    nk, blocksz, B = 12, 4, 2
    nb = nk // blocksz
    shards = _mk_shards(rng, K=K, nk=nk, ragged=False)
    hyp, z = _mk_hyp(2), rng.standard_normal((4, 2))
    block_subsets = list(itertools.combinations(range(nb), B))
    sts = {}
    for pkg in ACCS:
        sts[pkg] = {(k, sub): _shard_stats(
            pkg, hyp, z, shards[k], block_indices=None if sub is None
            else list(sub), batch_blocks=None if sub is None else B,
            block_size=blocksz)
            for k in range(K) for sub in [None, *block_subsets]}
    for key, got in sts["torch"].items():
        _assert_stats_close(got, sts["jax"][key], rtol=1e-12, atol=1e-13)
    st = sts["torch"]
    avg, total_w = None, 0.0
    for pattern in itertools.product([0, 1], repeat=K):
        pw = float(np.prod([p if b else 1.0 - p for b in pattern]))
        present = [k for k in range(K) if pattern[k]]
        for combo in itertools.product(block_subsets, repeat=len(present)):
            w = pw / (len(block_subsets) ** len(present))
            acc = AsyncStatsAccumulator(staleness=S, reweight="drop")
            for k in range(K):
                acc.push(k, st[(k, None)], stamp=0)
            for k, sub in zip(present, combo):
                acc.push(k, st[(k, sub)], stamp=S)
            contrib = acc.read(S).scale(w)
            avg = contrib if avg is None else avg + contrib
            total_w += w
    assert abs(total_w - 1.0) < 1e-12
    _assert_stats_close(avg, st[(0, None)] + st[(1, None)])


def test_presence_enumeration_grads_to_f64(rng):
    """For a loss linear in the folded Stats, the presence-averaged HT
    gradients equal the exact ones to f64: autograd runs through push and
    read (tensor adds and scales); the exact gradients are JAX's."""
    K, p, q, m, d = 3, 0.6, 2, 5, 2
    shards = _mk_shards(rng, K=K)
    hyp, z = _mk_hyp(q), rng.standard_normal((m, q))
    vc, vd = rng.standard_normal((m, d)), rng.standard_normal((m, m))
    patterns = [pt for pt in itertools.product([0, 1], repeat=K) if any(pt)]
    weights = [float(np.prod([p if b else 1.0 - p for b in pt]))
               for pt in patterns]

    def j_loss(h, zz):
        total = None
        for sh in shards:
            st = j_partial_stats(h, zz, jnp.asarray(sh["y"]),
                                 jnp.asarray(sh["mu"]), None, latent=False)
            total = st if total is None else total + st
        return (total.A + 2.0 * total.B + jnp.sum(vc * total.C)
                + jnp.sum(vd * total.D) + 0.5 * total.n)

    def t_grads(pattern):
        h = {k: v.requires_grad_() for k, v in _t(hyp).items()}
        zz = torch.from_numpy(z).requires_grad_()

        def st_of(sh):
            return partial_stats(h, zz, torch.from_numpy(sh["y"]),
                                 torch.from_numpy(sh["mu"]))
        if pattern is None:
            total = st_of(shards[0]) + st_of(shards[1]) + st_of(shards[2])
        else:
            acc = AsyncStatsAccumulator(staleness=0, reweight="probs")
            for k in range(K):
                if pattern[k]:
                    acc.push(k, st_of(shards[k]), stamp=0, prob=p)
            total = acc.read(0)
        loss = (total.A + 2.0 * total.B + (torch.from_numpy(vc) * total.C).sum()
                + (torch.from_numpy(vd) * total.D).sum() + 0.5 * total.n)
        leaves = [h[k] for k in sorted(h)] + [zz]
        return [np.zeros(t.shape) if g is None else g.numpy() for t, g in zip(
            leaves, torch.autograd.grad(loss, leaves, allow_unused=True))]

    g_exact = t_grads(None)
    avg = [sum(w * g for w, g in zip(weights, gs))
           for gs in zip(*[t_grads(pt) for pt in patterns])]
    j_exact = jax.tree.leaves(jax.jit(jax.grad(j_loss, argnums=(0, 1)))(
        _j(hyp), jnp.asarray(z)))
    for a, b in zip(avg, g_exact):
        np.testing.assert_allclose(a, b, rtol=1e-9, atol=1e-11)
    for a, b in zip(g_exact, j_exact):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-9, atol=1e-11)


def test_rescale_read_row_count_factor(rng):
    """``reweight="rescale"``: the row ratio n / n_live, n set to the full
    count, as JAX's read."""
    shards = _mk_shards(rng, K=3, nk=8)       # rows 8, 10, 12
    hyp, z = _mk_hyp(2), rng.standard_normal((4, 2))
    n_full = sum(sh["y"].shape[0] for sh in shards)
    reads = {}
    for pkg, acc_cls in ACCS.items():
        sts = [_shard_stats(pkg, hyp, z, sh) for sh in shards]
        acc = acc_cls(staleness=0, reweight="rescale")
        acc.push(0, sts[0], stamp=0)
        acc.push(2, sts[2], stamp=0)          # shard 1 (10 rows) missing
        assert acc.rows_live() == 20.0
        out = acc.read(0, n_rows=float(n_full))
        ref = (sts[0] + sts[2]).scale(n_full / 20.0)
        _assert_stats_close(out._replace(n=ref.n), ref)
        assert float(out.n) == float(n_full)
        with pytest.raises(ValueError, match="needs n_rows"):
            acc.read(0)
        reads[pkg] = out
    _assert_stats_close(reads["torch"], reads["jax"], rtol=1e-12, atol=1e-13)


def test_accumulator_validation():
    from repro.core.stats import zero_stats as j_zero
    from repro_torch.core.stats import zero_stats

    for acc_cls, zero in ((JAcc, j_zero), (AsyncStatsAccumulator, zero_stats)):
        with pytest.raises(ValueError, match="staleness must be"):
            acc_cls(staleness=-1)
        with pytest.raises(ValueError, match="reweight must be"):
            acc_cls(reweight="mean")
        acc = acc_cls()
        with pytest.raises(ValueError, match="prob must be"):
            acc.push(0, zero(2, 1), stamp=0, prob=0.0)
        assert len(acc) == 0 and 0 not in acc


# -- the engine ------------------------------------------------------------------

def _both(shards, d, **kw):
    """JAX's engine and the port's on the same shards."""
    return JEngine(shards, d=d, **kw), AsyncEngine(shards, d=d, device=CPU,
                                                   **kw)


def _flat(g):
    gh, gz = g
    return [np.asarray(gh[k]) for k in sorted(gh)] + [np.asarray(gz)]


def _assert_step_close(got, want, rtol=1e-9, atol=1e-11):
    (v, g), (jv, jg) = got, want
    np.testing.assert_allclose(float(v), float(jv), rtol=rtol)
    for a, b in zip(_flat(g), _flat(jg)):
        np.testing.assert_allclose(a, b, rtol=rtol, atol=atol)


def test_async_engine_all_fresh_matches_reference(rng):
    """refresh >= K, no failures: the async step is the synchronous step,
    against an independently built reference (JAX's collapsed bound of the
    summed Stats) and JAX's engine."""
    K, d, q = 3, 2, 2
    shards = _mk_shards(rng, K=K, d=d, q=q)
    hyp, z = _mk_hyp(q), rng.standard_normal((5, q))
    n_full = float(sum(sh["y"].shape[0] for sh in shards))

    def neg(h, zz):
        total = None
        for sh in shards:
            st = j_partial_stats(h, zz, jnp.asarray(sh["y"]),
                                 jnp.asarray(sh["mu"]), None, latent=False)
            total = st if total is None else total + st
        total = total._replace(n=jnp.asarray(n_full))
        return -j_collapsed_bound(h, zz, total, d)

    v_ref, g_ref = jax.jit(jax.value_and_grad(neg, argnums=(0, 1)))(
        _j(hyp), jnp.asarray(z))
    jeng, eng = _both(shards, d, staleness=1, refresh=K)
    got = eng.step(_t(hyp), torch.from_numpy(z))
    _assert_step_close(got, (v_ref, g_ref))
    np.testing.assert_allclose(float(got[0]), float(v_ref), rtol=1e-12)
    _assert_step_close(got, jeng.step(_j(hyp), jnp.asarray(z)))
    v2, g2 = eng.exact_value_and_grad(_t(hyp), torch.from_numpy(z))
    np.testing.assert_allclose(float(v2), float(v_ref), rtol=1e-12)
    _assert_step_close((v2, g2), (v_ref, g_ref))


def test_async_engine_staleness_convergence_fixed_point(rng):
    """At fixed (hyp, z) stale contributions equal fresh ones: after one
    refresh round the value sits on the synchronous value; every step is
    JAX's engine's step."""
    K, d = 4, 1
    shards = _mk_shards(rng, K=K, d=d)
    hyp, z = _mk_hyp(2), rng.standard_normal((4, 2))
    jeng, eng = _both(shards, d, staleness=K, refresh=1)
    v_ref, _ = eng.exact_value_and_grad(_t(hyp), torch.from_numpy(z))
    for _ in range(K):
        got = eng.step(_t(hyp), torch.from_numpy(z))
        _assert_step_close(got, jeng.step(_j(hyp), jnp.asarray(z)))
    np.testing.assert_allclose(float(got[0]), float(v_ref), rtol=1e-12)
    assert all(np.isfinite(a).all() for a in _flat(got[1]))


class _ScriptedFailure:
    """mask() scripted per step: shard 2 dies at steps 1..4."""

    def __init__(self, K):
        self.K, self.t = K, 0

    def mask(self):
        m = np.ones(self.K)
        if 1 <= self.t <= 4:
            m[2] = 0.0
        self.t += 1
        return m


def test_async_engine_churn_eviction_and_resurrection(rng):
    """A dead shard's contribution goes stale and is evicted after S steps;
    on resurrection its slot folds it again; the timer records the ragged
    refreshes.  Members and every step as JAX's engine."""
    K, d, S = 3, 1, 2
    shards = _mk_shards(rng, K=K, d=d, ragged=False)
    hyp, z = _mk_hyp(2), rng.standard_normal((4, 2))
    timer = StepTimer()
    jeng = JEngine(shards, d=d, staleness=S, refresh=K,
                   failure=_ScriptedFailure(K))
    eng = AsyncEngine(shards, d=d, staleness=S, refresh=K,
                      failure=_ScriptedFailure(K), timer=timer, device=CPU)
    members = [[0, 1, 2], [0, 1, 2], [0, 1, 2], [0, 1], [0, 1], [0, 1, 2],
               [0, 1, 2]]
    vals = []
    for want in members:
        got = eng.step(_t(hyp), torch.from_numpy(z))
        _assert_step_close(got, jeng.step(_j(hyp), jnp.asarray(z)))
        assert sorted(eng.acc.members()) == sorted(jeng.acc.members()) == want
        vals.append(float(got[0]))
    v_ref, _ = eng.exact_value_and_grad(_t(hyp), torch.from_numpy(z))
    np.testing.assert_allclose(vals[-1], float(v_ref), rtol=1e-12)
    assert vals[3] != float(v_ref)              # the noisy period was real
    s = timer.summary()
    assert s and np.isfinite(s["straggler_overhead"])
    assert [len(r) for r in timer.records] == [3, 2, 2, 2, 2, 3, 3]


def test_async_engine_churn_under_failure_simulator(rng):
    """Churn drawn by ``FailureSimulator``: the port's masks are bitwise
    JAX's for one seed, so both engines refresh, evict and fold the same
    shards, and every step is JAX's."""
    K, d = 4, 1
    shards = _mk_shards(rng, K=K, d=d)
    hyp, z = _mk_hyp(2), rng.standard_normal((4, 2))
    jeng = JEngine(shards, d=d, staleness=1, refresh=2, reweight="rescale",
                   failure=JFailureSimulator(K, 0.4, seed=5))
    eng = AsyncEngine(shards, d=d, staleness=1, refresh=2, reweight="rescale",
                      failure=FailureSimulator(K, 0.4, seed=5), device=CPU)
    for _ in range(8):
        got = eng.step(_t(hyp), torch.from_numpy(z))
        _assert_step_close(got, jeng.step(_j(hyp), jnp.asarray(z)))
        assert eng.acc.members() == jeng.acc.members()
        assert eng.acc.rows_live() == jeng.acc.rows_live()


def test_async_engine_svi_composes(rng):
    """``batch_blocks`` inside the engine: fed JAX's per-shard block
    indices, each step is JAX's; with a generator the steps are finite,
    replay is deterministic and other seeds draw other subsets."""
    K, d = 2, 1
    shards = _mk_shards(rng, K=K, nk=16, d=d, ragged=False)
    hyp, z = _mk_hyp(2), rng.standard_normal((4, 2))
    kw = dict(staleness=2, refresh=K, chunk_size=4, batch_blocks=2)
    jeng, eng = _both(shards, d, **kw)
    for t in range(3):
        key = jax.random.PRNGKey(t)
        idx = {k: np.asarray(j_sample_blocks(jax.random.fold_in(key, k), 4,
                                             2)) for k in range(K)}
        _assert_step_close(eng.step(_t(hyp), torch.from_numpy(z), idx),
                           jeng.step(_j(hyp), jnp.asarray(z), key=key))

    def run(seed):
        e = AsyncEngine(shards, d=d, device=CPU, **kw)
        return [float(e.step(_t(hyp), torch.from_numpy(z),
                             torch.Generator().manual_seed(seed + t))[0])
                for t in range(3)]

    a = run(0)
    assert a == run(0)
    assert all(np.isfinite(v) for v in a)
    assert run(100) != a


def test_async_engine_drop_mode_partial_membership_n(rng):
    """While only shard 0 has pushed, the drop-mode bound is the bound of
    the present subset (its own n), as in JAX's engine."""
    K, d = 3, 1
    shards = _mk_shards(rng, K=K, d=d)
    hyp, z = _mk_hyp(2), rng.standard_normal((4, 2))
    jeng, eng = _both(shards, d, staleness=K, refresh=1)
    got = eng.step(_t(hyp), torch.from_numpy(z))
    _assert_step_close(got, jeng.step(_j(hyp), jnp.asarray(z)))
    st0 = _shard_stats("torch", hyp, z, shards[0])
    assert float(st0.n) == shards[0]["y"].shape[0] != eng.n_full
    np.testing.assert_allclose(
        float(got[0]), -float(collapsed_bound(_t(hyp), torch.from_numpy(z),
                                              st0, d)), rtol=1e-12)


def test_async_engine_clipped_descent_is_stable(rng):
    """60 clipped SGD steps on stale folds, teacher-forced on JAX's
    trajectory: every step's value and gradient are JAX's, the gradient's
    norm stays under the clip, and the exact bound rises."""
    from repro_torch.train.steps import make_gp_async_step

    K, d, q, m, nk = 4, 1, 2, 6, 48
    t = rng.uniform(-2, 2, (K * nk, 1))
    x = np.hstack([t, 0.1 * rng.standard_normal((K * nk, 1))])
    y = np.sin(t) + 0.1 * rng.standard_normal((K * nk, 1))
    shards = [{"y": y[k * nk:(k + 1) * nk], "mu": x[k * nk:(k + 1) * nk]}
              for k in range(K)]
    hyp = {"log_sf2": 0.0, "log_ell": np.zeros((q,)), "log_beta": 0.0}
    z = rng.standard_normal((m, q))
    clip, lr = 50.0, 2e-3
    jeng = JEngine(shards, d=d, staleness=2 * K, refresh=1, clip=clip)
    eng, step = make_gp_async_step(shards, d, staleness=2 * K, refresh=1,
                                   clip=clip, device=CPU)
    assert isinstance(eng, AsyncEngine) and step == eng.step
    jh, jz = _j(hyp), jnp.asarray(z)
    v0, _ = eng.exact_value_and_grad(_t(hyp), torch.from_numpy(z))
    for _ in range(60):
        got = step({k: torch.from_numpy(np.array(v)) for k, v in jh.items()},
                   torch.from_numpy(np.array(jz)))
        jv, (jgh, jgz) = jeng.step(jh, jz)
        _assert_step_close(got, (jv, (jgh, jgz)))
        assert np.isfinite(float(got[0]))
        gn = float(np.sqrt(sum((a ** 2).sum() for a in _flat(got[1]))))
        assert gn <= clip * (1 + 1e-9)
        jh = {k: jh[k] - lr * jgh[k] for k in jh}
        jz = jz - lr * jgz
    v1, _ = eng.exact_value_and_grad(
        {k: torch.from_numpy(np.array(v)) for k, v in jh.items()},
        torch.from_numpy(np.array(jz)))
    assert float(v1) < float(v0)               # exact neg-bound decreased
    for cls in (JEngine, AsyncEngine):
        with pytest.raises(ValueError, match="clip must be positive"):
            cls(shards, d=d, clip=0.0)
        with pytest.raises(ValueError, match="refresh must be"):
            cls(shards, d=d, refresh=0)
