"""The port's minibatch (SVI) map step, Adam loop, ``fit_svi`` and
``DistributedGP(batch_blocks=...)`` against the JAX package's.

The first cases mirror ``tests/test_svi_stats.py`` one for one on the port
alone: averaging the reweighted Stats over ALL size-B block subsets (the
``block_indices`` hook) gives the exact Stats, bound and gradients to f64
rounding (rtol 1e-10 / atol 1e-12 on Stats, 1e-10 on the bound, rtol 1e-9 /
atol 1e-11 on gradients, the reference's own); a full batch is the exact
fold; per-shard sampling stays unbiased; the sampler draws without
replacement; the validation errors; the engine's SVI step; ``fit_svi``
raises the exact bound.

Then the port against JAX on the same numpy inputs and the same draws:
``partial_stats_chunked`` with JAX's ``block_indices`` (and ``init=``) at
1e-12, ``adam_step`` on fixed gradients at 1e-14, a 5-step ``fit_svi``
trajectory with ``batch_blocks >= nb`` (deterministic in both) at 1e-10,
and 4 spawned gloo ranks fed JAX's per-shard draws ``fold_in(key, k)``
against JAX's engine on 4 placeholder devices: value 1e-10 relative,
gradients rtol 1e-8 / atol 1e-10.
"""
import datetime
import itertools
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

import repro_torch as rt
from repro.core import SGPR as JSGPR
from repro.core import BayesianGPLVM as JGPLVM
from repro.core.stats import partial_stats_chunked as j_chunked
from repro.core.stats import sample_block_indices as j_sample
from repro.train import svi as j_svi
from repro_torch.core.bound import collapsed_bound
from repro_torch.core.distributed import DistributedGP
from repro_torch.core.stats import (partial_stats_chunked, sample_block_indices,
                                    zero_stats)
from repro_torch.train import svi as t_svi
from test_torch_spawn import spawn_ranks

from conftest import make_regression

ROOT = pathlib.Path(__file__).resolve().parents[1]
F64 = torch.float64


def _hyp(q):
    return {"log_sf2": np.float64(0.2), "log_ell": np.full((q,), 0.1),
            "log_beta": np.float64(1.0)}


def _t(tree):
    if isinstance(tree, dict):
        return {k: _t(v) for k, v in tree.items()}
    return torch.as_tensor(np.asarray(tree, np.float64))


def _j(tree):
    if isinstance(tree, dict):
        return {k: _j(v) for k, v in tree.items()}
    return jnp.asarray(np.asarray(tree, np.float64))


def _assert_stats_close(a, b, rtol=1e-10, atol=1e-12):
    for name, x, y in zip(a._fields, a, b):
        np.testing.assert_allclose(np.asarray(x), np.asarray(y), rtol=rtol,
                                   atol=atol, err_msg=name)


def _subset_average(subsets, stats_for_subset):
    subsets = list(subsets)
    acc = None
    for sub in subsets:
        st = stats_for_subset(np.asarray(sub))
        acc = st if acc is None else acc + st
    return acc.scale(1.0 / len(subsets))


def _problem(rng, n, m, q, d, latent):
    x = rng.standard_normal((n, q))
    y = rng.standard_normal((n, d))
    z = rng.standard_normal((m, q))
    s = rng.uniform(0.05, 0.6, (n, q)) if latent else None
    return x, y, z, s


# -- the port alone: the cases of tests/test_svi_stats.py ----------------------

@pytest.mark.parametrize("latent", [False, True])
def test_subset_averaged_stats_and_bound_equal_exact(rng, latent):
    n, m, q, d, block, B = 53, 6, 2, 3, 8, 3   # nb = 7, last block padded
    x, y, z, s = (None if a is None else torch.from_numpy(a)
                  for a in _problem(rng, n, m, q, d, latent))
    hyp = _t(_hyp(q))
    nb = -(-n // block)
    exact = partial_stats_chunked(hyp, z, y, x, s=s, latent=latent,
                                  block_size=block)
    avg = _subset_average(
        itertools.combinations(range(nb), B),
        lambda sub: partial_stats_chunked(hyp, z, y, x, s=s, latent=latent,
                                          block_size=block, batch_blocks=B,
                                          block_indices=sub))
    _assert_stats_close(exact, avg)
    b_exact = float(collapsed_bound(hyp, z, exact, d))
    b_avg = float(collapsed_bound(hyp, z, avg, d))
    assert abs(b_avg - b_exact) < 1e-10 * abs(b_exact)


def test_subset_averaged_grads_equal_exact(rng):
    n, m, q, d, block, B = 41, 5, 2, 2, 8, 2   # nb = 6, padded final block
    x, y, z, s = (torch.from_numpy(a)
                  for a in _problem(rng, n, m, q, d, True))
    hyp = _t(_hyp(q))
    nb = -(-n // block)
    vc = torch.from_numpy(rng.standard_normal((m, d)))
    vd = torch.from_numpy(rng.standard_normal((m, m)))

    def grads(indices):
        def loss(p):
            st = partial_stats_chunked(
                p["hyp"], p["z"], y, x, s=s, latent=True, block_size=block,
                batch_blocks=None if indices is None else B,
                block_indices=indices)
            return (st.A + 2.0 * st.B + (vc * st.C).sum() + (vd * st.D).sum()
                    + 3.0 * st.KL + 0.5 * st.n)
        _, g = t_svi.value_and_grad(loss, {"hyp": hyp, "z": z})
        return [g["hyp"][k] for k in sorted(hyp)] + [g["z"]]

    g_exact = grads(None)
    subsets = list(itertools.combinations(range(nb), B))
    acc = None
    for sub in subsets:
        g = grads(np.asarray(sub))
        acc = g if acc is None else [a + b for a, b in zip(acc, g)]
    for a, b in zip(g_exact, acc):
        np.testing.assert_allclose((b / len(subsets)).numpy(), a.numpy(),
                                   rtol=1e-9, atol=1e-11)


def test_full_batch_svi_equals_exact_bound_and_grads(rng):
    n, m, q, d, block = 60, 7, 2, 2, 13    # nb = 5, padded final block
    x, y = (torch.from_numpy(a) for a in make_regression(rng, n=n, q=q, d=d))
    z = torch.from_numpy(rng.standard_normal((m, q)))
    nb = -(-n // block)

    def vg(batch_blocks, generator):
        def neg(p):
            st = partial_stats_chunked(p["hyp"], p["z"], y, x, s=None,
                                       block_size=block,
                                       batch_blocks=batch_blocks,
                                       generator=generator)
            return -collapsed_bound(p["hyp"], p["z"], st, d)
        return t_svi.value_and_grad(neg, {"hyp": _t(_hyp(q)), "z": z})

    v0, g0 = vg(None, None)
    v1, g1 = vg(nb, torch.Generator().manual_seed(0))
    assert abs(float(v1) - float(v0)) < 1e-10 * abs(float(v0))
    np.testing.assert_allclose(g1["z"].numpy(), g0["z"].numpy(), rtol=1e-9,
                               atol=1e-11)
    for k in g0["hyp"]:
        np.testing.assert_allclose(g1["hyp"][k].numpy(), g0["hyp"][k].numpy(),
                                   rtol=1e-9, atol=1e-11)


@pytest.mark.statistical
def test_per_shard_sampling_unbiased(rng):
    """Each shard samples its own blocks and reweights locally; summing the
    shards' subset-averaged Stats gives the exact global Stats."""
    n, m, q, d, block, B, k_shards = 64, 5, 2, 2, 4, 2, 2
    x, y, z, _ = (None if a is None else torch.from_numpy(a)
                  for a in _problem(rng, n, m, q, d, False))
    hyp = _t(_hyp(q))
    exact = partial_stats_chunked(hyp, z, y, x, block_size=block)
    n_local = n // k_shards
    nb_local = n_local // block
    total = None
    for sh in range(k_shards):
        sl = slice(sh * n_local, (sh + 1) * n_local)
        avg = _subset_average(
            itertools.combinations(range(nb_local), B),
            lambda sub, sl=sl: partial_stats_chunked(
                hyp, z, y[sl], x[sl], block_size=block, batch_blocks=B,
                block_indices=sub))
        total = avg if total is None else total + avg
    _assert_stats_close(exact, total)


def test_sample_block_indices_no_replacement():
    nb, B = 11, 4
    seen = set()
    for i in range(20):
        idx = sample_block_indices(torch.Generator().manual_seed(i), nb, B)
        assert tuple(idx.shape) == (B,) and idx.dtype == torch.int64
        assert len(set(idx.tolist())) == B          # without replacement
        assert int(idx.min()) >= 0 and int(idx.max()) < nb
        seen.add(tuple(sorted(idx.tolist())))
    assert len(seen) > 1                            # the sampler varies


def test_svi_validation_errors(rng):
    y = torch.from_numpy(rng.standard_normal((20, 1)))
    x = torch.from_numpy(rng.standard_normal((20, 2)))
    z = torch.from_numpy(rng.standard_normal((4, 2)))
    hyp = _t(_hyp(2))
    with pytest.raises(ValueError, match="requires block_size"):
        partial_stats_chunked(hyp, z, y, x, block_size=None, batch_blocks=2)
    with pytest.raises(ValueError, match="needs a generator"):
        partial_stats_chunked(hyp, z, y, x, block_size=4, batch_blocks=2)
    with pytest.raises(ValueError, match=">= 1"):
        partial_stats_chunked(hyp, z, y, x, block_size=4, batch_blocks=0)
    with pytest.raises(ValueError, match="init cannot"):
        partial_stats_chunked(hyp, z, y, x, block_size=4, batch_blocks=2,
                              init=zero_stats(4, 1))
    with pytest.raises(ValueError, match="shape"):
        partial_stats_chunked(hyp, z, y, x, block_size=4, batch_blocks=2,
                              block_indices=np.array([0, 1, 2]))
    with pytest.raises(ValueError, match="requires chunk_size"):
        DistributedGP(batch_blocks=2, device="cpu")
    with pytest.raises(ValueError, match=">= 1"):
        DistributedGP(chunk_size=4, batch_blocks=0, device="cpu")
    eng = DistributedGP(chunk_size=4, batch_blocks=2, device="cpu")
    data, w = eng.put_data(y=y.numpy(), mu=x.numpy())
    with pytest.raises(ValueError, match="per-step draw"):
        eng.make_value_and_grad(1)(hyp, z, data["mu"], None, data["y"], w,
                                   np.ones(1), 20.0)
    for model in (rt.SGPR(x.numpy(), y.numpy(), num_inducing=4, device="cpu"),
                  rt.BayesianGPLVM(y.numpy(), q=1, num_inducing=4,
                                   chunk_size=4, device="cpu")):
        with pytest.raises(ValueError, match="fit_svi needs"):
            model.fit_svi(steps=1)


def test_distributed_svi_single_device(rng):
    """World of one: full-batch SVI == exact; a sampled step replays from
    the same generator state and varies across seeds."""
    n, m, q, d, block = 37, 5, 2, 1, 8           # padded to 40 -> nb = 5
    x, y = rng.standard_normal((n, q)), rng.standard_normal((n, d))
    z = torch.from_numpy(rng.standard_normal((m, q)))
    hyp = _t(_hyp(q))
    eng_exact = DistributedGP(chunk_size=block, device="cpu")
    data, w = eng_exact.put_data(y=y, mu=x)
    args = (hyp, z, data["mu"], None, data["y"], w, np.ones(1), float(n))
    v_ref, _ = eng_exact.make_value_and_grad(d)(*args)

    eng_full = DistributedGP(chunk_size=block, batch_blocks=5, device="cpu")
    v_full, (gh, gz) = eng_full.make_value_and_grad(d)(
        *args, torch.Generator().manual_seed(0))
    assert abs(float(v_full) - float(v_ref)) < 1e-10 * abs(float(v_ref))
    assert bool(torch.isfinite(gz).all())

    vg = DistributedGP(chunk_size=block, batch_blocks=2,
                       device="cpu").make_value_and_grad(d)
    vals = [float(vg(*args, torch.Generator().manual_seed(k))[0])
            for k in range(8)]
    assert all(np.isfinite(v) for v in vals)
    assert float(vg(*args, torch.Generator().manual_seed(0))[0]) == vals[0]
    assert len(set(vals)) > 1
    # one generator across steps: successive steps draw afresh
    gen = torch.Generator().manual_seed(0)
    assert len({float(vg(*args, gen)[0]) for _ in range(6)}) > 1


def test_make_gp_train_step_svi_smoke(rng):
    from repro_torch.train.steps import make_gp_train_step

    n, m, q, d = 24, 4, 2, 1
    x, y = rng.standard_normal((n, q)), rng.standard_normal((n, d))
    z = torch.from_numpy(rng.standard_normal((m, q)))
    eng, step = make_gp_train_step(None, d, chunk_size=4, batch_blocks=2,
                                   device="cpu")
    data, w = eng.put_data(y=y, mu=x)
    v, (gh, gz) = step(_t(_hyp(q)), z, data["mu"], None, data["y"], w,
                       np.ones(1), float(n), torch.Generator().manual_seed(7))
    assert np.isfinite(float(v))
    assert bool(torch.isfinite(gz).all())


def test_sgpr_fit_svi_improves_exact_bound(rng):
    x, y = make_regression(rng, n=160, q=1, d=1)
    gp = rt.SGPR(x, y, num_inducing=8, seed=0, chunk_size=16, batch_blocks=3,
                 device="cpu")
    b0 = gp.log_bound()
    gp.predictive_state()
    res = gp.fit_svi(steps=120, lr=3e-2, seed=0)
    assert gp._pstate_cache is None          # the fit dropped the caches
    assert res.n_steps == 120 and np.isfinite(res.history).all()
    assert gp.log_bound() > b0
    mean, var = gp.predict(x[:5])
    assert np.isfinite(mean).all() and np.isfinite(var).all()


def test_gplvm_fit_svi_improves_exact_bound(rng):
    y = rng.standard_normal((48, 4))
    lv = rt.BayesianGPLVM(y, q=2, num_inducing=6, seed=0, chunk_size=8,
                          batch_blocks=2, device="cpu")
    b0 = lv.log_bound()
    res = lv.fit_svi(steps=80, lr=2e-2, seed=0)
    assert np.isfinite(res.history).all()
    assert lv.log_bound() > b0


# -- the port against JAX -------------------------------------------------------

@pytest.mark.parametrize("latent", [False, True])
@pytest.mark.parametrize("indices", [(5, 0, 2), (6, 6, 1), (0, 1, 2, 3, 4, 5,
                                                             6, 3)])
def test_chunked_with_jax_block_indices_matches_jax(rng, latent, indices):
    """The same block indices (with replacement, and more than nb) give the
    same reweighted Stats in both packages, at 1e-12."""
    n, m, q, d, block = 53, 6, 2, 3, 8         # nb = 7
    x, y, z, s = _problem(rng, n, m, q, d, latent)
    hyp = _hyp(q)
    idx = np.asarray(indices)
    got = partial_stats_chunked(
        _t(hyp), torch.from_numpy(z), torch.from_numpy(y), torch.from_numpy(x),
        None if s is None else torch.from_numpy(s), latent=latent,
        block_size=block, batch_blocks=len(idx), block_indices=idx)
    want = j_chunked(_j(hyp), jnp.asarray(z), jnp.asarray(y), jnp.asarray(x),
                     None if s is None else jnp.asarray(s), latent=latent,
                     block_size=block, batch_blocks=len(idx),
                     block_indices=jnp.asarray(idx))
    _assert_stats_close(got, want, rtol=1e-12, atol=1e-12)


def test_jax_sampler_draws_replay_through_block_indices(rng):
    """JAX's own draw (``sample_block_indices(key, nb, B)``) replayed
    through the port's ``block_indices`` gives JAX's key-sampled Stats."""
    n, m, q, d, block, B = 90, 5, 2, 2, 8, 4   # nb = 12
    x, y, z, _ = _problem(rng, n, m, q, d, False)
    hyp = _hyp(q)
    key = jax.random.PRNGKey(11)
    idx = np.asarray(j_sample(key, -(-n // block), B))
    want = j_chunked(_j(hyp), jnp.asarray(z), jnp.asarray(y), jnp.asarray(x),
                     latent=False, block_size=block, batch_blocks=B, key=key)
    got = partial_stats_chunked(_t(hyp), torch.from_numpy(z),
                                torch.from_numpy(y), torch.from_numpy(x),
                                block_size=block, batch_blocks=B,
                                block_indices=idx)
    _assert_stats_close(got, want, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("latent", [False, True])
def test_init_threads_chunks_bitwise_and_matches_jax(rng, latent):
    """A host loop threading ``init`` through row chunks adds the bits of
    one call over all rows (port), and matches JAX's ``init=`` at 1e-12."""
    n, m, q, d, block = 96, 5, 2, 2, 8
    x, y, z, s = _problem(rng, n, m, q, d, latent)
    hyp = _hyp(q)
    t = {k: None if v is None else torch.from_numpy(v)
         for k, v in dict(x=x, y=y, z=z, s=s).items()}
    whole = partial_stats_chunked(_t(hyp), t["z"], t["y"], t["x"], t["s"],
                                  latent=latent, block_size=block,
                                  force_scan=True)
    carry, jcarry = None, None
    for lo in range(0, n, 3 * block):
        sl = slice(lo, lo + 3 * block)
        carry = partial_stats_chunked(
            _t(hyp), t["z"], t["y"][sl], t["x"][sl],
            None if s is None else t["s"][sl], latent=latent,
            block_size=block, force_scan=True, init=carry)
        jcarry = j_chunked(_j(hyp), jnp.asarray(z), jnp.asarray(y[sl]),
                           jnp.asarray(x[sl]),
                           None if s is None else jnp.asarray(s[sl]),
                           latent=latent, block_size=block, force_scan=True,
                           init=jcarry)
    for a, b in zip(carry, whole):
        assert torch.equal(a, b)
    _assert_stats_close(carry, jcarry, rtol=1e-12, atol=1e-12)


def test_adam_step_matches_jax_on_fixed_gradients(rng):
    params = {"hyp": {"log_beta": np.float64(0.3), "log_ell": rng.standard_normal(3)},
              "z": rng.standard_normal((4, 2))}
    tp, jp = _t(params), _j(params)
    to, jo = t_svi.adam_init(tp), j_svi.adam_init(jp)
    for i in range(6):
        g = {"hyp": {"log_beta": rng.standard_normal(()),
                     "log_ell": rng.standard_normal(3)},
             "z": rng.standard_normal((4, 2))}
        tp, to = t_svi.adam_step(tp, _t(g), to, lr=3e-2)
        jp, jo = j_svi.adam_step(jp, _j(g), jo, lr=3e-2)
    assert to["step"] == int(jo["step"]) == 6
    for tree_t, tree_j in ((tp, jp), (to["m"], jo["m"]), (to["v"], jo["v"])):
        for a, b in zip(jax.tree.leaves(_np(tree_t)), jax.tree.leaves(tree_j)):
            np.testing.assert_allclose(a, np.asarray(b), rtol=1e-14,
                                       atol=1e-14)


def _np(tree):
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    return tree.numpy()


def test_adam_step_keeps_each_leaf_dtype():
    params = {"a": torch.ones(3, dtype=torch.float32),
              "b": torch.ones(2, dtype=F64)}
    grads = {"a": torch.full((3,), 0.5, dtype=torch.float32),
             "b": torch.full((2,), 0.5, dtype=F64)}
    opt = t_svi.adam_init(params)
    new, opt = t_svi.adam_step(params, grads, opt, lr=1e-2)
    assert new["a"].dtype == opt["m"]["a"].dtype == torch.float32
    assert new["b"].dtype == opt["v"]["b"].dtype == F64


@pytest.mark.parametrize("model", ["sgpr", "gplvm"])
def test_fit_svi_full_batch_trajectory_matches_jax(rng, model):
    """batch_blocks >= nb: the SVI step is the exact fold in both packages,
    so 5 Adam steps from the same start give the same parameters and
    history, at 1e-10."""
    if model == "sgpr":
        x, y = make_regression(rng, n=70, q=2, d=2)
        jm = JSGPR(x, y, num_inducing=6, seed=0, chunk_size=16,
                   batch_blocks=5)
        tm = rt.SGPR(x, y, num_inducing=6, seed=0, chunk_size=16,
                     batch_blocks=5, device="cpu")
    else:
        y = rng.standard_normal((40, 3))
        jm = JGPLVM(y, q=2, num_inducing=5, seed=0, chunk_size=8,
                    batch_blocks=5)
        tm = rt.BayesianGPLVM(y, q=2, num_inducing=5, seed=0, chunk_size=8,
                              batch_blocks=5, device="cpu")
    jres = jm.fit_svi(steps=5, lr=2e-2, seed=0)
    tres = tm.fit_svi(steps=5, lr=2e-2, seed=0)
    np.testing.assert_allclose(tres.history, jres.history, rtol=1e-10)
    for a, b in zip(jax.tree.leaves(_np(tm.params)),
                    jax.tree.leaves(jm.params)):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-10, atol=1e-12)


# -- DistributedGP(batch_blocks) on 4 gloo ranks against JAX on 4 devices -------

N, M, Q, D, W, CHUNK, B = 101, 7, 2, 2, 4, 4, 2   # 7 blocks a shard
# name: (latent, failure_mode, fmask, argnums)
DIST_CASES = {
    "reg_drop": (False, "drop", (1, 1, 1, 1), (0, 1)),
    "reg_fail_drop": (False, "drop", (1, 0, 1, 1), (0, 1)),
    "reg_fail_rescale": (False, "rescale", (1, 0, 1, 1), (0, 1)),
    "lat_fail_rescale": (True, "rescale", (1, 0, 1, 1), (0, 1, 2, 3)),
}


def _dist_inputs():
    rng = np.random.default_rng(5)
    return (rng.standard_normal((N, Q)), rng.standard_normal((N, D)),
            rng.uniform(0.05, 0.6, (N, Q)), rng.standard_normal((M, Q)),
            _hyp(Q))


def _flatten(prefix, out, argnums, grads):
    for i, g in zip(argnums, grads):
        if isinstance(g, dict):
            for k, v in g.items():
                out[f"{prefix}/g{i}/{k}"] = np.asarray(v)
        else:
            out[f"{prefix}/g{i}"] = np.asarray(g)


_JAX_WORKER = """
import sys
import jax
import jax.numpy as jnp
import numpy as np
sys.path.insert(0, {tests!r})
import test_torch_svi as t
from repro.core import DistributedGP
from repro.core.stats import sample_block_indices
from repro.launch.mesh import make_compat_mesh

mesh = make_compat_mesh((t.W,), ("data",))
x, y, s, z, hyp = t._dist_inputs()
hyp = {{k: jnp.asarray(v) for k, v in hyp.items()}}
key = jax.random.PRNGKey(3)
out = {{}}
for name, (latent, mode, fmask, argnums) in t.DIST_CASES.items():
    eng = DistributedGP(mesh, data_axes=("data",), latent=latent,
                        failure_mode=mode, chunk_size=t.CHUNK,
                        batch_blocks=t.B)
    data, w = eng.put_data(**(dict(y=y, mu=x, s=s) if latent
                              else dict(y=y, mu=x)))
    nb = w.shape[0] // t.W // t.CHUNK
    fm = jnp.asarray(fmask, jnp.float64)
    nf = jnp.asarray(float(t.N))
    v, g = eng.make_value_and_grad(t.D, argnums=argnums)(
        hyp, jnp.asarray(z), data["mu"], data.get("s"), data["y"], w, fm, nf,
        key)
    out[name + "/value"] = np.asarray(v)
    out[name + "/bound"] = np.asarray(jax.jit(eng.bound_fn(t.D))(
        hyp, jnp.asarray(z), data["y"], data["mu"], data.get("s"), w, fm, nf,
        key))
    t._flatten(name, out, argnums, g)
for k in range(t.W):
    out[f"indices/{{k}}"] = np.asarray(sample_block_indices(
        jax.random.fold_in(key, k), nb, t.B))
np.savez({out!r}, **out)
print("JAX-REF-OK")
"""


@pytest.fixture(scope="module")
def jax_svi_ref(tmp_path_factory):
    out = tmp_path_factory.mktemp("jax_svi") / "ref.npz"
    env = {**os.environ, "XLA_FLAGS": "--xla_force_host_platform_device_count=4",
           "PYTHONPATH": os.pathsep.join([str(ROOT / "src"),
                                          os.environ.get("PYTHONPATH", "")])}
    code = _JAX_WORKER.format(tests=str(ROOT / "tests"), out=str(out))
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0 and "JAX-REF-OK" in res.stdout, \
        res.stdout + res.stderr
    return dict(np.load(out))


def _svi_rank(rank, world, store_path, out_dir):
    torch.set_num_threads(1)   # ranks share the cores: no oversubscription
    from repro_torch.launch import make_data_group

    group = make_data_group("cpu", store=dist.FileStore(store_path, world),
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=60))
    idx = np.load(pathlib.Path(out_dir) / "indices.npy")[rank]
    x, y, s, z, hyp = _dist_inputs()
    out = {}
    for name, (latent, mode, fmask, argnums) in DIST_CASES.items():
        eng = DistributedGP(group, latent=latent, failure_mode=mode,
                            chunk_size=CHUNK, batch_blocks=B, device="cpu")
        data, w = eng.put_data(**(dict(y=y, mu=x, s=s) if latent
                                  else dict(y=y, mu=x)))
        fm = np.asarray(fmask, np.float64)
        v, g = eng.make_value_and_grad(D, argnums=argnums)(
            _t(hyp), torch.from_numpy(z), data["mu"], data.get("s"),
            data["y"], w, fm, float(N), idx)
        out[name + "/value"] = v.numpy()
        out[name + "/bound"] = eng.bound_fn(D)(
            _t(hyp), torch.from_numpy(z), data["y"], data["mu"],
            data.get("s"), w, fm, float(N), idx).numpy()
        _flatten(name, out, argnums, g)
    np.savez(pathlib.Path(out_dir) / f"rank{rank}.npz", **out)
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def svi_ranks(jax_svi_ref, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("svi_ranks")
    np.save(tmp / "indices.npy",
            np.stack([jax_svi_ref[f"indices/{k}"] for k in range(W)]))
    codes, _ = spawn_ranks(_svi_rank, W, tmp)
    assert codes == [0] * W, f"rank exit codes {codes}"
    return [dict(np.load(tmp / f"rank{r}.npz")) for r in range(W)]


@pytest.mark.parametrize("case", list(DIST_CASES))
def test_svi_engine_on_four_ranks_matches_jax(case, svi_ranks, jax_svi_ref):
    argnums = DIST_CASES[case][3]
    for r in svi_ranks:
        for key in ("value", "bound"):
            want = float(jax_svi_ref[f"{case}/{key}"])
            assert abs(float(r[f"{case}/{key}"]) - want) <= 1e-10 * abs(want)
    keys = [k for k in jax_svi_ref if k.startswith(f"{case}/g")]
    assert len(keys) == 3 * (0 in argnums) + (1 in argnums) \
        + (2 in argnums) + (3 in argnums)
    for k in keys:
        if k.endswith(("/g2", "/g3")):   # mu/s: each rank's own rows
            got = np.concatenate([r[k] for r in svi_ranks])
        else:
            got = svi_ranks[0][k]
            for r in svi_ranks[1:]:
                np.testing.assert_array_equal(r[k], got, err_msg=k)
        np.testing.assert_allclose(got, jax_svi_ref[k], rtol=1e-8,
                                   atol=1e-10, err_msg=k)
