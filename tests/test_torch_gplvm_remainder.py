"""The rest of the Bayesian GPLVM against the JAX package: ``oilflow_like``,
``se_psi2`` and the matmul forms of psi2 (``psi2_mxu``, ``psi2_mxu_sym``),
the deprecated aliases, the ``psi2_fn`` hook (``partial_stats_chunked`` and
``DistributedGP``, in a world of one and on 2 gloo ranks) and
``BayesianGPLVM.reconstruct`` (paper §4.5).

Tolerances: psi2 forms, hooked Stats and bounds within 1e-12 of the
reference (the same f64 formulas, summed in other orders); the hooked
gradient within the repo's f64 gradient tier (rtol 1e-8, atol 1e-10); the
reconstruction objective and its gradient at the initialisation within
1e-10; the reconstruction within 1e-6 relative after 30 SCG iterations
from the same parameters.
"""
import datetime
import pathlib
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

import repro_torch as rt
from repro.core import BayesianGPLVM as JGPLVM
from repro.core import gp_kernels as j_gpk
from repro.core.stats import partial_stats_chunked as j_chunked
from repro.data import synthetic as j_synth
from repro_torch import convert
from repro_torch.core import gp_kernels as t_gpk
from repro_torch.core.flat import Flat, neg_value_and_grad
from repro_torch.core.stats import partial_stats_chunked as t_chunked
from repro_torch.data import synthetic as t_synth
from repro_torch.kernels.psi_stats import psi2_fn_for_engine
from test_torch_spawn import spawn_ranks

CPU = "cpu"
N, Q, M, D = 83, 3, 9, 4
STATS = ("A", "B", "C", "D", "KL", "n")


def _inputs(m=M):
    rng = np.random.default_rng(5)
    mu = rng.standard_normal((N, Q))
    s = rng.uniform(0.05, 0.8, (N, Q))
    w = (rng.uniform(size=N) > 0.2).astype(np.float64)
    z = rng.standard_normal((m, Q))
    y = rng.standard_normal((N, D))
    hyp = {"log_sf2": np.float64(0.2), "log_ell": rng.uniform(-0.3, 0.3, Q),
           "log_beta": np.float64(0.7)}
    return hyp, z, mu, s, w, y


def _t(tree):
    if isinstance(tree, dict):
        return {k: _t(v) for k, v in tree.items()}
    return torch.as_tensor(np.asarray(tree, np.float64))


def _j(tree):
    if isinstance(tree, dict):
        return {k: _j(v) for k, v in tree.items()}
    return jnp.asarray(tree)


@pytest.mark.parametrize("n", [1, 120, 1000])
def test_oilflow_like_matches_reference(n):
    got = t_synth.oilflow_like(np.random.default_rng(n), n=n)
    want = j_synth.oilflow_like(np.random.default_rng(n), n=n)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("m,chunk,tile", [(9, 1024, 64), (9, 16, 4),
                                          (70, 32, 64), (33, 50, 16)])
def test_psi2_forms_match_jax(m, chunk, tile):
    hyp, z, mu, s, w, _ = _inputs(m)
    want = np.asarray(j_gpk.psi2_mxu(_j(hyp), _j(z), _j(mu), _j(s), _j(w),
                                     chunk=chunk))
    got = t_gpk.psi2_mxu(_t(hyp), _t(z), _t(mu), _t(s), _t(w), chunk=chunk)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-12)
    want_sym = np.asarray(j_gpk.psi2_mxu_sym(_j(hyp), _j(z), _j(mu), _j(s),
                                             _j(w), chunk=chunk, tile=tile))
    got_sym = t_gpk.psi2_mxu_sym(_t(hyp), _t(z), _t(mu), _t(s), _t(w),
                                 chunk=chunk, tile=tile)
    assert torch.equal(got_sym, got_sym.T)
    np.testing.assert_allclose(got_sym.numpy(), want_sym, rtol=1e-12,
                               atol=1e-12)
    want_se = np.asarray(j_gpk.se_psi2(_j(hyp), _j(z), _j(mu), _j(s)))
    got_se = t_gpk.se_psi2(_t(hyp), _t(z), _t(mu), _t(s))
    np.testing.assert_allclose(got_se.numpy(), want_se, rtol=1e-12,
                               atol=1e-12)
    # the weighted forms agree with the kernel's own psi2
    np.testing.assert_allclose(got.numpy(), psi2_fn_for_engine()(
        _t(hyp), _t(z), _t(mu), _t(s), _t(w)).numpy(), rtol=1e-12,
        atol=1e-12)


def test_psi2_mxu_gradient_matches_the_direct_form():
    hyp, z, mu, s, w, _ = _inputs()
    g = torch.from_numpy(np.random.default_rng(1).standard_normal((M, M)))

    def grads(fn):
        h, zz, mm, ss = _t(hyp), _t(z), _t(mu), _t(s)
        leaves = [h["log_sf2"], h["log_ell"], zz, mm, ss]
        for t in leaves:
            t.requires_grad_()
        out = (fn(h, zz, mm, ss, _t(w)) * g).sum()
        return torch.autograd.grad(out, leaves)

    for a, b in zip(grads(t_gpk.psi2_mxu), grads(psi2_fn_for_engine())):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-10,
                                   atol=1e-12)


ALIASES = [("ard_kernel", "se_kernel", lambda h, z, mu, s: (h, mu, z)),
           ("ard_kdiag", "se_kdiag", lambda h, z, mu, s: (h, mu)),
           ("psi0", "se_psi0", lambda h, z, mu, s: (h, mu, s)),
           ("psi1", "se_psi1", lambda h, z, mu, s: (h, z, mu, s)),
           ("psi2", "se_psi2", lambda h, z, mu, s: (h, z, mu, s))]


@pytest.mark.parametrize("old,new,args", ALIASES, ids=[a[0] for a in ALIASES])
def test_deprecated_aliases_warn_once_and_match(old, new, args, monkeypatch):
    monkeypatch.setattr(t_gpk, "_DEPRECATION_WARNED", set())
    # The reference warns once per process too: another test file on the
    # same worker may have used its alias already.
    monkeypatch.setattr(j_gpk, "_DEPRECATION_WARNED", set())
    hyp, z, mu, s, _, _ = _inputs()
    with pytest.warns(DeprecationWarning, match=f"{old} is deprecated; use "
                      f"gp_kernels.{new}"):
        got = getattr(t_gpk, old)(*args(_t(hyp), _t(z), _t(mu), _t(s)))
    with warnings.catch_warnings():
        warnings.simplefilter("error")   # the second call is silent
        getattr(t_gpk, old)(*args(_t(hyp), _t(z), _t(mu), _t(s)))
    assert torch.equal(got, getattr(t_gpk, new)(
        *args(_t(hyp), _t(z), _t(mu), _t(s))))
    with pytest.warns(DeprecationWarning):
        want = getattr(j_gpk, old)(*args(_j(hyp), _j(z), _j(mu), _j(s)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12,
                               atol=1e-12)


def _hooks():
    """(port hook, JAX hook) pairs: the kernel's own psi2, and psi2_mxu."""
    return {"engine": (psi2_fn_for_engine(), None),
            "mxu": (t_gpk.psi2_mxu, j_gpk.psi2_mxu)}


@pytest.mark.parametrize("block", [None, 16])
@pytest.mark.parametrize("hook", ["engine", "mxu"])
def test_psi2_fn_through_chunked_map_matches_jax(hook, block):
    hyp, z, mu, s, w, y = _inputs()
    t_fn, j_fn = _hooks()[hook]
    got = t_chunked(_t(hyp), _t(z), _t(y), _t(mu), s=_t(s), weights=_t(w),
                    latent=True, block_size=block, psi2_fn=t_fn)
    want = j_chunked(_j(hyp), _j(z), _j(y), _j(mu), s=_j(s), weights=_j(w),
                     latent=True, block_size=block, psi2_fn=j_fn)
    for f in STATS:
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(want, f)), rtol=1e-12,
                                   atol=1e-12, err_msg=f)


def test_psi2_fn_for_engine_refuses_other_kernels():
    """Since the kernel zoo (ROADMAP Queue 1 item 6) the shim no longer
    refuses another expression: it hands back that expression's own psi2,
    the JAX shim's closure at 1e-12."""
    from repro.core.covariance import kernel_from_spec as j_spec
    from repro.kernels.psi_stats import psi2_fn_for_engine as j_shim

    spec = {"kind": "matern32", "dims": None, "quad_order": 5}
    hyp, z, mu, s, w, _ = _inputs()
    got = psi2_fn_for_engine(kernel=spec)(_t(hyp), _t(z), _t(mu), _t(s),
                                          _t(w))
    want = j_shim(kernel=j_spec(spec))(_j(hyp), _j(z), _j(mu), _j(s), _j(w))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12,
                               atol=1e-12)


# -- the hook through DistributedGP ---------------------------------------------

@pytest.fixture(scope="module")
def jax_hooks():
    """The reference engine's results with each hook, computed once."""
    return {hook: _jax_engine(hook) for hook in ("engine", "mxu")}


def _jax_engine(hook):
    """The reference engine on one device: bound, reduced Stats and the
    (hyp, z) gradient with the hook."""
    from repro.core import DistributedGP as JDGP
    from repro.launch.mesh import make_compat_mesh

    hyp, z, mu, s, w, y = _inputs()
    eng = JDGP(make_compat_mesh((1,), ("data",)), latent=True, chunk_size=16,
               psi2_fn=_hooks()[hook][1])
    data, wd = eng.put_data(y=y, mu=mu, s=s)
    wd = wd * jnp.pad(jnp.asarray(w), (0, wd.shape[0] - N))
    args = (_j(hyp), _j(z), data["y"], data["mu"], data["s"], wd,
            jnp.ones(1))
    out = {f: np.asarray(getattr(eng.reduced_stats(D)(*args), f))
           for f in STATS}
    neg, (gh, gz) = eng.make_value_and_grad(D)(
        _j(hyp), _j(z), data["mu"], data["s"], data["y"], wd, jnp.ones(1),
        jnp.asarray(float(N)))
    out["bound"] = -float(neg)
    out.update({f"g/{k}": np.asarray(v) for k, v in gh.items()})
    out["g/z"] = np.asarray(gz)
    return out


def _port_engine(group, hook, n_shards=1, rank=0):
    from repro_torch.core.distributed import DistributedGP, pad_and_shard

    hyp, z, mu, s, w, y = _inputs()
    eng = DistributedGP(group, latent=True, chunk_size=16, device=CPU,
                        psi2_fn=_hooks()[hook][0])
    data, wd = eng.put_data(y=y, mu=mu, s=s)
    padded, _ = pad_and_shard({"w": w}, n_shards, block=16)
    rows = wd.shape[0]
    wd = wd * torch.from_numpy(padded["w"][rank * rows:(rank + 1) * rows])
    args = (_t(hyp), _t(z), data["y"], data["mu"], data["s"], wd,
            np.ones(n_shards))
    out = {"bound": float(eng.bound_fn(D)(*args, float(N))),
           **{f: getattr(eng.reduced_stats(D)(*args), f).numpy()
              for f in STATS}}
    _, (gh, gz) = eng.make_value_and_grad(D)(
        _t(hyp), _t(z), data["mu"], data["s"], data["y"], wd,
        np.ones(n_shards), float(N))
    out.update({f"g/{k}": v.numpy() for k, v in gh.items()})
    out["g/z"] = gz.numpy()
    return out


def _compare(got, want):
    assert abs(got["bound"] - want["bound"]) <= 1e-12 * abs(want["bound"])
    for f in STATS:
        np.testing.assert_allclose(got[f], want[f], rtol=1e-12, atol=1e-12,
                                   err_msg=f)
    for k in want:
        if k.startswith("g/"):
            np.testing.assert_allclose(got[k], want[k], rtol=1e-8,
                                       atol=1e-10, err_msg=k)


@pytest.fixture
def world_of_one():
    from repro_torch.launch import make_data_group

    assert not dist.is_initialized()
    group = make_data_group(CPU, timeout=datetime.timedelta(seconds=60))
    try:
        yield group
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("hook", ["engine", "mxu"])
def test_psi2_fn_through_distributed_gp_in_a_world_of_one(world_of_one,
                                                          jax_hooks, hook):
    got = _port_engine(world_of_one, hook)
    _compare(got, jax_hooks[hook])
    if hook == "engine":   # the hook is the default kernel: the same bits
        from repro_torch.core.distributed import DistributedGP

        hyp, z, mu, s, w, y = _inputs()
        eng = DistributedGP(world_of_one, latent=True, chunk_size=16,
                            device=CPU)
        data, wd = eng.put_data(y=y, mu=mu, s=s)
        wd = wd * torch.from_numpy(np.pad(w, (0, wd.shape[0] - N)))
        assert float(eng.bound_fn(D)(_t(hyp), _t(z), data["y"], data["mu"],
                                     data["s"], wd, np.ones(1), float(N))) \
            == got["bound"]


def test_make_gp_train_step_passes_the_hook(world_of_one):
    from repro_torch.core.distributed import DistributedGP
    from repro_torch.train.steps import make_gp_train_step

    hyp, z, mu, s, w, y = _inputs()
    eng, step = make_gp_train_step(world_of_one, D, latent=True,
                                   chunk_size=16, argnums=(0, 1, 2, 3),
                                   psi2_fn=t_gpk.psi2_mxu, device=CPU)
    assert eng.psi2_fn is t_gpk.psi2_mxu
    ref = DistributedGP(world_of_one, latent=True, chunk_size=16, device=CPU,
                        psi2_fn=t_gpk.psi2_mxu)
    data, wd = eng.put_data(y=y, mu=mu, s=s)
    args = (_t(hyp), _t(z), data["mu"], data["s"], data["y"], wd, np.ones(1),
            float(N))
    v, g = step(*args)
    v_ref, g_ref = ref.make_value_and_grad(D, argnums=(0, 1, 2, 3))(*args)
    assert torch.equal(v, v_ref)
    for a, b in zip([*g[0].values(), *g[1:]], [*g_ref[0].values(),
                                              *g_ref[1:]]):
        assert torch.equal(a, b)


def _hook_rank(rank, world, store_path, out_dir):
    torch.set_num_threads(1)   # ranks share the cores: no oversubscription
    from repro_torch.launch import make_data_group

    group = make_data_group(CPU, store=dist.FileStore(store_path, world),
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=60))
    out = {}
    for hook in ("engine", "mxu"):
        out.update({f"{hook}/{k}": np.asarray(v) for k, v in
                    _port_engine(group, hook, world, rank).items()})
    np.savez(pathlib.Path(out_dir) / f"rank{rank}.npz", **out)
    dist.destroy_process_group()


def test_psi2_fn_through_distributed_gp_on_two_gloo_ranks(tmp_path,
                                                          jax_hooks):
    codes, _ = spawn_ranks(_hook_rank, 2, tmp_path)
    assert codes == [0, 0], codes
    ranks = [dict(np.load(tmp_path / f"rank{r}.npz")) for r in (0, 1)]
    for k in ranks[0]:   # the reduced Stats, bound and gradient: same bits
        np.testing.assert_array_equal(ranks[1][k], ranks[0][k], err_msg=k)
    for hook in ("engine", "mxu"):
        got = {k.split("/", 1)[1]: (float(v) if k.endswith("bound") else v)
               for k, v in ranks[0].items() if k.startswith(hook + "/")}
        _compare(got, jax_hooks[hook])


# -- reconstruct (paper §4.5) ----------------------------------------------------

@pytest.fixture(scope="module")
def recon():
    """A JAX GPLVM fitted 30 SCG iterations, its params carried to the
    port, and one held-out batch with a dimension missing."""
    rng = np.random.default_rng(0)
    y_all, _ = j_synth.sines_dataset(rng, n=200, noise=0.05)
    jm = JGPLVM(y_all, q=2, num_inducing=12, seed=1)
    jm.fit(max_iters=30)
    tm = rt.BayesianGPLVM(y_all, q=2, num_inducing=12, seed=1, device=CPU)
    tm.params = convert.params_from_numpy(jax.tree.map(np.asarray, jm.params),
                                          CPU)
    tm._invalidate_posterior()
    observed = np.array([True, True, False])
    ytest, _ = j_synth.sines_dataset(rng, n=10, noise=0.0)
    return jm, tm, ytest * observed, observed


def test_reconstruct_objective_and_init_match_jax(recon, monkeypatch):
    import repro.core.gplvm as j_gplvm_mod

    jm, tm, yp, observed = recon
    seen = {}
    real_scg = j_gplvm_mod.scg

    def spy(fg, x0, max_iters=200, **kw):
        seen["x0"] = np.array(x0)
        seen["value"], seen["grad"] = fg(x0)
        res = real_scg(fg, x0, max_iters=max_iters, **kw)
        seen["x"] = res.x
        return res

    monkeypatch.setattr(j_gplvm_mod, "scg", spy)
    want_rec = jm.reconstruct(yp, observed, iters=30)

    ypt, obs = torch.from_numpy(yp), torch.from_numpy(observed)
    local = tm._reconstruct_init(ypt, obs)
    flat = Flat(local)
    np.testing.assert_array_equal(flat.ravel(local), seen["x0"])
    # the reference's nearest neighbours, by its own (t, n, d) formula
    d2 = jnp.sum(jnp.where(jnp.asarray(observed)[None, None, :],
                           (jnp.asarray(yp)[:, None, :] - jm.y[None]) ** 2,
                           0.0), axis=-1)
    want_nn = np.asarray(jnp.argmin(d2, axis=1))
    np.testing.assert_array_equal(tm._nearest(ypt, obs).numpy(), want_nn)
    tm.NN_ELEMS = 3 * tm.n * tm.d   # three rows a block: the same answer
    try:
        np.testing.assert_array_equal(tm._nearest(ypt, obs).numpy(), want_nn)
    finally:
        del tm.NN_ELEMS
    v, g = neg_value_and_grad(tm._reconstruct_objective(
        ypt, obs, tm.predictive_state()), local)
    assert abs(v - seen["value"]) <= 1e-10 * abs(seen["value"])
    np.testing.assert_allclose(g, seen["grad"], rtol=1e-10, atol=1e-10)

    got_rec = tm.reconstruct(yp, observed, iters=30)
    assert got_rec.shape == want_rec.shape == (10, 3)
    assert np.linalg.norm(got_rec - want_rec) <= 1e-6 * np.linalg.norm(
        want_rec)


def test_reconstruct_of_nothing_is_empty(recon):
    _, tm, _, observed = recon
    assert tm.reconstruct(np.zeros((0, 3)), observed).shape == (0, 3)


def test_gplvm_reconstruction_beats_prior(rng):
    """tests/test_system.py::test_gplvm_reconstruction_beats_prior on the
    port: a trained GPLVM reconstructs held-out dims far better than the
    data mean."""
    y_all, _ = t_synth.sines_dataset(rng, n=200, noise=0.05)
    lv = rt.BayesianGPLVM(y_all, q=2, num_inducing=12, seed=1, device=CPU)
    lv.fit(max_iters=100)
    observed = np.array([True, True, False])
    ytest, _ = t_synth.sines_dataset(rng, n=10, noise=0.0)
    rec = lv.reconstruct(ytest * observed, observed, iters=40)
    err = float(np.mean(np.abs(rec[:, ~observed] - ytest[:, ~observed])))
    base = float(np.mean(np.abs(y_all[:, ~observed].mean(0)[None]
                                - ytest[:, ~observed])))
    assert err < 0.5 * base
