"""The port's distributed Map-Reduce (``repro_torch.core.distributed``)
against the JAX package's ``DistributedGP``.

The reference runs in one subprocess on 4 placeholder devices (a mesh
``(4,)`` over axis ``"data"``, as ``tests/test_distributed.py`` runs its
worker); the port runs 4 gloo ranks spawned with ``torch.multiprocessing``,
joined through a ``FileStore`` under ``tmp_path`` (no port is shared between
test workers).  Both take the same numpy inputs, at the shape of
``tests/_dist_worker.py`` (n 101, ragged over 4 shards), and write their
values, gradients, reduced Stats and predictive states to ``.npz`` files.
Tolerances are ``_dist_worker``'s: value 1e-9 relative, gradients rtol 1e-8 /
atol 1e-10, reduced Stats and states 1e-10.
"""
import datetime
import os
import pathlib
import subprocess
import sys
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.core import distributed as jdist
from repro.core.bound import collapsed_bound as j_collapsed_bound
from repro.core.stats import partial_stats as j_partial_stats
from test_torch_spawn import spawn_ranks

ROOT = pathlib.Path(__file__).resolve().parents[1]
N, M, Q, D, W = 101, 9, 2, 3, 4
GROUP_TIMEOUT = datetime.timedelta(seconds=60)

# name: (latent, failure_mode, chunk_size, fmask, argnums)
CASES = {
    "reg_ones": (False, "drop", None, (1, 1, 1, 1), (0, 1)),
    "reg_ones_chunk4": (False, "drop", 4, (1, 1, 1, 1), (0, 1)),
    "reg_fail_drop": (False, "drop", None, (1, 0, 1, 1), (0, 1)),
    "reg_fail_rescale": (False, "rescale", None, (1, 0, 1, 1), (0, 1)),
    "lat_ones": (True, "drop", None, (1, 1, 1, 1), (0, 1, 2, 3)),
    "lat_fail_drop": (True, "drop", None, (1, 0, 1, 1), (0, 1, 2, 3)),
}
# The cases whose reduced Stats and predictive state are compared too.
STATE_CASES = ("reg_fail_drop", "lat_ones")
STATE_FIELDS = ("chol_kmm", "chol_sigma", "c2", "a_mean", "g")
STATS_FIELDS = ("A", "B", "C", "D", "KL", "n")


def _inputs():
    rng = np.random.default_rng(7)
    x = rng.standard_normal((N, Q))
    y = rng.standard_normal((N, D))
    s = rng.uniform(0.05, 0.6, (N, Q))
    z = rng.standard_normal((M, Q))
    hyp = {"log_sf2": np.float64(0.1), "log_ell": np.zeros(Q),
           "log_beta": np.float64(0.5)}
    return x, y, s, z, hyp


def _flatten(prefix, out, argnums, grads):
    for i, g in zip(argnums, grads):
        if isinstance(g, dict):
            for k, v in g.items():
                out[f"{prefix}/g{i}/{k}"] = np.asarray(v)
        else:
            out[f"{prefix}/g{i}"] = np.asarray(g)


# -- the JAX reference, in a subprocess on 4 placeholder devices -------------

_JAX_WORKER = """
import sys
import jax
import jax.numpy as jnp
import numpy as np
sys.path.insert(0, {tests!r})
import test_torch_distributed as t
from repro.core import DistributedGP
from repro.launch.mesh import make_compat_mesh

mesh = make_compat_mesh((t.W,), ("data",))
x, y, s, z, hyp = t._inputs()
hyp = {{k: jnp.asarray(v) for k, v in hyp.items()}}
out = {{}}
for name, (latent, mode, chunk, fmask, argnums) in t.CASES.items():
    eng = DistributedGP(mesh, data_axes=("data",), latent=latent,
                        failure_mode=mode, chunk_size=chunk)
    data, w = eng.put_data(**(dict(y=y, mu=x, s=s) if latent
                              else dict(y=y, mu=x)))
    sd = data.get("s")
    fm = jnp.asarray(fmask, jnp.float64)
    nf = jnp.asarray(float(t.N))
    v, g = eng.make_value_and_grad(t.D, argnums=argnums)(
        hyp, jnp.asarray(z), data["mu"], sd, data["y"], w, fm, nf)
    out[name + "/value"] = np.asarray(v)
    out[name + "/bound"] = np.asarray(jax.jit(eng.bound_fn(t.D))(
        hyp, jnp.asarray(z), data["y"], data["mu"], sd, w, fm, nf))
    t._flatten(name, out, argnums, g)
    if name in t.STATE_CASES:
        st = eng.reduced_stats(t.D)(hyp, jnp.asarray(z), data["y"],
                                    data["mu"], sd, w, fm)
        for f in t.STATS_FIELDS:
            out[name + "/stats/" + f] = np.asarray(getattr(st, f))
        ps = eng.predictive_state(hyp, jnp.asarray(z), data["y"], data["mu"],
                                  sd, w, fm)
        for f in t.STATE_FIELDS:
            out[name + "/state/" + f] = np.asarray(getattr(ps, f))
np.savez({out!r}, **out)
print("JAX-REF-OK")
"""


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    out = tmp_path_factory.mktemp("jax_ref") / "ref.npz"
    env = {**os.environ, "XLA_FLAGS": "--xla_force_host_platform_device_count=4",
           "PYTHONPATH": os.pathsep.join([str(ROOT / "src"),
                                          os.environ.get("PYTHONPATH", "")])}
    code = _JAX_WORKER.format(tests=str(ROOT / "tests"), out=str(out))
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0 and "JAX-REF-OK" in res.stdout, \
        res.stdout + res.stderr
    return dict(np.load(out))


# -- the port, 4 gloo ranks ----------------------------------------------------

def _rank_main(rank, world, store_path, out_dir):
    torch.set_num_threads(1)   # ranks share the cores: no oversubscription
    from repro_torch.core.distributed import DistributedGP
    from repro_torch.launch import make_data_group

    group = make_data_group("cpu", store=dist.FileStore(store_path, world),
                            rank=rank, world_size=world, timeout=GROUP_TIMEOUT)
    x, y, s, z, hyp = _inputs()
    hyp = {k: torch.as_tensor(v, dtype=torch.float64) for k, v in hyp.items()}
    zt = torch.from_numpy(z)
    out = {}
    for name, (latent, mode, chunk, fmask, argnums) in CASES.items():
        eng = DistributedGP(group, latent=latent, failure_mode=mode,
                            chunk_size=chunk, device="cpu")
        data, w = eng.put_data(**(dict(y=y, mu=x, s=s) if latent
                                  else dict(y=y, mu=x)))
        sd = data.get("s")
        fm = np.asarray(fmask, np.float64)
        v, g = eng.make_value_and_grad(D, argnums=argnums)(
            hyp, zt, data["mu"], sd, data["y"], w, fm, float(N))
        out[name + "/value"] = v.numpy()
        out[name + "/bound"] = eng.bound_fn(D)(
            hyp, zt, data["y"], data["mu"], sd, w, fm, float(N)).numpy()
        _flatten(name, out, argnums, g)
        if name in STATE_CASES:
            st = eng.reduced_stats(D)(hyp, zt, data["y"], data["mu"], sd, w,
                                      fm)
            for f in STATS_FIELDS:
                out[f"{name}/stats/{f}"] = getattr(st, f).numpy()
            ps = eng.predictive_state(hyp, zt, data["y"], data["mu"], sd, w,
                                      fm)
            for f in STATE_FIELDS:
                out[f"{name}/state/{f}"] = getattr(ps, f).numpy()
    np.savez(pathlib.Path(out_dir) / f"rank{rank}.npz", **out)
    dist.destroy_process_group()


def _rank_dies(rank, world, store_path, out_dir):
    """Rank 1 leaves after joining; rank 0 then takes a step."""
    torch.set_num_threads(1)   # ranks share the cores: no oversubscription
    from repro_torch.core.distributed import DistributedGP
    from repro_torch.launch import make_data_group

    group = make_data_group("cpu", store=dist.FileStore(store_path, world),
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=10))
    if rank == 1:
        os._exit(0)
    x, y, _, z, hyp = _inputs()
    eng = DistributedGP(group, device="cpu")
    data, w = eng.put_data(y=y, mu=x)
    time.sleep(1.0)
    eng.make_value_and_grad(D)(
        {k: torch.as_tensor(v, dtype=torch.float64) for k, v in hyp.items()},
        torch.from_numpy(z), data["mu"], None, data["y"], w, np.ones(world),
        float(N))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ranks")
    codes, _ = spawn_ranks(_rank_main, W, tmp)
    assert codes == [0] * W, f"rank exit codes {codes}"
    return [dict(np.load(tmp / f"rank{r}.npz")) for r in range(W)]


def _gathered(ranks, key):
    """A row-sharded gradient: the ranks' blocks in rank order."""
    return np.concatenate([r[key] for r in ranks])


@pytest.mark.parametrize("case", list(CASES))
def test_value_and_grad_match_jax_on_four_ranks(case, ranks, jax_ref):
    argnums = CASES[case][4]
    for r in ranks:
        for key in ("value", "bound"):
            want = float(jax_ref[f"{case}/{key}"])
            assert abs(float(r[f"{case}/{key}"]) - want) <= 1e-9 * abs(want)
    keys = [k for k in jax_ref if k.startswith(f"{case}/g")]
    assert len(keys) == 3 * (0 in argnums) + (1 in argnums) \
        + (2 in argnums) + (3 in argnums)
    for k in keys:
        if k.endswith(("/g2", "/g3")):   # mu/s: each rank's own rows
            got = _gathered(ranks, k)
        else:
            got = ranks[0][k]
        np.testing.assert_allclose(got, jax_ref[k], rtol=1e-8, atol=1e-10,
                                   err_msg=k)


@pytest.mark.parametrize("case", STATE_CASES)
@pytest.mark.parametrize("what", ["stats", "state"])
def test_reduced_stats_and_predictive_state_match_jax(case, what, ranks,
                                                      jax_ref):
    keys = [k for k in jax_ref if k.startswith(f"{case}/{what}/")]
    assert len(keys) == len(STATS_FIELDS if what == "stats" else STATE_FIELDS)
    for r in ranks:
        for k in keys:
            np.testing.assert_allclose(r[k], jax_ref[k], rtol=1e-10,
                                       atol=1e-10, err_msg=k)


def test_every_rank_sees_the_same_bits(ranks):
    """The reduced Stats, the bound and the (hyp, z) gradients are bitwise
    the same on every rank: SCG takes the same step everywhere."""
    shared = [k for k in ranks[0] if not k.endswith(("/g2", "/g3"))]
    for r in ranks[1:]:
        for k in shared:
            np.testing.assert_array_equal(r[k], ranks[0][k], err_msg=k)


def test_failed_rank_fails_the_run_within_the_timeout(tmp_path):
    """A rank that dies makes the others' collective raise (connection
    closed, or the group's 10 s timeout): the run exits non-zero and hangs
    no rank."""
    codes, took = spawn_ranks(_rank_dies, 2, tmp_path, timeout=90)
    assert codes[1] == 0
    assert codes[0] not in (None, 0), codes
    assert took < 90


# -- a world of one, in this process -------------------------------------------

@pytest.fixture
def world_of_one():
    from repro_torch.launch import make_data_group

    assert not dist.is_initialized()
    group = make_data_group("cpu", timeout=GROUP_TIMEOUT)
    try:
        yield group
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("chunk", [None, 4])
@pytest.mark.parametrize("latent", [False, True])
def test_world_of_one_matches_jax_sequential(world_of_one, latent, chunk):
    from repro_torch.core.distributed import DistributedGP

    x, y, s, z, hyp = _inputs()
    eng = DistributedGP(world_of_one, latent=latent, chunk_size=chunk,
                        device="cpu")
    assert (eng.n_shards, eng.rank) == (1, 0)
    data, w = eng.put_data(**(dict(y=y, mu=x, s=s) if latent
                              else dict(y=y, mu=x)))
    v, (gh, gz) = eng.make_value_and_grad(D)(
        {k: torch.as_tensor(a, dtype=torch.float64) for k, a in hyp.items()},
        torch.from_numpy(z), data["mu"], data.get("s"), data["y"], w,
        np.ones(1), float(N))

    import jax

    def neg(h, zz):
        st = j_partial_stats(h, zz, jnp.asarray(y), jnp.asarray(x),
                             s=jnp.asarray(s) if latent else None,
                             latent=latent)
        return -j_collapsed_bound(h, zz, st, D)

    v_ref, (gh_ref, gz_ref) = jax.value_and_grad(neg, argnums=(0, 1))(
        {k: jnp.asarray(a) for k, a in hyp.items()}, jnp.asarray(z))
    assert abs(float(v) - float(v_ref)) <= 1e-9 * abs(float(v_ref))
    np.testing.assert_allclose(gz.numpy(), np.asarray(gz_ref), rtol=1e-8,
                               atol=1e-10)
    for k in gh_ref:
        np.testing.assert_allclose(gh[k].numpy(), np.asarray(gh_ref[k]),
                                   rtol=1e-8, atol=1e-10, err_msg=k)


def test_make_gp_train_step_is_the_engine_step(world_of_one):
    from repro_torch.core.distributed import DistributedGP
    from repro_torch.train.steps import make_gp_train_step

    x, y, s, z, hyp = _inputs()
    eng, step = make_gp_train_step(world_of_one, D, latent=True,
                                   failure_mode="rescale", chunk_size=8,
                                   argnums=(0, 1, 2, 3), device="cpu")
    ref = DistributedGP(world_of_one, latent=True, failure_mode="rescale",
                        chunk_size=8, device="cpu")
    assert isinstance(eng, DistributedGP)
    data, w = eng.put_data(y=y, mu=x, s=s)
    args = ({k: torch.as_tensor(a, dtype=torch.float64)
             for k, a in hyp.items()}, torch.from_numpy(z), data["mu"],
            data["s"], data["y"], w, np.ones(1), float(N))
    v, g = step(*args)
    v_ref, g_ref = ref.make_value_and_grad(D, argnums=(0, 1, 2, 3))(*args)
    assert torch.equal(v, v_ref)
    for a, b in zip([*g[0].values(), *g[1:]], [*g_ref[0].values(), *g_ref[1:]]):
        assert torch.equal(a, b)


def test_failed_cholesky_gives_nan_value_and_gradient(world_of_one):
    """A wild step (log_beta huge: a singular global factor) gives NaN
    value and gradient, and the step still returns on every rank."""
    from repro_torch.core.distributed import DistributedGP

    x, y, _, z, hyp = _inputs()
    eng = DistributedGP(world_of_one, device="cpu")
    data, w = eng.put_data(y=y, mu=x)
    bad = {k: torch.as_tensor(a, dtype=torch.float64) for k, a in hyp.items()}
    bad["log_sf2"] = torch.tensor(float("nan"), dtype=torch.float64)
    v, (gh, gz) = eng.make_value_and_grad(D)(
        bad, torch.from_numpy(z), data["mu"], None, data["y"], w, np.ones(1),
        float(N))
    assert np.isnan(float(v))
    assert bool(torch.isnan(gz).all())
    assert all(bool(torch.isnan(g).all()) for g in gh.values())
    assert np.isnan(float(eng.bound_fn(D)(bad, torch.from_numpy(z),
                                          data["y"], data["mu"], None, w,
                                          np.ones(1), float(N))))


# -- layout, options, devices ----------------------------------------------------

@pytest.mark.parametrize("block", [None, 4])
@pytest.mark.parametrize("shards", [1, 4])
@pytest.mark.parametrize("n", [0, 1, 101])
def test_pad_and_shard_and_unpad_match_jax(n, shards, block):
    from repro_torch.core.distributed import pad_and_shard, unpad

    rng = np.random.default_rng(n)
    arrs = {"y": rng.standard_normal((n, 3)), "mu": rng.standard_normal((n, 2)),
            "s": rng.uniform(0.1, 1.0, (n, 2))}
    got, w = pad_and_shard(arrs, shards, block=block)
    want, w_ref = jdist.pad_and_shard(arrs, shards, block=block)
    np.testing.assert_array_equal(w, w_ref)
    assert w.shape[0] % (shards * (block or 1)) == 0 and w.shape[0] > 0
    for k in arrs:
        np.testing.assert_array_equal(got[k], want[k])
        assert got[k].dtype == want[k].dtype
    np.testing.assert_array_equal(got["s"][n:], 1.0)
    back = unpad(got, n)
    for k in arrs:
        np.testing.assert_array_equal(back[k], arrs[k])
    np.testing.assert_array_equal(unpad(got["y"], n),
                                  jdist.unpad(want["y"], n))


def _engine(**kw):
    from repro_torch.core.distributed import DistributedGP

    return DistributedGP(device="cpu", **kw)


@pytest.mark.parametrize("make, item", [
    (lambda: _engine(batch_blocks=2, chunk_size=4), "item 3"),
    (lambda: _engine(chunk_size=4, reduce_mode="overlap"), "item 11"),
    (lambda: _engine(chunk_size=4, reduce_mode="overlap_eager"), "item 11"),
    (lambda: _engine(psi2_fn=lambda *a: None), "items 5 and 6"),
    (lambda: _engine(reg_stats_fn=lambda *a: None), "items 5 and 6"),
    (lambda: _engine(kernel={"kind": "matern32"}), "Kernel zoo"),
    (lambda: _engine().put_data(stream=object()), "item 9"),
    (lambda: _engine().open_stream(object()), "item 9"),
    (lambda: _engine().streamed_stats(None, None, None), "item 9"),
    (lambda: _engine().streamed_bound(None, None, None, 1), "item 9"),
    (lambda: _engine().streamed_value_and_grad(1), "item 9"),
    (lambda: _engine().streamed_svi_value_and_grad(1, 1), "item 9"),
    (lambda: _engine().streamed_predictive_state(None, None, None), "item 9"),
    (lambda: _engine().update_stats_fn(1), "item 7"),
    (lambda: _engine().update_predictive_state(None, None, None), "item 7"),
    (lambda: _engine().downdate_predictive_state(None, None, None), "item 7"),
    (lambda: _engine().predict_engine(None), "item 4"),
    (lambda: _engine().multi_predict_engine([None]), "item 8"),
])
def test_unported_options_raise_naming_their_roadmap_item(make, item):
    with pytest.raises(NotImplementedError, match=item):
        make()


def test_make_gp_train_step_refuses_unported_options():
    from repro_torch.train.steps import make_gp_train_step

    with pytest.raises(NotImplementedError, match="item 3"):
        make_gp_train_step(None, 1, chunk_size=4, batch_blocks=1,
                           device="cpu")
    with pytest.raises(NotImplementedError, match="item 11"):
        make_gp_train_step(None, 1, chunk_size=4, reduce_mode="overlap",
                           device="cpu")


def test_bad_arguments_raise():
    with pytest.raises(ValueError, match="chunk_size"):
        _engine(chunk_size=0)
    with pytest.raises(ValueError, match="failure_mode"):
        _engine(failure_mode="ignore")
    with pytest.raises(ValueError, match="argnums"):
        _engine().make_value_and_grad(1, argnums=(4,))


def test_no_cuda_no_fallback():
    """``device=None`` means the card: without one, the engine and the
    group refuse instead of running on the CPU."""
    from repro_torch.core.distributed import DistributedGP
    from repro_torch.launch import make_data_group

    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DistributedGP()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_data_group()
    assert not dist.is_initialized()
