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
atol 1e-10, reduced Stats and states 1e-10.  The same spawn also runs the
kernel zoo's cases (a ``Sum`` regression and a Matern-3/2 GPLVM, ROADMAP
Queue 1 item 6) and the online fold of a new 19-row block into reduced
Stats (``update_stats_fn``, item 7), the latter at rtol 1e-11
(``tests/test_online_updates.py:165``), and the overlapped reduce (item
11: ``reduce_mode`` "overlap" and "overlap_eager", regression in blocks of
4 and the latent map under (1, 0, 1, 1) rescale) at the file's
tolerances, ``overlap`` bitwise ``overlap_eager`` on every rank.
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
# The overlapped reduce: name: CASES' fields, then the reduce_mode.
OVERLAP_CASES = {
    "reg_chunk4_overlap": (False, "drop", 4, (1, 1, 1, 1), (0, 1),
                           "overlap"),
    "reg_chunk4_overlap_eager": (False, "drop", 4, (1, 1, 1, 1), (0, 1),
                                 "overlap_eager"),
    "lat_fail_rescale_overlap": (True, "rescale", 4, (1, 0, 1, 1),
                                 (0, 1, 2, 3), "overlap"),
    "lat_fail_rescale_overlap_eager": (True, "rescale", 4, (1, 0, 1, 1),
                                       (0, 1, 2, 3), "overlap_eager"),
}
ALL_CASES = {**{k: v + ("serial",) for k, v in CASES.items()},
             **OVERLAP_CASES}
# The cases whose reduced Stats and predictive state are compared too.
STATE_CASES = ("reg_fail_drop", "lat_ones")
STATE_FIELDS = ("chol_kmm", "chol_sigma", "c2", "a_mean", "g")
STATS_FIELDS = ("A", "B", "C", "D", "KL", "n")
# The kernel zoo through the engine: name: (latent, kernel spec, argnums).
SUM_SPEC = {"kind": "sum", "parts": [{"kind": "se", "dims": [0]},
                                     {"kind": "linear", "dims": [1]}],
            "quad_order": 11}
ZOO_CASES = {
    "reg_sum": (False, SUM_SPEC, (0, 1)),
    "lat_matern32": (True, {"kind": "matern32", "dims": [0, 1],
                            "quad_order": 11}, (0, 1, 2, 3)),
}
# The online fold: name: (kernel spec, fmask); the new block has K_NEW rows.
FOLD_CASES = {"fold_se": (None, (1, 1, 1, 1)),
              "fold_sum_fail": (SUM_SPEC, (1, 0, 1, 1))}
K_NEW = 19   # odd: the new block pads unevenly over 4 shards


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
    def put(key, g):
        if isinstance(g, dict):
            for k, v in g.items():
                put(f"{key}/{k}", v)
        else:
            out[key] = np.asarray(g)
    for i, g in zip(argnums, grads):
        put(f"{prefix}/g{i}", g)


def _zoo_hyp(spec, hyp):
    """``hyp`` laid out for a kernel spec: nested under k0/k1 for the Sum."""
    if spec["kind"] != "sum":
        return hyp
    return {"k0": {"log_sf2": hyp["log_sf2"], "log_ell": hyp["log_ell"][:1]},
            "k1": {"log_sv2": hyp["log_ell"][1:] - 0.3},
            "log_beta": hyp["log_beta"]}


def _new_block():
    rng = np.random.default_rng(11)
    return rng.standard_normal((K_NEW, Q)), rng.standard_normal((K_NEW, D))


def _map_tree(fn, tree):
    return ({k: _map_tree(fn, v) for k, v in tree.items()}
            if isinstance(tree, dict) else fn(tree))


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
for name, (latent, mode, chunk, fmask, argnums, reduce) in t.ALL_CASES.items():
    eng = DistributedGP(mesh, data_axes=("data",), latent=latent,
                        failure_mode=mode, chunk_size=chunk,
                        reduce_mode=reduce)
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
for name, (latent, spec, argnums) in t.ZOO_CASES.items():
    eng = DistributedGP(mesh, data_axes=("data",), latent=latent,
                        kernel=spec)
    data, w = eng.put_data(**(dict(y=y, mu=x, s=s) if latent
                              else dict(y=y, mu=x)))
    h = t._map_tree(jnp.asarray, t._zoo_hyp(spec, t._inputs()[4]))
    ones = jnp.ones((t.W,))
    v, g = eng.make_value_and_grad(t.D, argnums=argnums)(
        h, jnp.asarray(z), data["mu"], data.get("s"), data["y"], w, ones,
        jnp.asarray(float(t.N)))
    out[name + "/value"] = np.asarray(v)
    t._flatten(name, out, argnums, g)
xn, yn = t._new_block()
for name, (spec, fmask) in t.FOLD_CASES.items():
    eng = DistributedGP(mesh, data_axes=("data",), kernel=spec)
    h = t._map_tree(jnp.asarray, t._zoo_hyp(spec or {{"kind": "se"}},
                                             t._inputs()[4]))
    fm = jnp.asarray(fmask, jnp.float64)
    data, w = eng.put_data(y=y, mu=x)
    base = eng.reduced_stats(t.D)(h, jnp.asarray(z), data["y"], data["mu"],
                                  None, w, fm)
    new, wn = eng.put_data(y=yn, mu=xn)
    st = eng.update_stats_fn(t.D)(base, h, jnp.asarray(z), new["y"],
                                  new["mu"], None, wn, fm)
    for f in t.STATS_FIELDS:
        out[name + "/stats/" + f] = np.asarray(getattr(st, f))
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
    for name, (latent, mode, chunk, fmask, argnums, reduce) in \
            ALL_CASES.items():
        eng = DistributedGP(group, latent=latent, failure_mode=mode,
                            chunk_size=chunk, reduce_mode=reduce,
                            device="cpu")
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
    for name, (latent, spec, argnums) in ZOO_CASES.items():
        eng = DistributedGP(group, latent=latent, kernel=spec, device="cpu")
        data, w = eng.put_data(**(dict(y=y, mu=x, s=s) if latent
                                  else dict(y=y, mu=x)))
        h = _map_tree(lambda v: torch.as_tensor(v, dtype=torch.float64),
                      _zoo_hyp(spec, _inputs()[4]))
        v, g = eng.make_value_and_grad(D, argnums=argnums)(
            h, zt, data["mu"], data.get("s"), data["y"], w, np.ones(W),
            float(N))
        out[name + "/value"] = v.numpy()
        _flatten(name, out, argnums, g)
    xn, yn = _new_block()
    for name, (spec, fmask) in FOLD_CASES.items():
        eng = DistributedGP(group, kernel=spec, device="cpu")
        h = _map_tree(lambda v: torch.as_tensor(v, dtype=torch.float64),
                      _zoo_hyp(spec or {"kind": "se"}, _inputs()[4]))
        fm = np.asarray(fmask, np.float64)
        data, w = eng.put_data(y=y, mu=x)
        base = eng.reduced_stats(D)(h, zt, data["y"], data["mu"], None, w, fm)
        new, wn = eng.put_data(y=yn, mu=xn)
        st = eng.update_stats_fn(D)(base, h, zt, new["y"], new["mu"], None,
                                    wn, fm)
        for f in STATS_FIELDS:
            out[f"{name}/stats/{f}"] = getattr(st, f).numpy()
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


@pytest.mark.parametrize("case", list(ALL_CASES))
def test_value_and_grad_match_jax_on_four_ranks(case, ranks, jax_ref):
    argnums = ALL_CASES[case][4]
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


@pytest.mark.parametrize("case", list(ZOO_CASES))
def test_kernel_zoo_value_and_grad_match_jax_on_four_ranks(case, ranks,
                                                           jax_ref):
    """A non-SE expression through the engine (nested hyper-parameters for
    the Sum): its value and gradients as JAX's engine gives them."""
    keys = [k for k in jax_ref if k.startswith(f"{case}/g")]
    assert len(keys) == len([k for k in ranks[0]
                             if k.startswith(f"{case}/g")]) >= 4
    want = float(jax_ref[f"{case}/value"])
    for r in ranks:
        assert abs(float(r[f"{case}/value"]) - want) <= 1e-9 * abs(want)
    for k in keys:
        got = _gathered(ranks, k) if k.endswith(("/g2", "/g3")) \
            else ranks[0][k]
        np.testing.assert_allclose(got, jax_ref[k], rtol=1e-8, atol=1e-10,
                                   err_msg=k)


@pytest.mark.parametrize("case", list(FOLD_CASES))
def test_online_fold_matches_jax_on_four_ranks(case, ranks, jax_ref):
    """``update_stats_fn`` on 4 gloo ranks (a ragged 19-row block, with and
    without a failed shard) against JAX's on 4 placeholder devices, and the
    same bits on every rank."""
    for f in STATS_FIELDS:
        k = f"{case}/stats/{f}"
        np.testing.assert_allclose(ranks[0][k], jax_ref[k], rtol=1e-11,
                                   atol=1e-11, err_msg=k)
        for r in ranks[1:]:
            np.testing.assert_array_equal(r[k], ranks[0][k], err_msg=k)


def test_every_rank_sees_the_same_bits(ranks):
    """The reduced Stats, the bound and the (hyp, z) gradients are bitwise
    the same on every rank: SCG takes the same step everywhere."""
    shared = [k for k in ranks[0] if not k.endswith(("/g2", "/g3"))]
    for r in ranks[1:]:
        for k in shared:
            np.testing.assert_array_equal(r[k], ranks[0][k], err_msg=k)


@pytest.mark.parametrize("case", ["reg_chunk4", "lat_fail_rescale"])
def test_overlap_is_bitwise_overlap_eager_on_every_rank(case, ranks):
    """The double buffer only moves each block's wait: both modes fold the
    same reduced values in the same order, value, bound and every
    gradient bitwise, on every rank."""
    ov, eager = f"{case}_overlap/", f"{case}_overlap_eager/"
    keys = [k for k in ranks[0] if k.startswith(ov)]
    assert len(keys) >= 4
    for r in ranks:
        for k in keys:
            np.testing.assert_array_equal(r[k], r[eager + k[len(ov):]],
                                          err_msg=k)


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


@pytest.mark.parametrize("mode", ["overlap", "overlap_eager"])
def test_unported_options_raise_naming_their_roadmap_item(mode):
    """The options this test once held refused (``reduce_mode`` "overlap"
    and "overlap_eager", ROADMAP Queue 1 item 11) are ported: each builds
    and steps without a group, bitwise the serial step, as JAX's
    one-device engine does (``tests/test_overlap_reduce.py``)."""
    x, y, _, z, hyp = _inputs()
    th = {k: torch.as_tensor(v, dtype=torch.float64) for k, v in hyp.items()}
    out = {}
    for m in ("serial", mode):
        eng = _engine(chunk_size=4, reduce_mode=m)
        assert eng.reduce_mode == m
        data, w = eng.put_data(y=y, mu=x)
        out[m] = eng.make_value_and_grad(D)(th, torch.from_numpy(z),
                                            data["mu"], None, data["y"], w,
                                            np.ones(1), float(N))
    assert torch.equal(out[mode][0], out["serial"][0])
    assert torch.equal(out[mode][1][1], out["serial"][1][1])
    for k in hyp:
        assert torch.equal(out[mode][1][0][k], out["serial"][1][0][k])


def _sequential_jax(hyp, x, y, z, kernel=None):
    """The JAX package's sequential map, bound and state (no mesh)."""
    import jax

    from repro.serve import extract_state as j_extract

    jh = _map_tree(jnp.asarray, hyp)
    st = j_partial_stats(jh, jnp.asarray(z), jnp.asarray(y), jnp.asarray(x),
                         s=None, latent=False, kernel=kernel)

    def neg(h, zz):
        return -j_collapsed_bound(h, zz, j_partial_stats(
            h, zz, jnp.asarray(y), jnp.asarray(x), s=None, latent=False,
            kernel=kernel), D, kernel=kernel)

    v, g = jax.value_and_grad(neg, argnums=(0, 1))(jh, jnp.asarray(z))
    return st, v, g, j_extract(jh, jnp.asarray(z), st, kernel=kernel)


def _assert_tree_close(got, want, **tol):
    if isinstance(want, dict):
        assert sorted(got) == sorted(want)
        for k in want:
            _assert_tree_close(got[k], want[k], **tol)
    else:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **tol)


def _ported_reg_stats_fn(eng, hyp, zt, data, w, x, y, z):
    """The hook is called, once per map, and its Stats drive the bound:
    a hook that counts around the dense map gives JAX's bound."""
    from repro_torch.core.stats import reg_stats_dense

    calls = []

    def hook(*args):
        calls.append(1)
        return reg_stats_dense(*args)

    hooked = _engine(reg_stats_fn=hook)
    assert hooked.reg_stats_fn is hook
    v, _ = hooked.make_value_and_grad(D)(hyp, zt, data["mu"], None,
                                         data["y"], w, np.ones(1), float(N))
    _, v_ref, _, _ = _sequential_jax(_inputs()[4], x, y, z)
    assert calls == [1]
    assert abs(float(v) - float(v_ref)) <= 1e-9 * abs(float(v_ref))


def _ported_kernel(eng, hyp, zt, data, w, x, y, z):
    """A Matern-3/2 engine: value and gradient as JAX's sequential ones."""
    spec = {"kind": "matern32"}
    m32 = _engine(kernel=spec)
    v, (gh, gz) = m32.make_value_and_grad(D)(hyp, zt, data["mu"], None,
                                             data["y"], w, np.ones(1),
                                             float(N))
    from repro.core.covariance import kernel_from_spec

    _, v_ref, (gh_ref, gz_ref), _ = _sequential_jax(
        _inputs()[4], x, y, z, kernel=kernel_from_spec(spec))
    assert abs(float(v) - float(v_ref)) <= 1e-9 * abs(float(v_ref))
    np.testing.assert_allclose(gz.numpy(), np.asarray(gz_ref), rtol=1e-8,
                               atol=1e-10)
    _assert_tree_close(gh, gh_ref, rtol=1e-8, atol=1e-10)


def _ported_update_stats_fn(eng, hyp, zt, data, w, x, y, z):
    """The fold of a new block into the base: JAX's Stats of the union."""
    xn, yn = _new_block()
    base = eng.reduced_stats(D)(hyp, zt, data["y"], data["mu"], None, w,
                                np.ones(1))
    new, wn = eng.put_data(y=yn, mu=xn)
    got = eng.update_stats_fn(D)(base, hyp, zt, new["y"], new["mu"], None,
                                 wn, np.ones(1))
    want, _, _, _ = _sequential_jax(_inputs()[4], np.vstack([x, xn]),
                                    np.vstack([y, yn]), z)
    for f in STATS_FIELDS:
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(want, f)), rtol=1e-11,
                                   atol=1e-11, err_msg=f)


def _ported_update_predictive_state(eng, hyp, zt, data, w, x, y, z):
    """The served state refreshed by a new block: JAX's state of the
    union (``tests/_dist_worker.py``: 1e-8 / 1e-9)."""
    xn, yn = _new_block()
    state = eng.predictive_state(hyp, zt, data["y"], data["mu"], None, w)
    res = eng.update_predictive_state(state, xn, yn)
    _, _, _, want = _sequential_jax(_inputs()[4], np.vstack([x, xn]),
                                    np.vstack([y, yn]), z)
    assert res.fallback is False
    for f in STATE_FIELDS:
        np.testing.assert_allclose(getattr(res.state, f).numpy(),
                                   np.asarray(getattr(want, f)), rtol=1e-8,
                                   atol=1e-9, err_msg=f)


def _ported_downdate_predictive_state(eng, hyp, zt, data, w, x, y, z):
    """Forgetting the block the state holds: JAX's state without it
    (``tests/_dist_worker.py``: 1e-9 / 1e-10)."""
    xn, yn = _new_block()
    union, wu = eng.put_data(y=np.vstack([y, yn]), mu=np.vstack([x, xn]))
    state = eng.predictive_state(hyp, zt, union["y"], union["mu"], None, wu)
    res = eng.downdate_predictive_state(state, xn, yn)
    _, _, _, want = _sequential_jax(_inputs()[4], x, y, z)
    assert res.fallback is False
    for f in STATE_FIELDS:
        np.testing.assert_allclose(getattr(res.state, f).numpy(),
                                   np.asarray(getattr(want, f)), rtol=1e-9,
                                   atol=1e-10, err_msg=f)


def _ported_multi_predict_engine(eng, hyp, zt, data, w, x, y, z):
    """The fleet engine over the engine's states (the sequential state and
    one of a shifted ``log_sf2``): JAX's ``MultiPredictEngine`` answers on
    JAX's own states, at ``tests/test_torch_serving.py``'s engine
    tolerances (each package extracts its states)."""
    from repro.serve import MultiPredictEngine as JMulti

    hyp2 = {**hyp, "log_sf2": hyp["log_sf2"] + 0.3}
    states = [eng.predictive_state(h, zt, data["y"], data["mu"], None, w)
              for h in (hyp, hyp2)]
    fleet = eng.multi_predict_engine(states, block_size=4)
    assert fleet.n_models == 2 and fleet.group is None
    xs = np.random.default_rng(7).standard_normal((13, Q))
    mean, var = fleet.predict(xs, include_noise=True)
    raw = _inputs()[4]
    jstates = [_sequential_jax(h, x, y, z)[3] for h in
               (raw, {**raw, "log_sf2": raw["log_sf2"] + 0.3})]
    want_m, want_v = JMulti(jstates, block_size=4).predict(
        jnp.asarray(xs), include_noise=True)
    np.testing.assert_allclose(mean.numpy(), np.asarray(want_m), rtol=1e-9,
                               atol=1e-11)
    np.testing.assert_allclose(var.numpy(), np.asarray(want_v), rtol=1e-8,
                               atol=1e-10)


@pytest.mark.parametrize("check", [
    _ported_reg_stats_fn, _ported_kernel, _ported_update_stats_fn,
    _ported_update_predictive_state, _ported_downdate_predictive_state,
    _ported_multi_predict_engine,
], ids=lambda f: f.__name__.removeprefix("_ported_"))
def test_ported_options_match_jax_sequential(check):
    """The options that raised until the kernel zoo, the online updates and
    the serving extensions were ported (ROADMAP Queue 1 items 6, 7 and 8),
    each now against the JAX package's sequential math, in a world of one
    without a group."""
    x, y, _, z, hyp = _inputs()
    eng = _engine()
    data, w = eng.put_data(y=y, mu=x)
    th = {k: torch.as_tensor(v, dtype=torch.float64) for k, v in hyp.items()}
    check(eng, th, torch.from_numpy(z), data, w, x, y, z)


@pytest.mark.parametrize("mode", ["overlap", "overlap_eager"])
def test_make_gp_train_step_refuses_unported_options(mode):
    """``make_gp_train_step`` once refused ``reduce_mode`` (item 11); it
    now passes it through to the engine, whose step is the one returned."""
    from repro_torch.train.steps import make_gp_train_step

    eng, step = make_gp_train_step(None, 1, chunk_size=4, reduce_mode=mode,
                                   device="cpu")
    assert eng.reduce_mode == mode and eng.chunk_size == 4
    x, y, _, z, hyp = _inputs()
    data, w = eng.put_data(y=y[:, :1], mu=x)
    args = ({k: torch.as_tensor(v, dtype=torch.float64)
             for k, v in hyp.items()}, torch.from_numpy(z), data["mu"], None,
            data["y"], w, np.ones(1), float(N))
    v, g = step(*args)
    v_ref, g_ref = eng.make_value_and_grad(1)(*args)
    assert torch.equal(v, v_ref) and torch.equal(g[1], g_ref[1])


# The reference's three invalid arguments (src/repro/core/distributed.py:
# 229-247), each a ValueError there and in the port: (kwargs, message).
INVALID = {
    "batch_blocks_without_chunk_size": (dict(batch_blocks=2),
                                        "requires chunk_size"),
    "unknown_reduce_mode": (dict(chunk_size=4, reduce_mode="bogus"),
                            "reduce_mode must be"),
    "overlap_without_chunk_size": (dict(reduce_mode="overlap"),
                                   "requires chunk_size"),
}


@pytest.mark.parametrize("case", list(INVALID))
def test_invalid_arguments_raise_value_error_as_jax_does(case):
    """Validity first, as the reference checks it: an invalid value is a
    ValueError in both packages, never "not ported yet"."""
    from repro.launch.mesh import make_compat_mesh
    from repro_torch.train.steps import make_gp_train_step

    kwargs, message = INVALID[case]
    with pytest.raises(ValueError, match=message):
        jdist.DistributedGP(make_compat_mesh((1,), ("data",)), **kwargs)
    with pytest.raises(ValueError, match=message):
        _engine(**kwargs)
    with pytest.raises(ValueError, match=message):
        make_gp_train_step(None, 1, device="cpu", **kwargs)


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
