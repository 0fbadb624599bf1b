"""The expert-parallel MoE (``models.moe.moe_sharded``) against the JAX
package's ``moe_sharded`` on the same mesh shapes.

The problem is the reference's own (``tests/test_moe.py``): qwen3-moe
reduced, E 8, top-2, ``moe_d_ff`` 32, f32, the router drawn x0.1 and the
experts x0.05 from ``default_rng(0)``.  Four cases: capacity factor 8 (no
token dropped; x (4, 16, D), the reference's), 1.25 (x (4, 64, D): tokens
dropped), 1.25 with B·T/data not a multiple of ``model`` (x (2, 5, D):
padding), and the int8 wire at capacity factor 8.  JAX runs
once, in a subprocess on 8 placeholder devices, on the meshes (1, 4) and
(2, 2) of ("data", "model"): y, the aux losses and ``jax.grad`` of Σ y² in
the params and x, and, by hand from its ``_route`` / ``_pack_local`` on
each (data, model) token slice, the top-k choices, the kept (token,
choice) pairs and each data shard's mean of its slices' aux.  The port
runs 4 gloo ranks spawned once (``make_compat_mesh`` of each shape), each
rank its data shard, the expert leaves as its ``local_shard``: y within
1e-5 max abs (the int8 wire 1e-4), every gradient leaf and x's within 1e-5
of the largest entry (int8 1e-3), summed over the data shards, and with no
drop within 1e-5 of the dense path's; the top-k choices and kept pairs
identical.  The aux on data shard 0 equals JAX's, and every data shard's
is its own slices' mean (ROADMAP Queue 3 item 22: the reference keeps only
data shard 0's).  In the same spawn, ``moe_forward`` in the process group
of 4 with no mesh is bitwise ``moe_dense``.
"""
import dataclasses
import datetime
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist

from test_torch_spawn import spawn_ranks

ROOT = pathlib.Path(__file__).resolve().parents[1]
W = 4
MESHES = ((1, 4), (2, 2))
# case -> (capacity_factor, moe_dispatch_dtype, x shape (B, T))
CASES = {"nodrop": (8.0, "native", (4, 16)),
         "drop": (1.25, "native", (4, 64)),
         "pad": (1.25, "native", (2, 5)),
         "int8": (8.0, "int8", (4, 16))}
LEAVES = ("router", "w_gate", "w_up", "w_down")
GROUP_TIMEOUT = datetime.timedelta(seconds=60)
Y_TOL = {"native": 1e-5, "int8": 1e-4}
GRAD_TOL = {"native": 1e-5, "int8": 1e-3}
AUX_TOL = 1e-6


def cfg_kwargs(case):
    cf, wire, _ = CASES[case]
    return dict(moe_impl="sharded", num_experts=8, experts_per_token=2,
                moe_d_ff=32, capacity_factor=cf, moe_dispatch_dtype=wire)


def problem(case, d_model):
    """x (B, T, D) and the MoE params, f32 numpy, as ``tests/test_moe.py``
    draws them (x at this case's shape)."""
    rng = np.random.default_rng(0)
    b, t = CASES[case][2]
    x = rng.standard_normal((b, t, d_model)).astype(np.float32)
    p = {"router": rng.standard_normal((d_model, 8)) * .1,
         "w_gate": rng.standard_normal((8, d_model, 32)) * .05,
         "w_up": rng.standard_normal((8, d_model, 32)) * .05,
         "w_down": rng.standard_normal((8, 32, d_model)) * .05}
    return x, {k: v.astype(np.float32) for k, v in p.items()}


def mtag(mesh):
    return f"{mesh[0]}x{mesh[1]}"


_JAX_WORKER = """
import dataclasses, sys
import jax, jax.numpy as jnp
import numpy as np
sys.path.insert(0, {tests!r})
import test_torch_moe_sharded as t
from repro.configs import all_configs
from repro.distributed import sharding as shlib
from repro.launch.mesh import make_compat_mesh
from repro.models import moe as moe_mod

base = all_configs()["qwen3-moe-235b-a22b"].reduced()
meshes = {{m: make_compat_mesh(m, ("data", "model")) for m in t.MESHES}}
out = {{}}


def loss_fn(fn):
    def f(p_, x_):
        y, aux = fn(p_, x_)
        return jnp.sum(y ** 2), (y, aux)
    return jax.jit(jax.value_and_grad(f, argnums=(0, 1), has_aux=True))


def save(tag, res):
    (_, (y, aux)), (gp, gx) = res
    out[tag + "/y"] = np.asarray(y)
    out[tag + "/grad/x"] = np.asarray(gx)
    for k in t.LEAVES:
        out[tag + "/grad/" + k] = np.asarray(gp[k])
    for k, v in aux.items():
        out[tag + "/aux/" + k] = np.asarray(v)


for case in t.CASES:
    cfg = dataclasses.replace(base, **t.cfg_kwargs(case))
    x, p = t.problem(case, cfg.d_model)
    xj, pj = jnp.asarray(x), {{k: jnp.asarray(v) for k, v in p.items()}}
    if case == "nodrop":
        save("dense", loss_fn(lambda p_, x_: moe_mod.moe_dense(cfg, p_, x_))(
            pj, xj))
    for m, mesh in meshes.items():
        tag = case + "/" + t.mtag(m)
        with shlib.use_mesh(mesh):
            save(tag, loss_fn(lambda p_, x_: moe_mod.moe_sharded(
                cfg, p_, x_))(pj, xj))
        # each (data, model) token slice by hand: choices, kept pairs, aux
        dd, em = m
        b, tt, d = x.shape
        for di in range(dd):
            xf = xj[di * b // dd:(di + 1) * b // dd].reshape(-1, d)
            n = xf.shape[0]
            xf = jnp.pad(xf, ((0, (-n) % em), (0, 0)))
            per = xf.shape[0] // em
            auxs = []
            for i in range(em):
                xs = xf[i * per:(i + 1) * per]
                gates, eids, aux = moe_mod._route(cfg, pj["router"], xs)
                cap = moe_mod._capacity(cfg, per)
                _, (order, _, _, _, keep) = moe_mod._pack_local(
                    cfg, xs, gates, eids, cap)
                kept = jnp.zeros(keep.shape, bool).at[order].set(keep)
                sl = tag + "/slice/" + str(di) + "/" + str(i)
                out[sl + "/eids"] = np.asarray(eids)
                out[sl + "/kept"] = np.asarray(kept.reshape(eids.shape))
                auxs.append(aux)
            for k in auxs[0]:
                out[tag + "/hand_aux/" + str(di) + "/" + k] = np.mean(
                    [np.asarray(a[k], np.float64) for a in auxs])
np.savez({out!r}, **out)
print("JAX-REF-OK")
"""


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    out = tmp_path_factory.mktemp("jax_ref") / "ref.npz"
    env = {**os.environ,
           "XLA_FLAGS": "--xla_force_host_platform_device_count=8",
           "PYTHONPATH": os.pathsep.join([str(ROOT / "src"),
                                          os.environ.get("PYTHONPATH", "")])}
    code = _JAX_WORKER.format(tests=str(ROOT / "tests"), out=str(out))
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0 and "JAX-REF-OK" in res.stdout, \
        res.stdout + res.stderr
    return dict(np.load(out))


# -- the port, 4 gloo ranks ------------------------------------------------------

def _port_cfg(case):
    from repro_torch.configs import get_config

    return dataclasses.replace(get_config("qwen3-moe-235b-a22b").reduced(),
                               **cfg_kwargs(case))


def _rank_main(rank, world, store_path, out_dir):
    torch.set_num_threads(1)   # ranks share the cores: no oversubscription
    from repro_torch.distributed import sharding
    from repro_torch.launch import make_compat_mesh
    from repro_torch.models import moe

    store = dist.FileStore(store_path, world)
    meshes = {m: make_compat_mesh(m, ("data", "model"), "cpu", store=store,
                                  rank=rank, world_size=world,
                                  timeout=GROUP_TIMEOUT) for m in MESHES}
    logical = {k: leaf.logical for k, leaf in
               moe.init_moe(_port_cfg("nodrop")).items()}
    packed = []
    real_pack = moe._pack_local

    def recording_pack(cfg, xs, gates, eids, cap):
        buf, meta = real_pack(cfg, xs, gates, eids, cap)
        packed.append((eids, moe.kept_pairs(meta, *eids.shape)))
        return buf, meta
    moe._pack_local = recording_pack
    out = {}
    for case in CASES:
        cfg = _port_cfg(case)
        x, p = problem(case, cfg.d_model)
        for m, mesh in meshes.items():
            dd, em = m
            di = rank // em
            b = x.shape[0]
            xl = torch.from_numpy(x[di * b // dd:(di + 1) * b // dd].copy())
            whole = {k: torch.from_numpy(v) for k, v in p.items()}
            pl = {k: sharding.local_shard(v, logical[k], mesh,
                                          moe.EXPERT_RULES)
                  for k, v in whole.items()}
            leaves = [xl] + [pl[k] for k in LEAVES]
            for leaf in leaves:
                leaf.requires_grad_(True)
            packed.clear()
            with sharding.use_mesh(mesh):
                y, aux = moe.moe_forward(cfg, pl, xl)
                grads = torch.autograd.grad((y ** 2).sum(), leaves)
            tag = f"{case}/{mtag(m)}"
            out[tag + "/y"] = y.detach().numpy()
            for k, v in aux.items():
                out[tag + "/aux/" + k] = v.detach().numpy()
            out[tag + "/grad/x"] = grads[0].numpy()
            for k, g in zip(LEAVES, grads[1:]):
                out[tag + "/grad/" + k] = g.numpy()
            (eids, kept), = packed
            out[tag + "/eids"], out[tag + "/kept"] = eids.numpy(), kept.numpy()
            if case == "nodrop":   # the expert leaves whole: the same bits
                with torch.no_grad(), sharding.use_mesh(mesh):
                    out[tag + "/y_whole"] = moe.moe_forward(
                        cfg, whole, xl)[0].numpy()
    # no mesh in a process group of 4: the dense path, bit for bit
    moe._pack_local = real_pack
    cfg = _port_cfg("drop")
    x, p = problem("drop", cfg.d_model)
    xt, pt = torch.from_numpy(x), {k: torch.from_numpy(v)
                                   for k, v in p.items()}
    with torch.no_grad():
        got, got_aux = moe.moe_forward(cfg, pt, xt)
        want, want_aux = moe.moe_dense(cfg, pt, xt)
    out["nomesh_equal"] = np.asarray(
        torch.equal(got, want) and all(torch.equal(got_aux[k], want_aux[k])
                                       for k in want_aux))
    out["world"] = np.asarray(dist.get_world_size())
    np.savez(pathlib.Path(out_dir) / f"rank{rank}.npz", **out)
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ranks")
    codes, _ = spawn_ranks(_rank_main, W, tmp)
    assert codes == [0] * W, f"rank exit codes {codes}"
    return [dict(np.load(tmp / f"rank{r}.npz")) for r in range(W)]


def _rank(ranks, mesh, di, i):
    return ranks[di * mesh[1] + i]


def _summed(ranks, mesh, key, i):
    """A gradient summed over the data shards of model index i."""
    return sum(_rank(ranks, mesh, di, i)[key] for di in range(mesh[0]))


def _rel(got, want) -> float:
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


@pytest.mark.parametrize("mesh", MESHES, ids=mtag)
@pytest.mark.parametrize("case", CASES)
def test_y_matches_jax(ranks, jax_ref, case, mesh):
    tag = f"{case}/{mtag(mesh)}"
    want = jax_ref[tag + "/y"]
    got = np.concatenate([_rank(ranks, mesh, di, 0)[tag + "/y"]
                          for di in range(mesh[0])])
    assert got.shape == want.shape
    assert np.max(np.abs(got - want)) <= Y_TOL[CASES[case][1]]


@pytest.mark.parametrize("mesh", MESHES, ids=mtag)
@pytest.mark.parametrize("case", CASES)
def test_every_rank_of_a_model_group_has_the_same_bits(ranks, case, mesh):
    tag = f"{case}/{mtag(mesh)}"
    for di in range(mesh[0]):
        first = _rank(ranks, mesh, di, 0)
        for i in range(1, mesh[1]):
            r = _rank(ranks, mesh, di, i)
            for k in ("/y", "/grad/x", "/grad/router", "/aux/load_balance"):
                np.testing.assert_array_equal(r[tag + k], first[tag + k])


@pytest.mark.parametrize("mesh", MESHES, ids=mtag)
@pytest.mark.parametrize("case", CASES)
def test_gradients_match_jax(ranks, jax_ref, case, mesh):
    """x's gradient per data shard, the router's summed over data shards
    (each rank's already summed over ``model``), each rank's experts'
    summed over data shards against JAX's rows of them."""
    tag = f"{case}/{mtag(mesh)}"
    tol = GRAD_TOL[CASES[case][1]]
    gx = np.concatenate([_rank(ranks, mesh, di, 0)[tag + "/grad/x"]
                         for di in range(mesh[0])])
    assert _rel(gx, jax_ref[tag + "/grad/x"]) <= tol
    assert _rel(_summed(ranks, mesh, tag + "/grad/router", 0),
                jax_ref[tag + "/grad/router"]) <= tol
    el = 8 // mesh[1]
    for k in LEAVES[1:]:
        for i in range(mesh[1]):
            got = _summed(ranks, mesh, f"{tag}/grad/{k}", i)
            assert got.shape[0] == el
            assert _rel(got, jax_ref[f"{tag}/grad/{k}"][i * el:(i + 1) * el]
                        ) <= tol, (k, i)


@pytest.mark.parametrize("mesh", MESHES, ids=mtag)
def test_no_drop_matches_the_dense_path(ranks, jax_ref, mesh):
    tag = f"nodrop/{mtag(mesh)}"
    got = np.concatenate([_rank(ranks, mesh, di, 0)[tag + "/y"]
                          for di in range(mesh[0])])
    assert np.max(np.abs(got - jax_ref["dense/y"])) <= Y_TOL["native"]
    gx = np.concatenate([_rank(ranks, mesh, di, 0)[tag + "/grad/x"]
                         for di in range(mesh[0])])
    assert _rel(gx, jax_ref["dense/grad/x"]) <= GRAD_TOL["native"]
    assert _rel(_summed(ranks, mesh, tag + "/grad/router", 0),
                jax_ref["dense/grad/router"]) <= GRAD_TOL["native"]
    el = 8 // mesh[1]
    for k in LEAVES[1:]:
        got = np.concatenate([_summed(ranks, mesh, f"{tag}/grad/{k}", i)
                              for i in range(mesh[1])])
        assert _rel(got, jax_ref[f"dense/grad/{k}"]) <= GRAD_TOL["native"]


@pytest.mark.parametrize("mesh", MESHES, ids=mtag)
@pytest.mark.parametrize("case", ("drop", "pad"))
def test_choices_and_kept_pairs_match_jax(ranks, jax_ref, case, mesh):
    """Each token slice's top-k choices and the (token, choice) pairs that
    kept a slot, identical to JAX's: the stable sort by expert id keeps the
    first arrivals; padded tokens (all ties) take the lowest expert ids."""
    tag = f"{case}/{mtag(mesh)}"
    dropped = 0
    for di in range(mesh[0]):
        for i in range(mesh[1]):
            r = _rank(ranks, mesh, di, i)
            sl = f"{tag}/slice/{di}/{i}"
            np.testing.assert_array_equal(r[tag + "/eids"],
                                          jax_ref[sl + "/eids"])
            np.testing.assert_array_equal(r[tag + "/kept"],
                                          jax_ref[sl + "/kept"])
            dropped += int((~r[tag + "/kept"]).sum())
    if case == "drop":
        assert dropped > 0   # capacity 1.25 drops pairs on this problem


@pytest.mark.parametrize("mesh", MESHES, ids=mtag)
@pytest.mark.parametrize("case", CASES)
def test_aux_on_data_shard_0_is_jax_and_every_shard_its_own_mean(
        ranks, jax_ref, case, mesh):
    """ROADMAP Queue 3 item 22: the reference returns one aux for the whole
    mesh, data shard 0's mean over its model slices; the port returns on
    every rank its own data shard's mean."""
    tag = f"{case}/{mtag(mesh)}"
    for k in ("load_balance", "router_z"):
        want0 = float(jax_ref[f"{tag}/aux/{k}"])
        for i in range(mesh[1]):
            got0 = float(_rank(ranks, mesh, 0, i)[f"{tag}/aux/{k}"])
            assert abs(got0 - want0) <= AUX_TOL * abs(want0)
        for di in range(mesh[0]):
            hand = float(jax_ref[f"{tag}/hand_aux/{di}/{k}"])
            for i in range(mesh[1]):
                got = float(_rank(ranks, mesh, di, i)[f"{tag}/aux/{k}"])
                assert abs(got - hand) <= AUX_TOL * abs(hand)


@pytest.mark.parametrize("mesh", MESHES, ids=mtag)
def test_whole_expert_leaves_give_the_local_shards_bits(ranks, mesh):
    tag = f"nodrop/{mtag(mesh)}"
    for r in ranks:
        np.testing.assert_array_equal(r[tag + "/y_whole"], r[tag + "/y"])


def test_moe_forward_without_a_mesh_is_dense_in_a_group_of_4(ranks):
    for r in ranks:
        assert int(r["world"]) == W
        assert bool(r["nomesh_equal"])


class _FakeMesh:
    def __init__(self, **shape):
        self.shape = shape


@pytest.mark.parametrize("shape", [dict(data=4), dict(data=1, model=3)],
                         ids=["no-model-axis", "model-does-not-divide-E"])
def test_moe_sharded_is_dense_only_where_the_reference_is(shape):
    """With no ``model`` axis, or E not divisible by it, the reference's
    ``moe_sharded`` computes ``moe_dense``; so does the port's."""
    from repro_torch.distributed import sharding
    from repro_torch.models import moe

    cfg = _port_cfg("drop")
    x, p = problem("drop", cfg.d_model)
    xt, pt = torch.from_numpy(x), {k: torch.from_numpy(v)
                                   for k, v in p.items()}
    with torch.no_grad():
        want, _ = moe.moe_dense(cfg, pt, xt)
        with sharding.use_mesh(_FakeMesh(**shape)):
            got, _ = moe.moe_sharded(cfg, pt, xt)
    assert torch.equal(got, want)


def test_capacity_is_the_references():
    from repro.configs import all_configs
    from repro.models import moe as j_moe
    from repro_torch.models import moe

    for cf in (1.0, 1.25, 8.0, 16.0):
        for k, e in ((2, 8), (8, 128), (6, 160)):
            jc = dataclasses.replace(
                all_configs()["qwen3-moe-235b-a22b"], capacity_factor=cf,
                experts_per_token=k, num_experts=e)
            pc = dataclasses.replace(_port_cfg("drop"), capacity_factor=cf,
                                     experts_per_token=k, num_experts=e)
            for n in (1, 3, 16, 512, 2048, 8191):
                assert moe._capacity(pc, n) == j_moe._capacity(jc, n)


def test_the_chip_checks_int8_bound_is_the_references_scaled(jax_ref):
    """``chip_smoke.py`` phase 3l holds the int8 wire to
    ``tests/test_moe.py``'s 5e-2 max |err|, scaled by the max |y| of that
    problem's dense output (the nodrop case here)."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke

    want = 5e-2 / float(np.abs(jax_ref["dense/y"]).max())
    assert abs(chip_smoke.INT8_MAX_ERR_OVER_MAX_Y - want) <= 1e-4 * want
