"""Tensor parallelism of the other mixers (local windows, enc-dec
cross-attention, MLA, RG-LRU and SSD) against the JAX package's unsharded
functions, on 4 gloo ranks.

Configs: ``reduced()`` deepseek-v2-236b (MLA, 4 heads; its MoE dense,
each rank its experts), mamba2-370m (SSD, 8 heads of 16), recurrentgemma-9b
cut to its first three layers (R, R, A: RG-LRU width 64, MQA with a window
of 8) and whisper-medium (4 heads, kv 2: the kv heads whole at ``model``
4), each split by ``model`` 4; and ``mamba2-h6``, mamba2 at d_model 48 (6
SSD heads), which ``model`` 4 does not split (the whole block on every
rank) and ``model`` 2 does.  The JAX package runs each once per module in
this process (f32, jitted): the prefill logits of 4 prompts of 16 tokens
(two windows), 4 teacher-forced decode steps into grown caches, and
``jax.grad`` of ``forward_train``'s loss (3 labels masked).  The port runs
4 gloo ranks spawned once (``tests/test_torch_spawn.py::spawn_ranks``),
each building the meshes (1, 4) and (2, 2) of ("data", "model"), taking
its block of the JAX package's params (``local_shard``, which follows the
port's layout: the SSD's per-head blocks, RG-LRU's gates by columns) and
its data shard of the batch: logits and decode steps within 1e-4 relative
of JAX's (the mixers' tier, ``tests/test_torch_lm_mixers.py``), every
gradient leaf (assembled from the ranks' blocks, ``shard_ranges``) within
1e-4, and every rank of a ``model`` group with the same bits.  The same
ranks' (1, 4) logits against the port's own one-process run, and
``init_params_sharded``'s blocks and bytes for SSD and RG-LRU.
"""
import dataclasses
import datetime
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.configs import all_configs as j_all_configs
from repro.configs import load_all
from repro.models import transformer as j_tf
from repro.train import steps as j_steps
from repro_torch.configs import get_config
from repro_torch.convert import lm_params_from_numpy
from repro_torch.core.flat import tree_items
from repro_torch.distributed import sharding
from repro_torch.models import transformer as tf
from repro_torch.train import steps
from test_torch_spawn import spawn_ranks

W = 4
MESHES = ((1, 4), (2, 2))
B, T, NEW = 4, 16, 4
TOL = 1e-4
GROUP_TIMEOUT = datetime.timedelta(seconds=60)
# name -> (registered config, fields replaced in its reduced() config)
CONFIGS = {
    "deepseek-v2-236b": ("deepseek-v2-236b", {}),
    "mamba2-370m": ("mamba2-370m", {}),
    "recurrentgemma-9b": ("recurrentgemma-9b", {}),
    "whisper-medium": ("whisper-medium", {}),
    "mamba2-h6": ("mamba2-370m", dict(d_model=48)),
}
ARCHS = ("deepseek-v2-236b", "mamba2-370m", "recurrentgemma-9b",
         "whisper-medium")

load_all()


class SizesMesh:
    """A mesh given only as axis sizes (what the rules read), seen from
    one position."""

    def __init__(self, coord=None, **shape):
        self.shape = shape
        self.mesh_dim_names = tuple(shape)
        self._coord = coord

    def get_coordinate(self):
        return self._coord


def _cut(cfg):
    if cfg.name == "recurrentgemma-9b":
        return dataclasses.replace(cfg, blocks=cfg.blocks[:3], num_layers=3)
    return cfg


def port_cfg(name):
    arch, repl = CONFIGS[name]
    return dataclasses.replace(_cut(get_config(arch).reduced()), **repl)


def jax_cfg(name):
    arch, repl = CONFIGS[name]
    return dataclasses.replace(_cut(j_all_configs()[arch].reduced()), **repl)


def problem(cfg):
    """Tokens (B, T + NEW), labels (B, T) with 3 masked, frames (enc-dec)."""
    rng = np.random.default_rng(0)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (B, T + NEW),
                                  dtype=np.int32),
           "labels": rng.integers(0, cfg.vocab_size, (B, T), dtype=np.int32)}
    out["labels"][0, :3] = -1
    if cfg.family == "encdec":
        out["frames"] = rng.standard_normal(
            (B, cfg.num_frames, cfg.d_model)).astype(np.float32)
    return out


def mtag(mesh):
    return f"{mesh[0]}x{mesh[1]}"


def _key(path):
    return "/".join(map(str, path))


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want),
                                                  1e-30))


def _grow_jax(caches, empty):
    """JAX prefill caches in its empty caches of more positions: a leaf of
    the empty one's shape whole, any other into the first slots of the
    first axis that differs (``test_torch_lm_archs_serving.py``)."""
    def one(c, e):
        if c.shape == e.shape:
            return c
        ax = next(i for i, (m, n) in enumerate(zip(c.shape, e.shape))
                  if m != n)
        return e.at[(slice(None),) * ax + (slice(0, c.shape[ax]),)].set(c)
    return jax.tree.map(one, caches, empty)


# -- the JAX package, once per module ----------------------------------------

def _jax_reference(name):
    cfg = jax_cfg(name)
    jp, _ = j_tf.init_params(cfg, jax.random.PRNGKey(0))
    prob = problem(cfg)
    extra = ({"frames": jnp.asarray(prob["frames"])}
             if "frames" in prob else {})
    out = {"params/" + _key(k): np.asarray(v) for k, v in tree_items(jp)}
    logits, caches = jax.jit(j_steps.make_prefill_step(cfg))(
        jp, {"tokens": jnp.asarray(prob["tokens"][:, :T]), **extra})
    caches = _grow_jax(caches, j_tf.init_decode_cache(cfg, B, T + NEW))
    serve = jax.jit(j_steps.make_serve_step(cfg))
    steps_out = [np.asarray(logits)]
    for i in range(NEW):
        tok = jnp.asarray(prob["tokens"][:, T + i:T + i + 1])
        logits, caches = serve(jp, caches, tok,
                               jnp.full((B,), T + i, jnp.int32))
        steps_out.append(np.asarray(logits))
    out["logits"] = np.stack(steps_out)
    batch = {"tokens": jnp.asarray(prob["tokens"][:, :T]),
             "labels": jnp.asarray(prob["labels"]), **extra}
    (_, metrics), grads = jax.jit(jax.value_and_grad(
        lambda p: j_tf.forward_train(cfg, p, batch), has_aux=True))(jp)
    out["loss"] = np.asarray(metrics["loss"])
    out.update({"grad/" + _key(k): np.asarray(v)
                for k, v in tree_items(grads)})
    return out


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    """Each config's JAX outputs; its params also go to ``params.npz`` for
    the ranks."""
    tmp = tmp_path_factory.mktemp("jax_ref")
    ref = {name: _jax_reference(name) for name in CONFIGS}
    np.savez(tmp / "params.npz", **{f"{name}/{k}": v
                                    for name, r in ref.items()
                                    for k, v in r.items()
                                    if k.startswith("params/")})
    return ref, tmp


# -- the port ------------------------------------------------------------------

def _params_from(arrays, name, cfg):
    tree = {}
    prefix = f"{name}/params/"
    for key, v in arrays.items():
        if key.startswith(prefix):
            node = tree
            *path, leaf = key[len(prefix):].split("/")
            for p in path:
                node = node.setdefault(p, {})
            node[leaf] = v
    return lm_params_from_numpy(cfg, tree, device="cpu")


def _local(cfg, whole, mesh):
    """The rank's block of every leaf of ``whole`` (the port's layout)."""
    logical = dict(tree_items(tf.param_logical_axes(cfg)))
    local = {}
    for path, t in tree_items(whole):
        node = local
        for p in path[:-1]:
            node = node.setdefault(p, [] if isinstance(p, int) else {})
        node[path[-1]] = sharding.local_shard(t, logical[path], mesh,
                                              sharding.DEFAULT_RULES)
    return local


def _run(cfg, params, batch):
    """Prefill logits and NEW decode steps' logits, the loss and every
    gradient leaf of the rank's blocks."""
    prefill = steps.make_prefill_step(cfg)
    serve = steps.make_serve_step(cfg)
    tokens = batch["tokens"]
    b = tokens.shape[0]
    extra = {"frames": batch["frames"]} if "frames" in batch else {}
    logits, caches = prefill(params, {"tokens": tokens[:, :T], **extra})
    caches = tf.grow_decode_cache(cfg, caches, T + NEW)
    out = [logits]
    for i in range(NEW):
        logits, caches = serve(params, caches, tokens[:, T + i:T + i + 1],
                               torch.full((b,), T + i, dtype=torch.int32))
        out.append(logits)
    metrics, grads = steps.loss_and_grads(
        cfg, params, {"tokens": tokens[:, :T], "labels": batch["labels"],
                      **extra})
    res = {"logits": torch.stack(out).numpy(),
           "loss": metrics["loss"].detach().numpy()}
    res.update({"grad/" + _key(k): g.numpy() for k, g in tree_items(grads)})
    return res


def _rank_main(rank, world, store_path, out_dir):
    torch.set_num_threads(1)   # ranks share the cores: no oversubscription
    from repro_torch.launch import make_compat_mesh

    store = dist.FileStore(store_path, world)
    arrays = dict(np.load(pathlib.Path(out_dir) / "params.npz"))
    out = {}
    for m in MESHES:
        mesh = make_compat_mesh(m, ("data", "model"), "cpu", store=store,
                                rank=rank, world_size=world,
                                timeout=GROUP_TIMEOUT)
        for name in CONFIGS:
            cfg = port_cfg(name)
            local = _local(cfg, _params_from(arrays, name, cfg), mesh)
            with sharding.use_mesh(mesh):
                batch = steps.local_batch(
                    {k: torch.from_numpy(v)
                     for k, v in problem(cfg).items()})
                res = _run(cfg, local, batch)
            out.update({f"{mtag(m)}/{name}/{k}": v for k, v in res.items()})
        # init_params_sharded: the rank's blocks, the same draws
        for name in ("mamba2-370m", "recurrentgemma-9b"):
            cfg = port_cfg(name)
            mine = steps.init_params_sharded(
                cfg, torch.Generator().manual_seed(0), mesh, device="cpu")
            full = tf.init_params(cfg, torch.Generator().manual_seed(0),
                                  device="cpu")
            layout = dict(tree_items(sharding.param_layout(cfg, mesh)))
            whole = dict(tree_items(full))
            logical = dict(tree_items(tf.param_logical_axes(cfg)))
            same, shapes, held = True, True, 0
            for path, t in tree_items(mine):
                want = sharding.local_shard(whole[path], logical[path], mesh)
                same &= torch.equal(t, want)
                shapes &= tuple(t.shape) == layout[path].local
                held += t.numel() * t.element_size()
            tag = f"{mtag(m)}/{name}"
            out[f"{tag}/init_same"] = np.asarray(same)
            out[f"{tag}/init_shapes"] = np.asarray(shapes)
            out[f"{tag}/init_bytes"] = np.asarray(held)
    np.savez(pathlib.Path(out_dir) / f"rank{rank}.npz", **out)
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def ranks(jax_ref):
    _, tmp = jax_ref
    codes, _ = spawn_ranks(_rank_main, W, tmp)
    assert codes == [0] * W, f"rank exit codes {codes}"
    return [dict(np.load(tmp / f"rank{r}.npz")) for r in range(W)]


def _rank(ranks, mesh, di, i):
    return ranks[di * mesh[1] + i]


def _over_data(ranks, mesh, key):
    """A batch-sharded output, its data shards concatenated (model index
    0), along the batch axis of (steps, B, V) logits."""
    parts = [_rank(ranks, mesh, di, 0)[key] for di in range(mesh[0])]
    return np.concatenate(parts, axis=parts[0].ndim - 2)


def _index(ranges):
    """``np.ix_`` of ``shard_ranges``' per-dimension ranges."""
    return np.ix_(*[np.concatenate([np.arange(a, b) for a, b in rs])
                    for rs in ranges])


CASES = [(m, n) for m in MESHES for n in CONFIGS]
IDS = [f"{mtag(m)}-{n}" for m, n in CASES]


@pytest.mark.parametrize("mesh,name", CASES, ids=IDS)
def test_prefill_and_decode_logits_match_jax(ranks, jax_ref, mesh, name):
    want = jax_ref[0][name]["logits"]
    got = _over_data(ranks, mesh, f"{mtag(mesh)}/{name}/logits")
    assert got.shape == want.shape == (NEW + 1, B, port_cfg(name).vocab_size)
    for s in range(NEW + 1):
        assert _rel(got[s], want[s]) <= TOL, s


@pytest.mark.parametrize("mesh,name", CASES, ids=IDS)
def test_gradients_match_jax(ranks, jax_ref, mesh, name):
    """The loss on every rank, and each leaf's gradient assembled from the
    ranks' blocks in the port's layout, against ``jax.grad``."""
    ref = jax_ref[0][name]
    cfg = port_cfg(name)
    tag = f"{mtag(mesh)}/{name}"
    logical = dict(tree_items(tf.param_logical_axes(cfg)))
    for r in ranks:
        assert _rel(r[tag + "/loss"], ref["loss"]) <= TOL
    for path, lg in logical.items():
        key = "grad/" + _key(path)
        want = ref[key]
        got = np.full(want.shape, np.nan, np.float32)
        for di in range(mesh[0]):
            for i in range(mesh[1]):
                coord = {"data": di, "model": i}
                rs = sharding.shard_ranges(
                    lg, want.shape, SizesMesh(data=mesh[0], model=mesh[1]),
                    coord)
                got[_index(rs)] = _rank(ranks, mesh, di, i)[f"{tag}/{key}"]
        assert _rel(got, want) <= TOL, path


@pytest.mark.parametrize("mesh,name", CASES, ids=IDS)
def test_every_rank_of_a_model_group_has_the_same_bits(ranks, mesh, name):
    """Logits, the loss, and the gradient of every leaf the port's layout
    does not cut over ``model``, bitwise across each ``model`` group (the
    gradients of leaves not cut at all across every rank, after their sum
    over ``data``)."""
    cfg = port_cfg(name)
    tag = f"{mtag(mesh)}/{name}"
    sizes = SizesMesh(data=mesh[0], model=mesh[1])
    for di in range(mesh[0]):
        first = _rank(ranks, mesh, di, 0)
        for i in range(1, mesh[1]):
            for k in (tag + "/logits", tag + "/loss"):
                np.testing.assert_array_equal(_rank(ranks, mesh, di, i)[k],
                                              first[k], err_msg=k)
    for path, leaf in tree_items(tf.param_spec(cfg)):
        if sharding.block_axes(leaf.logical, leaf.shape, sizes):
            continue
        k = f"{tag}/grad/{_key(path)}"
        for r in ranks[1:]:
            np.testing.assert_array_equal(r[k], ranks[0][k], err_msg=k)


@pytest.mark.parametrize("arch", ARCHS)
def test_each_mixer_under_model_4_matches_one_process(ranks, jax_ref, arch):
    """The (1, 4) ranks' logits against the port's own unsharded run of
    the same params in this process, and the mixer's leaves cut over
    ``model`` (its heads or channels, not run replicated)."""
    cfg = port_cfg(arch)
    arrays = dict(np.load(jax_ref[1] / "params.npz"))
    params = _params_from(arrays, arch, cfg)
    batch = {k: torch.from_numpy(v) for k, v in problem(cfg).items()}
    want = _run(cfg, params, batch)["logits"]
    got = _over_data(ranks, (1, 4), f"1x4/{arch}/logits")
    for s in range(NEW + 1):
        assert _rel(got[s], want[s]) <= TOL, s
    mixer = {"deepseek-v2-236b": "wq_b", "mamba2-370m": "w_in",
             "recurrentgemma-9b": "w_a", "whisper-medium": "wq"}[arch]
    layout = sharding.param_layout(cfg, SizesMesh(data=1, model=4))
    cut = [lay for path, lay in tree_items(layout) if path[-1] == mixer]
    assert cut and all("model" in lay.axes for lay in cut)


def test_a_mixer_that_model_does_not_divide_runs_whole(ranks):
    """6 SSD heads under ``model`` 4: the SSD leaves whole on every rank
    (the rules' fallback); under ``model`` 2, 3 heads a rank."""
    cfg = port_cfg("mamba2-h6")
    for model, heads in ((4, 6), (2, 3)):
        layout = dict(tree_items(sharding.param_layout(
            cfg, SizesMesh(data=4 // model, model=model))))
        w_in = layout[("groups", "g0", "ssd", "w_in")]
        assert ("model" in w_in.axes) == (heads != 6)
        assert w_in.local[-1] == 2 * heads * 16 + 2 * 16 + heads
    for r in ranks[1:]:
        np.testing.assert_array_equal(
            r["1x4/mamba2-h6/grad/groups/g0/ssd/w_in"],
            ranks[0]["1x4/mamba2-h6/grad/groups/g0/ssd/w_in"])


@pytest.mark.parametrize("mesh", MESHES, ids=mtag)
@pytest.mark.parametrize("name", ["mamba2-370m", "recurrentgemma-9b"])
def test_init_params_sharded_holds_only_its_blocks(ranks, mesh, name):
    """Each rank's leaves are its ``local_shard`` blocks of
    ``init_params``' draws, of the shapes ``param_layout`` resolves, and
    its bytes those of the blocks."""
    cfg = port_cfg(name)
    sizes = SizesMesh(data=mesh[0], model=mesh[1])
    layout = [lay for _, lay in tree_items(sharding.param_layout(cfg, sizes))]
    want = sum(int(np.prod(lay.local)) * 4 for lay in layout)
    assert want < sum(int(np.prod(lay.shape)) * 4 for lay in layout)
    tag = f"{mtag(mesh)}/{name}"
    for r in ranks:
        assert bool(r[f"{tag}/init_same"])
        assert bool(r[f"{tag}/init_shapes"])
        assert int(r[f"{tag}/init_bytes"]) == want


@pytest.mark.parametrize("model", [1, 2, 4])
def test_the_ssd_and_rglru_rank_blocks_are_slices_of_the_whole(jax_ref,
                                                               model):
    """Rank i's blocks at ``model`` m, pinned against the reference's whole
    params: ``w_in``'s columns of its heads' z, x and dt with B and C
    whole, ``conv_w`` its x channels with B and C, ``w_out`` its heads'
    rows; RG-LRU's ``w_a`` / ``w_i`` its columns, ``w_x`` its columns."""
    arrays = dict(np.load(jax_ref[1] / "params.npz"))
    cfg = port_cfg("mamba2-370m")
    di, h, p, n = 128, 8, 16, 16
    whole = _params_from(arrays, "mamba2-370m", cfg)["groups"]["g0"]["ssd"]
    logical = tf.param_logical_axes(cfg)["groups"]["g0"]["ssd"]
    rg_cfg = port_cfg("recurrentgemma-9b")
    rg = _params_from(arrays, "recurrentgemma-9b", rg_cfg)["groups"]["g0"][
        "rglru"]
    rg_logical = tf.param_logical_axes(rg_cfg)["groups"]["g0"]["rglru"]
    lru = 64
    for i in range(model):
        mesh = SizesMesh((0, i), data=1, model=model)
        hs, cs = h // model, di // model
        zx = np.r_[i * cs:(i + 1) * cs]
        want = np.concatenate(
            [zx, di + zx, np.r_[2 * di:2 * di + 2 * n],
             2 * di + 2 * n + np.r_[i * hs:(i + 1) * hs]])
        got = sharding.local_shard(whole["w_in"], logical["w_in"], mesh)
        np.testing.assert_array_equal(got.numpy(),
                                      whole["w_in"].numpy()[:, :, want])
        conv = np.concatenate([zx, np.r_[di:di + 2 * n]])
        got = sharding.local_shard(whole["conv_w"], logical["conv_w"], mesh)
        np.testing.assert_array_equal(got.numpy(),
                                      whole["conv_w"].numpy()[:, conv])
        got = sharding.local_shard(whole["w_out"], logical["w_out"], mesh)
        np.testing.assert_array_equal(got.numpy(),
                                      whole["w_out"].numpy()[:, zx])
        cols = np.r_[i * lru // model:(i + 1) * lru // model]
        for leaf in ("w_a", "w_i", "w_x"):
            got = sharding.local_shard(rg[leaf], rg_logical[leaf], mesh)
            np.testing.assert_array_equal(got.numpy(), rg[leaf].numpy()[:, cols])


@pytest.mark.parametrize("name", ["mamba2-370m", "recurrentgemma-9b"])
def test_every_layout_function_resolves_the_ports_block(name):
    """At ``model`` 4 each leaf has one layout: ``param_layout``'s spec,
    axes and local shape, ``spec_for``, ``block_axes``, ``shard_slices``
    and ``tree_shardings`` all give the block ``local_shard`` cuts (RG-LRU's
    gates by columns, not the reference's rows); a packed SSD dimension
    has no slice or placement."""
    from torch.distributed.tensor import Shard

    cfg = port_cfg(name)
    mesh = SizesMesh((0, 1), data=1, model=4)
    layout = dict(tree_items(sharding.param_layout(cfg, mesh)))
    packed = 0
    for path, leaf in tree_items(tf.param_spec(cfg)):
        lay = layout[path]
        spec = sharding.spec_for(leaf.logical, leaf.shape, mesh)
        assert lay.spec == spec
        assert lay.axes == sharding.block_axes(leaf.logical, leaf.shape, mesh)
        block = sharding.local_shard(torch.zeros(leaf.shape), leaf.logical,
                                     mesh)
        assert tuple(block.shape) == lay.local, path
        ranges = sharding.shard_ranges(leaf.logical, leaf.shape, mesh,
                                       {"data": 0, "model": 1})
        if any(len(rs) > 1 for rs in ranges):
            packed += 1
            with pytest.raises(ValueError):
                sharding.shard_slices(leaf.logical, leaf.shape, mesh,
                                      {"data": 0, "model": 1})
            with pytest.raises(ValueError):
                sharding.tree_shardings({"x": leaf.logical},
                                        {"x": leaf.shape}, mesh)
            continue
        sl = sharding.shard_slices(leaf.logical, leaf.shape, mesh,
                                   {"data": 0, "model": 1})
        assert [(s.start, s.stop) for s in sl] == [rs[0] for rs in ranges]
        placement = sharding.tree_shardings({"x": leaf.logical},
                                            {"x": leaf.shape}, mesh)["x"]
        assert placement[1] == (Shard(spec.index("model"))
                                if "model" in lay.axes
                                else placement[1]), path
        if path[-1] in ("w_a", "w_i"):
            assert spec[-1] == "model" and spec[-2] is None, spec
    assert packed == (3 if name == "mamba2-370m" else 0)
