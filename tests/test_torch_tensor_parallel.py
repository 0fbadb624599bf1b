"""Tensor parallelism of the dense LM layers (``distributed.tensor_parallel``,
the split ``attention``, ``mlp``, vocab and cross-entropy, FSDP over
``data``) against the JAX package's unsharded functions, on 4 gloo ranks.

Configs: ``reduced()`` llama3.2-1b (SwiGLU, tied), starcoder2-3b (GELU
with biases, layernorm, QKV bias) and codeqwen1.5-7b (QKV bias), each with
8 heads so that every mesh splits them (llama and starcoder2 kv 4,
codeqwen MHA, kv 8), and three variants of llama: 6 heads (head dim 16),
whole attention at ``model`` 4; kv 2 under 8 heads, kv heads replicated at
``model`` 4; kv 3 under 12 heads (head dim 8), whose ranks' query heads
straddle kv groups.  The JAX package runs each once per module in this
process (f32, jitted): the prefill logits of 4 prompts of 12 tokens, 4
teacher-forced decode steps into grown caches, and ``jax.grad`` of
``forward_train``'s loss (3 labels masked).  The port runs 4 gloo ranks
spawned once (``tests/test_torch_spawn.py::spawn_ranks``), each building
the meshes (1, 4), (2, 2) and (4, 1) of ("data", "model"), taking its
block of the JAX package's params (``local_shard`` under
``DEFAULT_RULES``) and its data shard of the batch (``local_batch``):
logits (the query-chunked and the flash route) and decode steps within
1e-5 relative of JAX's, every gradient leaf (assembled from the ranks'
blocks after ``loss_and_grads``' sums over ``data``) within 1e-5, and
every rank of a ``model`` group with the same bits.  In the same spawn,
``init_params_sharded`` holds only the rank's blocks, each the same draw
as ``init_params``'.  A (1, 1) mesh is bitwise the unsharded path, and
the other mixers' tensor parallelism is ``test_torch_tensor_parallel_mixers.py``.
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
from repro_torch.models import attention as attn
from repro_torch.models import transformer as tf
from repro_torch.train import steps
from test_torch_spawn import spawn_ranks

W = 4
MESHES = ((1, 4), (2, 2), (4, 1))
B, T, NEW = 4, 12, 4
TOL = 1e-5
GROUP_TIMEOUT = datetime.timedelta(seconds=60)
# name -> (registered config, fields replaced in its reduced() config)
CONFIGS = {
    "llama3.2-1b": ("llama3.2-1b", dict(num_heads=8, num_kv_heads=4)),
    "starcoder2-3b": ("starcoder2-3b", dict(num_heads=8, num_kv_heads=4)),
    "codeqwen1.5-7b": ("codeqwen1.5-7b", dict(num_heads=8, num_kv_heads=8)),
    "heads6": ("llama3.2-1b", dict(num_heads=6, num_kv_heads=2,
                                   head_dim=16)),
    "kv2": ("llama3.2-1b", dict(num_heads=8, num_kv_heads=2)),
    "kv3": ("llama3.2-1b", dict(num_heads=12, num_kv_heads=3, head_dim=8)),
}

load_all()


class SizesMesh:
    """A mesh given only as axis sizes (what the rules read)."""

    def __init__(self, **shape):
        self.shape = shape


def port_cfg(name):
    arch, repl = CONFIGS[name]
    return dataclasses.replace(get_config(arch).reduced(), **repl)


def jax_cfg(name):
    arch, repl = CONFIGS[name]
    return dataclasses.replace(j_all_configs()[arch].reduced(), **repl)


def problem(cfg):
    """Tokens (B, T + NEW) and labels (B, T), 3 masked."""
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, cfg.vocab_size, (B, T + NEW), dtype=np.int32)
    labels = rng.integers(0, cfg.vocab_size, (B, T), dtype=np.int32)
    labels[0, :3] = -1
    return tokens, labels


def mtag(mesh):
    return f"{mesh[0]}x{mesh[1]}"


def _key(path):
    return "/".join(map(str, path))


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want),
                                                  1e-30))


# -- the JAX package, once per module ----------------------------------------

def _jax_reference(name):
    cfg = jax_cfg(name)
    jp, _ = j_tf.init_params(cfg, jax.random.PRNGKey(0))
    tokens, labels = problem(cfg)
    out = {"params/" + _key(k): np.asarray(v) for k, v in tree_items(jp)}
    logits, caches = jax.jit(j_steps.make_prefill_step(cfg))(
        jp, {"tokens": jnp.asarray(tokens[:, :T])})
    empty = j_tf.init_decode_cache(cfg, B, T + NEW)
    caches = {g: {k: empty[g][k].at[:, :, :a.shape[2]].set(a)
                  for k, a in c.items()} for g, c in caches.items()}
    serve = jax.jit(j_steps.make_serve_step(cfg))
    steps_out = [np.asarray(logits)]
    for i in range(NEW):
        tok = jnp.asarray(tokens[:, T + i:T + i + 1])
        logits, caches = serve(jp, caches, tok,
                               jnp.full((B,), T + i, jnp.int32))
        steps_out.append(np.asarray(logits))
    out["logits"] = np.stack(steps_out)
    batch = {"tokens": jnp.asarray(tokens[:, :T]),
             "labels": jnp.asarray(labels)}
    (loss, _), grads = jax.jit(jax.value_and_grad(
        lambda p: j_tf.forward_train(cfg, p, batch), has_aux=True))(jp)
    out["loss"] = np.asarray(loss)
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


# -- the port, 4 gloo ranks --------------------------------------------------

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


def _run(cfg, params, tokens, labels):
    """Prefill logits, NEW decode steps' logits, the flash route's prefill
    logits, the loss and every gradient leaf of the rank's blocks."""
    prefill = steps.make_prefill_step(cfg)
    serve = steps.make_serve_step(cfg)
    b = tokens.shape[0]
    logits, caches = prefill(params, {"tokens": tokens[:, :T]})
    caches = tf.grow_decode_cache(cfg, caches, T + NEW)
    out = [logits]
    for i in range(NEW):
        logits, caches = serve(params, caches, tokens[:, T + i:T + i + 1],
                               torch.full((b,), T + i, dtype=torch.int32))
        out.append(logits)
    flash = steps.make_prefill_step(dataclasses.replace(cfg, use_flash=True))(
        params, {"tokens": tokens[:, :T]})[0]
    metrics, grads = steps.loss_and_grads(
        cfg, params, {"tokens": tokens[:, :T], "labels": labels})
    res = {"logits": torch.stack(out).numpy(), "flash": flash.numpy(),
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
            whole = _params_from(arrays, name, cfg)
            logical = tf.param_logical_axes(cfg)
            local = {}
            for (path, t), (_, lg) in zip(tree_items(whole),
                                          tree_items(logical)):
                node = local
                for p in path[:-1]:
                    node = node.setdefault(p, {})
                node[path[-1]] = sharding.local_shard(
                    t, lg, mesh, sharding.DEFAULT_RULES)
            tokens, labels = problem(cfg)
            with sharding.use_mesh(mesh):
                batch = steps.local_batch(
                    {"tokens": torch.from_numpy(tokens),
                     "labels": torch.from_numpy(labels)})
                res = _run(cfg, local, batch["tokens"], batch["labels"])
            out.update({f"{mtag(m)}/{name}/{k}": v for k, v in res.items()})
        # init_params_sharded: the rank's blocks, the same draws
        cfg = port_cfg("llama3.2-1b")
        gen = torch.Generator().manual_seed(0)
        mine = steps.init_params_sharded(cfg, gen, mesh, device="cpu")
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
        out[f"{mtag(m)}/init_same"] = np.asarray(same)
        out[f"{mtag(m)}/init_shapes"] = np.asarray(shapes)
        out[f"{mtag(m)}/init_bytes"] = np.asarray(held)
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
    0), along the batch axis of (steps, B, V) logits or (B, V)."""
    parts = [_rank(ranks, mesh, di, 0)[key] for di in range(mesh[0])]
    return np.concatenate(parts, axis=parts[0].ndim - 2)


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
def test_the_flash_route_matches_jax(ranks, jax_ref, mesh, name):
    """The flash route (its plain version on the CPU) on the rank's local
    heads, against JAX's query-chunked prefill."""
    got = _over_data(ranks, mesh, f"{mtag(mesh)}/{name}/flash")
    assert _rel(got, jax_ref[0][name]["logits"][0]) <= TOL


@pytest.mark.parametrize("mesh,name", CASES, ids=IDS)
def test_gradients_match_jax(ranks, jax_ref, mesh, name):
    """The loss on every rank, and each leaf's gradient assembled from the
    ranks' blocks (``shard_slices``), against ``jax.grad``."""
    ref = jax_ref[0][name]
    cfg = port_cfg(name)
    tag = f"{mtag(mesh)}/{name}"
    logical = dict(tree_items(tf.param_logical_axes(cfg)))
    sizes = SizesMesh(data=mesh[0], model=mesh[1])
    for r in ranks:
        assert _rel(r[tag + "/loss"], ref["loss"]) <= TOL
    for path, lg in logical.items():
        key = "grad/" + _key(path)
        want = ref[key]
        got = np.full(want.shape, np.nan, np.float32)
        for di in range(mesh[0]):
            for i in range(mesh[1]):
                sl = sharding.shard_slices(lg, want.shape, sizes,
                                           {"data": di, "model": i})
                got[sl] = _rank(ranks, mesh, di, i)[f"{tag}/{key}"]
        assert _rel(got, want) <= TOL, path


@pytest.mark.parametrize("mesh,name", CASES, ids=IDS)
def test_every_rank_of_a_model_group_has_the_same_bits(ranks, mesh, name):
    """Logits, the loss, and the gradient of every leaf not split over
    ``model``, bitwise across each ``model`` group (and the replicated
    gradients across the data groups too, after their sum)."""
    cfg = port_cfg(name)
    tag = f"{mtag(mesh)}/{name}"
    sizes = SizesMesh(data=mesh[0], model=mesh[1])
    spec = {path: sharding.spec_axes(sharding.spec_for(leaf.logical,
                                                       leaf.shape, sizes))
            for path, leaf in tree_items(tf.param_spec(cfg))}
    keys = [tag + k for k in ("/logits", "/flash", "/loss")]
    for di in range(mesh[0]):
        first = _rank(ranks, mesh, di, 0)
        for i in range(1, mesh[1]):
            for k in keys:
                np.testing.assert_array_equal(_rank(ranks, mesh, di, i)[k],
                                              first[k], err_msg=k)
    for path, axes in spec.items():
        if axes:
            continue
        k = f"{tag}/grad/{_key(path)}"
        for r in ranks[1:]:
            np.testing.assert_array_equal(r[k], ranks[0][k], err_msg=k)


@pytest.mark.parametrize("mesh", MESHES, ids=mtag)
def test_init_params_sharded_holds_only_its_blocks(ranks, mesh):
    """Each rank's leaves are its ``local_shard`` blocks of
    ``init_params``' draws, of the shapes ``param_layout`` resolves, and
    its bytes those of the blocks: a quarter of every leaf the rules cut
    over all four ranks."""
    cfg = port_cfg("llama3.2-1b")
    sizes = SizesMesh(data=mesh[0], model=mesh[1])
    layout = [lay for _, lay in tree_items(sharding.param_layout(cfg, sizes))]
    want = sum(int(np.prod(lay.local)) * 4 for lay in layout)
    whole = sum(int(np.prod(lay.shape)) * 4 for lay in layout)
    assert want < whole
    for r in ranks:
        assert bool(r[f"{mtag(mesh)}/init_same"])
        assert bool(r[f"{mtag(mesh)}/init_shapes"])
        assert int(r[f"{mtag(mesh)}/init_bytes"]) == want


def test_a_1x1_mesh_is_bitwise_the_unsharded_path(jax_ref):
    """Under a (1, 1) mesh no leaf is cut and no collective runs: the
    prefill, decode and gradients have the unsharded path's bits."""
    cfg = port_cfg("starcoder2-3b")
    arrays = dict(np.load(jax_ref[1] / "params.npz"))
    params = _params_from(arrays, "starcoder2-3b", cfg)
    tokens, labels = (torch.from_numpy(a) for a in problem(cfg))
    want = _run(cfg, params, tokens, labels)
    with sharding.use_mesh(SizesMesh(data=1, model=1)):
        got = _run(cfg, params, tokens, labels)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


# name, model -> rank 1's (split, heads, kv held, first kv head, kv heads,
#                           expansion)
LAYOUTS = {
    ("llama3.2-1b", 4): (True, 2, True, 1, 1, None),
    ("heads6", 4): (False, 6, False, 0, 2, None),
    ("heads6", 2): (True, 3, True, 1, 1, None),
    ("kv2", 4): (True, 2, False, 0, 1, None),
    ("kv3", 4): (True, 3, False, 0, 2, (0, 1, 1)),
    ("kv3", 2): (True, 6, False, 1, 2, (0, 0, 1, 1, 1, 1)),
    ("codeqwen1.5-7b", 4): (True, 2, True, 2, 2, None),
}


@pytest.mark.parametrize("name,model", sorted(LAYOUTS),
                         ids=[f"{n}-model{m}" for n, m in sorted(LAYOUTS)])
def test_head_layout_follows_the_resolved_specs(name, model, monkeypatch):
    """Rank 1's query and kv heads: whole attention where ``heads`` does
    not divide, the kv heads its query heads read where ``kv_heads`` does
    not, expanded to one a query head where they are not whole groups."""
    from repro_torch.distributed import tensor_parallel as tp

    monkeypatch.setattr(tp, "model_index", lambda: 1)
    with sharding.use_mesh(SizesMesh(data=1, model=model)):
        hl = attn.head_layout(port_cfg(name))
    assert tuple(hl) == LAYOUTS[(name, model)]


@pytest.mark.parametrize("arch,leaf,local", [
    ("llama3.2-1b", ("groups", "g0", "attn", "wq"), (16, 128, 128)),
    ("llama3.2-1b", ("groups", "g0", "attn", "wk"), (16, 128, 512)),
    ("llama3.2-1b", ("embed",), (8016, 128)),
    ("llama3.2-1b", ("groups", "g0", "mlp", "w_down"), (16, 512, 128)),
    ("starcoder2-3b", ("groups", "g0", "attn", "wq"), (30, 192, 3072)),
    ("starcoder2-3b", ("groups", "g0", "attn", "bq"), (30, 3072)),
    ("qwen3-moe-235b-a22b", ("groups", "g0", "moe", "w_gate"),
     (94, 8, 256, 1536)),
    ("qwen3-moe-235b-a22b", ("groups", "g0", "attn", "wk"), (94, 256, 256)),
])
def test_param_layout_at_the_production_mesh(arch, leaf, local):
    """The (16, 16) mesh: kv 8 under ``model`` 16 is whole, starcoder2's
    24 heads under 16 leave its attention whole, ``embed`` goes over
    ``data`` (FSDP), the experts over ``model`` and ``moe_mlp`` over
    ``data``."""
    layout = dict(tree_items(sharding.param_layout(
        get_config(arch), SizesMesh(data=16, model=16))))
    assert layout[leaf].local == local
