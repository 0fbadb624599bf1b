"""The port's LM serving path against the JAX package's, at
``llama3.2-1b.reduced()``.

The JAX package's parameters (``init_params`` from a fixed key) are carried
over with ``convert.lm_params_from_numpy``; tokens and activations are made
with numpy.  Both run in f32 on the CPU (the reduced config computes in
f32): bf16 rounds at other places in XLA and torch, so bf16 is held only on
the card, kernel against plain.  Tolerance 1e-4 (relative and absolute):
the two frameworks sum the same f32 products in other orders, through two
layers.  Both packages' registered config trains and prefills through the
query-chunked attention; the serving path here asks for the flash route
with ``dataclasses.replace(cfg, use_flash=True)`` in both (the Pallas
kernel in interpret mode on the JAX side), and ``gqa_forward`` is held on
each route against the JAX package's same route.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import all_configs, load_all
from repro.models import attention as j_attn
from repro.models import common as j_common
from repro.models import mlp as j_mlp
from repro.models import transformer as j_tf
from repro.train import steps as j_steps
from repro_torch.configs import all_configs as torch_configs
from repro_torch.configs import get_config
from repro_torch.convert import lm_params_from_numpy
from repro_torch.models import attention as attn
from repro_torch.models import common
from repro_torch.models import mlp
from repro_torch.models import transformer as tf
from repro_torch.train import steps

TOL = dict(rtol=1e-4, atol=1e-4)
B, T = 2, 8

DENSE = ["qwen2-1.5b", "llama3.2-1b", "starcoder2-3b", "codeqwen1.5-7b",
         "chameleon-34b"]

load_all()
J_CFG = dataclasses.replace(all_configs()["llama3.2-1b"].reduced(),
                            use_flash=True)
CFG = dataclasses.replace(get_config("llama3.2-1b").reduced(), use_flash=True)


@pytest.fixture(scope="module")
def params():
    """(JAX params, the port's copy on the CPU)."""
    jp, _ = j_tf.init_params(J_CFG, jax.random.PRNGKey(0))
    tree = jax.tree.map(np.asarray, jp)
    return jp, lm_params_from_numpy(CFG, tree, device="cpu")


@pytest.fixture(scope="module")
def tokens():
    return np.random.default_rng(0).integers(0, CFG.vocab_size, (B, T + 1),
                                             dtype=np.int32)


@pytest.fixture(scope="module")
def j_prefill():
    return jax.jit(j_steps.make_prefill_step(J_CFG))


@pytest.fixture(scope="module")
def j_serve():
    return jax.jit(j_steps.make_serve_step(J_CFG))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _assert_tree_close(got, want):
    assert set(got) == set(want)
    for key in want:
        if isinstance(want[key], dict):
            _assert_tree_close(got[key], want[key])
        else:
            np.testing.assert_allclose(got[key].numpy(), want[key], **TOL,
                                       err_msg=key)


def _grow(caches, size, like):
    """Prefill caches (layers, B, T, ...) copied into slots 0..T-1 of empty
    caches with room for ``size`` positions (``like``: the port's or the
    JAX package's)."""
    if like == "jax":
        empty = j_tf.init_decode_cache(J_CFG, B, size)
        return {g: {k: empty[g][k].at[:, :, :a.shape[2]].set(a)
                    for k, a in c.items()} for g, c in caches.items()}
    return tf.grow_decode_cache(CFG, caches, size)


def test_config_is_jax_config_with_flash():
    """The port's own copies of the JAX registry's ten configs (its own
    registry), field by field the JAX package's as registered (use_flash
    False), full and reduced; the serving variant here is the same
    replace() of each."""
    asdict = dataclasses.asdict
    assert sorted(torch_configs()) == sorted(all_configs())
    assert set(DENSE) < set(torch_configs())
    for name in all_configs():
        assert asdict(get_config(name)) == asdict(all_configs()[name]), name
        assert not get_config(name).use_flash
        assert asdict(get_config(name).reduced()) == \
            asdict(all_configs()[name].reduced()), name
    assert asdict(CFG) == asdict(J_CFG)


def test_param_tree_matches(params):
    jp, p = params
    assert jax.tree.structure(_np(jp)) == jax.tree.structure(
        jax.tree.map(lambda t: t.numpy(), p))
    shapes = jax.tree.map(lambda leaf: leaf.shape, tf.param_spec(CFG),
                          is_leaf=lambda x: isinstance(x, common.Leaf))
    assert jax.tree.map(lambda t: tuple(t.shape), p) == shapes
    drawn = tf.init_params(CFG, torch.Generator().manual_seed(0),
                           device="cpu")
    assert jax.tree.map(lambda t: (tuple(t.shape), t.dtype), drawn) == \
        jax.tree.map(lambda t: (tuple(t.shape), t.dtype), p)
    assert float(drawn["embed"].std()) == pytest.approx(0.02, rel=0.1)


def test_norms_and_rope():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((B, T, 4, 16)).astype(np.float32)
    scale, bias = rng.standard_normal((2, 16)).astype(np.float32)
    pos = np.tile(np.arange(3, 3 + T, dtype=np.int32), (B, 1))
    np.testing.assert_allclose(
        common.rmsnorm(torch.from_numpy(x), torch.from_numpy(scale)).numpy(),
        np.asarray(j_common.rmsnorm(jnp.asarray(x), jnp.asarray(scale))),
        **TOL)
    np.testing.assert_allclose(
        common.layernorm(*map(torch.from_numpy, (x, scale, bias))).numpy(),
        np.asarray(j_common.layernorm(*map(jnp.asarray, (x, scale, bias)))),
        **TOL)
    np.testing.assert_allclose(
        common.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                          CFG.rope_theta).numpy(),
        np.asarray(j_common.apply_rope(jnp.asarray(x), jnp.asarray(pos),
                                       CFG.rope_theta)), **TOL)


@pytest.mark.parametrize("mlp_type", ["swiglu", "gelu"])
def test_mlp_matches_jax(mlp_type):
    """Both FFNs of the JAX package (llama's SwiGLU; GELU, tanh form, for
    the configs that come later), on the spec's shapes."""
    cfg = dataclasses.replace(CFG, mlp_type=mlp_type)
    rng = np.random.default_rng(3)
    p = {k: rng.standard_normal(leaf.shape).astype(np.float32)
         / np.sqrt(leaf.shape[0]) for k, leaf in mlp.init_mlp(cfg).items()}
    x = rng.standard_normal((B, T, cfg.d_model)).astype(np.float32)
    want = j_mlp.mlp_forward(dataclasses.replace(J_CFG, mlp_type=mlp_type),
                             {k: jnp.asarray(v) for k, v in p.items()},
                             jnp.asarray(x))
    got = mlp.mlp_forward(cfg, {k: torch.from_numpy(v) for k, v in p.items()},
                          torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("use_flash", [True, False])
def test_gqa_forward_matches_both_jax_paths(params, use_flash):
    jp, p = params
    j_layer = jax.tree.map(lambda a: a[0], jp["groups"]["g0"]["attn"])
    layer = {k: v[0] for k, v in p["groups"]["g0"]["attn"].items()}
    x = np.random.default_rng(2).standard_normal(
        (B, T, CFG.d_model)).astype(np.float32)
    pos = np.tile(np.arange(T, dtype=np.int32), (B, 1))
    want = j_attn.gqa_forward(dataclasses.replace(J_CFG, use_flash=use_flash),
                              j_layer, jnp.asarray(x), jnp.asarray(pos))
    got = attn.gqa_forward(dataclasses.replace(CFG, use_flash=use_flash),
                           layer, torch.from_numpy(x), torch.from_numpy(pos))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_unported_paths_raise(params, monkeypatch):
    """The query-chunked route (``use_flash=False``), once refused, now
    held against the JAX package's, with and without a local window; a
    window on the flash route stays refused (the kernel has none; the JAX
    package drops it, ROADMAP Queue 3 item 18).  Every mixer, MoE, enc-dec
    and unstacked groups are ported; the expert-parallel MoE schedule
    follows the mesh, not the process group: in a world of 4 with no mesh
    the sharded config's prefill is the dense one's, as the reference's
    with no mesh."""
    jp, p = params
    j_layer = jax.tree.map(lambda a: a[0], jp["groups"]["g0"]["attn"])
    layer = {k: v[0] for k, v in p["groups"]["g0"]["attn"].items()}
    x = np.random.default_rng(5).standard_normal(
        (1, 12, CFG.d_model)).astype(np.float32)
    pos = np.arange(12, dtype=np.int32)[None]
    chunked = dataclasses.replace(CFG, use_flash=False)
    j_chunked = dataclasses.replace(J_CFG, use_flash=False)
    for window in (None, 4):
        want = j_attn.gqa_forward(j_chunked, j_layer, jnp.asarray(x),
                                  jnp.asarray(pos), window=window)
        got = attn.gqa_forward(chunked, layer, torch.from_numpy(x),
                               torch.from_numpy(pos), window=window)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    with pytest.raises(NotImplementedError, match="Queue 3 item 18"):
        attn.gqa_forward(CFG, layer, torch.from_numpy(x),
                         torch.from_numpy(pos), window=4)
    mla = get_config("deepseek-v2-236b").reduced()
    assert "wkv_a" in tf.param_spec(mla)["groups"]["g1"]["attn"]
    moe_cfg = dataclasses.replace(get_config("qwen3-moe-235b-a22b").reduced(),
                                  moe_impl="sharded")
    moe_p = tf.init_params(moe_cfg, torch.Generator().manual_seed(0),
                           device="cpu")
    tokens = torch.zeros((1, 4), dtype=torch.int32)
    dense = steps.make_prefill_step(dataclasses.replace(
        moe_cfg, moe_impl="dense"))(moe_p, {"tokens": tokens})[0]
    monkeypatch.setattr(torch.distributed, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.distributed, "get_world_size", lambda: 4)
    got = steps.make_prefill_step(moe_cfg)(moe_p, {"tokens": tokens})[0]
    assert torch.equal(got, dense)


def test_prefill_and_decode_match_jax(params, tokens, j_prefill, j_serve):
    """Prefill logits and every cache leaf, then one decode step into a
    grown cache: logits and every cache leaf."""
    jp, p = params
    prompt = tokens[:, :T]
    j_logits, j_caches = j_prefill(jp, {"tokens": jnp.asarray(prompt)})
    logits, caches = steps.make_prefill_step(CFG)(
        p, {"tokens": torch.from_numpy(prompt)})
    assert logits.dtype == torch.float32 and logits.shape == (B, CFG.vocab_size)
    np.testing.assert_allclose(logits.numpy(), np.asarray(j_logits), **TOL)
    _assert_tree_close(caches, _np(j_caches))
    assert caches["g0"]["k"].shape == (2, B, T, CFG.num_kv_heads,
                                       attn.head_dim(CFG))

    tok = tokens[:, T:T + 1]
    pos = np.full((B,), T, np.int32)
    j_logits2, j_caches2 = j_serve(jp, _grow(j_caches, T + 1, "jax"),
                                   jnp.asarray(tok), jnp.asarray(pos))
    grown = _grow(caches, T + 1, "torch")
    logits2, caches2 = steps.make_serve_step(CFG)(
        p, grown, torch.from_numpy(tok), torch.from_numpy(pos))
    np.testing.assert_allclose(logits2.numpy(), np.asarray(j_logits2), **TOL)
    _assert_tree_close(caches2, _np(j_caches2))
    assert (grown["g0"]["pos"][..., T] == -1).all()   # input left as it was


def test_teacher_forced_decode_reproduces_prefill(params, tokens):
    """Decoding the prompt token by token from an empty cache gives the
    prefill's last logits (cache path == prefill path), as
    tests/test_models_smoke.py checks for the JAX package, here at 1e-4."""
    _, p = params
    prompt = torch.from_numpy(tokens[:, :T])
    want, _ = steps.make_prefill_step(CFG)(p, {"tokens": prompt})
    caches = tf.init_decode_cache(CFG, B, T + 1, device="cpu")
    serve = steps.make_serve_step(CFG)
    for i in range(T):
        logits, caches = serve(p, caches, prompt[:, i:i + 1],
                               torch.full((B,), i, dtype=torch.int32))
    torch.testing.assert_close(logits, want, **TOL)


def test_decode_after_prefill_needs_a_grown_cache(params, tokens, j_prefill,
                                                  j_serve):
    """A fault of the reference's serving recipe (ROADMAP Queue 3), in both
    packages: the prefill's caches hold exactly T positions, and decode
    writes at slot min(pos, S - 1), so decoding position T straight into
    them overwrites token T-1's K/V.  Decoding into a grown cache gives the
    logits of the (T+1)-token prefill."""
    jp, p = params
    prompt, tok = tokens[:, :T], tokens[:, T:T + 1]
    pos = np.full((B,), T, np.int32)

    j_want, _ = j_prefill(jp, {"tokens": jnp.asarray(tokens)})
    _, j_caches = j_prefill(jp, {"tokens": jnp.asarray(prompt)})
    j_args = (jnp.asarray(tok), jnp.asarray(pos))
    j_straight, _ = j_serve(jp, j_caches, *j_args)
    j_grown, _ = j_serve(jp, _grow(j_caches, T + 1, "jax"), *j_args)

    prefill, serve = steps.make_prefill_step(CFG), steps.make_serve_step(CFG)
    want, _ = prefill(p, {"tokens": torch.from_numpy(tokens)})
    _, caches = prefill(p, {"tokens": torch.from_numpy(prompt)})
    args = (torch.from_numpy(tok), torch.from_numpy(pos))
    straight, _ = serve(p, caches, *args)
    grown, _ = serve(p, _grow(caches, T + 1, "torch"), *args)

    for w, s, g in ((np.asarray(j_want), np.asarray(j_straight),
                     np.asarray(j_grown)),
                    (want.numpy(), straight.numpy(), grown.numpy())):
        np.testing.assert_allclose(g, w, **TOL)
        rel = np.linalg.norm(s - w) / np.linalg.norm(w)
        assert rel > 1e-2, rel
