"""Serving the five architectures the port adds, against the JAX package's
(``reduced()`` sizes on the CPU, f32; recurrentgemma cut to R, R, A as in
``test_torch_lm_archs.py``): prefill logits and every cache leaf, one
decode step into a grown cache, decode from an empty cache against the
prefill, an unstacked block group, and the rolling window cache after a
prefill (ROADMAP Queue 3 item 19).  Tolerance 1e-4 (relative and
absolute).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import transformer as j_tf
from repro.train import steps as j_steps
from repro_torch.configs import BlockGroup
from repro_torch.core.flat import tree_items
from repro_torch.models import attention as attn
from repro_torch.models import transformer as tf
from repro_torch.train import steps
from test_torch_lm_archs import ARCHS, B, TOL, UNSTACKED, batch, models

T = 24                  # a multiple of the reduced window (8)


def _prompt(cfg, t=T, seed=1):
    b = batch(cfg, seed=seed, t=t)
    del b["labels"]
    return b


def _grow_jax(caches, empty):
    """The JAX package's prefill caches copied into its empty caches with
    room for more positions, as the port's ``grow_decode_cache`` does: a
    leaf that already has the empty one's shape (SSD and RG-LRU states,
    cross K/V, a full window) whole, any other into the first slots of its
    sequence axis (the first axis that differs)."""
    def one(c, e):
        if c.shape == e.shape:
            return c
        ax = next(i for i, (m, n) in enumerate(zip(c.shape, e.shape))
                  if m != n)
        return e.at[(slice(None),) * ax + (slice(0, c.shape[ax]),)].set(c)
    return jax.tree.map(one, caches, empty)


def _assert_trees_close(got, want):
    want = dict(tree_items(jax.tree.map(np.asarray, want)))
    got = dict(tree_items(got))
    assert set(got) == set(want)
    for path, a in got.items():
        assert tuple(a.shape) == want[path].shape, path
        np.testing.assert_allclose(a.numpy(), want[path], **TOL,
                                   err_msg=str(path))


def _serve_both(arch, **replace):
    """Prefill T tokens in both packages, then one decode step into caches
    grown to T + 1: (JAX out, port out) of each."""
    j_cfg, jp, cfg, p = models(arch, **replace)
    prompt = _prompt(j_cfg)
    j_pre = jax.jit(j_steps.make_prefill_step(j_cfg))(
        jp, {k: jnp.asarray(v) for k, v in prompt.items()})
    pre = steps.make_prefill_step(cfg)(
        p, {k: torch.from_numpy(v) for k, v in prompt.items()})
    tok = np.random.default_rng(2).integers(0, cfg.vocab_size, (B, 1),
                                            dtype=np.int32)
    pos = np.full((B,), T, np.int32)
    j_grown = _grow_jax(j_pre[1], j_tf.init_decode_cache(j_cfg, B, T + 1))
    j_dec = jax.jit(j_steps.make_serve_step(j_cfg))(
        jp, j_grown, jnp.asarray(tok), jnp.asarray(pos))
    grown = tf.grow_decode_cache(cfg, pre[1], T + 1)
    dec = steps.make_serve_step(cfg)(p, grown, torch.from_numpy(tok),
                                     torch.from_numpy(pos))
    return (j_pre, pre), (j_dec, dec)


def _assert_serving_matches(arch, **replace):
    ((j_logits, j_caches), (logits, caches)), \
        ((j_logits2, j_caches2), (logits2, caches2)) = _serve_both(
            arch, **replace)
    assert logits.dtype == torch.float32
    np.testing.assert_allclose(logits.numpy(), np.asarray(j_logits), **TOL)
    _assert_trees_close(caches, j_caches)
    np.testing.assert_allclose(logits2.numpy(), np.asarray(j_logits2), **TOL)
    _assert_trees_close(caches2, j_caches2)
    return caches


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_jax(arch):
    """Prefill logits and every cache leaf (SSD and RG-LRU states, the
    window cache, the MLA compressed cache, cross K/V), then one decode
    step into caches grown to T + 1: its logits and every cache leaf."""
    _assert_serving_matches(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_from_an_empty_cache_reproduces_the_prefill(arch):
    """Decoding the prompt token by token from an empty cache gives the
    prefill's last logits (tests/test_models_smoke.py:84-121 for the JAX
    package, here at 1e-4); for whisper the cross K/V come from
    ``encode_kv`` of the encoder's output, once."""
    _, _, cfg, p = models(arch)
    prompt = {k: torch.from_numpy(v) for k, v in _prompt(cfg, t=12).items()}
    want, _ = steps.make_prefill_step(cfg)(p, prompt)
    caches = tf.init_decode_cache(cfg, B, 13, device="cpu")
    if cfg.family == "encdec":
        with torch.no_grad():
            enc_out = tf._encode(cfg, p, prompt["frames"])
            for gi, g in enumerate(cfg.blocks):
                layers = tf._unstack(p["groups"][f"g{gi}"], g.count)
                kv = [attn.encode_kv(cfg, lp["xattn"], enc_out)
                      for lp in layers]
                caches[f"g{gi}"]["xk"] = torch.stack([k for k, _ in kv])
                caches[f"g{gi}"]["xv"] = torch.stack([v for _, v in kv])
    serve = steps.make_serve_step(cfg)
    for i in range(12):
        logits, caches = serve(p, caches, prompt["tokens"][:, i:i + 1],
                               torch.full((B,), i, dtype=torch.int32))
    torch.testing.assert_close(logits, want, **TOL)


def test_unstacked_group_serves_like_jax():
    """deepseek with its MoE group unstacked: the caches are a list of
    per-layer caches in both packages; prefill and a decode step match."""
    caches = _assert_serving_matches("deepseek-v2-236b", blocks=UNSTACKED)
    assert isinstance(caches["g1"], list) and len(caches["g1"]) == 2


# -- ROADMAP Queue 3 item 19: the window cache after a prefill ----------------

W = 8


def _window_case(t):
    """recurrentgemma (R, R, A; window 8): the A layer's cache after a
    t-token prefill in each package, and the logits of decoding token t
    straight after it (no grown cache) against those of the (t+1)-token
    prefill."""
    j_cfg, jp, cfg, p = models("recurrentgemma-9b")
    assert cfg.local_window == W and cfg.blocks[2].mixer == "lattn"
    tokens = batch(cfg, seed=3, t=t + 1)["tokens"]
    pos = np.full((B,), t, np.int32)
    j_prefill = jax.jit(j_steps.make_prefill_step(j_cfg))
    j_serve = jax.jit(j_steps.make_serve_step(j_cfg))
    j_want, _ = j_prefill(jp, {"tokens": jnp.asarray(tokens)})
    _, j_caches = j_prefill(jp, {"tokens": jnp.asarray(tokens[:, :t])})
    j_got, _ = j_serve(jp, j_caches, jnp.asarray(tokens[:, t:]),
                       jnp.asarray(pos))
    prefill, serve = steps.make_prefill_step(cfg), steps.make_serve_step(cfg)
    want, _ = prefill(p, {"tokens": torch.from_numpy(tokens)})
    _, caches = prefill(p, {"tokens": torch.from_numpy(tokens[:, :t])})
    got, _ = serve(p, caches, torch.from_numpy(tokens[:, t:]),
                   torch.from_numpy(pos))
    return (jax.tree.map(np.asarray, j_caches["g2"]), caches["g2"],
            (np.asarray(j_got), np.asarray(j_want)),
            (got.numpy(), want.numpy()))


def _rel(got, want):
    return np.linalg.norm(got - want) / np.linalg.norm(want)


@pytest.mark.parametrize("t", [8, 12, 16])
def test_window_cache_after_a_prefill(t):
    """The port puts position p of a window layer's prefill cache at slot
    p % w, where decode writes it: its cache is the JAX package's rolled
    by t % w (the same positions; their K/V within 1e-4), and decoding
    token t straight after the prefill matches the (t+1)-token prefill.
    The JAX package keeps the last w positions at slots 0..w-1, which
    agrees only when w divides t: at t = 12 its decode overwrites a
    position still inside the window, and its logits leave the prefill's
    by more than 1e-2 (relative RMS)."""
    j_cache, cache, (j_got, j_want), (got, want) = _window_case(t)
    shift = t % W
    np.testing.assert_array_equal(cache["pos"].numpy(),
                                  np.roll(j_cache["pos"], shift, axis=1))
    assert (cache["pos"] % W == torch.arange(W)).all()
    for name in ("k", "v"):
        np.testing.assert_allclose(cache[name].numpy(),
                                   np.roll(j_cache[name], shift, axis=1),
                                   **TOL, err_msg=name)
    np.testing.assert_allclose(got, want, **TOL)
    if shift:
        assert _rel(j_got, j_want) > 1e-2
    else:
        np.testing.assert_allclose(j_got, j_want, **TOL)


@pytest.mark.parametrize("t", [8, 16])
def test_window_cache_is_unrolled_when_the_window_divides_t(t):
    """Where w divides t the roll is the identity: the window cache is
    bitwise the last w positions of the same layer's full cache (the layer
    prefilled as plain attention, its input unchanged)."""
    _, _, cfg, p = models("recurrentgemma-9b")
    full_cfg = dataclasses.replace(cfg, blocks=cfg.blocks[:2] + (
        BlockGroup("attn", "mlp", 1, scan=False),))
    tokens = torch.from_numpy(batch(cfg, seed=3, t=t)["tokens"])
    _, caches = steps.make_prefill_step(cfg)(p, {"tokens": tokens})
    _, full = steps.make_prefill_step(full_cfg)(p, {"tokens": tokens})
    for name in ("k", "v", "pos"):
        assert torch.equal(caches["g2"][name], full["g2"][name][:, -W:])
