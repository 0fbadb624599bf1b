"""The port's LM training path against the JAX package's, at the five dense
configs' ``reduced()`` sizes on the CPU, in f32.

The JAX package's parameters (``init_params`` from a fixed key) are carried
over with ``convert.lm_params_from_numpy``; tokens, labels and activations
are made with numpy.  Each JAX reference is computed once per module.
Tolerance 1e-4 (relative to the reference's norm, per output and per
gradient leaf): the two frameworks sum the same f32 products in other
orders.  Remat is held against no remat inside the port, where only the
recomputation differs: bitwise or within 1e-6.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import SHAPES as J_SHAPES
from repro.configs import all_configs as j_all_configs
from repro.configs import load_all
from repro.launch import roofline as j_roofline
from repro.models import attention as j_attn
from repro.models import common as j_common
from repro.models import transformer as j_tf
from repro.train import steps as j_steps
from repro_torch.configs import SHAPES, all_configs, get_config
from repro_torch.convert import lm_params_from_numpy
from repro_torch.core.flat import tree_items
from repro_torch.launch import roofline
from repro_torch.models import attention as attn
from repro_torch.models import common
from repro_torch.models import transformer as tf
from repro_torch.train import steps

TOL = 1e-4
B, T = 2, 24
DENSE = ["qwen2-1.5b", "llama3.2-1b", "starcoder2-3b", "codeqwen1.5-7b",
         "chameleon-34b"]

load_all()


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want),
                                                  1e-30))


def _batch(cfg, seed=0, t=T):
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, cfg.vocab_size, (B, t), dtype=np.int32)
    labels[0, :3] = -1                                   # masked labels
    return {"tokens": rng.integers(0, cfg.vocab_size, (B, t),
                                   dtype=np.int32), "labels": labels}


@functools.cache
def _models(arch):
    """(JAX config, JAX params, the port's config, the port's params)."""
    j_cfg = j_all_configs()[arch].reduced()
    jp, _ = j_tf.init_params(j_cfg, jax.random.PRNGKey(0))
    cfg = get_config(arch).reduced()
    return j_cfg, jp, cfg, lm_params_from_numpy(
        cfg, jax.tree.map(np.asarray, jp), device="cpu")


@functools.cache
def _j_loss_and_grads(arch):
    j_cfg, jp, _, _ = _models(arch)
    batch = {k: jnp.asarray(v) for k, v in _batch(j_cfg).items()}
    (loss, metrics), grads = jax.jit(jax.value_and_grad(
        lambda p: j_tf.forward_train(j_cfg, p, batch), has_aux=True))(jp)
    return float(loss), jax.tree.map(np.asarray, metrics), \
        jax.tree.map(np.asarray, grads)


def _port_loss_and_grads(cfg, params, batch):
    params = jax.tree.map(lambda a: a.clone().requires_grad_(True), params)
    loss, metrics = tf.forward_train(
        cfg, params, {k: torch.from_numpy(v) for k, v in batch.items()})
    paths, leaves = zip(*tree_items(params))
    grads = torch.autograd.grad(loss, leaves)
    return loss, metrics, dict(zip(paths, grads))


def test_registry_holds_the_five_dense_configs():
    """The five dense configs, among the JAX registry's ten."""
    assert set(DENSE) < set(all_configs())
    assert sorted(all_configs()) == sorted(j_all_configs())


@pytest.mark.parametrize("arch", DENSE)
def test_forward_train_loss_and_gradients_match_jax(arch):
    """The loss, the metrics and every gradient leaf (``jax.grad`` against
    autograd), on the same params, tokens and labels (3 masked)."""
    j_cfg, _, cfg, p = _models(arch)
    j_loss, j_metrics, j_grads = _j_loss_and_grads(arch)
    loss, metrics, grads = _port_loss_and_grads(cfg, p, _batch(j_cfg))
    assert loss.dtype == torch.float32 and loss.shape == ()
    assert _rel(loss.item(), j_loss) <= TOL
    assert set(metrics) == set(j_metrics) == {"loss", "load_balance",
                                              "router_z"}
    assert metrics["load_balance"].item() == 0 == j_metrics["load_balance"]
    assert metrics["router_z"].item() == 0 == j_metrics["router_z"]
    j_leaves = dict(tree_items(j_grads))
    assert set(grads) == set(j_leaves)
    for path, g in grads.items():
        assert g.shape == j_leaves[path].shape, path
        assert _rel(g.numpy(), j_leaves[path]) <= TOL, path


@pytest.mark.parametrize("arch", [a for a in DENSE if a != "llama3.2-1b"])
def test_prefill_of_the_new_configs_matches_jax(arch):
    """Prefill logits and every cache leaf of the four configs this slice
    registers (GQA kv 2 and 32, QKV bias, layernorm, GELU, untied and bf16
    params), through the query-chunked attention in both packages."""
    j_cfg, jp, cfg, p = _models(arch)
    tokens = _batch(j_cfg, seed=1)["tokens"]
    j_logits, j_caches = jax.jit(j_steps.make_prefill_step(j_cfg))(
        jp, {"tokens": jnp.asarray(tokens)})
    logits, caches = steps.make_prefill_step(cfg)(
        p, {"tokens": torch.from_numpy(tokens)})
    assert _rel(logits.numpy(), j_logits) <= TOL
    j_leaves = dict(tree_items(jax.tree.map(np.asarray, j_caches)))
    leaves = dict(tree_items(caches))
    assert set(leaves) == set(j_leaves)
    for path, a in leaves.items():
        assert _rel(a.float().numpy(), j_leaves[path]) <= TOL, path


ATTEND_CASES = {
    # name: (T, S, H, Hkv, causal, window, chunk)
    "causal": (24, 24, 4, 2, True, None, 512),
    "not_causal": (24, 24, 4, 2, False, None, 512),
    "window_8": (24, 24, 4, 2, True, 8, 512),
    "s_longer_than_t": (12, 30, 4, 2, True, None, 512),
    "ragged_chunk": (40, 40, 4, 2, True, None, 16),
    "ragged_chunk_window": (40, 40, 4, 2, True, 8, 16),
    "gqa_group_2_mha": (20, 20, 2, 2, True, None, 8),
    "s_shorter_than_t": (30, 12, 4, 1, True, None, 16),
}


@pytest.mark.parametrize("case", sorted(ATTEND_CASES))
def test_attend_chunked_matches_jax(case):
    """``_attend_chunked``'s output and its input gradients (a random
    cotangent, ``jax.vjp`` against autograd)."""
    t, s, h, hkv, causal, window, chunk = ATTEND_CASES[case]
    rng = np.random.default_rng(4)
    q, k, v = (rng.standard_normal((B, n, heads, 16)).astype(np.float32)
               for n, heads in ((t, h), (s, hkv), (s, hkv)))
    ct = rng.standard_normal((B, t, h, 16)).astype(np.float32)
    kw = dict(causal=causal, window=window, chunk=chunk)
    want, vjp = jax.vjp(lambda *a: j_attn._attend_chunked(*a, **kw),
                        *map(jnp.asarray, (q, k, v)))
    want_grads = vjp(jnp.asarray(ct))
    args = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    got = attn._attend_chunked(*args, **kw)
    got.backward(torch.from_numpy(ct))
    assert got.shape == (B, t, h, 16)
    assert _rel(got.detach().numpy(), want) <= TOL
    for a, w in zip(args, want_grads):
        assert _rel(a.grad.numpy(), w) <= TOL


def test_attend_chunked_keeps_a_bf16_dtype():
    """bf16 in, bf16 out: the scores, softmax and PV run in f32, and the
    chunking does not change the answer beyond bf16's rounding of it."""
    rng = np.random.default_rng(5)
    q, k, v = (torch.from_numpy(rng.standard_normal((B, 40, 4, 16))
                                .astype(np.float32)) for _ in range(3))
    one = attn._attend_chunked(q, k, v, causal=True, window=None, chunk=40)
    got = attn._attend_chunked(*(x.bfloat16() for x in (q, k, v)),
                               causal=True, window=None, chunk=16)
    assert got.dtype == torch.bfloat16
    assert _rel(got.float().numpy(), one.numpy()) <= 2e-2


def test_cross_entropy_chunked_matches_jax():
    """A ragged last chunk (T 40, chunk 16) and masked labels: the loss and
    its gradients in h and in the unembedding."""
    rng = np.random.default_rng(6)
    h = rng.standard_normal((B, 40, 32)).astype(np.float32)
    w = (rng.standard_normal((32, 100)) / 6).astype(np.float32)
    labels = rng.integers(0, 100, (B, 40), dtype=np.int32)
    labels[:, ::7] = -1
    want, (gh, gw) = jax.value_and_grad(
        lambda a, b: j_common.cross_entropy_chunked(
            a, b, jnp.asarray(labels), chunk=16), argnums=(0, 1))(
        jnp.asarray(h), jnp.asarray(w))
    th, tw = (torch.from_numpy(a).requires_grad_(True) for a in (h, w))
    got = common.cross_entropy_chunked(th, tw, torch.from_numpy(labels),
                                       chunk=16)
    got.backward()
    assert _rel(got.item(), float(want)) <= TOL
    assert _rel(th.grad.numpy(), gh) <= TOL
    assert _rel(tw.grad.numpy(), gw) <= TOL
    no_labels = torch.full((B, 40), -1, dtype=torch.int32)
    assert common.cross_entropy_chunked(th, tw, no_labels).item() == 0.0


@pytest.mark.parametrize("policy", ["full", "dots"])
def test_remat_matches_no_remat(policy, monkeypatch):
    """Remat on a stacked group (2 layers) against remat off: the loss
    bitwise and every gradient within 1e-6, and each layer's function run
    again in the backward (4 calls against 2)."""
    _, _, cfg, p = _models("llama3.2-1b")
    batch = _batch(cfg)
    calls = []
    real = tf._layer_fwd

    def counting(*args, **kwargs):
        calls.append(torch.is_grad_enabled())
        return real(*args, **kwargs)
    monkeypatch.setattr(tf, "_layer_fwd", counting)
    out = {}
    for remat in (False, True):
        calls.clear()
        c = dataclasses.replace(cfg, remat=remat, remat_policy=policy)
        out[remat] = _port_loss_and_grads(c, p, batch)
        out[remat] = out[remat] + (len(calls),)
    assert out[False][3] == cfg.num_layers
    assert out[True][3] == 2 * cfg.num_layers
    assert out[True][0].item() == out[False][0].item()
    for path, g in out[False][2].items():
        torch.testing.assert_close(out[True][2][path], g, rtol=1e-6,
                                   atol=1e-6, msg=str(path))


def test_forward_train_refuses_the_flash_kernel():
    """The flash kernel has no backward: training asks for the query-chunked
    attention instead of silently taking it."""
    _, _, cfg, p = _models("llama3.2-1b")
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg).items()}
    with pytest.raises(NotImplementedError, match="no backward"):
        tf.forward_train(dataclasses.replace(cfg, use_flash=True), p, batch)


def test_training_holds_no_decode_caches(monkeypatch):
    """``forward_train`` computes no K/V twice: no cache is built."""
    _, _, cfg, p = _models("llama3.2-1b")
    built = []
    monkeypatch.setattr(tf, "_gqa_cache_from_seq",
                        lambda *a: built.append(1))
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg).items()}
    tf.forward_train(cfg, p, batch)
    assert built == []


@pytest.mark.parametrize("arch", sorted(j_all_configs()))
def test_model_flops_match_jax(arch):
    """``_active_params`` and ``model_flops`` equal the JAX package's for
    every config of its registry (the port's copy reads any config with
    the same fields) and every ``SHAPES`` cell, and for the port's own
    registered configs."""
    j_cfg = j_all_configs()[arch]
    cfgs = [j_cfg, get_config(arch)]
    assert sorted(SHAPES) == sorted(J_SHAPES)
    for cfg in cfgs:
        assert roofline._active_params(cfg) == \
            j_roofline._active_params(j_cfg)
        for name, shape in SHAPES.items():
            for n_dev in (1, 256):
                assert roofline.model_flops(cfg, shape, n_dev) == \
                    j_roofline.model_flops(j_cfg, J_SHAPES[name], n_dev)


def test_roofline_peaks_are_chip_smokes_h100():
    import pathlib
    import sys
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
    import chip_smoke

    _, _, bytes_s, bf16 = chip_smoke.PEAKS["SXM"]
    assert (roofline.PEAK_FLOPS, roofline.HBM_BW) == (bf16, bytes_s)
