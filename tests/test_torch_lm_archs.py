"""The five architectures whose mixers the port adds (whisper-medium,
deepseek-v2-236b, qwen3-moe-235b-a22b, recurrentgemma-9b, mamba2-370m)
against the JAX package's, at ``reduced()`` sizes on the CPU in f32:
the registry, the parameter trees, ``forward_train`` (total, metrics,
every gradient leaf) and an unstacked block group, and the analytic
parameter counts of the full configs.

recurrentgemma runs its first three layers (R, R, A): the JAX package's
reduced config keeps all 38 single-layer groups, whose jit compile takes
minutes (``tests/test_models_smoke.py`` marks it slow).  The JAX
package's parameters (``init_params`` from a fixed key) are carried over
with ``convert.lm_params_from_numpy``; tokens, labels and frames are made
with numpy.  Each JAX reference is computed once per module.  Tolerance
1e-4 (relative and absolute): the two frameworks sum the same f32
products in other orders.
"""
import dataclasses
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import checkpoint as j_ckpt
from repro.configs import all_configs as j_all_configs
from repro.configs import cells as j_cells
from repro.configs import load_all
from repro.models import transformer as j_tf
from repro_torch.checkpoint import checkpoint as ckpt
from repro_torch.configs import BlockGroup, all_configs, cells, get_config
from repro_torch.convert import lm_params_from_numpy
from repro_torch.core.flat import tree_items
from repro_torch.launch import roofline
from repro_torch.models import common
from repro_torch.models import transformer as tf
from repro_torch.optim import adam

TOL = dict(rtol=1e-4, atol=1e-4)
B, T = 2, 24
ARCHS = ["whisper-medium", "deepseek-v2-236b", "qwen3-moe-235b-a22b",
         "recurrentgemma-9b", "mamba2-370m"]

load_all()


def cut(cfg):
    """recurrentgemma's first three layers (R, R, A); others as they are."""
    if cfg.name != "recurrentgemma-9b":
        return cfg
    return dataclasses.replace(cfg, blocks=cfg.blocks[:3], num_layers=3)


def batch(cfg, seed=0, t=T):
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, cfg.vocab_size, (B, t), dtype=np.int32)
    labels[0, :3] = -1                                   # masked labels
    out = {"tokens": rng.integers(0, cfg.vocab_size, (B, t), dtype=np.int32),
           "labels": labels}
    if cfg.family == "encdec":
        out["frames"] = rng.standard_normal(
            (B, cfg.num_frames, cfg.d_model)).astype(np.float32)
    return out


@functools.cache
def models(arch, **replace):
    """(JAX config, JAX params, the port's config, the port's params)."""
    j_cfg = dataclasses.replace(cut(j_all_configs()[arch].reduced()),
                                **replace)
    jp, _ = j_tf.init_params(j_cfg, jax.random.PRNGKey(0))
    cfg = dataclasses.replace(cut(get_config(arch).reduced()), **replace)
    return j_cfg, jp, cfg, lm_params_from_numpy(
        cfg, jax.tree.map(np.asarray, jp), device="cpu")


@functools.cache
def j_loss_and_grads(arch, **replace):
    j_cfg, jp, _, _ = models(arch, **replace)
    jb = {k: jnp.asarray(v) for k, v in batch(j_cfg).items()}
    (total, metrics), grads = jax.jit(jax.value_and_grad(
        lambda p: j_tf.forward_train(j_cfg, p, jb), has_aux=True))(jp)
    return float(total), jax.tree.map(np.asarray, metrics), \
        dict(tree_items(jax.tree.map(np.asarray, grads)))


def port_loss_and_grads(cfg, params, b):
    params = common.tree_map(lambda a: a.clone().requires_grad_(True), params)
    total, metrics = tf.forward_train(
        cfg, params, {k: torch.from_numpy(v) for k, v in b.items()})
    paths, leaves = zip(*tree_items(params))
    return total, metrics, dict(zip(paths, torch.autograd.grad(total,
                                                               leaves)))


def assert_train_matches(arch, **replace):
    j_cfg, _, cfg, p = models(arch, **replace)
    j_total, j_metrics, j_grads = j_loss_and_grads(arch, **replace)
    total, metrics, grads = port_loss_and_grads(cfg, p, batch(j_cfg))
    assert total.dtype == torch.float32 and total.shape == ()
    np.testing.assert_allclose(total.item(), j_total, **TOL)
    assert set(metrics) == set(j_metrics) == {"loss", "load_balance",
                                              "router_z"}
    for k, v in metrics.items():
        np.testing.assert_allclose(v.item(), j_metrics[k], **TOL, err_msg=k)
    assert (metrics["load_balance"].item() > 0) == bool(cfg.num_experts)
    assert set(grads) == set(j_grads)
    for path, g in grads.items():
        assert g.shape == j_grads[path].shape, path
        np.testing.assert_allclose(g.numpy(), j_grads[path], **TOL,
                                   err_msg=str(path))


def test_registry_holds_the_ten_configs_with_the_jax_numbers():
    """``get_config`` returns the JAX registry's numbers for all ten
    architectures, full and reduced, and ``cells`` its shape cells."""
    asdict = dataclasses.asdict
    assert sorted(all_configs()) == sorted(j_all_configs())
    for name, j_cfg in j_all_configs().items():
        assert asdict(get_config(name)) == asdict(j_cfg), name
        assert asdict(get_config(name).reduced()) == asdict(j_cfg.reduced())
        assert cells(get_config(name)) == j_cells(j_cfg), name


@pytest.mark.parametrize("arch", ARCHS)
def test_param_tree_matches_jax(arch):
    """Keys, shapes and dtypes of the port's spec and of its random init
    against the JAX package's ``init_params``."""
    _, jp, cfg, p = models(arch)
    j_shapes = {k: v.shape for k, v in tree_items(jax.tree.map(np.asarray,
                                                                jp))}
    spec = dict(tree_items(tf.param_spec(cfg)))
    assert {k: v.shape for k, v in spec.items()} == j_shapes
    drawn = tf.init_params(cfg, torch.Generator().manual_seed(0),
                           device="cpu")
    assert {k: (tuple(v.shape), v.dtype) for k, v in tree_items(drawn)} == \
        {k: (tuple(v.shape), v.dtype) for k, v in tree_items(p)}


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_train_matches_jax(arch):
    """The total (with the MoE aux losses), ``loss``, ``load_balance``,
    ``router_z`` and every gradient leaf (``jax.grad`` against autograd),
    on the same params, tokens, labels (3 masked) and frames."""
    assert_train_matches(arch)


UNSTACKED = (BlockGroup("mla", "mlp", 1, scan=False),
             BlockGroup("mla", "moe", 2, scan=False))


def test_unstacked_group_matches_jax(tmp_path):
    """deepseek reduced with its MoE group unstacked (``scan=False``,
    count 2): the tree holds ``{"unstacked": [layer, layer]}``,
    ``forward_train`` and every gradient leaf match, Adam updates the
    list, and a train state crosses the two packages' checkpoints."""
    assert_train_matches("deepseek-v2-236b", blocks=UNSTACKED)
    j_cfg, jp, cfg, p = models("deepseek-v2-236b", blocks=UNSTACKED)
    assert isinstance(p["groups"]["g1"]["unstacked"], list)
    assert len(p["groups"]["g1"]["unstacked"]) == 2

    state = {"params": p, "opt": adam.init_opt_state(p)}
    grads = common.tree_map(torch.ones_like, p)
    params, opt, _ = adam.adam_update(adam.AdamConfig(), common.tree_map(
        torch.clone, p), grads, state["opt"])
    assert isinstance(opt["m"]["groups"]["g1"]["unstacked"], list)
    state = {"params": params, "opt": opt}
    ckpt.save(tmp_path / "ckpt_step1", state, {"step": 1})
    j_like = {"params": jp, "opt": {
        "m": jax.tree.map(jnp.zeros_like, jp),
        "v": jax.tree.map(jnp.zeros_like, jp),
        "step": jnp.zeros((), jnp.int32)}}
    j_state, _ = j_ckpt.restore(tmp_path / "ckpt_step1", j_like)
    back, _ = ckpt.restore(tmp_path / "ckpt_step1", state, "cpu")
    for (path, a), (_, b), (_, j) in zip(
            tree_items(state), tree_items(back),
            tree_items(jax.tree.map(np.asarray, j_state))):
        assert torch.equal(a, b), path
        np.testing.assert_array_equal(a.numpy(), j, err_msg=str(path))


@pytest.mark.parametrize("arch", ARCHS)
def test_active_params_match_the_param_spec(arch):
    """``launch/roofline.py::_active_params`` against the port's own
    ``param_spec`` of the full config, from shapes alone (nothing is
    allocated): within 2%, as tests/test_param_counts.py holds the JAX
    package's against its abstract init."""
    cfg = get_config(arch)
    actual = sum(math.prod(leaf.shape)
                 for _, leaf in tree_items(tf.param_spec(cfg)))
    analytic, _ = roofline._active_params(cfg)
    assert abs(actual - analytic) / actual < 0.02, (arch, actual, analytic)
