"""The port's AdamW, int8 gradient compression and LM train step against
the JAX package's.

The optimiser is held on its own: the same numpy gradients go to both
packages' ``adam_update`` for 3 steps (params, moments, step, grad_norm and
lr within 1e-6, each leaf in norm: both compute in f32, except that the JAX package,
under the x64 mode importing it turns on, computes the warmup schedule and
the last subtraction ``p - lr * delta`` in f64 -- one f32 rounding of p
apart).  The model is held with its gradients (``test_torch_lm_train.py``);
here, 3 full train steps on the JAX token stream's ``host_batch`` tokens
compare losses and grad norms (1e-4), not every parameter: Adam maps
gradient entries near zero to updates of about +-lr, so a rounding-level
difference in such an entry moves its parameter by up to 2 lr while the
loss does not notice.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import all_configs as j_all_configs
from repro.configs import load_all
from repro.data.tokens import TokenStream as JTokenStream
from repro.optim import adam as j_adam
from repro.optim import compression as j_comp
from repro.train import steps as j_steps
from repro_torch.configs import get_config
from repro_torch.convert import lm_params_from_numpy
from repro_torch.core.flat import tree_items, tree_map
from repro_torch.optim import adam
from repro_torch.optim import compression as comp
from repro_torch.train import steps

DENSE = ["qwen2-1.5b", "llama3.2-1b", "starcoder2-3b", "codeqwen1.5-7b",
         "chameleon-34b"]
ADAM_RTOL = 1e-6
STEP_TOL = 1e-4

load_all()


def _rel(got, want) -> float:
    """Relative distance in norm: an entry that cancels (m near 0 after a
    sign change of g) may differ in its leading digits after one f32
    rounding of a sum (the grad norm's) differs."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want),
                                                  1e-30))


def _tensors(tree):
    return tree_map(lambda a: torch.from_numpy(np.array(a)), tree)


def _params(rng):
    """A matrix, a vector (not decayed), a stacked group's (layers, D) norm
    scale (2-D, so decayed, as in the JAX package) and a stacked matrix."""
    return {"w": rng.standard_normal((6, 5)).astype(np.float32),
            "b": rng.standard_normal(5).astype(np.float32),
            "groups": {"g0": {
                "norm1": {"scale": (0.1 * rng.standard_normal((2, 5)))
                          .astype(np.float32)},
                "wq": rng.standard_normal((2, 5, 4)).astype(np.float32)}}}


def _grads(rng, params, size):
    """Gradients of global norm ``size``, with exact zeros and entries near
    zero (where Adam's m / sqrt(v) is about +-1)."""
    g = tree_map(lambda p: rng.standard_normal(p.shape).astype(np.float32),
                 params)
    g["w"][0] = 0.0
    g["b"][:2] = 1e-7
    g["groups"]["g0"]["norm1"]["scale"][:] = 0.0
    norm = np.sqrt(sum(np.sum(a.astype(np.float64) ** 2)
                       for _, a in tree_items(g)))
    return tree_map(lambda a: (a * (size / norm)).astype(np.float32), g)


def test_adam_update_matches_jax():
    """3 steps on the same gradients: clipped (norm 3), clipped, not
    clipped (norm 0.5), through the warmup (2 steps)."""
    rng = np.random.default_rng(0)
    p0 = _params(rng)
    cfg = adam.AdamConfig(lr=1e-2, warmup_steps=2)
    j_cfg = j_adam.AdamConfig(lr=1e-2, warmup_steps=2)
    jp = tree_map(jnp.asarray, p0)
    js = j_adam.init_opt_state(jp)
    tp = _tensors(p0)
    ts = adam.init_opt_state(tp)
    assert ts["step"].dtype == torch.int32 and ts["step"].shape == ()
    for size in (3.0, 3.0, 0.5):
        g = _grads(rng, p0, size)
        jp, js, jm = j_adam.adam_update(j_cfg, jp, tree_map(jnp.asarray, g),
                                        js)
        out, ts, tm = adam.adam_update(cfg, tp, _tensors(g), ts)
        assert out is tp                     # updated in place
        for name in ("grad_norm", "lr"):
            np.testing.assert_allclose(tm[name].item(), float(jm[name]),
                                       rtol=ADAM_RTOL, err_msg=name)
        assert int(ts["step"]) == int(js["step"])
        for label, got, want in (("params", tp, jp), ("m", ts["m"], js["m"]),
                                 ("v", ts["v"], js["v"])):
            want = dict(tree_items(jax.tree.map(np.asarray, want)))
            for path, a in tree_items(got):
                assert _rel(a.numpy(), want[path]) <= ADAM_RTOL, (label,
                                                                  path)
    # Decoupled weight decay: the stacked scale (zero gradient) shrank.
    scale = tp["groups"]["g0"]["norm1"]["scale"].numpy()
    assert np.all(np.abs(scale) < np.abs(p0["groups"]["g0"]["norm1"]
                                         ["scale"]))


def test_weight_decay_reaches_matrices_only():
    """With zero gradients the update is the decay alone: every leaf with
    ndim >= 2 (a stacked norm scale too) scales by 1 - lr wd, a vector
    stays, in both packages."""
    rng = np.random.default_rng(1)
    p0 = _params(rng)
    zero = tree_map(np.zeros_like, p0)
    cfg = adam.AdamConfig(lr=1e-2, warmup_steps=1)
    tp = _tensors(p0)
    adam.adam_update(cfg, tp, _tensors(zero), adam.init_opt_state(tp))
    jp, _, _ = j_adam.adam_update(
        j_adam.AdamConfig(lr=1e-2, warmup_steps=1), tree_map(jnp.asarray, p0),
        tree_map(jnp.asarray, zero),
        j_adam.init_opt_state(tree_map(jnp.asarray, p0)))
    want = dict(tree_items(jax.tree.map(np.asarray, jp)))
    for path, a in tree_items(tp):
        p = dict(tree_items(p0))[path]
        expect = p if p.ndim < 2 else p * np.float32(1 - 1e-2 * 0.1)
        np.testing.assert_allclose(a.numpy(), expect, rtol=1e-6,
                                   err_msg=str(path))
        np.testing.assert_allclose(a.numpy(), want[path], rtol=1e-6,
                                   err_msg=str(path))


def test_compress_with_feedback_matches_jax():
    """The int8 values, the wire-equivalent gradients and the residuals,
    bitwise, over 3 rounds of error feedback, with ties at .5 (round half
    to even in both)."""
    rng = np.random.default_rng(2)
    grads = {"w": rng.standard_normal((16, 8)).astype(np.float32),
             "ties": np.array([127.0, 0.5, 1.5, 2.5, -0.5, -1.5, 0.0],
                              np.float32),
             "tiny": np.full(3, 1e-20, np.float32)}
    for name, g in grads.items():
        q, s = comp.quantize_int8(torch.from_numpy(g))
        jq, js = j_comp.quantize_int8(jnp.asarray(g))
        assert q.dtype == torch.int8
        np.testing.assert_array_equal(q.numpy(), np.asarray(jq), name)
        assert s.item() == float(js)
    np.testing.assert_array_equal(
        comp.quantize_int8(torch.from_numpy(grads["ties"]))[0].numpy(),
        [127, 0, 2, 2, 0, -2, 0])
    err, j_err = comp.init_error_state(_tensors(grads)), \
        j_comp.init_error_state(tree_map(jnp.asarray, grads))
    for _ in range(3):
        out, err = comp.compress_with_feedback(_tensors(grads), err)
        j_out, j_err = j_comp.compress_with_feedback(
            tree_map(jnp.asarray, grads), j_err)
        for name in grads:
            np.testing.assert_array_equal(out[name].numpy(),
                                          np.asarray(j_out[name]), name)
            np.testing.assert_array_equal(err[name].numpy(),
                                          np.asarray(j_err[name]), name)
    assert comp.wire_bytes(_tensors(grads), True) == \
        j_comp.wire_bytes(tree_map(jnp.asarray, grads), True)


def test_compression_error_feedback():
    """The JAX package's own error-feedback test, mirrored: 8 compressed
    rounds sum to within 2% of the true sum; int8 is 4x fewer bytes."""
    rng = np.random.default_rng(0)
    g = {"w": torch.from_numpy(rng.standard_normal((64, 64))
                               .astype(np.float32))}
    err = comp.init_error_state(g)
    tot_c = torch.zeros_like(g["w"])
    tot = torch.zeros_like(g["w"])
    for _ in range(8):
        gc, err = comp.compress_with_feedback(g, err)
        tot_c = tot_c + gc["w"]
        tot = tot + g["w"]
    rel = float(torch.linalg.norm(tot_c - tot) / torch.linalg.norm(tot))
    assert rel < 0.02
    assert comp.wire_bytes(g, True) * 4 == comp.wire_bytes(g, False)


@functools.cache
def _j_train(arch, n_steps=3):
    """The JAX package's state and ``n_steps`` jitted train steps on its
    stream's ``host_batch`` tokens: (initial params, batches, losses, grad
    norms)."""
    cfg = j_all_configs()[arch].reduced()
    state, _ = j_steps.init_train_state(cfg, jax.random.PRNGKey(0))
    params0 = jax.tree.map(np.asarray, state["params"])
    step = jax.jit(j_steps.make_train_step(cfg, j_adam.AdamConfig(
        warmup_steps=2)))
    stream = JTokenStream(cfg.vocab_size, 24, 2, seed=0)
    batches, losses, norms = [], [], []
    for i in range(n_steps):
        batches.append(stream.host_batch(i))
        state, m = step(state, {k: jnp.asarray(v)
                                for k, v in batches[-1].items()})
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    return params0, batches, losses, norms


@pytest.mark.parametrize("arch", DENSE)
def test_train_steps_match_jax(arch):
    """3 ``make_train_step`` steps from the JAX package's initial state on
    its token stream: every step's loss and grad norm within 1e-4."""
    params0, batches, losses, norms = _j_train(arch)
    cfg = get_config(arch).reduced()
    params = lm_params_from_numpy(cfg, params0, device="cpu")
    state = {"params": params, "opt": adam.init_opt_state(params)}
    step = steps.make_train_step(cfg, adam.AdamConfig(warmup_steps=2))
    for i, batch in enumerate(batches):
        state, m = step(state, {k: torch.from_numpy(np.array(v))
                                for k, v in batch.items()})
        assert set(m) == {"loss", "load_balance", "router_z", "grad_norm",
                          "lr"}
        np.testing.assert_allclose(m["loss"].item(), losses[i],
                                   rtol=STEP_TOL, err_msg=f"step {i}")
        np.testing.assert_allclose(m["grad_norm"].item(), norms[i],
                                   rtol=STEP_TOL, err_msg=f"step {i}")
    assert int(state["opt"]["step"]) == len(batches)
