"""The port's LM mixers and FFNs against the JAX package's, one module at a
time, at ``reduced()`` widths on the CPU in f32: Mamba-2 SSD
(``models/ssm.py``), RG-LRU (``models/rglru.py``), MLA, cross-attention
and the rolling local-window cache (``models/attention.py``), and the MoE
router and dense experts (``models/moe.py``).

The same numpy inputs and parameters (every leaf drawn N(0, 1/fan_in),
the constant-initialised ones too, so that every term is exercised) go
through both packages.  Each forward is held with its outputs and the
gradient of a scalar of them (``jax.grad`` against autograd) in every
input and parameter, each decode step against the JAX package's step
from the same cache, and step-by-step decode against the forward.
Tolerance 1e-4 (relative and absolute): the two frameworks sum the same
f32 products in other orders.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import all_configs as j_all_configs
from repro.configs import load_all
from repro.models import attention as j_attn
from repro.models import moe as j_moe
from repro.models import rglru as j_rglru
from repro.models import ssm as j_ssm
from repro_torch.configs import get_config
from repro_torch.models import attention as attn
from repro_torch.models import common
from repro_torch.models import moe
from repro_torch.models import rglru
from repro_torch.models import ssm

TOL = dict(rtol=1e-4, atol=1e-4)
B, T = 2, 37          # T not a multiple of the SSD chunk (16) nor the window

load_all()


def _cfgs(arch):
    return j_all_configs()[arch].reduced(), get_config(arch).reduced()


def _np_params(spec, seed):
    """Every leaf of ``spec`` drawn N(0, 1/fan_in) with numpy."""
    rng = np.random.default_rng(seed)
    return common.tree_map(
        lambda leaf: (rng.standard_normal(leaf.shape)
                      * leaf.normal_std).astype(np.float32), spec)


def _both(tree):
    """(jnp tree, torch tree with grad) of a numpy tree."""
    return (jax.tree.map(jnp.asarray, tree),
            common.tree_map(lambda a: torch.from_numpy(a.copy())
                            .requires_grad_(True), tree))


def _close(got, want, msg=""):
    np.testing.assert_allclose(
        got.detach().float().numpy() if isinstance(got, torch.Tensor)
        else got, np.asarray(want, np.float32), **TOL, err_msg=msg)


def _close_tree(got, want, msg=""):
    for k in want:
        if isinstance(want[k], dict):
            _close_tree(got[k], want[k], f"{msg}/{k}")
        else:
            _close(got[k], want[k], f"{msg}/{k}")


def _x(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _check_grads(j_fn, t_fn, j_args, t_args, seed):
    """The gradient of sum(out * ct) (``out`` the function's array
    outputs, ``ct`` random) in every argument, JAX against torch."""
    j_out = jax.eval_shape(j_fn, *j_args)
    cts = [jnp.asarray(_x(seed + i, *o.shape)) for i, o in
           enumerate(jax.tree.leaves(j_out))]

    def j_scalar(*args):
        return sum(jnp.sum(o * c) for o, c in
                   zip(jax.tree.leaves(j_fn(*args)), cts))
    want = jax.jit(jax.grad(j_scalar, argnums=tuple(range(len(j_args)))))(
        *j_args)
    t_out = t_fn(*t_args)
    t_leaves = [o for o in jax.tree.leaves(
        t_out, is_leaf=lambda a: isinstance(a, torch.Tensor))]
    scalar = sum(torch.sum(o * torch.from_numpy(np.array(c)))
                 for o, c in zip(t_leaves, cts))
    flat_args = [a for a in jax.tree.leaves(
        t_args, is_leaf=lambda a: isinstance(a, torch.Tensor))]
    got = torch.autograd.grad(scalar, flat_args, allow_unused=True)
    for g, w in zip(got, jax.tree.leaves(want)):
        w = np.asarray(w)
        _close(torch.zeros(w.shape) if g is None else g, w)
    return t_out


# -- Mamba-2 SSD ----------------------------------------------------------------

def _ssd_scan_inputs(with_init):
    rng = np.random.default_rng(1)
    h, p_dim, n = 3, 4, 5
    x = rng.standard_normal((B, T, h, p_dim)).astype(np.float32)
    a = -np.log1p(np.exp(rng.standard_normal((B, T, h)))).astype(np.float32)
    b_in, c_in = (rng.standard_normal((B, T, n)).astype(np.float32)
                  for _ in range(2))
    init = (rng.standard_normal((B, h, p_dim, n)).astype(np.float32)
            if with_init else None)
    return x, a, b_in, c_in, init


@pytest.mark.parametrize("with_init", [False, True])
def test_ssd_scan_matches_jax(with_init):
    """y and the final state, T 37 in chunks of 16 (a ragged last chunk),
    from zero and from a given initial state, and their gradients in
    every input."""
    x, a, b_in, c_in, init = _ssd_scan_inputs(with_init)
    args = [x, a, b_in, c_in] + ([init] if with_init else [])

    def j_fn(*arr):
        return j_ssm.ssd_scan(*arr[:4], 16, init_state=arr[4]
                              if with_init else None)

    def t_fn(*arr):
        return ssm.ssd_scan(*arr[:4], 16, init_state=arr[4]
                            if with_init else None)
    j_args = [jnp.asarray(v) for v in args]
    t_args = [torch.from_numpy(v).requires_grad_(True) for v in args]
    y, state = _check_grads(j_fn, t_fn, j_args, t_args, seed=10)
    j_y, j_state = j_fn(*j_args)
    assert y.shape == x.shape and state.shape == (B, 3, 4, 5)
    _close(y, j_y)
    _close(state, j_state)


def test_causal_conv_and_segsum_match_jax():
    xc = _x(2, B, T, 6)
    w, b = _x(3, 6, 4), _x(4, 6)
    _close(ssm._causal_conv(*map(torch.from_numpy, (xc, w, b))),
           j_ssm._causal_conv(*map(jnp.asarray, (xc, w, b))))
    a = _x(5, 3, 9)
    got = ssm._segsum(torch.from_numpy(a)).numpy()
    want = np.asarray(j_ssm._segsum(jnp.asarray(a)))
    assert np.array_equal(np.isinf(got), np.isinf(want))
    np.testing.assert_allclose(got[np.isfinite(got)], want[np.isfinite(want)],
                               **TOL)


@pytest.fixture(scope="module")
def ssd_setup():
    j_cfg, cfg = _cfgs("mamba2-370m")
    return j_cfg, cfg, _np_params(ssm.init_ssd(cfg), 6)


@pytest.mark.parametrize("with_init", [False, True])
def test_ssd_forward_matches_jax(ssd_setup, with_init):
    """The block's output and its ``{"ssd", "conv"}`` state, and the
    gradients in x and every parameter (and the carried state)."""
    j_cfg, cfg, params = ssd_setup
    x = _x(7, B, T, cfg.d_model)
    init = {"ssd": _x(8, B, *ssm.init_ssd_cache(cfg, B, torch.float32,
                                                 "cpu")["ssd"].shape[1:])}
    jp, tp = _both(params)
    j_init, t_init = _both(init) if with_init else (None, None)

    def j_fn(p, xx, st):
        y, c = j_ssm.ssd_forward(j_cfg, p, xx, init=st)
        return y, c["ssd"]

    def t_fn(p, xx, st):
        y, c = ssm.ssd_forward(cfg, p, xx, init=st)
        return y, c["ssd"]
    _check_grads(j_fn, t_fn, [jp, jnp.asarray(x), j_init],
                 [tp, torch.from_numpy(x).requires_grad_(True), t_init],
                 seed=20)
    y, c = ssm.ssd_forward(cfg, tp, torch.from_numpy(x), init=t_init)
    j_y, j_c = j_ssm.ssd_forward(j_cfg, jp, jnp.asarray(x), init=j_init)
    _close(y, j_y)
    _close_tree(c, j_c)
    assert c["conv"].shape == (B, cfg.conv_kernel - 1,
                               ssm.dims(cfg)[0] + 2 * cfg.ssm_state_dim)


def test_ssd_decode_matches_jax_and_the_forward(ssd_setup):
    """One decode step from a random cache against the JAX package's; and
    T steps from the empty cache reproduce the forward's outputs and
    state."""
    j_cfg, cfg, params = ssd_setup
    jp, tp = _both(params)
    empty = ssm.init_ssd_cache(cfg, B, torch.float32, "cpu")
    cache = {k: _x(9 + i, *v.shape) for i, (k, v) in enumerate(empty.items())}
    x_t = _x(11, B, 1, cfg.d_model)
    with torch.no_grad():
        y, c = ssm.ssd_decode(cfg, tp, torch.from_numpy(x_t),
                              {k: torch.from_numpy(v) for k, v in cache.items()})
    j_y, j_c = j_ssm.ssd_decode(j_cfg, jp, jnp.asarray(x_t),
                                {k: jnp.asarray(v) for k, v in cache.items()})
    _close(y, j_y)
    _close_tree(c, j_c)

    x = torch.from_numpy(_x(12, B, T, cfg.d_model))
    with torch.no_grad():
        want, want_c = ssm.ssd_forward(cfg, tp, x)
        c = empty
        for i in range(T):
            y_i, c = ssm.ssd_decode(cfg, tp, x[:, i:i + 1], c)
            _close(y_i, want[:, i:i + 1].numpy(), f"step {i}")
    _close_tree(c, {k: v.numpy() for k, v in want_c.items()})


def test_ssd_decode_rounds_where_the_forward_does(ssd_setup):
    """At bf16 the port's decode step rounds where ``ssd_forward`` does, so
    T steps from the empty cache give the forward's outputs (relative RMS
    below 1e-3; the CPU gives the same bits); the JAX package's step keeps
    three of those values in f32 and leaves its own forward by more
    (ROADMAP Queue 3 item 20).  In f32 the two steps are the same function
    (``test_ssd_decode_matches_jax_and_the_forward``)."""
    j_cfg, cfg, params = ssd_setup
    x = _x(39, B, T, cfg.d_model)
    xb = torch.from_numpy(x).bfloat16()
    tp = {k: torch.from_numpy(v) for k, v in params.items()}
    with torch.no_grad():
        want, _ = ssm.ssd_forward(cfg, tp, xb)
        c = ssm.init_ssd_cache(cfg, B, torch.bfloat16, "cpu")
        got = []
        for i in range(T):
            y_i, c = ssm.ssd_decode(cfg, tp, xb[:, i:i + 1], c)
            got.append(y_i)
    got = torch.cat(got, dim=1)
    assert got.dtype == torch.bfloat16
    port = float(torch.linalg.norm(got.float() - want.float())
                 / torch.linalg.norm(want.float()))
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    xj = jnp.asarray(x, jnp.bfloat16)
    j_want, _ = jax.jit(lambda q, xx: j_ssm.ssd_forward(j_cfg, q, xx))(jp, xj)
    j_step = jax.jit(lambda q, xx, cc: j_ssm.ssd_decode(j_cfg, q, xx, cc))
    jc = {k: jnp.zeros(v.shape, jnp.float32 if k == "ssd" else jnp.bfloat16)
          for k, v in c.items()}
    j_got = []
    for i in range(T):
        y_i, jc = j_step(jp, xj[:, i:i + 1], jc)
        j_got.append(y_i)
    j_got = np.asarray(jnp.concatenate(j_got, axis=1), np.float64)
    j_want = np.asarray(j_want, np.float64)
    ref = np.linalg.norm(j_got - j_want) / np.linalg.norm(j_want)
    assert port < 1e-3 < ref, (port, ref)


# -- RG-LRU ---------------------------------------------------------------------

@pytest.fixture(scope="module")
def rglru_setup():
    j_cfg, cfg = _cfgs("recurrentgemma-9b")
    return j_cfg, cfg, _np_params(rglru.init_rglru(cfg), 13)


@pytest.mark.parametrize("with_init", [False, True])
def test_rglru_forward_matches_jax(rglru_setup, with_init):
    """The block's output and ``{"h", "conv"}`` cache, and the gradients in
    x, every parameter and the carried state."""
    j_cfg, cfg, params = rglru_setup
    x = _x(14, B, T, cfg.d_model)
    init = {"h": _x(15, B, cfg.lru_width)}
    jp, tp = _both(params)
    j_init, t_init = _both(init) if with_init else (None, None)

    def j_fn(p, xx, st):
        return j_rglru.rglru_forward(j_cfg, p, xx, init=st)

    def t_fn(p, xx, st):
        return rglru.rglru_forward(cfg, p, xx, init=st)
    _check_grads(j_fn, t_fn, [jp, jnp.asarray(x), j_init],
                 [tp, torch.from_numpy(x).requires_grad_(True), t_init],
                 seed=30)
    y, c = t_fn(tp, torch.from_numpy(x), t_init)
    j_y, j_c = j_fn(jp, jnp.asarray(x), j_init)
    _close(y, j_y)
    _close_tree(c, j_c)


@pytest.mark.parametrize("t", [1, 2, 37, 64, 300])
def test_linear_scan_matches_associative_scan(t):
    """The Hillis-Steele scan against ``jax.lax.associative_scan`` with the
    same combine and against the sequential recurrence in f64; the f32
    rounding spread of the two log-depth scans stays below 1e-5."""
    rng = np.random.default_rng(t)
    a = rng.uniform(0.0, 1.0, (B, t, 8)).astype(np.float32)
    b = rng.standard_normal((B, t, 8)).astype(np.float32)

    def combine(left, right):
        return left[0] * right[0], right[0] * left[1] + right[1]
    _, want = jax.lax.associative_scan(combine, (jnp.asarray(a),
                                                 jnp.asarray(b)), axis=1)
    got = rglru.linear_scan(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    exact = np.zeros((B, t, 8))
    h = np.zeros((B, 8))
    for i in range(t):
        h = a[:, i].astype(np.float64) * h + b[:, i]
        exact[:, i] = h
    scale = np.abs(exact).max()
    assert np.abs(got - exact).max() <= 1e-5 * scale
    assert np.abs(got - np.asarray(want)).max() <= 1e-5 * scale


def test_rglru_decode_matches_jax_and_the_forward(rglru_setup):
    j_cfg, cfg, params = rglru_setup
    jp, tp = _both(params)
    empty = rglru.init_rglru_cache(cfg, B, torch.float32, "cpu")
    cache = {k: _x(16 + i, *v.shape) for i, (k, v) in enumerate(empty.items())}
    x_t = _x(18, B, 1, cfg.d_model)
    with torch.no_grad():
        y, c = rglru.rglru_decode(
            cfg, tp, torch.from_numpy(x_t),
            {k: torch.from_numpy(v) for k, v in cache.items()})
    j_y, j_c = j_rglru.rglru_decode(
        j_cfg, jp, jnp.asarray(x_t), {k: jnp.asarray(v) for k, v in
                                      cache.items()})
    _close(y, j_y)
    _close_tree(c, j_c)

    x = torch.from_numpy(_x(19, B, T, cfg.d_model))
    with torch.no_grad():
        want, want_c = rglru.rglru_forward(cfg, tp, x)
        c = empty
        for i in range(T):
            y_i, c = rglru.rglru_decode(cfg, tp, x[:, i:i + 1], c)
            _close(y_i, want[:, i:i + 1].numpy(), f"step {i}")
    _close_tree(c, {k: v.numpy() for k, v in want_c.items()})


# -- local-window attention: the rolling decode cache --------------------------

def test_window_decode_matches_jax_and_the_forward():
    """recurrentgemma's local attention (window 8, MQA): one decode step
    into a rolling cache at a position past the window against the JAX
    package's; T steps from the empty cache (8 slots, position p at slot
    p % 8) reproduce the windowed forward."""
    j_cfg, cfg = _cfgs("recurrentgemma-9b")
    assert cfg.local_window == 8
    params = _np_params(attn.init_gqa(cfg), 20)
    jp, tp = _both(params)
    empty = attn.init_gqa_cache(cfg, B, T, torch.float32, "cpu")
    assert empty["k"].shape[1] == cfg.local_window
    pos = np.array([21, 30], np.int32)
    base = pos[:, None] - 8    # slot s: the position in [p-8, p) = s mod 8
    cache = {"k": _x(21, *empty["k"].shape), "v": _x(22, *empty["v"].shape),
             "pos": (base + (np.arange(8)[None] - base) % 8).astype(np.int32)}
    x_t = _x(23, B, 1, cfg.d_model)
    with torch.no_grad():
        y, c = attn.gqa_decode(cfg, tp, torch.from_numpy(x_t),
                               {k: torch.from_numpy(v) for k, v in
                                cache.items()}, torch.from_numpy(pos))
    j_y, j_c = j_attn.gqa_decode(j_cfg, jp, jnp.asarray(x_t),
                                 {k: jnp.asarray(v) for k, v in
                                  cache.items()}, jnp.asarray(pos))
    _close(y, j_y)
    _close_tree(c, j_c)

    x = torch.from_numpy(_x(24, B, T, cfg.d_model))
    positions = torch.arange(T, dtype=torch.int32).expand(B, T)
    with torch.no_grad():
        want = attn.gqa_forward(cfg, tp, x, positions, window=8)
        c = empty
        for i in range(T):
            y_i, c = attn.gqa_decode(cfg, tp, x[:, i:i + 1], c,
                                     torch.full((B,), i, dtype=torch.int32))
            _close(y_i, want[:, i:i + 1].numpy(), f"step {i}")
    assert (c["pos"] % 8 == torch.arange(8)).all()


# -- MLA --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def mla_setup():
    j_cfg, cfg = _cfgs("deepseek-v2-236b")
    return j_cfg, cfg, _np_params(attn.init_mla(cfg), 25)


def test_mla_forward_matches_jax(mla_setup):
    """The output (qk head dim 24, value head dim 16) and the gradients in
    x and every parameter."""
    j_cfg, cfg, params = mla_setup
    x = _x(26, B, T, cfg.d_model)
    pos = np.tile(np.arange(T, dtype=np.int32), (B, 1))
    jp, tp = _both(params)
    y = _check_grads(
        lambda p, xx: j_attn.mla_forward(j_cfg, p, xx, jnp.asarray(pos)),
        lambda p, xx: attn.mla_forward(cfg, p, xx, torch.from_numpy(pos)),
        [jp, jnp.asarray(x)], [tp, torch.from_numpy(x).requires_grad_(True)],
        seed=40)
    _close(y, j_attn.mla_forward(j_cfg, jp, jnp.asarray(x), jnp.asarray(pos)))


def test_mla_decode_matches_jax_and_the_forward(mla_setup):
    """The absorbed decode from a random compressed cache against the JAX
    package's; T steps from the empty cache reproduce the forward."""
    j_cfg, cfg, params = mla_setup
    jp, tp = _both(params)
    empty = attn.init_mla_cache(cfg, B, T, torch.float32, "cpu")
    pos = np.array([5, 20], np.int32)
    cache = {"c_kv": _x(27, *empty["c_kv"].shape),
             "k_rope": _x(28, *empty["k_rope"].shape),
             "pos": np.where(np.arange(T)[None] < pos[:, None],
                             np.arange(T)[None], -1).astype(np.int32)}
    x_t = _x(29, B, 1, cfg.d_model)
    with torch.no_grad():
        y, c = attn.mla_decode(cfg, tp, torch.from_numpy(x_t),
                               {k: torch.from_numpy(v) for k, v in
                                cache.items()}, torch.from_numpy(pos))
    j_y, j_c = j_attn.mla_decode(j_cfg, jp, jnp.asarray(x_t),
                                 {k: jnp.asarray(v) for k, v in
                                  cache.items()}, jnp.asarray(pos))
    _close(y, j_y)
    _close_tree(c, j_c)

    x = torch.from_numpy(_x(30, B, T, cfg.d_model))
    positions = torch.arange(T, dtype=torch.int32).expand(B, T)
    with torch.no_grad():
        want = attn.mla_forward(cfg, tp, x, positions)
        c = empty
        for i in range(T):
            y_i, c = attn.mla_decode(cfg, tp, x[:, i:i + 1], c,
                                     torch.full((B,), i, dtype=torch.int32))
            _close(y_i, want[:, i:i + 1].numpy(), f"step {i}")


# -- cross-attention (whisper) --------------------------------------------------

def test_cross_attention_matches_jax():
    """``encode_kv`` of a 16-frame encoder output and ``cross_forward`` of
    T decoder rows against it (not causal), with the gradients in both
    inputs and every parameter; a single-row query (decode) too."""
    j_cfg, cfg = _cfgs("whisper-medium")
    params = _np_params(attn.init_cross(cfg), 31)
    jp, tp = _both(params)
    enc = _x(32, B, cfg.num_frames, cfg.d_model)
    x = _x(33, B, T, cfg.d_model)

    def j_fn(p, xx, ee):
        return j_attn.cross_forward(j_cfg, p, xx,
                                    j_attn.encode_kv(j_cfg, p, ee))

    def t_fn(p, xx, ee):
        return attn.cross_forward(cfg, p, xx, attn.encode_kv(cfg, p, ee))
    _check_grads(j_fn, t_fn, [jp, jnp.asarray(x), jnp.asarray(enc)],
                 [tp, torch.from_numpy(x).requires_grad_(True),
                  torch.from_numpy(enc).requires_grad_(True)], seed=50)
    k, v = attn.encode_kv(cfg, tp, torch.from_numpy(enc))
    j_k, j_v = j_attn.encode_kv(j_cfg, jp, jnp.asarray(enc))
    assert k.shape == (B, cfg.num_frames, cfg.num_kv_heads,
                       attn.head_dim(cfg))
    _close(k, j_k)
    _close(v, j_v)
    for rows in (x, x[:, :1]):
        _close(t_fn(tp, torch.from_numpy(rows), torch.from_numpy(enc)),
               j_fn(jp, jnp.asarray(rows), jnp.asarray(enc)))


# -- MoE --------------------------------------------------------------------------

@pytest.fixture(scope="module", params=["qwen3-moe-235b-a22b",
                                        "deepseek-v2-236b"])
def moe_setup(request):
    j_cfg, cfg = _cfgs(request.param)
    return j_cfg, cfg, _np_params(moe.init_moe(cfg), 34)


def test_route_matches_jax(moe_setup):
    """Softmax, top-k, the renormalised gates and both aux losses, and
    the gradient of a scalar of gates and losses in x and the router."""
    j_cfg, cfg, params = moe_setup
    x = _x(35, B * T, cfg.d_model)
    router = params["router"]
    gates, eids, aux = moe._route(cfg, torch.from_numpy(router),
                                  torch.from_numpy(x))
    j_gates, j_eids, j_aux = j_moe._route(j_cfg, jnp.asarray(router),
                                          jnp.asarray(x))
    assert np.array_equal(eids.numpy(), np.asarray(j_eids))
    _close(gates, j_gates)
    _close_tree(aux, j_aux)
    np.testing.assert_allclose(gates.sum(-1).numpy(), 1.0, rtol=1e-6)

    def j_fn(r, xx):
        g, _, a = j_moe._route(j_cfg, r, xx)
        return g, a["load_balance"], a["router_z"]

    def t_fn(r, xx):
        g, _, a = moe._route(cfg, r, xx)
        return g, a["load_balance"], a["router_z"]
    _check_grads(j_fn, t_fn, [jnp.asarray(router), jnp.asarray(x)],
                 [torch.from_numpy(router).requires_grad_(True),
                  torch.from_numpy(x).requires_grad_(True)], seed=60)


def test_moe_dense_matches_jax(moe_setup):
    """The combined expert output and the aux losses, and the gradients
    in x and every parameter; ``moe_forward`` under either ``moe_impl``
    (no process group) is the dense path."""
    j_cfg, cfg, params = moe_setup
    x = _x(36, B, T, cfg.d_model)
    jp, tp = _both(params)
    y = _check_grads(
        lambda p, xx: j_moe.moe_dense(j_cfg, p, xx),
        lambda p, xx: moe.moe_dense(cfg, p, xx),
        [jp, jnp.asarray(x)], [tp, torch.from_numpy(x).requires_grad_(True)],
        seed=70)
    j_y, j_aux = j_moe.moe_dense(j_cfg, jp, jnp.asarray(x))
    _close(y[0], j_y)
    _close_tree(y[1], j_aux)
    for impl in ("dense", "sharded"):
        got, _ = moe.moe_forward(dataclasses.replace(cfg, moe_impl=impl), tp,
                                 torch.from_numpy(x))
        assert torch.equal(got, y[0])


def test_moe_dense_gate_normalisation():
    """tests/test_moe.py's property on the port: identical experts make the
    MoE output the single expert's, whatever the routing (the gates sum to
    one), and the load-balance loss is at least 1."""
    cfg = dataclasses.replace(get_config("deepseek-v2-236b").reduced(),
                              num_experts=4, experts_per_token=2, moe_d_ff=16)
    rng = np.random.default_rng(0)
    d = cfg.d_model
    p = {"router": torch.from_numpy(rng.standard_normal((d, 4))).float()}
    for name, shape in (("w_gate", (1, d, 16)), ("w_up", (1, d, 16)),
                        ("w_down", (1, 16, d))):
        p[name] = torch.from_numpy(np.tile(rng.standard_normal(shape) * 0.1,
                                           (4, 1, 1))).float()
    x = torch.from_numpy(rng.standard_normal((2, 8, d))).float()
    y, aux = moe.moe_dense(cfg, p, x)
    one = (torch.nn.functional.silu(x @ p["w_gate"][0])
           * (x @ p["w_up"][0])) @ p["w_down"][0]
    torch.testing.assert_close(y, one, rtol=1e-4, atol=1e-5)
    assert float(aux["load_balance"]) >= 1.0 - 1e-6
