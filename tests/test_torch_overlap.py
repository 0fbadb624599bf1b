"""The port's overlapped reduce (``partial_stats_chunked(block_reduce_fn=)``,
``DistributedGP(reduce_mode="overlap"|"overlap_eager")``) against the JAX
package's, case for case with ``tests/test_overlap_reduce.py``.

  * An identity hook folds the same per-block values in the same order as
    the plain fold, so it is BITWISE the plain fold, buffered or eager,
    with the padded last block and under an SVI subset; and within f64
    rounding (1e-12) of JAX's hook on the same inputs.
  * In a world of one (a gloo group of one rank in this process) the
    all_reduce is the identity, so ``overlap`` and ``overlap_eager`` are
    bitwise ``serial``, value and gradients, for the regression and latent
    maps, SVI with rescale, and an explicit ``reg_stats_fn`` hook (the
    reference's Pallas case); and within value 1e-9 and gradients rtol
    1e-8 / atol 1e-10 of JAX's one-device overlapped engine, the world-of-
    one tolerances of ``tests/test_torch_distributed.py``.
  * A step issues one all_reduce a block, plus the gradient's: counted by
    wrapping ``torch.distributed.all_reduce``, which the serial reduce
    calls too (twice a step).

The 4-rank cases ride in ``tests/test_torch_distributed.py``'s spawn.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.core.distributed import DistributedGP as JDistributedGP
from repro.core.stats import Stats as JStats
from repro.core.stats import partial_stats_chunked as j_chunked
from repro.launch.mesh import make_compat_mesh
from repro_torch.core.distributed import DistributedGP
from repro_torch.core.stats import Stats, partial_stats_chunked

from conftest import make_regression

MODES = ("serial", "overlap", "overlap_eager")


def _mk_hyp(q):
    return {"log_sf2": 0.2, "log_ell": np.full((q,), 0.1), "log_beta": 1.0}


def _t(hyp):
    return {k: torch.as_tensor(np.asarray(v, np.float64))
            for k, v in hyp.items()}


def _j(hyp):
    return {k: jnp.asarray(np.asarray(v, np.float64)) for k, v in hyp.items()}


def _assert_stats_bitwise(a, b):
    for name, x, y in zip(a._fields, a, b):
        assert torch.equal(x, y), name


def _assert_stats_close_to_jax(a, b):
    for name, x, y in zip(a._fields, a, b):
        np.testing.assert_allclose(x.numpy(), np.asarray(y), rtol=1e-12,
                                   atol=1e-12, err_msg=name)


def _leaves(grads):
    """The gradients' leaves in ``jax.tree.leaves`` order."""
    out = []
    for g in grads:
        out += [g[k] for k in sorted(g)] if isinstance(g, dict) else [g]
    return out


@pytest.fixture(scope="module")
def group():
    """A gloo world of one in this process, for the module."""
    from repro_torch.launch import make_data_group

    assert not dist.is_initialized()
    g = make_data_group("cpu")
    try:
        yield g
    finally:
        dist.destroy_process_group()


# -- the hook ------------------------------------------------------------------

@pytest.mark.parametrize("latent", [False, True])
@pytest.mark.parametrize("buffered", [True, False])
def test_identity_reduce_bitwise_equals_plain_scan(rng, latent, buffered):
    n, m, q, d, block = 53, 6, 2, 3, 8          # nb = 7, last block padded
    x = rng.standard_normal((n, q))
    y = rng.standard_normal((n, d))
    z = rng.standard_normal((m, q))
    s = rng.uniform(0.05, 0.6, (n, q)) if latent else None
    hyp = _mk_hyp(q)
    ts = None if s is None else torch.from_numpy(s)

    plain = partial_stats_chunked(_t(hyp), torch.from_numpy(z),
                                  torch.from_numpy(y), torch.from_numpy(x),
                                  ts, latent=latent, block_size=block,
                                  force_scan=True)
    ov = partial_stats_chunked(_t(hyp), torch.from_numpy(z),
                               torch.from_numpy(y), torch.from_numpy(x), ts,
                               latent=latent, block_size=block,
                               block_reduce_fn=lambda st: st,
                               reduce_buffered=buffered)
    _assert_stats_bitwise(plain, ov)
    want = j_chunked(_j(hyp), jnp.asarray(z), jnp.asarray(y), jnp.asarray(x),
                     s=None if s is None else jnp.asarray(s), latent=latent,
                     block_size=block, block_reduce_fn=lambda st: st,
                     reduce_buffered=buffered)
    _assert_stats_close_to_jax(ov, want)


def test_identity_reduce_bitwise_with_svi_subset(rng):
    n, m, q, block, B = 41, 5, 2, 8, 3          # nb = 6
    x = rng.standard_normal((n, q))
    y = rng.standard_normal((n, 2))
    z = rng.standard_normal((m, q))
    hyp = _mk_hyp(q)
    sub = [0, 4, 2]
    args = (_t(hyp), torch.from_numpy(z), torch.from_numpy(y),
            torch.from_numpy(x))

    plain = partial_stats_chunked(*args, block_size=block, batch_blocks=B,
                                  block_indices=sub, force_scan=True)
    ov = partial_stats_chunked(*args, block_size=block, batch_blocks=B,
                               block_indices=sub,
                               block_reduce_fn=lambda st: st)
    _assert_stats_bitwise(plain, ov)
    want = j_chunked(_j(hyp), jnp.asarray(z), jnp.asarray(y), jnp.asarray(x),
                     s=None, latent=False, block_size=block, batch_blocks=B,
                     block_indices=jnp.asarray(sub),
                     block_reduce_fn=lambda st: st)
    _assert_stats_close_to_jax(ov, want)


def test_partial_stats_chunked_overlap_validation(rng):
    """The same ValueErrors as JAX's, in the same order."""
    y = rng.standard_normal((20, 1))
    x = rng.standard_normal((20, 2))
    z = rng.standard_normal((4, 2))
    hyp = _mk_hyp(2)
    ident = lambda st: st   # noqa: E731
    for chunked, h, conv, stats_cls in (
            (j_chunked, _j(hyp), jnp.asarray, JStats),
            (partial_stats_chunked, _t(hyp), torch.from_numpy, Stats)):
        args = (h, conv(z), conv(y), conv(x))
        with pytest.raises(ValueError, match="requires block_size"):
            chunked(*args, s=None, latent=False, block_size=None,
                    block_reduce_fn=ident)
        init = chunked(*args, s=None, latent=False, block_size=4)
        with pytest.raises(ValueError, match="init cannot be combined"):
            chunked(*args, s=None, latent=False, block_size=4,
                    block_reduce_fn=ident, init=stats_cls(*init))
        # batch_blocks' own checks come first, as in the reference
        with pytest.raises(ValueError, match="batch_blocks must be"):
            chunked(*args, s=None, latent=False, block_size=4,
                    batch_blocks=0, block_reduce_fn=ident, init=init)


def test_engine_reduce_mode_validation():
    mesh = make_compat_mesh((1,), ("data",))
    for make in (lambda **kw: JDistributedGP(mesh, **kw),
                 lambda **kw: DistributedGP(device="cpu", **kw)):
        with pytest.raises(ValueError, match="reduce_mode must be"):
            make(chunk_size=4, reduce_mode="async")
        with pytest.raises(ValueError, match="requires chunk_size"):
            make(reduce_mode="overlap")
    for mode in MODES:   # every valid mode builds
        assert DistributedGP(device="cpu", chunk_size=4,
                             reduce_mode=mode).reduce_mode == mode


# -- a world of one --------------------------------------------------------------

def _problem(rng, latent, n=37, m=5, q=2, d=2):
    x = rng.standard_normal((n, q))
    y = rng.standard_normal((n, d))
    z = rng.standard_normal((m, q))
    s = rng.uniform(0.05, 0.6, (n, q)) if latent else None
    return x, y, z, s


def _port_step(group, mode, latent, x, y, z, s, d, block, **kw):
    eng = DistributedGP(group, latent=latent, chunk_size=block,
                        reduce_mode=mode, device="cpu", **kw)
    data, w = eng.put_data(**(dict(y=y, mu=x, s=s) if latent
                              else dict(y=y, mu=x)))
    argnums = (0, 1, 2, 3) if latent else (0, 1)
    step = eng.make_value_and_grad(d, argnums=argnums)
    return lambda *extra: step(_t(_mk_hyp(x.shape[1])), torch.from_numpy(z),
                               data["mu"], data.get("s"), data["y"], w,
                               np.ones(1), float(x.shape[0]), *extra)


@pytest.fixture(scope="module")
def jax_overlap():
    """JAX's one-device overlapped engine on both maps: (value, grads)."""
    rng = np.random.default_rng(5)
    mesh = make_compat_mesh((1,), ("data",))
    out = {}
    for latent in (False, True):
        x, y, z, s = _problem(rng, latent)
        eng = JDistributedGP(mesh, latent=latent, chunk_size=8,
                             reduce_mode="overlap")
        data, w = eng.put_data(**(dict(y=y, mu=x, s=s) if latent
                                  else dict(y=y, mu=x)))
        argnums = (0, 1, 2, 3) if latent else (0, 1)
        v, g = eng.make_value_and_grad(2, argnums=argnums)(
            _j(_mk_hyp(2)), jnp.asarray(z), data["mu"], data.get("s"),
            data["y"], w, jnp.ones((1,)), jnp.asarray(float(x.shape[0])))
        out[latent] = ((x, y, z, s), float(v),
                       [np.asarray(t) for t in jax.tree.leaves(g)])
    return out


@pytest.mark.parametrize("latent", [False, True])
def test_one_device_overlap_bitwise_equals_serial(group, rng, latent):
    x, y, z, s = _problem(rng, latent)
    out = {mode: _port_step(group, mode, latent, x, y, z, s, 2, 8)()
           for mode in MODES}
    v0, g0 = out["serial"]
    for mode in ("overlap", "overlap_eager"):
        v, g = out[mode]
        assert torch.equal(v, v0), mode
        for a, b in zip(_leaves(g0), _leaves(g)):
            assert torch.equal(a, b), mode


@pytest.mark.parametrize("latent", [False, True])
def test_one_device_overlap_matches_jax(group, jax_overlap, latent):
    (x, y, z, s), v_ref, g_ref = jax_overlap[latent]
    for mode in ("overlap", "overlap_eager"):
        v, g = _port_step(group, mode, latent, x, y, z, s, 2, 8)()
        assert abs(float(v) - v_ref) <= 1e-9 * abs(v_ref)
        got = _leaves(g)
        assert len(got) == len(g_ref)
        for a, b in zip(got, g_ref):
            np.testing.assert_allclose(a.numpy(), b, rtol=1e-8, atol=1e-10)


def test_one_device_overlap_bitwise_svi_and_rescale(group, rng):
    n, m, q, d, block = 40, 4, 2, 1, 8
    x, y = make_regression(rng, n=n, q=q, d=d)
    z = rng.standard_normal((m, q))
    vals = {}
    for mode in MODES:
        step = _port_step(group, mode, False, x, y, z, None, d, block,
                          batch_blocks=2, failure_mode="rescale")
        vals[mode] = step(torch.Generator().manual_seed(3))
    v0, (gh0, gz0) = vals["serial"]
    for mode in ("overlap", "overlap_eager"):
        v, (gh, gz) = vals[mode]
        assert torch.equal(v, v0) and torch.equal(gz, gz0), mode
        for k in gh0:
            assert torch.equal(gh[k], gh0[k]), (mode, k)


def test_one_device_overlap_with_a_reg_stats_hook(group, rng):
    """An explicit ``reg_stats_fn`` (the reference's Pallas-backend case:
    a per-block hook feeding the in-map collective) keeps the bits."""
    from repro_torch.core.stats import reg_stats_dense

    n, m, q, d, block = 33, 6, 2, 1, 8
    x, y = make_regression(rng, n=n, q=q, d=d)
    z = rng.standard_normal((m, q))
    out = {mode: _port_step(group, mode, False, x, y, z, None, d, block,
                            reg_stats_fn=reg_stats_dense)()
           for mode in ("serial", "overlap")}
    assert torch.equal(out["overlap"][0], out["serial"][0])
    for a, b in zip(_leaves(out["serial"][1]), _leaves(out["overlap"][1])):
        assert torch.equal(a, b)


@pytest.mark.parametrize("mode, svi", [
    ("serial", False), ("overlap", False), ("overlap_eager", False),
    ("overlap", True)])
def test_a_step_reduces_once_a_block(group, rng, monkeypatch, mode, svi):
    """37 rows in blocks of 8 are 5 blocks: the overlapped step issues 5
    block reduces and the gradient's one; the serial step its one reduce
    and the gradient's.  Under SVI (2 blocks, rescale) the deterministic
    live count takes one scalar reduce of its own; the bound alone has no
    gradient's reduce."""
    calls = []
    real = dist.all_reduce

    def counted(t, *args, **kwargs):
        calls.append(t.numel())
        return real(t, *args, **kwargs)
    monkeypatch.setattr(dist, "all_reduce", counted)
    x, y, z, _ = _problem(rng, False)
    kw = dict(batch_blocks=2, failure_mode="rescale") if svi else {}
    step = _port_step(group, mode, False, x, y, z, None, 2, 8, **kw)
    step(*([torch.Generator().manual_seed(1)] if svi else []))
    blocks = 2 if svi else 5
    stats_numel = 5 * 5 + 5 * 2 + 4            # m², m·d, A, B, KL, n
    grad_numel = 1 + 2 + 1 + 5 * 2             # log_sf2, log_ell, log_beta, z
    if mode == "serial":
        assert calls == [stats_numel + svi, grad_numel]
    else:
        assert calls == ([stats_numel] * blocks + [1] * svi + [grad_numel])
    calls.clear()
    eng = DistributedGP(group, chunk_size=8, reduce_mode=mode, device="cpu")
    data, w = eng.put_data(y=y, mu=x)
    eng.bound_fn(2)(_t(_mk_hyp(2)), torch.from_numpy(z), data["y"],
                    data["mu"], None, w, np.ones(1), float(x.shape[0]))
    assert len(calls) == (1 if mode == "serial" else 5)
