"""Posterior sampling in the port (``serve.posterior.sample_block`` /
``sample_joint``, ``PredictEngine.sample`` / ``sample_stream``,
``SGPR.sample``) against the JAX package.

torch's and ``jax.random``'s generators differ, so the draws themselves
are held against the reference by feeding both packages the same standard
normals: JAX's ``sample_block`` draws ``jax.random.normal(key, ...)``, and
the port's ``_sample_from_normals`` takes exactly those normals (rtol 1e-9,
atol 1e-10); the JAX engine's block draws (``fold_in(key, i)``) go through
the port's body block by block.  The JAX references are computed once per
module.  The statistical cases of ``tests/test_serving_sampling.py`` then
run on the port's own generator, at the same Monte-Carlo bounds (5 standard
errors for means, 6 for covariances), and its structural contracts: the
same key gives the same samples, pad rows never leak, blocks are
independent, a sharded or streamed call gives the one-shot bits.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch as rt
from repro.core.stats import partial_stats as j_partial_stats
from repro.serve import PredictEngine as JEngine
from repro.serve import extract_state as j_extract
from repro.serve import posterior as j_post
from repro_torch import convert
from repro_torch.core.stats import partial_stats
from repro_torch.serve import posterior
from repro_torch.serve.posterior import _ARRAY_FIELDS

from conftest import make_regression

CPU = "cpu"
S = 4000   # draws per statistical test; SE bounds below scale as 1/sqrt(S)
RTOL, ATOL = 1e-9, 1e-10


def _hyp(rng, q):
    return {"log_sf2": np.float64(rng.uniform(-0.5, 0.8)),
            "log_ell": rng.uniform(-0.4, 0.4, q),
            "log_beta": np.float64(1.2)}


def _inputs(rng, n=90, m=13, q=2, d=3):
    return (_hyp(rng, q), rng.standard_normal((n, q)),
            rng.standard_normal((n, d)), rng.standard_normal((m, q)))


def _state(rng, **kw):
    """The port's state of the reference tests' random problem."""
    hyp, x, y, z = _inputs(rng, **kw)
    th = {k: torch.as_tensor(v) for k, v in hyp.items()}
    z = torch.from_numpy(z)
    return rt.extract_state(th, z, partial_stats(th, z, torch.from_numpy(y),
                                                 torch.from_numpy(x)),
                            device=CPU)


# -- against the JAX package, the same normals -------------------------------------

@pytest.fixture(scope="module")
def ref():
    """One JAX state, its leaves carried into the port, and JAX's draws:
    ``sample_block`` on a block (noise-free and noisy), on an f32 state,
    and ``PredictEngine.sample`` over 11 queries in blocks of 4, with the
    normals each consumed."""
    rng = np.random.default_rng(0)
    hyp, x, y, z = _inputs(rng)
    jh = {k: jnp.array(v) for k, v in hyp.items()}
    js = j_extract(jh, jnp.array(z), j_partial_stats(
        jh, jnp.array(z), jnp.array(y), jnp.array(x), s=None,
        latent=False))
    leaves = {"hyp": {k: np.array(v) for k, v in js.hyp.items()},
              **{f: np.array(getattr(js, f)) for f in _ARRAY_FIELDS}}
    xb = rng.standard_normal((8, 2))
    xs = rng.standard_normal((11, 2))
    out = {"leaves": leaves, "xb": xb, "xs": xs}
    key = jax.random.PRNGKey(1)
    out["eps"] = np.array(jax.random.normal(key, (5, 8, 3),
                                            dtype=jnp.float64))
    for noise in (False, True):
        out[f"block/{noise}"] = np.array(j_post.sample_block(
            js, jnp.array(xb), key, 5, include_noise=noise))
    out["block/f32"] = np.array(j_post.sample_block(
        js.astype(jnp.float32), jnp.array(xb, jnp.float32), key, 5))
    out["joint"] = np.array(j_post.sample_joint(js, jnp.array(xs), key, 5))
    out["eps_joint"] = np.array(jax.random.normal(key, (5, 11, 3),
                                                  dtype=jnp.float64))
    out["engine"] = np.array(JEngine(js, block_size=4).sample(
        jnp.array(xs), 6, key))
    out["engine_eps"] = [np.array(jax.random.normal(
        jax.random.fold_in(key, i), (6, 4, 3), dtype=jnp.float64))
        for i in range(3)]
    return out


def _port(ref):
    return convert.state_from_numpy(ref["leaves"], CPU)


@pytest.mark.parametrize("noise", [False, True])
def test_sample_body_matches_jax_on_its_normals(ref, noise):
    got = posterior._sample_from_normals(
        _port(ref), torch.from_numpy(ref["xb"]), torch.from_numpy(ref["eps"]),
        include_noise=noise)
    assert got.shape == (5, 8, 3) and got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), ref[f"block/{noise}"], rtol=RTOL,
                               atol=ATOL)


def test_f32_state_samples_in_f64_and_casts_back_as_jax_does(ref):
    """An f32 state's moments and factor are computed in f64, the draws
    cast to f32: JAX's draws to f32 rounding."""
    state = _port(ref).astype(torch.float32)
    got = posterior._sample_from_normals(
        state, torch.from_numpy(ref["xb"]).float(),
        torch.from_numpy(ref["eps"]))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref["block/f32"], rtol=1e-6,
                               atol=1e-6)


def test_joint_and_engine_blocks_match_jax_on_its_normals(ref):
    """``sample_joint``'s one piece, and the engine's padded blocks (11
    queries in blocks of 4: the last block holds one pad row), each through
    the port's body on the normals JAX's block i consumed."""
    state, xs = _port(ref), torch.from_numpy(ref["xs"])
    joint = posterior._sample_from_normals(state, xs,
                                           torch.from_numpy(ref["eps_joint"]))
    np.testing.assert_allclose(joint.numpy(), ref["joint"], rtol=RTOL,
                               atol=ATOL)
    eng = rt.PredictEngine(state, block_size=4, device=CPU)
    xq, t = eng._pad_blocks(xs)
    assert (xq.shape[0], t) == (12, 11)
    blocks = [posterior._sample_from_normals(state, xq[4 * i:4 * i + 4],
                                             torch.from_numpy(e))
              for i, e in enumerate(ref["engine_eps"])]
    got = torch.cat(blocks, 1)[:, :t]
    np.testing.assert_allclose(got.numpy(), ref["engine"], rtol=RTOL,
                               atol=ATOL)


def test_sample_block_draws_its_normals_from_the_key(ref):
    """``sample_block`` is ``_sample_from_normals`` on ``torch.randn`` of
    its generator: an integer key and a generator seeded with it agree."""
    state, xb = _port(ref), torch.from_numpy(ref["xb"])
    eps = torch.randn((5, 8, 3), generator=torch.Generator().manual_seed(3),
                      dtype=torch.float64)
    want = posterior._sample_from_normals(state, xb, eps)
    assert torch.equal(posterior.sample_block(state, xb, 3, 5), want)
    assert torch.equal(posterior.sample_block(
        state, xb, torch.Generator().manual_seed(3), 5), want)


# -- the reference's statistical and structural cases, on the port ----------------

def test_sample_moments_match_full_cov(rng):
    """Empirical mean within 5 SE and covariance within 6 SE of the
    analytic joint posterior, per output dim (one jointly sampled block)."""
    eng = rt.PredictEngine(_state(rng), block_size=8, device=CPU)
    xs = rng.standard_normal((8, 2))
    mean, cov = (a.numpy() for a in eng.predict_full_cov(xs))
    smp = eng.sample(xs, S, 1).numpy()                     # (S, 8, 3)
    sd = np.sqrt(np.diag(cov))
    assert (np.abs(smp.mean(0) - mean)
            <= 5.0 * sd[:, None] / np.sqrt(S) + 1e-12).all()
    se_cov = np.sqrt((np.outer(sd**2, sd**2) + cov**2) / S)
    for j in range(smp.shape[2]):
        r = smp[:, :, j] - mean[None, :, j]
        assert (np.abs(r.T @ r / S - cov) <= 6.0 * se_cov + 1e-12).all()


def test_same_key_deterministic(rng):
    eng = rt.PredictEngine(_state(rng), block_size=8, device=CPU)
    xs = rng.standard_normal((11, 2))
    a = eng.sample(xs, 16, 3)
    assert a.shape == (16, 11, 3)
    assert torch.equal(a, eng.sample(xs, 16, 3))
    # a generator is a key too: one integer is drawn from it
    g1, g2 = (torch.Generator().manual_seed(9) for _ in range(2))
    assert torch.equal(eng.sample(xs, 4, g1), eng.sample(xs, 4, g2))


def test_distinct_keys_independent(rng):
    """Different keys give different draws, uncorrelated: the cross-moment
    E[r1 r2] has SE c_ii / sqrt(S)."""
    eng = rt.PredictEngine(_state(rng), block_size=8, device=CPU)
    xs = rng.standard_normal((8, 2))
    mean, cov = (a.numpy() for a in eng.predict_full_cov(xs))
    s1, s2 = eng.sample(xs, S, 10).numpy(), eng.sample(xs, S, 11).numpy()
    assert not np.array_equal(s1, s2)
    c_diag = np.diag(cov)
    for j in range(s1.shape[2]):
        cross = np.mean((s1[:, :, j] - mean[None, :, j])
                        * (s2[:, :, j] - mean[None, :, j]), axis=0)
        assert (np.abs(cross) <= 5.0 * c_diag / np.sqrt(S) + 1e-12).all()


def test_pad_rows_never_leak(rng):
    """The factor is lower-triangular: a padded block's leading rows are
    bitwise an unpadded call's with the same key."""
    eng = rt.PredictEngine(_state(rng), block_size=8, device=CPU)
    xs = rng.standard_normal((8, 2))
    full = eng.sample(xs, 32, 7)                 # no padding
    short = eng.sample(xs[:5], 32, 7)            # 5 -> 8 padded
    assert short.shape == (32, 5, 3)
    assert torch.equal(short, full[:, :5])


def test_odd_t_multi_block_moments(rng):
    """Several blocks and a padded tail: per-row means and variances still
    converge to the diagonal posterior."""
    eng = rt.PredictEngine(_state(rng), block_size=4, device=CPU)
    xs = rng.standard_normal((11, 2))            # 11 -> 12 padded
    mean, var = (a.numpy() for a in eng.predict(xs))
    smp = eng.sample(xs, S, 2).numpy()
    assert smp.shape == (S, 11, 3)
    sd = np.sqrt(var)
    assert (np.abs(smp.mean(0) - mean)
            <= 5.0 * sd[:, None] / np.sqrt(S) + 1e-12).all()
    se_var = np.sqrt(2.0 / S) * var
    assert (np.abs(smp.var(axis=0) - var[:, None])
            <= 6.0 * se_var[:, None] + 1e-12).all()


def test_cross_block_independence(rng):
    """Blocks are drawn independently: rows of block 0 and block 1 are
    uncorrelated to within SE."""
    eng = rt.PredictEngine(_state(rng), block_size=4, device=CPU)
    xs = rng.standard_normal((8, 2))             # exactly 2 blocks
    mean, var = (a.numpy() for a in eng.predict(xs))
    smp = eng.sample(xs, S, 4).numpy()
    r, sd = smp[:, :, 0] - mean[None, :, 0], np.sqrt(var)
    for i in range(4):
        for j in range(4, 8):
            assert abs(np.mean(r[:, i] * r[:, j])) \
                <= 5.0 * sd[i] * sd[j] / np.sqrt(S) + 1e-12


def test_include_noise_inflates_variance(rng):
    """``include_noise`` draws observations: per-row variance var + 1/beta
    within SE."""
    eng = rt.PredictEngine(_state(rng), block_size=8, device=CPU)
    xs = rng.standard_normal((8, 2))
    v = eng.predict(xs, include_noise=True)[1].numpy()
    smp = eng.sample(xs, S, 6, include_noise=True).numpy()
    se_var = np.sqrt(2.0 / S) * v
    assert (np.abs(smp.var(axis=0) - v[:, None])
            <= 6.0 * se_var[:, None] + 1e-12).all()


def test_sample_joint_is_one_piece(rng):
    """``sample_joint``: the exact joint over all queries, deterministic per
    key, mean within SE."""
    state = _state(rng)
    xs = rng.standard_normal((9, 2))
    a = posterior.sample_joint(state, xs, 0, S)
    b = posterior.sample_joint(state, xs, 0, 4)
    assert a.shape == (S, 9, 3) and b.shape == (4, 9, 3)
    assert torch.equal(posterior.sample_joint(state, xs, 0, 4), b)
    mean, cov = (t.numpy() for t in rt.PredictEngine(
        state, block_size=16, device=CPU).predict_full_cov(xs))
    sd = np.sqrt(np.diag(cov))
    assert (np.abs(a.numpy().mean(0) - mean)
            <= 5.0 * sd[:, None] / np.sqrt(S) + 1e-12).all()


def test_sample_rejects_bad_args(rng):
    state = _state(rng)
    xs = rng.standard_normal((4, 2))
    with pytest.raises(ValueError, match="num_samples"):
        rt.PredictEngine(state, block_size=8, device=CPU).sample(xs, 0, 0)
    lossy = rt.PredictEngine(state.astype(torch.bfloat16), block_size=8,
                             compute_dtype=torch.bfloat16, device=CPU)
    with pytest.raises(ValueError, match="Cholesky"):
        lossy.sample(xs, 2, 0)
    quant = rt.PredictEngine(state.astype(torch.bfloat16), block_size=8,
                             device=CPU)
    with pytest.raises(ValueError, match="storage"):
        quant.sample(xs, 2, 0)
    with pytest.raises(ValueError, match="storage"):
        next(quant.sample_stream(iter([xs]), 2, 0))
    with pytest.raises(ValueError, match="f32/f64"):
        posterior.sample_joint(state.astype(torch.bfloat16), xs, 0, 2)


def test_sgpr_sample_wrapper(rng):
    """``SGPR.sample``: numpy draws of the right shape, deterministic per
    seed (or generator), the sample mean within SE of ``predict``."""
    x, y = make_regression(rng, n=60, q=2, d=2)
    model = rt.SGPR(x, y, num_inducing=8, seed=0, device=CPU)
    xs = x[:9]
    smp = model.sample(xs, 800, seed=1)
    assert isinstance(smp, np.ndarray)
    assert smp.shape == (800, 9, 2) and np.isfinite(smp).all()
    np.testing.assert_array_equal(smp, model.sample(xs, 800, seed=1))
    assert not np.array_equal(smp, model.sample(xs, 800, seed=2))
    np.testing.assert_array_equal(
        model.sample(xs, 8, generator=torch.Generator().manual_seed(4)),
        model.sample(xs, 8, generator=torch.Generator().manual_seed(4)))
    mean, var = model.predict(xs)
    se = np.sqrt(var / 800.0)
    assert (np.abs(smp.mean(0) - mean) <= 5.0 * se[:, None] + 1e-12).all()


@pytest.mark.parametrize("batches", [[32], [8, 8, 16], [16, 16]])
def test_sample_stream_over_whole_blocks_is_the_one_shot(rng, batches):
    """Streamed batches of whole blocks draw the one-shot call's bits: a
    block's normals depend on (key, global block index) alone."""
    eng = rt.PredictEngine(_state(rng), block_size=8, device=CPU)
    xs = rng.standard_normal((32, 2))
    one = eng.sample(xs, 6, 21)
    cuts = np.cumsum([0] + batches)
    got = list(eng.sample_stream([xs[a:b] for a, b in zip(cuts, cuts[1:])],
                                 6, 21))
    assert [g.shape[1] for g in got] == batches
    assert torch.equal(torch.cat(got, 1), one)
