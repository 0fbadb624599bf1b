"""The port's serving predict step against the JAX package's.

The same numpy inputs go through ``repro.kernels.predict.ops.predict_stats``
(the Pallas kernel in interpret mode, f64) and through the port's wrapper on
the CPU, where it computes the plain version: rtol 1e-12.  The CUDA kernel
is held against the plain version on the card in ``test_torch_cuda.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.predict import ops as j_p_ops
from repro_torch.kernels.predict import kernel as p_k
from repro_torch.kernels.predict import ops as p_ops
from repro_torch.kernels.predict import ref as p_ref

# (t, m, q, d, g symmetric, Pallas block_m)
SHAPES = [
    pytest.param(64, 16, 2, 1, True, 16,
                 id="64-16-2-1"),      # exact tile fit after padding
    pytest.param(100, 37, 3, 2, True, 16,
                 id="100-37-3-2"),     # nothing divides anything
    pytest.param(33, 130, 9, 5, True, 16,
                 id="33-130-9-5"),     # m > one tile, q padded
    pytest.param(100, 37, 3, 2, False, 16,
                 id="100-37-3-2-nonsymmetric-g"),  # the function of any g
    pytest.param(40, 1030, 3, 2, True, 128,
                 id="40-1030-3-2"),    # m > 768: no (t, m) slab fits a block
]


def _inputs(seed, t, m, q, d, symmetric=True):
    rng = np.random.default_rng(seed)
    hyp = {"log_sf2": np.asarray(rng.uniform(-0.5, 0.8)),
           "log_ell": rng.uniform(-0.4, 0.4, q)}
    z = rng.standard_normal((m, q))
    a_mean = rng.standard_normal((m, d))
    g = rng.standard_normal((m, m))
    if symmetric:
        g = g + g.T                               # symmetric like the real g
    x = rng.standard_normal((t, q))
    return hyp, z, a_mean, g, x


def _torch(hyp, *arrs, device="cpu", dtype=torch.float64):
    def t(a):
        return torch.from_numpy(np.array(a, dtype=np.float64)).to(device, dtype)
    return {k: t(v) for k, v in hyp.items()}, *map(t, arrs)


@pytest.mark.parametrize("t,m,q,d,symmetric,block_m", SHAPES)
def test_plain_matches_pallas_interpret(t, m, q, d, symmetric, block_m):
    hyp, z, a_mean, g, x = _inputs(t + m, t, m, q, d, symmetric)
    jh = {k: jnp.asarray(v) for k, v in hyp.items()}
    want = j_p_ops.predict_stats(jh, *map(jnp.asarray, (z, a_mean, g, x)),
                                 block_t=32, block_m=block_m)
    got = p_ops.predict_stats(*_torch(hyp, z, a_mean, g, x))
    for name, a, b in zip(("mean", "quad"), got, want):
        assert a.dtype == torch.float64
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-12,
                                   atol=1e-14, err_msg=name)


def test_sub_f32_queries_compute_in_f32():
    """The compute-dtype clamp: bf16 queries run f32 tiles and come back in
    bf16; f32 and f64 keep their width."""
    assert p_ops.tile_dtype(torch.bfloat16) == torch.float32
    assert p_ops.tile_dtype(torch.float16) == torch.float32
    assert p_ops.tile_dtype(torch.float32) == torch.float32
    assert p_ops.tile_dtype(torch.float64) == torch.float64
    hyp, z, a_mean, g, x = _inputs(5, 20, 7, 2, 2)
    th, tz, ta, tg, tx = _torch(hyp, z, a_mean, g, x, dtype=torch.bfloat16)
    mean, quad = p_ops.predict_stats(th, tz, ta, tg, tx)
    assert mean.dtype == quad.dtype == torch.bfloat16
    ref_mean, ref_quad = p_ref.predict_ref(
        *(v.float() for v in (th["log_sf2"], th["log_ell"], tz, ta, tg, tx)))
    torch.testing.assert_close(mean, ref_mean.bfloat16(), rtol=0, atol=0)
    torch.testing.assert_close(quad, ref_quad.bfloat16(), rtol=0, atol=0)


def test_cpu_path_differentiates():
    """The CPU path is the plain version, so autograd reaches the queries
    (the CUDA kernel refuses inputs that require grad, test_torch_cuda)."""
    hyp, z, a_mean, g, x = _inputs(8, 6, 5, 2, 1)
    th, tz, ta, tg, tx = _torch(hyp, z, a_mean, g, x)
    tx.requires_grad_(True)
    mean, quad = p_ops.predict_stats(th, tz, ta, tg, tx)
    (gx,) = torch.autograd.grad(mean.sum() + quad.sum(), tx)
    want = torch.func.grad(lambda xx: sum(
        o.sum() for o in p_ref.predict_ref(th["log_sf2"], th["log_ell"], tz,
                                           ta, tg, xx)))(tx.detach())
    torch.testing.assert_close(gx, want, rtol=1e-12, atol=1e-14)
    assert bool(gx.abs().sum() > 0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("m", [150, 512, 2048, 8192])
def test_shared_memory_is_fixed_and_fits(m, dtype):
    """The CUDA block's shared memory is one constant per dtype, whatever m
    and q, and fits the card's 227 KB.  f64: two 32-row chunks of a pair
    tile and the 64 x 128 slab panel, row stride 132; one 16-feature chunk
    of z, 64 x rows, 1/ell^2, the quad partials of 4 column warps.  f32:
    two 16-row chunks, the transposed 128-row panel (128 columns of stride
    132), z, 128 x rows, the scales, the quad partials of 2 column warps
    and the 256 threads' 8 row sums; two such blocks (each with the 1 KB
    the card reserves) fit an SM's 228 KB."""
    item = torch.empty((), dtype=dtype).element_size()
    if dtype == torch.float64:
        want = item * (2 * 32 * 132 + 64 * 132 + 16 * 128 + 64 * 17 + 16
                       + 256)
    else:
        want = item * (2 * 16 * 132 + 128 * 132 + 16 * 128 + 128 * 17 + 16
                       + 256 + 8 * 256)
        assert p_k.BLOCKS_PER_SM[dtype] * (want + 1024) <= 228 * 1024
    for q in (1, 8, 300, 1000):
        assert p_k.smem_bytes(m, q, dtype) == want <= p_k.SMEM_MAX
    assert p_k.pair_tiles(m) == (-(-m // 128)) * (-(-m // 128) + 1) // 2
