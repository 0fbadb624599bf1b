"""The port's flash attention against the JAX package's.

The same numpy inputs go through ``repro.kernels.flash_attention`` (the
Pallas kernel in interpret mode, blocks of 32, and its dense oracle
``attention_ref``) and through the port's wrapper on the CPU, where it
computes the plain version.  Tolerances are the tiers of
``tests/test_kernels_pallas.py``: 2e-5 in f32 (both sides sum in f32, in
other orders) and 2e-2 in bf16 (one bf16 rounding of the output).  Rows
that see no key are compared only on the port's side, where they must be
exactly 0: the JAX oracle returns NaN there, and the Pallas kernel's
-1e30 mask makes its output on them depend on its block size (shown
below).  The CUDA kernel is held against the plain version on the card in
``test_torch_cuda.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import ops as j_fa_ops
from repro.kernels.flash_attention import ref as j_fa_ref
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention import ref as fa_ref

# The sweep of tests/test_kernels_pallas.py, plus a causal T > S case whose
# first T - S rows see no key.
SWEEP = [
    (2, 4, 2, 64, 64, 64, True, "float32"),
    (1, 8, 1, 70, 70, 64, True, "float32"),      # MQA, ragged t
    (1, 4, 4, 33, 90, 128, True, "float32"),     # t < s, suffix-aligned
    (2, 2, 2, 96, 48, 64, False, "float32"),     # non-causal, t > s
    (1, 4, 2, 64, 64, 64, True, "bfloat16"),     # bf16 path
    (1, 4, 4, 1, 57, 64, True, "float32"),       # decode-shaped (T=1)
    (1, 2, 1, 96, 48, 64, True, "float32"),      # causal t > s: empty rows
]
TOL = {"float32": 2e-5, "bfloat16": 2e-2}


def _inputs(seed, b, h, hkv, t, s, dh):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, h, t, dh)),
            rng.standard_normal((b, hkv, s, dh)),
            rng.standard_normal((b, hkv, s, dh)))


def _seen(t, s, causal):
    """Rows of a (T, S) problem that see at least one key."""
    rows = np.arange(t)
    return rows + (s - t) >= 0 if causal else np.ones(t, bool)


def _port(arrs, dtype, causal, **kw):
    dt = getattr(torch, dtype)
    q, k, v = (torch.from_numpy(a).to(dt) for a in arrs)
    return fa_ops.flash_attention(q, k, v, causal=causal, **kw)


def _jax(fn, arrs, dtype, causal, **kw):
    q, k, v = (jnp.asarray(a, getattr(jnp, dtype)) for a in arrs)
    return np.asarray(fn(q, k, v, causal=causal, **kw), np.float32)


@pytest.mark.parametrize("b,h,hkv,t,s,dh,causal,dtype", SWEEP)
def test_plain_matches_pallas_interpret(b, h, hkv, t, s, dh, causal, dtype):
    arrs = _inputs(t + s, b, h, hkv, t, s, dh)
    got = _port(arrs, dtype, causal)
    assert got.dtype == getattr(torch, dtype) and got.shape == (b, h, t, dh)
    want = _jax(j_fa_ops.flash_attention, arrs, dtype, causal,
                block_q=32, block_k=32)
    seen = _seen(t, s, causal)
    np.testing.assert_allclose(got.float().numpy()[:, :, seen],
                               want[:, :, seen], rtol=TOL[dtype],
                               atol=TOL[dtype])
    assert (got[:, :, ~seen] == 0).all()


@pytest.mark.parametrize("b,h,hkv,t,s,dh,causal,dtype", SWEEP)
def test_plain_matches_jax_oracle(b, h, hkv, t, s, dh, causal, dtype):
    arrs = _inputs(t + s + 1, b, h, hkv, t, s, dh)
    got = _port(arrs, dtype, causal)
    want = _jax(j_fa_ref.attention_ref, arrs, dtype, causal)
    seen = _seen(t, s, causal)
    np.testing.assert_allclose(got.float().numpy()[:, :, seen],
                               want[:, :, seen], rtol=TOL[dtype],
                               atol=TOL[dtype])


@pytest.mark.parametrize("chunk", [1, 7, 64])
def test_plain_chunking_changes_nothing(chunk):
    """Query-row chunks (the card check's memory cap) give the unchunked
    result: each row's softmax is computed alone either way."""
    arrs = _inputs(3, 1, 4, 2, 70, 90, 64)
    q, k, v = (torch.from_numpy(a).float() for a in arrs)
    whole = fa_ref.attention_ref(q, k, v, causal=True)
    chunked = fa_ref.attention_ref(q, k, v, causal=True, chunk=chunk)
    torch.testing.assert_close(chunked, whole, rtol=1e-6, atol=1e-6)


def test_reference_rows_without_context_depend_on_block_size():
    """A fault of the reference (ROADMAP Queue 3): with causal T > S, rows
    that see no key come back from the Pallas kernel as the mean of a kv
    block's values at one block size and as 0 at another, because its
    masked scores are -1e30 and exp(0) = 1 in a fully masked block.  The
    port returns exactly 0 there."""
    arrs = _inputs(0, 1, 1, 1, 96, 48, 64)
    at32 = _jax(j_fa_ops.flash_attention, arrs, "float32", True,
                block_q=32, block_k=32)
    at16 = _jax(j_fa_ops.flash_attention, arrs, "float32", True,
                block_q=16, block_k=16)
    empty = slice(32, 48)                 # rows 0..47 see no key
    v_mean = arrs[2][0, 0, :32].mean(axis=0)
    np.testing.assert_allclose(at32[0, 0, empty],
                               np.broadcast_to(v_mean, (16, 64)), atol=1e-5)
    assert np.abs(at16[0, 0, :48]).max() == 0.0
    port = _port(arrs, "float32", True)
    assert (port[0, 0, :48] == 0).all()
    seen = slice(48, 96)
    np.testing.assert_allclose(port.numpy()[0, 0, seen], at16[0, 0, seen],
                               rtol=2e-5, atol=2e-5)


# -- host-side helpers of the bf16 kernel (TMA tensor maps) -------------------

from repro_torch.kernels.flash_attention import kernel as fa_k  # noqa: E402


@pytest.mark.parametrize("layout", ["contiguous", "transposed"])
@pytest.mark.parametrize("b,h,t,dh", [(4, 32, 2048, 64), (2, 8, 100, 128),
                                      (1, 1, 1, 64)])
def test_tma_strides_are_the_views_strides(layout, b, h, t, dh):
    """The tensor map's strides over (B, H, T) are the view's own where the
    axis has more than one entry, and a contiguous layout's where it has
    one (TMA never steps along it); every byte stride stays a multiple of
    16 for views the model makes."""
    x = torch.zeros((b, h, t, dh), dtype=torch.bfloat16)
    if layout == "transposed":
        x = torch.zeros((b, t, h, dh), dtype=torch.bfloat16).transpose(1, 2)
    got = fa_k.tma_strides(x.shape, x.stride())
    for size, st, own in zip((b, h, t), got, x.stride()[:3]):
        if size > 1:
            assert st == own
    assert got[2] == (x.stride(2) if t > 1 else dh)
    assert got[1] == (x.stride(1) if h > 1 else got[2] * t)
    assert got[0] == (x.stride(0) if b > 1 else got[1] * h)
    assert all(st * 2 % fa_k.TMA_ALIGN == 0 for st in got)
    assert fa_k.tma_refusal(0, x.shape, x.stride(), 2) is None


def test_tma_refusal_names_what_breaks_the_16_byte_rule():
    """Base addresses and the strides of axes longer than 1 must be
    multiples of 16 bytes, and the last axis contiguous."""
    shape = (2, 4, 100, 64)
    ok = (4 * 100 * 64, 100 * 64, 64, 1)
    assert fa_k.tma_refusal(1024, shape, ok, 2) is None
    assert "base address" in fa_k.tma_refusal(1026, shape, ok, 2)
    assert "last axis" in fa_k.tma_refusal(0, shape, (*ok[:3], 2), 2)
    odd = (4 * 100 * 68, 100 * 68, 68, 1)      # rows of 68 bf16: 136 bytes
    assert fa_k.tma_refusal(0, shape, odd, 2).endswith(
        "stride over T is not a multiple of 16 bytes")
    # the same rows in f32 are 272 bytes, a multiple of 16
    assert fa_k.tma_refusal(0, shape, odd, 4) is None
    # a size-1 axis may carry any stride: TMA never steps along it
    assert fa_k.tma_refusal(0, (1, 4, 100, 64), (3, *ok[1:]), 2) is None
    assert "over B" in fa_k.tma_refusal(0, (2, 4, 100, 64), (3, *ok[1:]), 2)
