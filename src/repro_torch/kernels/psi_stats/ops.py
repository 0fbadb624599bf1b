"""Wrappers of the psi-statistics kernels: ``psi2`` and ``psi1``.

The tensor's device decides the path.  On the CPU each wrapper computes the
plain version (``ref.py``), which autograd differentiates as it stands.  On
CUDA it always launches the hand-written kernel (``csrc/psi_stats.cu``)
through a ``torch.autograd.Function`` and raises where the kernel cannot
run; there is no fallback.

Precision: f64 inputs run the kernels' double instantiation, every other
dtype their float one (the TPU kernels compute in f32 whatever they are
given, ``repro/kernels/psi_stats/ops.py``); outputs come back in the
caller's dtype.  The GPLVM is f64, so its map step takes the double one:
f32 map statistics break the q(u) factorisation at full width (ROADMAP,
Queue 3).

Differentiation: ``pallas_call`` has no VJP, so the JAX package wraps psi2
in a ``custom_vjp`` that recomputes through XLA.  Here each Function's
backward recomputes the plain version in row chunks (``kernels._vjp``):
O(chunk·m²·q) memory for psi2 and O(chunk·m·q) for psi1, whatever n is.
``log_sf2`` and ``log_ell`` are separate inputs, so the hyper-parameters get
their gradients.
"""
from __future__ import annotations

import torch

from .. import _build
from .. import _vjp
from . import kernel as _k
from . import ref as _ref

#: launches of each CUDA kernel since the counts were last reset, by kernel
#: and tile dtype
LAUNCHES = {"psi2_float32": 0, "psi2_float64": 0,
            "psi1_float32": 0, "psi1_float64": 0}
_PSI2_KEY = {torch.float32: "psi2_float32", torch.float64: "psi2_float64"}
_PSI1_KEY = {torch.float32: "psi1_float32", torch.float64: "psi1_float64"}


def _tile_dtype(dtype) -> torch.dtype:
    return torch.float64 if dtype == torch.float64 else torch.float32


def _check(name, hyp, z, mu, s, *more):
    """Device and shape checks of the CUDA path."""
    operands = (z, mu, s, *more, hyp["log_sf2"], hyp["log_ell"])
    if mu.device.type != "cuda" or any(t.device != mu.device
                                       for t in operands):
        raise ValueError(f"{name}: every operand must be on one CUDA device, "
                         f"got {[str(t.device) for t in operands]}")
    n, q = mu.shape
    m = z.shape[0]
    if z.shape != (m, q) or s.shape != (n, q) \
            or hyp["log_ell"].shape != (q,) or m < 1 \
            or any(t.shape != (n,) for t in more):
        raise ValueError(
            f"{name}: shapes mu {tuple(mu.shape)}, s {tuple(s.shape)}, "
            f"z {tuple(z.shape)}, log_ell {tuple(hyp['log_ell'].shape)}"
            + "".join(f", w {tuple(t.shape)}" for t in more)
            + " do not agree")


# -- psi2 --------------------------------------------------------------------

def psi2(hyp: dict, z, mu, s, w):
    """Weighted ``Ψ2 = Σᵢ wᵢ ⟨k(xᵢ, z_a) k(xᵢ, z_b)⟩`` (m, m) for mu, s
    (n, q), w (n,), z (m, q), in mu's dtype.  On CUDA, D is exactly
    symmetric and the (n, m, m) per-point tensor is never stored."""
    log_sf2, log_ell = hyp["log_sf2"], hyp["log_ell"]
    if mu.device.type == "cpu":
        dt = _tile_dtype(mu.dtype)
        return _ref.psi2_ref(*(t.to(dt) for t in (log_sf2, log_ell, z, mu, s,
                                                  w))).to(mu.dtype)
    _check("psi2", hyp, z, mu, s, w)
    return _Psi2.apply(log_sf2, log_ell, z, mu, s, w)


def _launch_psi2(log_sf2, log_ell, z, mu, s, w):
    n, q = mu.shape
    m = z.shape[0]
    dt = _tile_dtype(mu.dtype)
    args = [_build.operand(t, dt) for t in (mu, s, w, z, log_sf2, log_ell)]
    n_slices, rows, scratch = _k.psi2_scratch(n, m, q, dt, mu.device)
    d_out = torch.empty((m, m), dtype=torch.float64, device=mu.device)
    _k.psi2(*args, n_slices, rows, scratch, d_out)
    LAUNCHES[_PSI2_KEY[dt]] += 1
    return d_out if mu.dtype == torch.float64 else d_out.to(mu.dtype)


def psi2_vjp(log_sf2, log_ell, z, mu, s, w, g, needs):
    """Gradients of ``<g, psi2(...)>`` by the plain version, recomputed in
    row chunks: the backward of the CUDA path, callable on any device."""
    m, q = z.shape
    chunk = _vjp.rows_per_chunk(m * m * q)

    def fn(log_sf2, log_ell, z, mu, s, w):
        return (_ref.psi2_ref(log_sf2, log_ell, z, mu, s, w),)

    return _vjp.chunked_vjp(fn, (log_sf2, log_ell, z), (mu, s, w), (g,),
                            needs, chunk)


class _Psi2(torch.autograd.Function):
    """Forward: the CUDA kernel.  Backward: :func:`psi2_vjp`."""

    @staticmethod
    def forward(ctx, log_sf2, log_ell, z, mu, s, w):
        ctx.save_for_backward(log_sf2, log_ell, z, mu, s, w)
        return _launch_psi2(log_sf2, log_ell, z, mu, s, w)

    @staticmethod
    def backward(ctx, g):
        return tuple(psi2_vjp(*ctx.saved_tensors, g, ctx.needs_input_grad))


# -- psi1 --------------------------------------------------------------------

def psi1(hyp: dict, z, mu, s):
    """``Ψ1 = ⟨k(xᵢ, z_m)⟩`` (n, m) for mu, s (n, q), z (m, q), in mu's
    dtype."""
    log_sf2, log_ell = hyp["log_sf2"], hyp["log_ell"]
    if mu.device.type == "cpu":
        dt = _tile_dtype(mu.dtype)
        return _ref.psi1_ref(*(t.to(dt) for t in (log_sf2, log_ell, z, mu,
                                                  s))).to(mu.dtype)
    _check("psi1", hyp, z, mu, s)
    return _Psi1.apply(log_sf2, log_ell, z, mu, s)


def _launch_psi1(log_sf2, log_ell, z, mu, s):
    n, m = mu.shape[0], z.shape[0]
    dt = _tile_dtype(mu.dtype)
    out = torch.empty((n, m), dtype=dt, device=mu.device)
    if n == 0:
        return out.to(mu.dtype)
    _k.psi1(*(_build.operand(t, dt) for t in (mu, s, z, log_sf2, log_ell)),
            out)
    LAUNCHES[_PSI1_KEY[dt]] += 1
    return out.to(mu.dtype)


def psi1_vjp(log_sf2, log_ell, z, mu, s, g, needs):
    """Gradients of ``<g, psi1(...)>`` by the plain version, recomputed in
    row chunks (each chunk takes its rows of ``g``)."""
    m, q = z.shape
    chunk = _vjp.rows_per_chunk(m * q)

    def fn(log_sf2, log_ell, z, mu, s):
        return (_ref.psi1_ref(log_sf2, log_ell, z, mu, s),)

    return _vjp.chunked_vjp(fn, (log_sf2, log_ell, z), (mu, s), (g,), needs,
                            chunk, per_row=True)


class _Psi1(torch.autograd.Function):
    """Forward: the CUDA kernel.  Backward: :func:`psi1_vjp`."""

    @staticmethod
    def forward(ctx, log_sf2, log_ell, z, mu, s):
        ctx.save_for_backward(log_sf2, log_ell, z, mu, s)
        return _launch_psi1(log_sf2, log_ell, z, mu, s)

    @staticmethod
    def backward(ctx, g):
        return tuple(psi1_vjp(*ctx.saved_tensors, g, ctx.needs_input_grad))


def psi2_fn_for_engine(kernel=None):
    """The ``psi2_fn`` hook of ``core.partial_stats`` and ``DistributedGP``
    for ``kernel`` (None: SE-ARD): :func:`psi2` (the kernel on CUDA, its
    plain version on the CPU) for the full-width SE-ARD, and the
    expression's own ``psi2`` (analytic or quadrature, plain torch) for
    every other one, as the JAX package's shim routes them."""
    from ...core.covariance import as_kernel, is_fused_se

    kernel = as_kernel(kernel)
    return psi2 if is_fused_se(kernel) else kernel.psi2
