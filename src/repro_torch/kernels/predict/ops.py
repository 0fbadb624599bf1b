"""Wrapper of the fused serving predict kernel: ``predict_stats``, and the
engine's dispatch shim ``predict_fn_for_engine``.

The tensor's device decides the path.  On the CPU the wrapper computes the
plain version (``ref.py``).  On CUDA it always launches the hand-written
kernel (``csrc/predict.cu``) and raises where the kernel cannot run; there
is no fallback.  Prediction is forward-only on CUDA: the kernel has no
backward, as the JAX package's Pallas predict has none
(``src/repro/kernels/predict/ops.py:13-17``), so the CUDA path refuses
inputs that require grad rather than drop their gradient silently.  A
caller that differentiates (``BayesianGPLVM.reconstruct``) takes the plain
composition, ``serve.posterior.predict_mean_var_plain``, as the JAX
package's does.  The CPU path is plain autograd and differentiates.

Precision: the tiles run in the query dtype, with sub-f32 lifted to f32
(the clamp of ``repro/kernels/predict/ops.py``).  Unlike the TPU kernel, an
f64 request is kept, through the kernel's double instantiation: an engine
over an f64 state contracts in f64, as the JAX engine's default path does.
Outputs come back in the query dtype.
"""
from __future__ import annotations

import torch

from .. import _build
from . import kernel as _k
from . import ref as _ref

#: launches of the CUDA kernel since the counts were last reset, by tile dtype
LAUNCHES = {"float32": 0, "float64": 0}


def tile_dtype(compute_dtype) -> torch.dtype:
    """The dtype the tiles run in: sub-f32 lifted to f32, else as asked."""
    return (torch.float32 if torch.finfo(compute_dtype).bits < 32
            else compute_dtype)


def predict_stats(hyp: dict, z, a_mean, g, x):
    """``(mean, quad)``: ``ksm @ a_mean`` (t, d) and
    ``rowsum((ksm @ g) * ksm)`` (t,) for queries x (t, q), in x's dtype;
    the tiles run in :func:`tile_dtype` of x's dtype."""
    dt = tile_dtype(x.dtype)
    hp_src = (hyp["log_sf2"], hyp["log_ell"])
    if x.device.type == "cpu":
        mean, quad = _ref.predict_ref(*(v.to(dt) for v in hp_src),
                                      *(v.to(dt) for v in (z, a_mean, g, x)))
        return mean.to(x.dtype), quad.to(x.dtype)
    operands = (z, a_mean, g, x, *hp_src)
    if x.device.type != "cuda" or any(t.device != x.device for t in operands):
        raise ValueError("predict_stats: every operand must be on one CUDA "
                         f"device, got {[str(t.device) for t in operands]}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in operands):
        raise RuntimeError(
            "predict_stats on CUDA has no backward, as the JAX package's "
            "Pallas predict has none; differentiate the plain composition "
            "(serve.posterior.predict_mean_var_plain), or call this under "
            "torch.no_grad() or on detached tensors")
    t, q = x.shape
    m, d = a_mean.shape
    if z.shape != (m, q) or g.shape != (m, m) \
            or hyp["log_ell"].shape != (q,) or m < 1:
        raise ValueError(
            f"predict_stats: shapes x {tuple(x.shape)}, z {tuple(z.shape)}, "
            f"a_mean {tuple(a_mean.shape)}, g {tuple(g.shape)}, "
            f"log_ell {tuple(hyp['log_ell'].shape)} do not agree")
    h, kscr = _k.scratch(t, m, q, dt, x.device)
    mean = torch.empty((t, d), dtype=dt, device=x.device)
    quad = torch.empty((t,), dtype=dt, device=x.device)
    _k.predict(*(_build.operand(v, dt) for v in (x, z, *hp_src, a_mean, g)),
               h, kscr, mean, quad)
    LAUNCHES[str(dt).removeprefix("torch.")] += 1
    return mean.to(x.dtype), quad.to(x.dtype)


def predict_fn_for_engine(kernel=None):
    """The engine's per-block function for a state of ``kernel`` (None:
    SE-ARD), ``fn(state, x) -> (mean (t, d), var (t,))`` noise-free: for the
    full-width SE-ARD, which the kernel specialises, :func:`predict_stats`
    (the kernel on CUDA, its plain version on the CPU); for every other
    expression the plain serving math
    (``serve.posterior.predict_mean_var_plain``) on any device, as the JAX
    package's shim routes them."""
    from ...core.covariance import as_kernel, is_fused_se

    if not is_fused_se(as_kernel(kernel)):
        from ...serve.posterior import predict_mean_var_plain
        return predict_mean_var_plain

    def fn(state, x):
        mean, quad = predict_stats(state.hyp, state.z, state.a_mean, state.g,
                                   x)
        return mean, state.kernel.kdiag(state.hyp, x) - quad

    return fn
