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
in a ``custom_vjp`` that recomputes through XLA, and differentiates psi1
through XLA's ``se_psi1``.  Here each Function takes a hand-written
backward kernel (``csrc/psi2_bwd.cu``, ``csrc/psi1_bwd.cu``: the closed
forms of ``ref.psi2_vjp_ref`` and ``ref.psi1_vjp_ref``) and raises where
it cannot run; there is no fallback.  :func:`psi2_vjp` and
:func:`psi1_vjp`, the plain versions recomputed in row chunks
(``kernels._vjp``), are kept as the backward kernels' oracles; no path
calls them.  ``log_sf2`` and ``log_ell`` are separate inputs, so the
hyper-parameters get their gradients.

For every tensor but a real CPU one (a CUDA tensor, or a fake tensor of
the dry run) each Function calls its operators,
``torch.ops.repro_torch.psi2`` / ``psi2_bwd`` / ``psi1`` (``torch.library``:
each CUDA implementation is the device check and the launch), as do
their backward operators ``psi2_bwd`` / ``psi1_bwd``; the fake
implementations give the outputs' shapes and dtypes and the FLOP formulas
(``psi2_flop_count``, ``psi2_bwd_flop_count``, ``psi1_flop_count``,
``psi1_bwd_flop_count``) the kernels' work, so the dry run
(``launch.dryrun``) counts the kernels.
"""
from __future__ import annotations

import torch
from torch._subclasses.fake_tensor import is_fake
from torch.utils.flop_counter import register_flop_formula

from .. import _build
from .. import _vjp
from . import kernel as _k
from . import ref as _ref

#: launches of each CUDA kernel since the counts were last reset, by kernel
#: and tile dtype
LAUNCHES = {"psi2_float32": 0, "psi2_float64": 0,
            "psi2_bwd_float32": 0, "psi2_bwd_float64": 0,
            "psi1_float32": 0, "psi1_float64": 0,
            "psi1_bwd_float32": 0, "psi1_bwd_float64": 0}
_PSI2_KEY = {torch.float32: "psi2_float32", torch.float64: "psi2_float64"}
_PSI1_KEY = {torch.float32: "psi1_float32", torch.float64: "psi1_float64"}


def _tile_dtype(dtype) -> torch.dtype:
    return torch.float64 if dtype == torch.float64 else torch.float32


def _on_one_card(name, *operands):
    """The operators' device check."""
    dev = operands[0].device
    if dev.type != "cuda" or any(t.device != dev for t in operands):
        raise ValueError(f"{name}: every operand must be on one CUDA device, "
                         f"got {[str(t.device) for t in operands]}")


def _check(name, hyp, z, mu, s, *more):
    """Shape checks of the operator path."""
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
    if mu.device.type == "cpu" and not is_fake(mu):
        dt = _tile_dtype(mu.dtype)
        return _ref.psi2_ref(*(t.to(dt) for t in (log_sf2, log_ell, z, mu, s,
                                                  w))).to(mu.dtype)
    _check("psi2", hyp, z, mu, s, w)
    return _Psi2.apply(log_sf2, log_ell, z, mu, s, w)


# The operators: schemas and CUDA registrations (no custom_op wrapper,
# whose per-call checks cost more than the launch's own host work).
_LIB = torch.library.Library("repro_torch", "FRAGMENT")
_LIB.define("psi2(Tensor log_sf2, Tensor log_ell, Tensor z, Tensor mu, "
            "Tensor s, Tensor w) -> Tensor")
_LIB.define("psi1(Tensor log_sf2, Tensor log_ell, Tensor z, Tensor mu, "
            "Tensor s) -> Tensor")


def _psi2_op(log_sf2, log_ell, z, mu, s, w):
    _on_one_card("psi2", mu, s, w, z, log_sf2, log_ell)
    return _launch_psi2(log_sf2, log_ell, z, mu, s, w)


_LIB.impl("psi2", _psi2_op, "CUDA")


@torch.library.register_fake("repro_torch::psi2", lib=_LIB)
def _(log_sf2, log_ell, z, mu, s, w):
    return mu.new_empty((z.shape[0], z.shape[0]))


def psi2_flops(n: int, m: int, q: int) -> int:
    """psi2's FLOPs: each row (its weight not known here, so every row)
    against the upper half of the pairs, 2q + 5 a pair (the centred
    exponent and the weighted exp's FMA)."""
    return n * (m * (m + 1) // 2) * (2 * q + 5)


@register_flop_formula(torch.ops.repro_torch.psi2)
def psi2_flop_count(log_sf2_shape, log_ell_shape, z_shape, mu_shape,
                    *args, **kwargs) -> int:
    return psi2_flops(mu_shape[0], z_shape[0], z_shape[1])


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
    row chunks under autograd: the oracle of the backward kernel, callable
    on any device."""
    m, q = z.shape
    chunk = _vjp.rows_per_chunk(m * m * q)

    def fn(log_sf2, log_ell, z, mu, s, w):
        return (_ref.psi2_ref(log_sf2, log_ell, z, mu, s, w),)

    return _vjp.chunked_vjp(fn, (log_sf2, log_ell, z), (mu, s, w), (g,),
                            needs, chunk)


_LIB.define("psi2_bwd(Tensor log_sf2, Tensor log_ell, Tensor z, Tensor mu, "
            "Tensor s, Tensor w, Tensor g, int flags) -> (Tensor, Tensor, "
            "Tensor, Tensor, Tensor, Tensor)")


def _psi2_bwd_op(log_sf2, log_ell, z, mu, s, w, g, flags):
    _on_one_card("psi2_bwd", mu, s, w, z, log_sf2, log_ell, g)
    return _launch_psi2_bwd(log_sf2, log_ell, z, mu, s, w, g, flags,
                            _build.sm_count(mu.device))


_LIB.impl("psi2_bwd", _psi2_bwd_op, "CUDA")


@torch.library.register_fake("repro_torch::psi2_bwd", lib=_LIB)
def _(log_sf2, log_ell, z, mu, s, w, g, flags):
    shapes = ((), log_ell.shape, z.shape, mu.shape if flags & 1 else (0,),
              s.shape if flags & 2 else (0,), w.shape if flags & 4 else (0,))
    return tuple(t.new_empty(sh) for t, sh in
                 zip((log_sf2, log_ell, z, mu, s, w), shapes))


def psi2_bwd_flops(n: int, m: int, q: int) -> int:
    """psi2's backward kernel's FLOPs: each row (every row, as the
    forward's formula) against the upper half of the pairs, per (row,
    pair) the exponent formed once (E's product over the 2q + 2 columns,
    2(2q + 2)), F (3: the exp's FMA, the cotangent, the weight), the rows'
    sums H = G B (2(2q + 1)) and the pairs' sums Q = F^T A (2(2q + 1))."""
    return n * (m * (m + 1) // 2) * (12 * q + 11)


@register_flop_formula(torch.ops.repro_torch.psi2_bwd)
def psi2_bwd_flop_count(log_sf2_shape, log_ell_shape, z_shape, mu_shape,
                        *args, **kwargs) -> int:
    return psi2_bwd_flops(mu_shape[0], z_shape[0], z_shape[1])


def psi2_bwd_launch_args(log_sf2, log_ell, z, mu, s, w, g, flags, sms):
    """psi2's backward operands, scratch and outputs for one launch
    (``kernel.psi2_bwd``'s arguments) on a card of ``sms`` SMs: the
    operands as they are (the log hyper-parameters in f64), one scratch
    allocation."""
    n, q = mu.shape
    m = z.shape[0]
    f64 = torch.float64
    dt = _tile_dtype(mu.dtype)
    dev = mu.device
    blocks, row_tiles, _, _ = _k.psi2_bwd_plan(
        n, m, sms * _k.psi2_bwd_blocks_per_sm(q))

    def rows(shape, flag):
        return torch.empty(shape if flags & flag else (0,), dtype=dt,
                           device=dev)
    return (*(_build.operand(t, dt) for t in (mu, s, w, z, g)),
            _build.operand(log_sf2, f64), _build.operand(log_ell, f64),
            blocks, row_tiles, flags,
            torch.empty((_k.psi2_bwd_scratch_len(n, m, q, blocks, row_tiles),),
                        dtype=f64, device=dev),
            torch.empty((m, q), dtype=f64, device=dev),
            torch.empty((q,), dtype=f64, device=dev),
            torch.empty((), dtype=f64, device=dev),
            rows((n, q), 1), rows((n, q), 2), rows((n,), 4))


def _launch_psi2_bwd(log_sf2, log_ell, z, mu, s, w, g, flags, sms):
    """The bare backward launch (the operator's implementation): device
    checks are the caller's."""
    args = psi2_bwd_launch_args(log_sf2, log_ell, z, mu, s, w, g, flags, sms)
    _k.psi2_bwd(*args)
    LAUNCHES["psi2_bwd_" + str(args[0].dtype).removeprefix("torch.")] += 1
    dz, dell, dsf2, dmu, ds, dw = args[-6:]
    return (dsf2.to(log_sf2.dtype), dell.to(log_ell.dtype), dz.to(z.dtype),
            dmu.to(mu.dtype), ds.to(s.dtype), dw.to(w.dtype))


class _Psi2(torch.autograd.Function):
    """Forward: the operator (the CUDA kernel).  Backward: the backward
    operator (the CUDA backward kernel)."""

    @staticmethod
    def forward(ctx, log_sf2, log_ell, z, mu, s, w):
        ctx.save_for_backward(log_sf2, log_ell, z, mu, s, w)
        return torch.ops.repro_torch.psi2(log_sf2, log_ell, z, mu, s, w)

    @staticmethod
    def backward(ctx, g):
        needs = ctx.needs_input_grad
        grads = torch.ops.repro_torch.psi2_bwd(*ctx.saved_tensors, g,
                                               _build.row_flags(needs))
        return tuple(t if need else None for t, need in zip(grads, needs))


# -- psi1 --------------------------------------------------------------------

def psi1(hyp: dict, z, mu, s):
    """``Ψ1 = ⟨k(xᵢ, z_m)⟩`` (n, m) for mu, s (n, q), z (m, q), in mu's
    dtype."""
    log_sf2, log_ell = hyp["log_sf2"], hyp["log_ell"]
    if mu.device.type == "cpu" and not is_fake(mu):
        dt = _tile_dtype(mu.dtype)
        return _ref.psi1_ref(*(t.to(dt) for t in (log_sf2, log_ell, z, mu,
                                                  s))).to(mu.dtype)
    _check("psi1", hyp, z, mu, s)
    return _Psi1.apply(log_sf2, log_ell, z, mu, s)


def _psi1_op(log_sf2, log_ell, z, mu, s):
    _on_one_card("psi1", mu, s, z, log_sf2, log_ell)
    return _launch_psi1(log_sf2, log_ell, z, mu, s)


_LIB.impl("psi1", _psi1_op, "CUDA")


@torch.library.register_fake("repro_torch::psi1", lib=_LIB)
def _(log_sf2, log_ell, z, mu, s):
    return mu.new_empty((mu.shape[0], z.shape[0]))


def psi1_flops(n: int, m: int, q: int) -> int:
    """psi1's FLOPs: 4q + 3 a (row, inducing point) entry."""
    return n * m * (4 * q + 3)


@register_flop_formula(torch.ops.repro_torch.psi1)
def psi1_flop_count(log_sf2_shape, log_ell_shape, z_shape, mu_shape,
                    *args, **kwargs) -> int:
    return psi1_flops(mu_shape[0], z_shape[0], z_shape[1])


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
    row chunks (each chunk takes its rows of ``g``): the oracle of the
    backward kernel, callable on any device."""
    m, q = z.shape
    chunk = _vjp.rows_per_chunk(m * q)

    def fn(log_sf2, log_ell, z, mu, s):
        return (_ref.psi1_ref(log_sf2, log_ell, z, mu, s),)

    return _vjp.chunked_vjp(fn, (log_sf2, log_ell, z), (mu, s), (g,), needs,
                            chunk, per_row=True)


_LIB.define("psi1_bwd(Tensor log_sf2, Tensor log_ell, Tensor z, Tensor mu, "
            "Tensor s, Tensor g, int flags) -> (Tensor, Tensor, Tensor, "
            "Tensor, Tensor)")


def _psi1_bwd_op(log_sf2, log_ell, z, mu, s, g, flags):
    _on_one_card("psi1_bwd", mu, s, z, log_sf2, log_ell, g)
    return _launch_psi1_bwd(log_sf2, log_ell, z, mu, s, g, flags,
                            _build.sm_count(mu.device))


_LIB.impl("psi1_bwd", _psi1_bwd_op, "CUDA")


@torch.library.register_fake("repro_torch::psi1_bwd", lib=_LIB)
def _(log_sf2, log_ell, z, mu, s, g, flags):
    shapes = ((), log_ell.shape, z.shape, mu.shape if flags & 1 else (0,),
              s.shape if flags & 2 else (0,))
    return tuple(t.new_empty(sh) for t, sh in
                 zip((log_sf2, log_ell, z, mu, s), shapes))


def psi1_bwd_flops(n: int, m: int, q: int) -> int:
    """psi1's backward kernel's FLOPs: per (row, point) entry the exponent
    (3q), psi1 and E (3), the row sums of E, E r, E r^2 (4q + 1) and the
    point sums of E r a (3q)."""
    return n * m * (10 * q + 4)


@register_flop_formula(torch.ops.repro_torch.psi1_bwd)
def psi1_bwd_flop_count(log_sf2_shape, log_ell_shape, z_shape, mu_shape,
                        *args, **kwargs) -> int:
    return psi1_bwd_flops(mu_shape[0], z_shape[0], z_shape[1])


def psi1_bwd_launch_args(log_sf2, log_ell, z, mu, s, g, flags, sms):
    """psi1's backward operands, scratch and outputs for one launch
    (``kernel.psi1_bwd``'s arguments) on a card of ``sms`` SMs: one
    scratch allocation for the blocks' partials."""
    n, q = mu.shape
    m = z.shape[0]
    f64 = torch.float64
    dt = _tile_dtype(mu.dtype)
    dev = mu.device
    n_blocks, rows = _k.psi1_bwd_plan(
        n, sms * _k.psi1_bwd_blocks_per_sm(m, q, dt))

    def out_rows(flag):
        return torch.empty((n, q) if flags & flag else (0,), dtype=dt,
                           device=dev)
    return (*(_build.operand(t, dt) for t in (mu, s, z, log_sf2, log_ell, g)),
            n_blocks, rows, flags,
            torch.empty((n_blocks * ((m + 1) * q + 1),), dtype=f64,
                        device=dev),
            torch.empty((m, q), dtype=f64, device=dev),
            torch.empty((q,), dtype=f64, device=dev),
            torch.empty((), dtype=f64, device=dev), out_rows(1), out_rows(2))


def _launch_psi1_bwd(log_sf2, log_ell, z, mu, s, g, flags, slots):
    """The bare backward launch (the operator's implementation): device
    checks are the caller's."""
    args = psi1_bwd_launch_args(log_sf2, log_ell, z, mu, s, g, flags, slots)
    _k.psi1_bwd(*args)
    LAUNCHES["psi1_bwd_" + str(args[0].dtype).removeprefix("torch.")] += 1
    dz, dell, dsf2, dmu, ds = args[-5:]
    return (dsf2.to(log_sf2.dtype), dell.to(log_ell.dtype), dz.to(z.dtype),
            dmu.to(mu.dtype), ds.to(s.dtype))


class _Psi1(torch.autograd.Function):
    """Forward: the operator (the CUDA kernel).  Backward: the backward
    operator (the CUDA backward kernel)."""

    @staticmethod
    def forward(ctx, log_sf2, log_ell, z, mu, s):
        ctx.save_for_backward(log_sf2, log_ell, z, mu, s)
        return torch.ops.repro_torch.psi1(log_sf2, log_ell, z, mu, s)

    @staticmethod
    def backward(ctx, g):
        needs = ctx.needs_input_grad
        grads = torch.ops.repro_torch.psi1_bwd(
            *ctx.saved_tensors, g, _build.row_flags((*needs, False)))
        return tuple(t if need else None for t, need in zip(grads, needs))


def psi2_fn_for_engine(kernel=None):
    """The ``psi2_fn`` hook of ``core.partial_stats`` and ``DistributedGP``
    for ``kernel`` (None: SE-ARD): :func:`psi2` (the kernel on CUDA, its
    plain version on the CPU) for the full-width SE-ARD, and the
    expression's own ``psi2`` (analytic or quadrature, plain torch) for
    every other one, as the JAX package's shim routes them."""
    from ...core.covariance import as_kernel, is_fused_se

    kernel = as_kernel(kernel)
    return psi2 if is_fused_se(kernel) else kernel.psi2
