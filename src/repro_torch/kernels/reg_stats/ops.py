"""Wrapper of the fused regression-statistics kernel: ``reg_stats``, and
the map's dispatch shim ``reg_stats_fn_for_engine``.

The tensor's device decides the path.  On the CPU the wrapper computes the
plain version (``ref.py``).  On CUDA it always launches the hand-written
kernel (``csrc/reg_stats.cu``) and raises where the kernel cannot run;
there is no fallback.

Precision: f64 inputs run the kernel's double instantiation, every other
dtype its float one (the TPU kernel's f32 contract,
``repro/kernels/reg_stats/ops.py``).  The TPU clamps f64 to f32; the port
does not, because at ``sgpr-synth-1m`` f32 tiles move the served mean far
outside its budget and f32 outputs break the q(u) factorisation (ROADMAP,
Queue 3).  The per-slice
partials are summed in f64 and the outputs come back in the caller's
dtype, so the fold across chunks and all solves downstream run in f64.

Differentiation: the CUDA path is a ``torch.autograd.Function`` whose
forward is the kernel and whose backward is the hand-written backward
kernel (``csrc/reg_stats_bwd.cu``, the closed form of
``ref.reg_stats_vjp_ref``), where the JAX package's ``custom_vjp``
recomputes through XLA.  It raises where that kernel cannot run; there is
no fallback.  :func:`reg_stats_vjp`, the dense formulation recomputed in
row chunks (``kernels._vjp``) under autograd, is kept as its oracle and
runs on any device; no path calls it.

For every tensor but a real CPU one (a CUDA tensor, or a fake tensor of
the dry run) the Function's forward and backward call the operators
``torch.ops.repro_torch.reg_stats`` and ``reg_stats_bwd``
(``torch.library``: each CUDA implementation is the device check and the
launch).  Their fake implementations give the outputs' shapes and dtypes,
and their FLOP formulas (``flop_count``, ``bwd_flop_count``) the kernels'
work, so the dry run (``launch.dryrun``) counts the kernels, not the plain
versions.
"""
from __future__ import annotations

import math

import torch
from torch._subclasses.fake_tensor import is_fake
from torch.utils.flop_counter import register_flop_formula

from .. import _build
from .. import _vjp
from . import kernel as _k
from . import ref as _ref

#: launches of the CUDA kernels since the counts were last reset: the
#: forward by tile dtype, the backward as ``bwd_<dtype>``
LAUNCHES = {"float32": 0, "float64": 0, "bwd_float32": 0, "bwd_float64": 0}


def reg_stats(hyp: dict, z, x, y, w):
    """``(b, C, D)``: ``sf2·Σw`` (), ``knmᵀ(w⊙Y)`` (m, d) and
    ``(knm⊙w)ᵀknm`` (m, m) for x (n, q), y (n, d), w (n,), z (m, q), in
    x's dtype.  On CUDA the (n, m) slab is never stored."""
    log_sf2, log_ell = hyp["log_sf2"], hyp["log_ell"]
    if x.device.type == "cpu" and not is_fake(x):
        return _ref.reg_stats_ref(log_sf2.to(x.dtype), log_ell.to(x.dtype),
                                  z, x, y, w)
    n, q = x.shape
    m, d = z.shape[0], y.shape[1]
    if z.shape != (m, q) or y.shape != (n, d) or w.shape != (n,) \
            or log_ell.shape != (q,) or m < 1:
        raise ValueError(
            f"reg_stats: shapes x {tuple(x.shape)}, y {tuple(y.shape)}, "
            f"w {tuple(w.shape)}, z {tuple(z.shape)}, "
            f"log_ell {tuple(log_ell.shape)} do not agree")
    return _RegStats.apply(log_sf2, log_ell, z, x, y, w)


# The operator: a schema and a CUDA registration (no custom_op wrapper,
# whose per-call checks cost more than the launch's own host work).
_LIB = torch.library.Library("repro_torch", "FRAGMENT")
_LIB.define("reg_stats(Tensor log_sf2, Tensor log_ell, Tensor z, Tensor x, "
            "Tensor y, Tensor w) -> (Tensor, Tensor, Tensor)")


def _reg_stats_op(log_sf2, log_ell, z, x, y, w):
    operands = (z, x, y, w, log_sf2, log_ell)
    if any(t.device != x.device for t in operands):
        raise ValueError("reg_stats: every operand must be on one CUDA "
                         f"device, got {[str(t.device) for t in operands]}")
    return _launch(log_sf2, log_ell, z, x, y, w)


_LIB.impl("reg_stats", _reg_stats_op, "CUDA")


@torch.library.register_fake("repro_torch::reg_stats", lib=_LIB)
def _(log_sf2, log_ell, z, x, y, w):
    m, d = z.shape[0], y.shape[1]
    return x.new_empty(()), x.new_empty((m, d)), x.new_empty((m, m))


def flops(n: int, m: int, q: int, d: int) -> int:
    """The kernel's FLOPs: the (n, m) slab's distances and scaling
    (3q + 2 a pair), D's upper half (n m (m + 1) / 2 FMAs), C (n m d
    FMAs), b (n adds)."""
    return n * m * (3 * q + 2) + n * m * (m + 1) + 2 * n * m * d + n


@register_flop_formula(torch.ops.repro_torch.reg_stats)
def flop_count(log_sf2_shape, log_ell_shape, z_shape, x_shape, y_shape,
               w_shape, *args, **kwargs) -> int:
    (n, q), m, d = x_shape, z_shape[0], y_shape[1]
    return flops(n, m, q, d)


#: -log2(e) / 2: the f32 kernel's exponent is sum_q (x_q - z_q)^2 s_q with
#: s = this / ell^2, exponentiated by one ex2.approx
_NEG_HALF_LOG2E = -0.5 / math.log(2.0)


def launch_args(log_sf2, log_ell, z, x, y, w):
    """The kernel's operands, scratch and outputs for one launch (the tile
    dtype's inputs, hp, the plan and its scratch): ``kernel.reg_stats``'s
    arguments.  f64 at m <= 512 takes the cluster kernel (a cluster of
    ceil(m/64) blocks a slice, ``kernel.cluster_plan``), every other case
    a per-tile kernel (``_build.fill_plan``).  The f32 kernel takes
    -log2(e) / (2 ell^2), folded here in the hyper-parameters' own dtype
    and rounded once."""
    n, q = x.shape
    m, d = z.shape[0], y.shape[1]
    f64 = torch.float64
    dt = f64 if x.dtype == f64 else torch.float32
    xs, ys, ws, zs = (t.to(dt).contiguous() for t in (x, y, w, z))
    inv = torch.exp(-2.0 * log_ell)
    if dt != f64:
        inv = inv * _NEG_HALF_LOG2E
    hp = torch.cat([torch.exp(log_sf2).reshape(1), inv]).to(dt).contiguous()
    dev = x.device
    d_out = torch.empty((m, m), dtype=f64, device=dev)
    c_out = torch.empty((m, d), dtype=f64, device=dev)
    b_out = torch.empty((), dtype=f64, device=dev)
    if _k.takes_cluster(m, dt):
        nb = _k.cluster_bands(m)
        n_slices, per_slice = _k.cluster_slices(
            n, _k.cluster_slots(m, q, dev))
        band = _k.BAND
        part_d = torch.empty((n_slices, nb * (nb + 1) // 2, band, band),
                             dtype=f64, device=dev)
        part_g = torch.empty((n_slices, nb * 8, 8, 8), dtype=f64, device=dev)
        return (xs, ys, ws, zs, hp, n_slices, per_slice, part_d,
                torch.empty_like(part_d),
                torch.empty((n_slices, nb * band, d), dtype=f64, device=dev),
                torch.empty((n_slices,), dtype=f64, device=dev),
                _k.plan_tensor(m, dev), part_g, torch.empty_like(part_g),
                d_out, c_out, b_out)
    tile, rows = _k.TILE, _k.ROWS
    slots = _build.sm_count(x.device) * (1 if dt == f64 else _k.F32_BLOCKS_PER_SM)
    n_tiles, n_slices, per_slice = _build.fill_plan(n, m, slots, tile, rows)
    part_d = torch.empty((n_slices, n_tiles, tile, tile), dtype=dt,
                         device=dev)
    part_comp = torch.empty_like(part_d)
    part_c = torch.empty((n_slices, -(-m // tile) * tile, d), dtype=dt,
                         device=dev)
    part_b = torch.empty((n_slices,), dtype=dt, device=dev)
    return (xs, ys, ws, zs, hp, n_slices, per_slice, part_d, part_comp,
            part_c, part_b, d_out, c_out, b_out)


def _launch(log_sf2, log_ell, z, x, y, w):
    """The bare launch (the operator's implementation): device checks are
    the caller's."""
    args = launch_args(log_sf2, log_ell, z, x, y, w)
    _k.reg_stats(*args)
    LAUNCHES[str(args[0].dtype).removeprefix("torch.")] += 1
    b_out, c_out, d_out = args[-1], args[-2], args[-3]
    return b_out.to(x.dtype), c_out.to(x.dtype), d_out.to(x.dtype)


def reg_stats_fn_for_engine(kernel=None):
    """The ``reg_stats_fn`` hook of ``core.stats.partial_stats`` and
    ``DistributedGP`` for ``kernel`` (None: SE-ARD), ``fn(hyp, z, x, y, w)
    -> (b, C, D)``: :func:`reg_stats` (the kernel on CUDA) for the
    full-width SE-ARD, which the kernel specialises, and the expression's
    own plain ``K``/``kdiag`` (``core.stats.reg_stats_dense``) on any device
    for every other one, as the JAX package's shim routes them."""
    from ...core.covariance import as_kernel, is_fused_se
    from ...core.stats import reg_stats_dense

    kernel = as_kernel(kernel)
    if is_fused_se(kernel):
        return reg_stats

    def fn(hyp, z, x, y, w):
        return reg_stats_dense(hyp, z, x, y, w, kernel=kernel)

    return fn


def _dense(log_sf2, log_ell, z, x, y, w):
    from ...core.stats import reg_stats_dense

    return reg_stats_dense({"log_sf2": log_sf2, "log_ell": log_ell}, z, x,
                           y, w)


def reg_stats_vjp(log_sf2, log_ell, z, x, y, w, gb, gc, gd, needs):
    """Gradients of ``<(gb, gc, gd), reg_stats(...)>`` by the dense
    formulation, recomputed in row chunks under autograd: the oracle of
    the backward kernel, callable on any device."""
    chunk = _vjp.rows_per_chunk(z.shape[0])
    return _vjp.chunked_vjp(_dense, (log_sf2, log_ell, z), (x, y, w),
                            (gb, gc, gd), needs, chunk)


# -- the backward -------------------------------------------------------------

_LIB.define("reg_stats_bwd(Tensor log_sf2, Tensor log_ell, Tensor z, "
            "Tensor x, Tensor y, Tensor w, Tensor gb, Tensor gc, Tensor gd, "
            "int flags) -> (Tensor, Tensor, Tensor, Tensor, Tensor, Tensor)")


def _bwd_op(log_sf2, log_ell, z, x, y, w, gb, gc, gd, flags):
    operands = (z, x, y, w, log_sf2, log_ell, gb, gc, gd)
    if any(t.device != x.device for t in operands):
        raise ValueError("reg_stats_bwd: every operand must be on one CUDA "
                         f"device, got {[str(t.device) for t in operands]}")
    dt = torch.float64 if x.dtype == torch.float64 else torch.float32
    return _launch_bwd(log_sf2, log_ell, z, x, y, w, gb, gc, gd, flags,
                       _k.bwd_slots(dt, z.shape[0], x.shape[1], x.device))


_LIB.impl("reg_stats_bwd", _bwd_op, "CUDA")


@torch.library.register_fake("repro_torch::reg_stats_bwd", lib=_LIB)
def _(log_sf2, log_ell, z, x, y, w, gb, gc, gd, flags):
    # a row output not asked for (flags 1 x, 2 y, 4 w) is empty
    shapes = ((), log_ell.shape, z.shape, x.shape if flags & 1 else (0,),
              y.shape if flags & 2 else (0,), w.shape if flags & 4 else (0,))
    return tuple(t.new_empty(sh) for t, sh in
                 zip((log_sf2, log_ell, z, x, y, w), shapes))


def bwd_flops(n: int, m: int, q: int, d: int) -> int:
    """The backward kernel's FLOPs: knm S (n m^2 FMAs), knm built once per
    group of output column tiles (3q + 2 a pair each time; one group up to
    1,024 points), and each entry's epilogue: P (d FMAs), E, and r, E r,
    E r^2 per feature (4q)."""
    groups = _k.bwd_cluster(m)[1]
    return 2 * n * m * m + n * m * (3 * q + 2) * groups \
        + n * m * (2 * d + 4 + 4 * q)


@register_flop_formula(torch.ops.repro_torch.reg_stats_bwd)
def bwd_flop_count(log_sf2_shape, log_ell_shape, z_shape, x_shape, y_shape,
                   *args, **kwargs) -> int:
    (n, q), m, d = x_shape, z_shape[0], y_shape[1]
    return bwd_flops(n, m, q, d)


def bwd_launch_args(log_sf2, log_ell, z, x, y, w, gb, gc, gd, flags, slots):
    """The backward kernel's operands, scratch and outputs for one launch
    (``kernel.reg_stats_bwd``'s arguments) over ``slots`` cluster slots
    (``kernel.bwd_slots``): z, S = gD + gD^T and gC zero-padded to
    128-row multiples, hp = [sf2, sf2 gb, 1/ell^2] in the tile dtype; the
    ranks' row partials only where ``flags`` asks for a row output."""
    n, q = x.shape
    m, d = z.shape[0], y.shape[1]
    f64 = torch.float64
    dt = f64 if x.dtype == f64 else torch.float32
    dev = x.device
    mp = -(-m // _k.BWD_COLUMNS) * _k.BWD_COLUMNS
    xs, ys, ws = (_build.operand(t, dt) for t in (x, y, w))
    zp = torch.zeros((mp, q), dtype=dt, device=dev)
    zp[:m] = z
    sp = torch.zeros((mp, mp), dtype=dt, device=dev)
    sp[:m, :m] = gd + gd.T
    gcp = torch.zeros((mp, d), dtype=dt, device=dev)
    gcp[:m] = gc
    sf2 = torch.exp(log_sf2)
    hp = torch.cat([sf2.reshape(1), (sf2 * gb).reshape(1),
                    torch.exp(-2.0 * log_ell)]).to(dt).contiguous()
    n_slices, per = _k.bwd_plan(n, slots)
    width = _k.bwd_cluster(m)[0]

    def rows(shape, flag):
        return torch.empty(shape if flags & flag else (0,), dtype=dt,
                           device=dev)
    return (xs, ys, ws, zp, sp, gcp, hp, m, n_slices, per, flags,
            torch.empty((n_slices, mp, q), dtype=f64, device=dev),
            torch.empty((n_slices * width, q), dtype=f64, device=dev),
            torch.empty((n_slices * width,), dtype=f64, device=dev),
            torch.empty((m, q), dtype=f64, device=dev),
            torch.empty((q,), dtype=f64, device=dev),
            torch.empty((), dtype=f64, device=dev),
            rows((width, n, q), 1), rows((width, n, d), 2),
            rows((width, n), 4),
            rows((n, q), 1), rows((n, d), 2), rows((n,), 4))


def _launch_bwd(log_sf2, log_ell, z, x, y, w, gb, gc, gd, flags, slots):
    """The bare backward launch (the operator's implementation): device
    checks are the caller's.  d log_sf2 gets gb b (b = sf2 sum w) here."""
    args = bwd_launch_args(log_sf2, log_ell, z, x, y, w, gb, gc, gd, flags,
                           slots)
    _k.reg_stats_bwd(*args)
    LAUNCHES["bwd_" + str(args[0].dtype).removeprefix("torch.")] += 1
    (dz, dell, dsf2), (dx, dy, dw) = args[-9:-6], args[-3:]
    b = torch.exp(log_sf2.double()) * w.double().sum()
    dsf2 = dsf2 + gb.double() * b
    return (dsf2.to(log_sf2.dtype), dell.to(log_ell.dtype), dz.to(z.dtype),
            dx.to(x.dtype), dy.to(y.dtype), dw.to(w.dtype))


class _RegStats(torch.autograd.Function):
    """Forward: the operator (the CUDA kernel).  Backward: the backward
    operator (the CUDA backward kernel)."""

    @staticmethod
    def forward(ctx, log_sf2, log_ell, z, x, y, w):
        ctx.save_for_backward(log_sf2, log_ell, z, x, y, w)
        return torch.ops.repro_torch.reg_stats(log_sf2, log_ell, z, x, y, w)

    @staticmethod
    def backward(ctx, gb, gc, gd):
        needs = ctx.needs_input_grad
        grads = torch.ops.repro_torch.reg_stats_bwd(
            *ctx.saved_tensors, gb, gc, gd, _build.row_flags(needs))
        return tuple(g if need else None for g, need in zip(grads, needs))
