"""Wrapper of the fused regression-statistics kernel: ``reg_stats``.

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

The CUDA path has no gradient yet (the ``autograd.Function`` with the dense
backward comes with training), so it refuses inputs that require grad
rather than return wrong gradients silently.
"""
from __future__ import annotations

import math

import torch

from . import kernel as _k
from . import ref as _ref

#: launches of the CUDA kernel since the counts were last reset, by tile dtype
LAUNCHES = {"float32": 0, "float64": 0}

_MAX_TILES = 65535   # gridDim.y of the tile pass


def _plan(n: int, m: int, device) -> tuple[int, int, int]:
    """(D tiles, n-slices, rows per slice): enough blocks for ~4 per SM."""
    nts = -(-m // _k.TILE)
    n_tiles = nts * (nts + 1) // 2
    if n_tiles > _MAX_TILES:
        raise ValueError(f"m={m} needs {n_tiles} D tiles; the kernel takes "
                         f"at most {_MAX_TILES}")
    chunks = max(1, -(-n // _k.ROWS))
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    n_slices = max(1, min(chunks, math.ceil(4 * sms / n_tiles)))
    rows = -(-chunks // n_slices) * _k.ROWS
    return n_tiles, max(1, -(-n // rows)), rows


def reg_stats(hyp: dict, z, x, y, w):
    """``(b, C, D)``: ``sf2·Σw`` (), ``knmᵀ(w⊙Y)`` (m, d) and
    ``(knm⊙w)ᵀknm`` (m, m) for x (n, q), y (n, d), w (n,), z (m, q), in
    x's dtype.  On CUDA the (n, m) slab is never stored."""
    if x.device.type == "cpu":
        return _ref.reg_stats_ref(hyp["log_sf2"].to(x.dtype),
                                  hyp["log_ell"].to(x.dtype), z, x, y, w)
    operands = (z, x, y, w, hyp["log_sf2"], hyp["log_ell"])
    if x.device.type != "cuda" or any(t.device != x.device for t in operands):
        raise ValueError("reg_stats: every operand must be on one CUDA "
                         f"device, got {[str(t.device) for t in operands]}")
    if any(t.requires_grad for t in operands):
        raise RuntimeError(
            "reg_stats on CUDA has no backward yet (it comes with training); "
            "call it under torch.no_grad() or on detached tensors")
    n, q = x.shape
    m, d = z.shape[0], y.shape[1]
    if z.shape != (m, q) or y.shape != (n, d) or w.shape != (n,) \
            or hyp["log_ell"].shape != (q,) or m < 1:
        raise ValueError(
            f"reg_stats: shapes x {tuple(x.shape)}, y {tuple(y.shape)}, "
            f"w {tuple(w.shape)}, z {tuple(z.shape)}, "
            f"log_ell {tuple(hyp['log_ell'].shape)} do not agree")

    f64 = torch.float64
    dt = f64 if x.dtype == f64 else torch.float32
    xs, ys, ws, zs = (t.to(dt).contiguous() for t in (x, y, w, z))
    hp = torch.cat([torch.exp(hyp["log_sf2"]).reshape(1),
                    torch.exp(-2.0 * hyp["log_ell"])]).to(dt).contiguous()
    n_tiles, n_slices, rows = _plan(n, m, x.device)
    m_pad = -(-m // _k.TILE) * _k.TILE
    dev = x.device
    part_d = torch.empty((n_slices, n_tiles, _k.TILE, _k.TILE), dtype=dt,
                         device=dev)
    part_c = torch.empty((n_slices, m_pad, d), dtype=dt, device=dev)
    part_b = torch.empty((n_slices,), dtype=dt, device=dev)
    d_out = torch.empty((m, m), dtype=f64, device=dev)
    c_out = torch.empty((m, d), dtype=f64, device=dev)
    b_out = torch.empty((), dtype=f64, device=dev)
    _k.reg_stats(xs, ys, ws, zs, hp, n_slices, rows, part_d, part_c, part_b,
                 d_out, c_out, b_out)
    LAUNCHES[str(dt).removeprefix("torch.")] += 1
    return b_out.to(x.dtype), c_out.to(x.dtype), d_out.to(x.dtype)
