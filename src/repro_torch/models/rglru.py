"""RG-LRU recurrent block (Griffin / RecurrentGemma).

Port of ``repro.models.rglru``.  Recurrence (per channel):

    r_t = sigmoid(W_a xc_t + b_a)              recurrence gate
    i_t = sigmoid(W_i xc_t + b_i)              input gate
    a_t = exp(-c * softplus(Lambda) * r_t)     c = 8
    h_t = a_t h_{t-1} + sqrt(1 - a_t^2) * (i_t * xc_t)

where xc is the width-4 causal conv of the linear branch.  Train/prefill
solve the recurrence with a log-depth scan over time (:func:`linear_scan`,
Hillis-Steele, in place of ``jax.lax.associative_scan``); decode keeps an
O(lru_width) state.  The block multiplies the recurrence output with a
GeLU gate branch (the tanh form, as ``jax.nn.gelu``) and projects back.

Tensor parallelism: under a mesh whose ``model`` axis divides the LRU
width, each rank holds lru / model channels: ``w_x``, ``w_gate``,
``conv_w`` and ``conv_b`` column-parallel on the replicated input
(``copy_to_model``), the conv and the scan per channel, so local, and
``w_out`` row-parallel (``tensor_parallel.row_parallel``).  The gates'
``w_a`` / ``w_i`` are cut by columns, not by rows as the reference's spec
``("lru", None)`` has them (``distributed.sharding.PortAxes``): the
conv output is all-gathered once a layer (``gather_over_model``) and each
rank computes its channels' gates exactly.  The row split would need a
row-parallel sum of the whole (B, T, lru) pre-activation before each rank
kept its channels, two f32 exchanges a layer against one gather in the
compute dtype.  ``b_a``, ``b_i`` and ``lam`` are whole; each rank reads
its channels of them (their gradient summed over ``model``).  The cache
holds the rank's channels.  Where ``model`` does not divide the width,
the block runs whole on every rank.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..distributed import tensor_parallel as tp
from ..distributed.sharding import PortAxes, local_shape
from .common import Leaf
from .ssm import _causal_conv

_C = 8.0


def init_rglru(cfg) -> dict:
    lru = cfg.lru_width or cfg.d_model
    d = cfg.d_model
    by_columns = PortAxes(("lru", None), (None, "lru"))
    return {"w_x": Leaf((d, lru), logical=("embed", "lru")),
            "w_gate": Leaf((d, lru), logical=("embed", "lru")),
            "conv_w": Leaf((lru, cfg.conv_kernel), logical=("lru", "conv")),
            "conv_b": Leaf((lru,), "zeros", logical=("lru",)),
            "w_a": Leaf((lru, lru), logical=by_columns),
            "b_a": Leaf((lru,), "zeros", logical=(None,)),
            "w_i": Leaf((lru, lru), logical=by_columns),
            "b_i": Leaf((lru,), "zeros", logical=(None,)),
            "lam": Leaf((lru,), "ones", logical=(None,)),
            "w_out": Leaf((lru, d), logical=("lru", "embed"))}


def _mine(p, name: str, cols: slice | None):
    """A whole vector leaf, or this rank's channels of it (``cols``)."""
    return p[name] if cols is None else tp.copy_to_model(p[name])[cols]


def _gates(p, xc, cols: slice | None = None):
    """(a, b) of this rank's channels: xc (..., lru / model) the rank's
    conv output, gathered whole for the column-parallel gates."""
    xa = xc if cols is None else tp.gather_over_model(xc, -1)
    r = torch.sigmoid(xa @ p["w_a"].to(xc.dtype)
                      + _mine(p, "b_a", cols).to(xc.dtype)).float()
    i = torch.sigmoid(xa @ p["w_i"].to(xc.dtype)
                      + _mine(p, "b_i", cols).to(xc.dtype)).float()
    lam = F.softplus(_mine(p, "lam", cols).float())
    a = torch.exp(-_C * lam * r)                             # (..., lru) <= 1
    b = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12)) * i * xc.float()
    return a, b


def _split(cfg, p, x):
    """(x, w_x, w_gate, w_out, cols): the weights gathered over ``data``;
    with the channels split, x through ``copy_to_model`` and ``cols`` this
    rank's channels of the whole width (else None)."""
    lru, d = cfg.lru_width or cfg.d_model, x.shape[-1]
    w_x = tp.gather_over_data(p["w_x"], 0, d).to(x.dtype)
    w_gate = tp.gather_over_data(p["w_gate"], 0, d).to(x.dtype)
    w_out = tp.gather_over_data(p["w_out"], 1, d).to(x.dtype)
    n = w_x.shape[1]
    if n == lru:
        return x, w_x, w_gate, w_out, None
    lo = tp.model_index() * n
    return tp.copy_to_model(x), w_x, w_gate, w_out, slice(lo, lo + n)


def _project_out(y, w_out, cols):
    return y @ w_out if cols is None else tp.row_parallel(y, w_out)


def linear_scan(a, b):
    """h_t = a_t h_{t-1} + b_t (h_{-1} = 0) over axis 1 of (B,T,C) tensors,
    by the Hillis-Steele inclusive scan: ceil(log2 T) rounds, round d
    combining each element with the one 2^d steps before it by
    ``(a_l, b_l), (a_r, b_r) -> (a_l a_r, a_r b_l + b_r)``.  Returns h."""
    t = a.shape[1]
    step = 1
    while step < t:
        a, b = (torch.cat([a[:, :step], a[:, step:] * a[:, :-step]], dim=1),
                torch.cat([b[:, :step], a[:, step:] * b[:, :-step]
                           + b[:, step:]], dim=1))
        step *= 2
    return b


def rglru_forward(cfg, p, x, *, init=None):
    """x (B,T,D) -> (y (B,T,D), cache dict ``{"h", "conv"}`` of this
    rank's channels)."""
    x, w_x, w_gate, w_out, cols = _split(cfg, p, x)
    xl = x @ w_x                                             # (B,T,lru)
    xc = _causal_conv(xl, p["conv_w"], p["conv_b"])
    a, b = _gates(p, xc, cols)                               # (B,T,lru) f32
    if init is not None:
        # Fold the carried state in as a virtual step-0 contribution.
        b = torch.cat([b[:, :1] + a[:, :1] * init["h"].float()[:, None],
                       b[:, 1:]], dim=1)
    h = linear_scan(a, b)
    gate = F.gelu(x @ w_gate, approximate="tanh")
    y = _project_out(h.to(x.dtype) * gate, w_out, cols)
    cache = {"h": h[:, -1], "conv": xl[:, -(cfg.conv_kernel - 1):, :]}
    return y, cache


def init_rglru_cache(cfg, batch: int, dtype, device) -> dict:
    lru = local_shape(("lru",), (cfg.lru_width or cfg.d_model,))[0]
    return {
        "h": torch.zeros((batch, lru), dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, cfg.conv_kernel - 1, lru), dtype=dtype,
                            device=device),
    }


def rglru_decode(cfg, p, x_t, cache: dict):
    """Single-token step; x_t (B,1,D).  The cache passed in is left as it
    was."""
    x_t, w_x, w_gate, w_out, cols = _split(cfg, p, x_t)
    xl = x_t @ w_x                                           # (B,1,lru)
    win = torch.cat([cache["conv"], xl], dim=1)              # (B,K,lru)
    xc = torch.einsum("bkc,ck->bc", win.float(), p["conv_w"].float())
    xc = (xc + p["conv_b"].float()).to(x_t.dtype)
    a, b = _gates(p, xc, cols)                               # (B,lru)
    h = a * cache["h"] + b
    gate = F.gelu(x_t @ w_gate, approximate="tanh")
    y = _project_out(h[:, None, :].to(x_t.dtype) * gate, w_out, cols)
    return y, {"h": h, "conv": win[:, 1:]}
