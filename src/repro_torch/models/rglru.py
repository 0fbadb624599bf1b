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
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .common import Leaf
from .ssm import _causal_conv

_C = 8.0


def init_rglru(cfg) -> dict:
    lru = cfg.lru_width or cfg.d_model
    d = cfg.d_model
    return {"w_x": Leaf((d, lru), logical=("embed", "lru")),
            "w_gate": Leaf((d, lru), logical=("embed", "lru")),
            "conv_w": Leaf((lru, cfg.conv_kernel), logical=("lru", "conv")),
            "conv_b": Leaf((lru,), "zeros", logical=("lru",)),
            "w_a": Leaf((lru, lru), logical=("lru", None)),
            "b_a": Leaf((lru,), "zeros", logical=(None,)),
            "w_i": Leaf((lru, lru), logical=("lru", None)),
            "b_i": Leaf((lru,), "zeros", logical=(None,)),
            "lam": Leaf((lru,), "ones", logical=(None,)),
            "w_out": Leaf((lru, d), logical=("lru", "embed"))}


def _gates(p, xc):
    r = torch.sigmoid(xc @ p["w_a"].to(xc.dtype)
                      + p["b_a"].to(xc.dtype)).float()
    i = torch.sigmoid(xc @ p["w_i"].to(xc.dtype)
                      + p["b_i"].to(xc.dtype)).float()
    lam = F.softplus(p["lam"].float())
    a = torch.exp(-_C * lam * r)                             # (..., lru) <= 1
    b = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12)) * i * xc.float()
    return a, b


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
    """x (B,T,D) -> (y (B,T,D), cache dict ``{"h", "conv"}``)."""
    xl = x @ p["w_x"].to(x.dtype)                            # (B,T,lru)
    xc = _causal_conv(xl, p["conv_w"], p["conv_b"])
    a, b = _gates(p, xc)                                     # (B,T,lru) f32
    if init is not None:
        # Fold the carried state in as a virtual step-0 contribution.
        b = torch.cat([b[:, :1] + a[:, :1] * init["h"].float()[:, None],
                       b[:, 1:]], dim=1)
    h = linear_scan(a, b)
    gate = F.gelu(x @ p["w_gate"].to(x.dtype), approximate="tanh")
    y = (h.to(x.dtype) * gate) @ p["w_out"].to(x.dtype)
    cache = {"h": h[:, -1], "conv": xl[:, -(cfg.conv_kernel - 1):, :]}
    return y, cache


def init_rglru_cache(cfg, batch: int, dtype, device) -> dict:
    lru = cfg.lru_width or cfg.d_model
    return {
        "h": torch.zeros((batch, lru), dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, cfg.conv_kernel - 1, lru), dtype=dtype,
                            device=device),
    }


def rglru_decode(cfg, p, x_t, cache: dict):
    """Single-token step; x_t (B,1,D).  The cache passed in is left as it
    was."""
    xl = x_t @ p["w_x"].to(x_t.dtype)                        # (B,1,lru)
    win = torch.cat([cache["conv"], xl], dim=1)              # (B,K,lru)
    xc = torch.einsum("bkc,ck->bc", win.float(), p["conv_w"].float())
    xc = (xc + p["conv_b"].float()).to(x_t.dtype)
    a, b = _gates(p, xc)                                     # (B,lru)
    h = a * cache["h"] + b
    gate = F.gelu(x_t @ p["w_gate"].to(x_t.dtype), approximate="tanh")
    y = (h[:, None, :].to(x_t.dtype) * gate) @ p["w_out"].to(x_t.dtype)
    return y, {"h": h, "conv": win[:, 1:]}
