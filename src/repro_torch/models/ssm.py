"""Mamba-2 SSD (state-space duality) block: chunked, attention-free.

Port of ``repro.models.ssm``.  Train/prefill run the quadratic-within-chunk,
recurrent-across-chunk SSD algorithm; decode keeps a constant-size
(H, P, N) state per layer.  The JAX package's four-operand einsums are
written here as pairwise contractions, each a batched matmul or a
broadcast product, so no (B, nc, cs, cs, H, P)-sized intermediate is made
at full width; the recurrence across chunks is a Python loop over the
chunks (the JAX package's x64 branch unrolls it the same way).

Block layout (mamba2): in_proj -> [z | x | B | C | dt]; depthwise causal
conv over [x|B|C]; silu; SSD; gated RMSNorm(y * silu(z)); out_proj.
Single B/C group (n_groups=1), scalar A per head (log-parametrised).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .common import Leaf, rmsnorm


def dims(cfg):
    d_inner = cfg.ssm_expand * cfg.d_model
    n_heads = cfg.ssm_heads or d_inner // cfg.ssm_head_dim
    return d_inner, n_heads, cfg.ssm_head_dim, cfg.ssm_state_dim


def init_ssd(cfg) -> dict:
    d_inner, h, _, n = dims(cfg)
    conv_dim = d_inner + 2 * n
    return {"w_in": Leaf((cfg.d_model, 2 * d_inner + 2 * n + h),
                         logical=("embed", "inner")),
            "conv_w": Leaf((conv_dim, cfg.conv_kernel),
                           logical=("inner", "conv")),
            "conv_b": Leaf((conv_dim,), "zeros", logical=("inner",)),
            "a_log": Leaf((h,), "zeros", logical=(None,)),
            "dt_bias": Leaf((h,), "zeros", logical=(None,)),
            "d_skip": Leaf((h,), "ones", logical=(None,)),
            "norm": Leaf((d_inner,), "zeros", logical=(None,)),
            "w_out": Leaf((d_inner, cfg.d_model), logical=("inner", "embed"))}


def _causal_conv(x, w, b):
    """Depthwise causal conv in f32: x (B,T,C), w (C,K) -> (B,T,C) in x's
    dtype; out[t] = b + sum_k w[:, k] * x[t - K + 1 + k] (zeros before the
    start), the K taps summed in order."""
    k = w.shape[1]
    t = x.shape[1]
    xp = F.pad(x.float(), (0, 0, k - 1, 0))
    w32 = w.float()
    out = xp[:, 0:t] * w32[:, 0]
    for j in range(1, k):
        out = out + xp[:, j:j + t] * w32[:, j]
    return (out + b.float()).to(x.dtype)


def _segsum(a):
    """a (..., T) -> (..., T, T): sum_{j<i<=t} with -inf above diagonal."""
    t = a.shape[-1]
    cs = torch.cumsum(a, dim=-1)
    d = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((t, t), dtype=torch.bool, device=a.device))
    return torch.where(mask, d, float("-inf"))


def ssd_scan(x, a, b_in, c_in, chunk: int, init_state=None):
    """SSD: x (B,T,H,P), a (B,T,H) [log decay, <=0], b/c (B,T,N) shared
    across heads.  Returns (y (B,T,H,P) in x's dtype, final_state
    (B,H,P,N) f32).  A ragged T is padded to whole chunks with zeros (no
    decay, no input), then sliced off."""
    bsz, t, h, p_dim = x.shape
    n = b_in.shape[-1]
    cs = min(chunk, t)
    pad = (-t) % cs
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        a = F.pad(a, (0, 0, 0, pad))
        b_in = F.pad(b_in, (0, 0, 0, pad))
        c_in = F.pad(c_in, (0, 0, 0, pad))
    nc = x.shape[1] // cs
    xb = x.reshape(bsz, nc, cs, h, p_dim).float()
    a32 = a.reshape(bsz, nc, cs, h).permute(0, 3, 1, 2).float()  # (B,H,nc,cs)
    bb = b_in.reshape(bsz, nc, cs, n).float()
    cb = c_in.reshape(bsz, nc, cs, n).float()

    acum = torch.cumsum(a32, dim=-1)                          # (B,H,nc,cs)
    l_mat = torch.exp(_segsum(a32))                           # (B,H,nc,l,s)

    # intra-chunk (diagonal blocks): (C B^T) * L, then against x
    cbt = torch.einsum("bcln,bcsn->bcls", cb, bb)             # (B,nc,l,s)
    m = cbt[:, None] * l_mat                                  # (B,H,nc,l,s)
    y_diag = torch.einsum("bhcls,bcshp->bclhp", m, xb)

    # chunk-final states
    decay_states = torch.exp(acum[..., -1:] - acum)           # (B,H,nc,cs)
    xd = xb * decay_states.permute(0, 2, 3, 1)[..., None]     # (B,nc,cs,H,P)
    states = torch.einsum("bcln,bclhp->bchpn", bb, xd)        # (B,nc,H,P,N)

    # inter-chunk recurrence: S_{c+1} = exp(sum a_c) S_c + states_c
    chunk_decay = torch.exp(acum[..., -1])                    # (B,H,nc)
    carry = (torch.zeros((bsz, h, p_dim, n), dtype=torch.float32,
                         device=x.device)
             if init_state is None else init_state.float())
    prev = []
    for ci in range(nc):
        prev.append(carry)                                    # state BEFORE chunk
        carry = chunk_decay[..., ci][..., None, None] * carry + states[:, ci]
    prev_states = torch.stack(prev, dim=1)                    # (B,nc,H,P,N)

    # inter-chunk contribution
    state_decay = torch.exp(acum)                             # (B,H,nc,cs)
    y_off = torch.einsum("bcln,bchpn->bclhp", cb, prev_states)
    y_off = y_off * state_decay.permute(0, 2, 3, 1)[..., None]

    y = (y_diag + y_off).reshape(bsz, nc * cs, h, p_dim)[:, :t]
    return y.to(x.dtype), carry


def _split_proj(cfg, proj):
    d_inner, h, _, n = dims(cfg)
    return torch.split(proj, [d_inner, d_inner, n, n, h], dim=-1)


def ssd_forward(cfg, p, x, *, init=None):
    """Full block.  x (B,T,D) -> (y (B,T,D), state dict ``{"ssd", "conv"}``:
    the final SSD state and the last K-1 conv inputs)."""
    d_inner, h, p_dim, n = dims(cfg)
    proj = x @ p["w_in"].to(x.dtype)
    z, xs, b_in, c_in, dt = _split_proj(cfg, proj)
    conv_in = torch.cat([xs, b_in, c_in], dim=-1)
    conv = F.silu(_causal_conv(conv_in, p["conv_w"], p["conv_b"]))
    xs, b_in, c_in = torch.split(conv, [d_inner, n, n], dim=-1)
    dt = F.softplus(dt.float() + p["dt_bias"].float())       # (B,T,H)
    a = -torch.exp(p["a_log"].float())[None, None, :] * dt
    xh = xs.reshape(*xs.shape[:2], h, p_dim)
    xd = xh * dt[..., None].to(xs.dtype)
    y, state = ssd_scan(xd, a, b_in, c_in, cfg.ssm_chunk,
                        init_state=init["ssd"] if init else None)
    skip = p["d_skip"].float()[None, None, :, None] * xh.float()
    y = (y.float() + skip).to(x.dtype)
    y = y.reshape(*x.shape[:2], d_inner)
    y = rmsnorm(y * F.silu(z), p["norm"])
    out = y @ p["w_out"].to(x.dtype)
    conv_tail = conv_in[:, -(cfg.conv_kernel - 1):, :]
    return out, {"ssd": state, "conv": conv_tail}


def init_ssd_cache(cfg, batch: int, dtype, device) -> dict:
    d_inner, h, p_dim, n = dims(cfg)
    conv_dim = d_inner + 2 * n
    return {
        "ssd": torch.zeros((batch, h, p_dim, n), dtype=torch.float32,
                           device=device),
        "conv": torch.zeros((batch, cfg.conv_kernel - 1, conv_dim),
                            dtype=dtype, device=device),
    }


def ssd_decode(cfg, p, x_t, cache: dict):
    """Single-token step.  x_t (B,1,D) -> (y (B,1,D), new cache); the cache
    passed in is left as it was.

    It rounds to the compute dtype where ``ssd_forward`` does (the conv
    output before its silu, x * dt before the state update, the SSD output
    before the skip term), so that at bf16 a decoded token is computed as
    the prefill computes it.  The JAX package's step keeps those three in
    f32, and its bf16 decode leaves its own prefill by more than the 2e-2
    tier at full width (ROADMAP Queue 3 item 20); in f32 the two are the
    same function."""
    d_inner, h, p_dim, n = dims(cfg)
    dtype = x_t.dtype
    proj = x_t @ p["w_in"].to(dtype)
    z, xs, b_in, c_in, dt = _split_proj(cfg, proj)
    conv_in = torch.cat([xs, b_in, c_in], dim=-1)            # (B,1,C)
    win = torch.cat([cache["conv"], conv_in], dim=1)         # (B,K,C)
    conv = torch.einsum("bkc,ck->bc", win.float(), p["conv_w"].float())
    conv = F.silu((conv + p["conv_b"].float()).to(dtype))
    xs, b_in, c_in = torch.split(conv, [d_inner, n, n], dim=-1)
    dt = F.softplus(dt[:, 0].float() + p["dt_bias"].float())  # (B,H)
    a = torch.exp(-torch.exp(p["a_log"].float())[None] * dt)
    xh = xs.reshape(-1, h, p_dim)
    xd = (xh * dt[..., None].to(dtype)).float()
    st = a[..., None, None] * cache["ssd"] + xd[..., None] * b_in.float()[
        :, None, None, :]
    y = torch.einsum("bhpn,bn->bhp", st, c_in.float()).to(dtype)
    y = (y.float() + p["d_skip"].float()[None, :, None] * xh.float()).to(dtype)
    y = rmsnorm(y.reshape(-1, 1, d_inner) * F.silu(z), p["norm"])
    out = y @ p["w_out"].to(dtype)
    return out, {"ssd": st, "conv": win[:, 1:]}
