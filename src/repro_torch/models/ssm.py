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

Tensor parallelism: under a mesh whose ``model`` axis divides the heads,
each rank holds a per-head block of the packed leaves
(``distributed.sharding.Packed``): of ``w_in`` the columns of its H /
model heads' ``z``, ``x`` and ``dt`` with ``B`` and ``C`` whole, of
``conv_w`` / ``conv_b`` its ``x`` channels with ``B`` and ``C`` whole, of
``w_out`` its heads' rows.  The reference's spec cuts the packed columns
in one contiguous block (``"inner"``), which straddles ``z`` and ``x``;
its partitioner reshuffles, the port says each collective itself, so it
cuts head by head instead.  The input goes through ``copy_to_model``;
``B`` and ``C`` (and their weights' columns, which every rank reads
alike) through ``copy_to_model`` too, so their gradient is summed over
``model``, as the whole ``wk`` / ``wv`` of attention; the rank's
channels of the whole vectors (``a_log``, ``dt_bias``, ``d_skip``,
``norm``) likewise.  The scan is per head, so local.  The gated RMSNorm
normalises over all of d_inner: each row's sum of squares is summed over
``model`` in f32, in rank order (``tensor_parallel.sum_over_model``), the
same bits on every rank.  ``w_out`` is row-parallel.  The state cache
holds the rank's heads, the conv cache its channels ``x | B | C``.
Where ``model`` does not divide the heads, the block runs whole on every
rank.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..distributed import tensor_parallel as tp
from ..distributed.sharding import Packed, PortAxes, local_shape
from .common import Leaf, rmsnorm


def dims(cfg):
    d_inner = cfg.ssm_expand * cfg.d_model
    n_heads = cfg.ssm_heads or d_inner // cfg.ssm_head_dim
    return d_inner, n_heads, cfg.ssm_head_dim, cfg.ssm_state_dim


def _packed(cfg, *names):
    """The packed dimension of segments ``names`` (of z, x, B, C, dt)."""
    d_inner, h, _, n = dims(cfg)
    seg = {"z": (d_inner, h), "x": (d_inner, h), "B": (n, 0), "C": (n, 0),
           "dt": (h, h)}
    return Packed("inner", tuple(seg[k] for k in names))


def init_ssd(cfg) -> dict:
    d_inner, h, _, n = dims(cfg)
    conv_dim = d_inner + 2 * n
    proj = _packed(cfg, "z", "x", "B", "C", "dt")
    conv = _packed(cfg, "x", "B", "C")
    return {"w_in": Leaf((cfg.d_model, 2 * d_inner + 2 * n + h),
                         logical=PortAxes(("embed", "inner"),
                                          ("embed", proj))),
            "conv_w": Leaf((conv_dim, cfg.conv_kernel),
                           logical=PortAxes(("inner", "conv"),
                                            (conv, "conv"))),
            "conv_b": Leaf((conv_dim,), "zeros",
                           logical=PortAxes(("inner",), (conv,))),
            "a_log": Leaf((h,), "zeros", logical=(None,)),
            "dt_bias": Leaf((h,), "zeros", logical=(None,)),
            "d_skip": Leaf((h,), "ones", logical=(None,)),
            "norm": Leaf((d_inner,), "zeros", logical=(None,)),
            "w_out": Leaf((d_inner, cfg.d_model),
                          logical=PortAxes(("inner", "embed"),
                                           (_packed(cfg, "x"), "embed")))}


def local_heads(cfg) -> int:
    """This rank's SSD heads under the context mesh."""
    h = dims(cfg)[1]
    return local_shape(PortAxes((None,), (_packed(cfg, "dt"),)), (h,))[0]


def _weights(cfg, p, x):
    """(x, this rank's weights by name, its heads): the leaves gathered
    over ``data``; with the heads split, x and the pieces every rank reads
    alike through ``copy_to_model``, the whole vectors cut to the rank's
    heads and channels (module doc)."""
    d_inner, h, p_dim, n = dims(cfg)
    d = x.shape[-1]
    w = {"w_in": tp.gather_over_data(p["w_in"], 0, d),
         "w_out": tp.gather_over_data(p["w_out"], 1, d)}
    hl = (w["w_in"].shape[1] - 2 * n) // (2 * p_dim + 1)
    names = ("conv_w", "conv_b", "a_log", "dt_bias", "d_skip", "norm")
    if hl == h:
        return x, {**w, **{k: p[k] for k in names}}, h
    di = hl * p_dim
    r = tp.model_index()
    w_in = w["w_in"]
    w["w_in"] = torch.cat([w_in[:, :2 * di],
                           tp.copy_to_model(w_in[:, 2 * di:2 * di + 2 * n]),
                           w_in[:, 2 * di + 2 * n:]], dim=1)
    for k in ("conv_w", "conv_b"):
        w[k] = torch.cat([p[k][:di], tp.copy_to_model(p[k][di:])], dim=0)
    for k in ("a_log", "dt_bias", "d_skip"):
        w[k] = tp.copy_to_model(p[k])[r * hl:(r + 1) * hl]
    w["norm"] = tp.copy_to_model(p["norm"])[r * di:(r + 1) * di]
    return tp.copy_to_model(x), w, hl


def _gated_norm(y, z, scale, d_inner: int):
    """RMSNorm(y * silu(z)) over all d_inner channels; y, z this rank's
    channels (the sum of squares summed over ``model`` where they are
    fewer)."""
    v = y * F.silu(z)
    if v.shape[-1] == d_inner:
        return rmsnorm(v, scale)
    v32 = v.float()
    ss = tp.sum_over_model(torch.sum(v32 * v32, dim=-1, keepdim=True))
    out = v32 * torch.rsqrt(ss / d_inner + 1e-6)
    return (out * (1.0 + scale.float())).to(v.dtype)


def _project_out(y, w_out, split: bool):
    w_out = w_out.to(y.dtype)
    return tp.row_parallel(y, w_out) if split else y @ w_out


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


def _split_proj(cfg, proj, h: int):
    """z, x, B, C, dt of ``h`` heads' projection."""
    _, _, p_dim, n = dims(cfg)
    return torch.split(proj, [h * p_dim, h * p_dim, n, n, h], dim=-1)


def ssd_forward(cfg, p, x, *, init=None):
    """Full block.  x (B,T,D) -> (y (B,T,D), state dict ``{"ssd", "conv"}``:
    the final SSD state and the last K-1 conv inputs, of this rank's heads
    and channels)."""
    d_inner, h_all, p_dim, n = dims(cfg)
    x, w, h = _weights(cfg, p, x)
    di = h * p_dim
    proj = x @ w["w_in"].to(x.dtype)
    z, xs, b_in, c_in, dt = _split_proj(cfg, proj, h)
    conv_in = torch.cat([xs, b_in, c_in], dim=-1)
    conv = F.silu(_causal_conv(conv_in, w["conv_w"], w["conv_b"]))
    xs, b_in, c_in = torch.split(conv, [di, n, n], dim=-1)
    dt = F.softplus(dt.float() + w["dt_bias"].float())       # (B,T,H)
    a = -torch.exp(w["a_log"].float())[None, None, :] * dt
    xh = xs.reshape(*xs.shape[:2], h, p_dim)
    xd = xh * dt[..., None].to(xs.dtype)
    y, state = ssd_scan(xd, a, b_in, c_in, cfg.ssm_chunk,
                        init_state=init["ssd"] if init else None)
    skip = w["d_skip"].float()[None, None, :, None] * xh.float()
    y = (y.float() + skip).to(x.dtype)
    y = y.reshape(*x.shape[:2], di)
    y = _gated_norm(y, z, w["norm"], d_inner)
    out = _project_out(y, w["w_out"], h != h_all)
    conv_tail = conv_in[:, -(cfg.conv_kernel - 1):, :]
    return out, {"ssd": state, "conv": conv_tail}


def init_ssd_cache(cfg, batch: int, dtype, device) -> dict:
    _, _, p_dim, n = dims(cfg)
    h = local_heads(cfg)
    conv_dim = h * p_dim + 2 * n
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
    d_inner, h_all, p_dim, n = dims(cfg)
    dtype = x_t.dtype
    x_t, w, h = _weights(cfg, p, x_t)
    di = h * p_dim
    proj = x_t @ w["w_in"].to(dtype)
    z, xs, b_in, c_in, dt = _split_proj(cfg, proj, h)
    conv_in = torch.cat([xs, b_in, c_in], dim=-1)            # (B,1,C)
    win = torch.cat([cache["conv"], conv_in], dim=1)         # (B,K,C)
    conv = torch.einsum("bkc,ck->bc", win.float(), w["conv_w"].float())
    conv = F.silu((conv + w["conv_b"].float()).to(dtype))
    xs, b_in, c_in = torch.split(conv, [di, n, n], dim=-1)
    dt = F.softplus(dt[:, 0].float() + w["dt_bias"].float())  # (B,H)
    a = torch.exp(-torch.exp(w["a_log"].float())[None] * dt)
    xh = xs.reshape(-1, h, p_dim)
    xd = (xh * dt[..., None].to(dtype)).float()
    st = a[..., None, None] * cache["ssd"] + xd[..., None] * b_in.float()[
        :, None, None, :]
    y = torch.einsum("bhpn,bn->bhp", st, c_in.float()).to(dtype)
    y = (y.float() + w["d_skip"].float()[None, :, None] * xh.float()).to(dtype)
    y = _gated_norm(y.reshape(-1, 1, di), z, w["norm"], d_inner)
    out = _project_out(y, w["w_out"], h != h_all)
    return out, {"ssd": st, "conv": win[:, 1:]}
