"""Where a bf16 decode step departs from the forward's last row.

    python3 tools/decode_gap.py               # full width, on the card
    python3 tools/decode_gap.py --device cpu --small

recurrentgemma-9b's local-attention mixer (d_model 4096, 16 heads, one KV
head, Dh 256, window 2048) at full width, random bf16 weights (seed 0) and
a random bf16 input of B 4 x T 3,072 (1.5 windows).  The decode path is a
prefill of the first T-1 rows (``_gqa_cache_from_seq``: the rolled window
cache), then ``gqa_decode`` of row T-1; the forward path is ``gqa_forward``
over all T rows, read at row T-1.  Each op of the two paths is replayed
with the functions' own shapes (so the same kernels run), each path on its
own inputs, and compared:

* ``proj_*``: the q/k/v and output projections (bf16 GEMMs, M = B for the
  decode step, M = B T for the forward), each also against the f32 product
  of the same bf16 operands rounded once to bf16 (``frac_off_f32``: the
  share of outputs that are not that rounding);
* ``rope_*``, ``cache_k``/``cache_v`` (the prefilled cache against the
  forward's K/V at the window's positions), ``scores``, ``probs`` and
  ``attn_f32`` (the attention output in f32 before its bf16 rounding);
* ``attn_bf16`` and ``mixer_out``: the rounded output and after ``wo``.

Each entry: relative RMS, max |diff| and the share of elements that differ.
The replay is checked bitwise against ``gqa_forward`` and ``gqa_decode``.
Then deepseek-v2's MLA (``mla_replay``, B 4 x T 2,048), recurrentgemma's
RG-LRU and mamba2's SSD (each decode step from the state after T-1 rows
against the forward's row T-1), at full width with bf16 compute.
The whole run is made with ``torch.backends.cuda.matmul.
allow_bf16_reduced_precision_reduction`` as PyTorch sets it (True) and
again set False; TF32 is off.  Then a table of bf16 GEMMs at M = B (a
decode step) and M = B T (a prefill) over the five configs' projection
shapes gives ``frac_off_f32`` for each.  Prints one JSON line a run, and
the card's name and power limit.
"""
import argparse
import dataclasses
import json
import os
import subprocess
import sys

import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import attention as attn  # noqa: E402
from repro_torch.models import rglru, ssm  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402
from repro_torch.models.common import apply_rope, materialize  # noqa: E402

# (K, N) of the bf16 projections a decode step runs: recurrentgemma's
# q/wo, k/v and MLP; deepseek's and qwen3-moe's expert and attention shapes
GEMM_SHAPES = ((4096, 4096), (4096, 256), (4096, 12288), (12288, 4096),
               (5120, 1536), (1536, 5120), (4096, 1536), (1536, 4096),
               (5120, 1536 + 64), (4096, 8192))


def diff(got, want) -> dict:
    d = got.double() - want.double()
    return {"rel": float(d.norm() / want.double().norm()),
            "max_abs": float(d.abs().max()),
            "frac_diff": float((got != want).double().mean())}


def off_f32(y, a, w) -> float:
    """Share of the bf16 product ``y`` of a @ w that is not the f32 product
    of the same operands rounded once."""
    return float((y != (a.float() @ w.float()).to(y.dtype)).double().mean())


def replay(cfg, p, x, b, t):
    """Both paths op by op; returns the comparisons."""
    w, dh = cfg.local_window, attn.head_dim(cfg)
    hkv, h = cfg.num_kv_heads, cfg.num_heads
    group = h // hkv
    dev = x.device
    positions = torch.arange(t, device=dev)[None].expand(b, t)
    pos = torch.full((b,), t - 1, dtype=torch.int32, device=dev)
    out = {}
    x_t = x[:, -1:]
    # projections: the forward's last row against the decode step's
    proj_f, proj_d = {}, {}
    for n in "qkv":
        wn = p[f"w{n}"]
        proj_f[n] = (x @ wn)[:, -1:]
        proj_d[n] = x_t @ wn
        out[f"proj_{n}"] = diff(proj_d[n], proj_f[n])
        out[f"proj_{n}"]["frac_off_f32_decode"] = off_f32(proj_d[n], x_t, wn)
        out[f"proj_{n}"]["frac_off_f32_forward"] = off_f32(proj_f[n], x_t, wn)
    # RoPE of each path's own projection, and of the same input at one row
    # against many rows
    q_f, k_f, v_f = attn._qkv(cfg, p, x, positions)
    q_d, k_d, v_d = attn._qkv(cfg, p, x_t, pos[:, None])
    for n, got, want in (("q", q_d, q_f), ("k", k_d, k_f)):
        out[f"rope_{n}"] = diff(got, want[:, -1:])
    one = (x @ p["wq"]).reshape(b, t, h, dh)
    out["rope_q_same_input"] = diff(
        apply_rope(one[:, -1:], positions[:, -1:], cfg.rope_theta),
        apply_rope(one, positions, cfg.rope_theta)[:, -1:])
    out["v"] = diff(v_d, v_f[:, -1:])
    # the prefilled cache (T-1 rows) against the forward's K/V at the
    # window's positions t-w .. t-2, in position order
    cache = tf._gqa_cache_from_seq(cfg, p, x[:, :-1], positions[:, :-1],
                                   window=w)
    order = torch.argsort(cache["pos"][0].long())
    keep = order[cache["pos"][0, order] > t - 1 - w]
    first = t - 1 - (len(keep))
    for n, full in (("k", k_f), ("v", v_f)):
        out[f"cache_{n}"] = diff(cache[n][:, keep], full[:, first:t - 1])
    # the decode step's attention, as gqa_decode computes it
    s_len = cache["k"].shape[1]
    slot = (pos % s_len).long()
    bidx = torch.arange(b, device=dev)
    ck = cache["k"].index_put((bidx, slot), k_d[:, 0])
    cv = cache["v"].index_put((bidx, slot), v_d[:, 0])
    cpos = cache["pos"].index_put((bidx, slot), pos.to(torch.int32))
    qb = q_d.reshape(b, hkv, group, dh)
    sc_d = torch.einsum("bhgd,bshd->bhgs", qb.float(), ck.float()) * dh ** -0.5
    valid = (cpos >= 0) & (cpos <= pos[:, None]) & (cpos > pos[:, None] - w)
    sc_d = torch.where(valid[:, None, None, :], sc_d, attn.NEG_INF)
    pr_d = torch.softmax(sc_d, dim=-1)
    o_d = torch.einsum("bhgs,bshd->bhgd", pr_d, cv.float())
    o_d = o_d.reshape(b, 1, h * dh)
    # the forward's last chunk, as _attend_chunked computes it
    c = min(512, t)
    pad = (-t) % c
    qp = torch.nn.functional.pad(q_f, (0, 0, 0, 0, 0, pad)) if pad else q_f
    start = t + pad - c
    qi = qp[:, start:start + c].float().reshape(b, c, hkv, group, dh)
    sc_f = torch.einsum("bcngd,bsnd->bngcs", qi, k_f.float()) * dh ** -0.5
    row = start + torch.arange(c, device=dev)
    col = torch.arange(t, device=dev)
    ok = (col[None, :] <= row[:, None]) & (col[None, :] > row[:, None] - w)
    sc_f = torch.where(ok, sc_f, attn.NEG_INF)
    pr_f = torch.softmax(sc_f, dim=-1)
    o_f = torch.einsum("bngcs,bsnd->bcngd", pr_f, v_f.float())
    last = t - 1 - start
    o_f = o_f[:, last:last + 1].reshape(b, 1, h * dh)
    # scores and probabilities at the window's positions, in position order
    slot_of = torch.argsort(cpos[0].long())
    in_win = slot_of[cpos[0, slot_of] > t - 1 - w]
    cols = cpos[0, in_win].long()
    out["scores"] = diff(sc_d[..., in_win].reshape(b, h, -1),
                         sc_f[..., last, :][..., cols].reshape(b, h, -1))
    out["probs"] = diff(pr_d[..., in_win].reshape(b, h, -1),
                        pr_f[..., last, :][..., cols].reshape(b, h, -1))
    out["attn_f32"] = diff(o_d, o_f)
    out["attn_bf16"] = diff(o_d.to(x.dtype), o_f.to(x.dtype))
    y_d = o_d.to(x.dtype) @ p["wo"]
    o_all = attn._attend_chunked(q_f, k_f, v_f, causal=True, window=w)
    o_all = o_all.reshape(b, t, h * dh)
    out["attn_row_is_replay"] = bool(torch.equal(o_all[:, -1:],
                                                 o_f.to(x.dtype)))
    y_f = (o_all @ p["wo"])[:, -1:]
    out["proj_o_same_input"] = diff(o_all[:, -1:] @ p["wo"], y_f)
    out["mixer_out"] = diff(y_d, y_f)
    # the replay is what the functions compute
    fwd = attn.gqa_forward(cfg, p, x, positions, window=w)[:, -1:]
    dec, _ = attn.gqa_decode(cfg, p, x_t, cache, pos)
    out["replay_is_forward"] = bool(torch.equal(y_f, fwd))
    out["replay_is_decode"] = bool(torch.equal(y_d, dec))
    out["functions"] = diff(dec, fwd)
    return out


def mla_replay(cfg, p, x, b, t):
    """deepseek-v2's MLA: the absorbed ``mla_decode`` after a prefill of T-1
    rows against ``mla_forward``'s row T-1, and against the same forward
    with its decompressed K and V kept in f32 (no bf16 rounding of
    c_kv @ W_kb and c_kv @ W_vb): the attention output in f32 before its
    bf16 rounding, the rounded output and after ``wo``."""
    h, lora = cfg.num_heads, cfg.kv_lora_rank
    nope, rope, dv = (cfg.qk_nope_head_dim, cfg.qk_rope_head_dim,
                      cfg.v_head_dim)
    dev = x.device
    positions = torch.arange(t, device=dev)[None].expand(b, t)
    pos = torch.full((b,), t - 1, dtype=torch.int32, device=dev)
    out = {}
    # decode: the prefill's compressed cache grown to T slots, then the
    # absorbed step as mla_decode computes it
    pre = tf._mla_cache_from_seq(cfg, p, x[:, :-1], positions[:, :-1])
    cache = attn.init_mla_cache(cfg, b, t, x.dtype, dev)
    for n, a in pre.items():
        cache[n][:, :t - 1] = a
    q_nope, q_rope, c_kv_t, k_rope_t = attn._mla_qkv(cfg, p, x[:, -1:],
                                                     pos[:, None])
    ck = cache["c_kv"].clone()
    ck[:, t - 1] = c_kv_t[:, 0]
    kr = cache["k_rope"].clone()
    kr[:, t - 1] = k_rope_t[:, 0]
    q_eff = torch.einsum("bhd,lhd->bhl", q_nope[:, 0].float(),
                         p["wk_b"].reshape(lora, h, nope).float())
    sc = torch.einsum("bhl,bsl->bhs", q_eff, ck.float())
    sc = sc + torch.einsum("bhd,bsd->bhs", q_rope[:, 0].float(), kr.float())
    pr = torch.softmax(sc * (nope + rope) ** -0.5, dim=-1)
    ctx = torch.einsum("bhs,bsl->bhl", pr, ck.float())
    o_d = torch.einsum("bhl,lhv->bhv", ctx, p["wv_b"].reshape(
        lora, h, dv).float()).reshape(b, 1, h * dv)
    dec, _ = attn.mla_decode(cfg, p, x[:, -1:], cache, pos)
    out["replay_is_decode"] = bool(torch.equal(o_d.to(x.dtype) @ p["wo"],
                                               dec))
    # forward: K and V decompressed in x's dtype (mla_forward), or in f32
    q_nope, q_rope, c_kv, k_rope = attn._mla_qkv(cfg, p, x, positions)
    q = torch.cat([q_nope, q_rope], dim=-1)
    fwd = attn.mla_forward(cfg, p, x, positions)[:, -1:]
    for label, dt in (("forward", x.dtype), ("forward_kv_f32",
                                             torch.float32)):
        k_nope = (c_kv.to(dt) @ p["wk_b"].to(dt)).reshape(b, t, h, nope)
        v = (c_kv.to(dt) @ p["wv_b"].to(dt)).reshape(b, t, h, dv)
        k = torch.cat([k_nope, k_rope.to(dt)[:, :, None, :].expand(
            b, t, h, rope)], dim=-1)
        # the last chunk's rows in f32 (_attend_chunked rounds its output
        # to q's dtype: here q stays f32 so the output does too)
        o_f = attn._attend_chunked(q[:, -512:].float(), k, v, causal=True,
                                   window=None)[:, -1:].reshape(b, 1, h * dv)
        y_f = o_f.to(x.dtype) @ p["wo"]
        out[f"{label}_attn_f32"] = diff(o_d, o_f)
        out[f"{label}_attn_bf16"] = diff(o_d.to(x.dtype), o_f.to(x.dtype))
        out[f"{label}_mixer_out"] = diff(dec, y_f)
        if dt == x.dtype:   # the replay is what mla_forward computes
            o_x = attn._attend_chunked(q[:, -512:], k, v, causal=True,
                                       window=None)[:, -1:]
            out["replay_is_forward"] = bool(torch.equal(
                o_x.reshape(b, 1, h * dv) @ p["wo"], fwd))
    out["functions"] = diff(dec, fwd)
    return out


def recurrent_replay(cfg, mod, kind, p, x):
    """An SSD or RG-LRU mixer's decode step from the state after T-1 rows
    against its forward over T rows, read at row T-1."""
    fwd = getattr(mod, f"{kind}_forward")
    dec = getattr(mod, f"{kind}_decode")
    y_f, _ = fwd(cfg, p, x)
    _, state = fwd(cfg, p, x[:, :-1])
    y_d, _ = dec(cfg, p, x[:, -1:], state)
    return diff(y_d, y_f[:, -1:])


def gemm_table(b, t, dev, gen) -> list:
    rows = []
    for k, n in GEMM_SHAPES:
        a = torch.randn((b * t, k), generator=gen, device=dev).to(torch.bfloat16)
        w = (torch.randn((k, n), generator=gen, device=dev)
             * k ** -0.5).to(torch.bfloat16)
        big = (a @ w)[-b:]
        small = a[-b:] @ w
        rows.append({"K": k, "N": n, "frac_off_f32_M_small": off_f32(
            small, a[-b:], w), "frac_off_f32_M_big": off_f32(big, a[-b:], w),
            "M_small_vs_M_big": diff(small, big)})
    return rows


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--small", action="store_true",
                    help="reduced width and T 24, window 8 (a CPU check)")
    args = ap.parse_args()
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config("recurrentgemma-9b")
    b, t = 4, 3072
    if args.small:
        cfg = dataclasses.replace(cfg.reduced(), local_window=8)
        b, t = 2, 12
    gen = torch.Generator(device=dev).manual_seed(0)
    p = materialize(attn.init_gqa(cfg), gen, torch.bfloat16, dev)
    x = torch.randn((b, t, cfg.d_model), generator=gen,
                    device=dev).to(torch.bfloat16)
    mcfg = get_config("deepseek-v2-236b")
    mb, mt = 4, 2048
    if args.small:
        mcfg, mb, mt = mcfg.reduced(), 2, 12
    mp = materialize(attn.init_mla(mcfg), gen, torch.bfloat16, dev)
    mx = torch.randn((mb, mt, mcfg.d_model), generator=gen,
                     device=dev).to(torch.bfloat16)
    rp = materialize(rglru.init_rglru(cfg), gen, torch.bfloat16, dev)
    scfg = get_config("mamba2-370m")
    if args.small:
        scfg = scfg.reduced()
    sp = materialize(ssm.init_ssd(scfg), gen, torch.float32, dev)
    sx = torch.randn((b, t, scfg.d_model), generator=gen,
                     device=dev).to(torch.bfloat16)
    flags = torch.backends.cuda.matmul
    default = flags.allow_bf16_reduced_precision_reduction
    for setting in (default, False):
        flags.allow_bf16_reduced_precision_reduction = setting
        with torch.no_grad():
            res = {"allow_bf16_reduced_precision_reduction": setting,
                   "B": b, "T": t, "window": cfg.local_window,
                   "ops": replay(cfg, p, x, b, t),
                   "mla": mla_replay(mcfg, mp, mx, mb, mt),
                   "rglru": recurrent_replay(cfg, rglru, "rglru", rp, x),
                   "ssd": recurrent_replay(scfg, ssm, "ssd", sp, sx),
                   "gemms": gemm_table(b, min(t, 2048), dev, gen)}
        print(json.dumps(res), flush=True)
    flags.allow_bf16_reduced_precision_reduction = default
    if dev.type == "cuda":
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
