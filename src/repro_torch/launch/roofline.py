"""Roofline of the LM configs (port of ``repro.launch.roofline``): the
analytic model FLOPs, and the roofline over the dry run's records.

``model_flops`` counts the useful work of a step, 6 * N_active * tokens
(train) or 2 * N_active * tokens (forward only), plus attention;
``chip_smoke.py`` divides it by a train step's time and the bf16 peak for
the MFU.  ``load_cells``, ``roofline_row`` and ``render_md`` read the
records of ``launch.dryrun`` (per rank: FLOPs, bytes, collective bytes)
and turn each into its three lower bounds on the step's time at the
peaks below: compute, memory and collective; the largest is the cell's
bound.  Every such time is analytic, not measured.

  PYTHONPATH=src python -m repro_torch.launch.roofline --mesh single --md

Hardware: one NVIDIA H100 SXM (NVIDIA's H100 data sheet, dense, without
sparsity): 989 TFLOP/s bf16 on the tensor cores, 3.35 TB/s of HBM3, 900
GB/s of NVLink 4 per card -- the SXM row of ``chip_smoke.py``'s ``PEAKS``.
"""
from __future__ import annotations

import argparse
import json
import pathlib

PEAK_FLOPS = 989e12       # bf16 FLOP/s / card
HBM_BW = 3.35e12          # B/s / card
LINK_BW = 900e9           # B/s / card, NVLink 4, all links
PEAKS_NOTE = ("analytic: NVIDIA H100 SXM data-sheet peaks, 989 TFLOP/s "
              "bf16, 3.35 TB/s HBM3, 900 GB/s NVLink 4")
ART = pathlib.Path(__file__).resolve().parents[3] / "artifacts" / \
    "dryrun_torch"


def _active_params(cfg) -> tuple[int, int]:
    """(total params, active-per-token params) from the config, analytic."""
    d = cfg.d_model
    v = cfg.vocab_size
    emb = v * d * (1 if cfg.tie_embeddings else 2)
    total = emb
    active = emb
    for g in cfg.blocks:
        per = 0
        per_active = 0
        if g.mixer in ("attn", "lattn"):
            dh = cfg.head_dim or d // cfg.num_heads
            a = d * cfg.num_heads * dh * 2 + d * cfg.num_kv_heads * dh * 2
            per += a
            per_active += a
        elif g.mixer == "mla":
            qk = cfg.qk_nope_head_dim + cfg.qk_rope_head_dim
            a = (d * cfg.q_lora_rank + cfg.q_lora_rank * cfg.num_heads * qk
                 + d * (cfg.kv_lora_rank + cfg.qk_rope_head_dim)
                 + cfg.kv_lora_rank * cfg.num_heads
                 * (cfg.qk_nope_head_dim + cfg.v_head_dim)
                 + cfg.num_heads * cfg.v_head_dim * d)
            per += a
            per_active += a
        elif g.mixer == "ssd":
            d_inner = cfg.ssm_expand * d
            n = cfg.ssm_state_dim
            a = d * (2 * d_inner + 2 * n + d_inner // cfg.ssm_head_dim) \
                + d_inner * d
            per += a
            per_active += a
        elif g.mixer == "rglru":
            lru = cfg.lru_width or d
            a = d * lru * 2 + lru * lru * 2 + lru * d
            per += a
            per_active += a
        if g.ffn == "mlp":
            mult = 3 if cfg.mlp_type == "swiglu" else 2
            a = mult * d * cfg.d_ff
            per += a
            per_active += a
        elif g.ffn == "moe":
            routed = 3 * d * cfg.moe_d_ff
            per += cfg.num_experts * routed + d * cfg.num_experts
            per_active += cfg.experts_per_token * routed
            if cfg.num_shared_experts:
                sh = 3 * d * (cfg.num_shared_experts * cfg.moe_d_ff)
                per += sh
                per_active += sh
        total += per * g.count
        active += per_active * g.count
    if cfg.family == "encdec":
        dh = cfg.head_dim or d // cfg.num_heads
        enc = cfg.encoder_layers * (
            d * cfg.num_heads * dh * 2 + d * cfg.num_kv_heads * dh * 2
            + 2 * d * cfg.d_ff)
        xattn = sum(g.count for g in cfg.blocks) * (
            d * cfg.num_heads * dh * 2 + d * cfg.num_kv_heads * dh * 2)
        total += enc + xattn
        active += enc + xattn
    return total, active


def model_flops(cfg, shape, n_dev: int) -> float:
    """Analytic useful FLOPs per device per step (attention included)."""
    _, act = _active_params(cfg)
    b, t = shape.global_batch, shape.seq_len
    if shape.kind == "train":
        tokens = b * t
        f = 6.0 * act * tokens
        f += _attn_flops(cfg, b, t, t, train=True)
    elif shape.kind == "prefill":
        tokens = b * t
        f = 2.0 * act * tokens
        f += _attn_flops(cfg, b, t, t, train=False)
    else:  # decode: one token against a length-t cache
        f = 2.0 * act * b
        f += _attn_flops(cfg, b, 1, t, train=False)
    return f / n_dev


def gp_model_flops(gp, n_dev: int) -> float:
    """The paper's map-step cost of one value and gradient of a GP config
    per device, O(n m^2 q) with the psi1 and gradient terms:
    3 n m^2 (2q + 4) / devices (the reference's, value and gradient ~3x
    the forward)."""
    return 3.0 * gp.n * gp.m * gp.m * (2.0 * gp.q + 4.0) / n_dev


def _attn_flops(cfg, b, t_q, t_kv, train: bool) -> float:
    mult = 3.0 if train else 1.0       # fwd + ~2x bwd
    f = 0.0
    for g in cfg.blocks:
        if g.mixer in ("attn", "lattn", "mla"):
            if g.mixer == "mla":
                dh_qk = cfg.qk_nope_head_dim + cfg.qk_rope_head_dim
                dh_v = cfg.v_head_dim
            else:
                dh_qk = dh_v = cfg.head_dim or cfg.d_model // cfg.num_heads
            kv = t_kv
            if g.mixer == "lattn" and cfg.local_window:
                kv = min(cfg.local_window, t_kv)
            # causal halves the average context for full self-attention
            eff = kv / 2.0 if (t_q == t_kv and g.mixer != "lattn") else kv
            f += g.count * 2.0 * b * cfg.num_heads * t_q * eff \
                * (dh_qk + dh_v) * mult
    return f


def load_cells(mesh: str, variant: str | None = None,
               root: pathlib.Path | str = ART) -> list[dict]:
    """The dry run's records under ``root``/``mesh`` (of one variant, or
    all)."""
    out = []
    for fp in sorted((pathlib.Path(root) / mesh).glob("*.json")):
        cell = json.loads(fp.read_text())
        if variant is None or cell.get("variant") in (variant, None):
            out.append(cell)
    return out


def roofline_row(cell: dict) -> dict:
    """A record's three bounds (seconds a step at the peaks), the dominant
    one, the model FLOPs against the counted ones, and the useful FLOPs at
    peak as a share of the bound."""
    fl = cell["flops"]
    by = cell["bytes"]["total"]
    co = cell["collectives"]["total"]
    t_c, t_m, t_l = fl / PEAK_FLOPS, by / HBM_BW, co / LINK_BW
    dom = max(("compute", t_c), ("memory", t_m), ("collective", t_l),
              key=lambda kv: kv[1])
    mf = cell["model_flops"]
    return {
        "arch": cell["arch"], "shape": cell["shape"],
        "variant": cell.get("variant", "baseline"),
        "compute_s": t_c, "memory_s": t_m, "collective_s": t_l,
        "dominant": dom[0], "bound_s": dom[1],
        "flops_dev": fl, "bytes_dev": by, "coll_dev": co,
        "mem_args_GB": cell["memory"]["argument_bytes"] / 1e9,
        "mem_temp_GB": cell["memory"]["temp_bytes"] / 1e9,
        "n_devices": cell["n_devices"],
        "model_flops_dev": mf,
        "model_over_counted": mf / fl if fl else 0.0,
        "roofline_frac": (mf / PEAK_FLOPS) / dom[1] if dom[1] else 0.0,
    }


def render_md(rows: list[dict]) -> str:
    hdr = ("| arch | shape | variant | compute s | memory s | coll s | "
           "dominant | model/counted | roofline frac | args GB | temp GB |\n"
           "|---|---|---|---|---|---|---|---|---|---|---|")
    lines = [hdr]
    for r in rows:
        lines.append(
            f"| {r['arch']} | {r['shape']} | {r['variant']} "
            f"| {r['compute_s']:.3e} | {r['memory_s']:.3e} "
            f"| {r['collective_s']:.3e} | **{r['dominant']}** "
            f"| {r['model_over_counted']:.2f} "
            f"| {r['roofline_frac']:.3f} | {r['mem_args_GB']:.2f} "
            f"| {r['mem_temp_GB']:.2f} |")
    return "\n".join(lines)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--mesh", default="single")
    ap.add_argument("--variant", default=None)
    ap.add_argument("--dir", default=str(ART),
                    help="the dry run's --out")
    ap.add_argument("--md", action="store_true")
    ap.add_argument("--json-out", default="")
    args = ap.parse_args(argv)
    rows = [roofline_row(c) for c in load_cells(args.mesh, args.variant,
                                                args.dir)]
    if args.json_out:
        pathlib.Path(args.json_out).write_text(json.dumps(rows, indent=1))
    print(f"({PEAKS_NOTE})")
    if args.md:
        print(render_md(rows))
    else:
        for r in rows:
            print(f"{r['arch']:>22} {r['shape']:>12} {r['variant']:>9} "
                  f"C {r['compute_s']:.2e}  M {r['memory_s']:.2e}  "
                  f"L {r['collective_s']:.2e}  -> {r['dominant']:<10} "
                  f"frac {r['roofline_frac']:.3f}")


if __name__ == "__main__":
    main()
