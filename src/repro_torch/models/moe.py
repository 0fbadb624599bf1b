"""Mixture-of-Experts FFN: the router and the exact all-experts path.

Port of the single-device half of ``repro.models.moe``.  ``moe_dense``
applies every expert to every token and combines the outputs by the
renormalised top-k gates: exact, and E / k times the routed FLOPs.  The
experts run one at a time (a loop over E of three products each), and the
combine accumulates in f32 and rounds once, as the JAX package's combining
einsum does; no (E, tokens, D) tensor is made.

``moe_impl="sharded"`` with no process group computes the dense path, as
the JAX package's ``moe_sharded`` does with no mesh.  The expert-parallel
schedule (capacity packing, the int8 all_to_all, experts sharded over a
group) is not ported yet (ROADMAP Queue 1 item 12c); in a world of more
than one rank the sharded path raises rather than replicate every expert
on every rank.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .common import Leaf


def init_moe(cfg) -> dict:
    e, d, dff = cfg.num_experts, cfg.d_model, cfg.moe_d_ff
    return {"router": Leaf((d, e)),
            "w_gate": Leaf((e, d, dff)), "w_up": Leaf((e, d, dff)),
            "w_down": Leaf((e, dff, d))}


def _route(cfg, router_w, x_flat):
    """x_flat (n, D) -> (gates (n,k) in x's dtype, eids (n,k), aux losses:
    the load-balance loss E * sum_e f_e P_e and the router z-loss, f32)."""
    logits = (x_flat @ router_w.to(x_flat.dtype)).float()
    probs = torch.softmax(logits, dim=-1)
    gates, eids = torch.topk(probs, cfg.experts_per_token, dim=-1)
    gates = gates / torch.sum(gates, dim=-1, keepdim=True)
    e = cfg.num_experts
    f = torch.mean(F.one_hot(eids, e).float(), dim=(0, 1))
    pmean = torch.mean(probs, dim=0)
    aux = e * torch.sum(f * pmean)
    zloss = torch.mean(torch.logsumexp(logits, dim=-1) ** 2)
    return gates.to(x_flat.dtype), eids, {"load_balance": aux,
                                          "router_z": zloss}


def moe_dense(cfg, p, x):
    """(B,T,D) exact all-experts path -> (y (B,T,D), aux)."""
    b, t, d = x.shape
    xf = x.reshape(b * t, d)
    gates, eids, aux = _route(cfg, p["router"], xf)
    y = torch.zeros((b * t, d), dtype=torch.float32, device=x.device)
    for e in range(cfg.num_experts):
        h = (F.silu(xf @ p["w_gate"][e].to(x.dtype))
             * (xf @ p["w_up"][e].to(x.dtype)))
        y_e = h @ p["w_down"][e].to(x.dtype)
        comb = torch.sum(gates * (eids == e), dim=-1)        # (n,), 0 if not routed
        y = y + comb[:, None].float() * y_e.float()
    return y.to(x.dtype).reshape(b, t, d), aux


def moe_sharded(cfg, p, x):
    """The expert-parallel path: with no process group of more than one
    rank, the dense path (the JAX package's ``moe_sharded`` without a
    mesh)."""
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized() \
            and dist.get_world_size() > 1:
        raise NotImplementedError(
            "the expert-parallel MoE schedule over a process group is not "
            "ported to repro_torch yet (ROADMAP Queue 1 item 12c)")
    return moe_dense(cfg, p, x)


def moe_forward(cfg, p, x):
    if cfg.moe_impl == "dense":
        return moe_dense(cfg, p, x)
    return moe_sharded(cfg, p, x)
