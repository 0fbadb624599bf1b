"""Dense MLPs: SwiGLU (llama/qwen family) and GELU (starcoder2/whisper).
Port of ``repro.models.mlp``."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .common import Leaf


def init_mlp(cfg, d_ff: int | None = None) -> dict:
    d_ff = cfg.d_ff if d_ff is None else d_ff
    d = cfg.d_model
    if cfg.mlp_type == "swiglu":
        return {"w_gate": Leaf((d, d_ff), logical=("embed", "mlp")),
                "w_up": Leaf((d, d_ff), logical=("embed", "mlp")),
                "w_down": Leaf((d_ff, d), logical=("mlp", "embed"))}
    return {"w_up": Leaf((d, d_ff), logical=("embed", "mlp")),
            "b_up": Leaf((d_ff,), "zeros", logical=("mlp",)),
            "w_down": Leaf((d_ff, d), logical=("mlp", "embed")),
            "b_down": Leaf((d,), "zeros", logical=(None,))}


def mlp_forward(cfg, p: dict, x: torch.Tensor) -> torch.Tensor:
    if cfg.mlp_type == "swiglu":
        g = F.silu(x @ p["w_gate"].to(x.dtype))
        u = x @ p["w_up"].to(x.dtype)
        return (g * u) @ p["w_down"].to(x.dtype)
    # jax.nn.gelu defaults to the tanh approximation
    h = F.gelu(x @ p["w_up"].to(x.dtype) + p["b_up"].to(x.dtype),
               approximate="tanh")
    return h @ p["w_down"].to(x.dtype) + p["b_down"].to(x.dtype)
