"""Dense MLPs: SwiGLU (llama/qwen family) and GELU (starcoder2/whisper).
Port of ``repro.models.mlp``.

Under a mesh whose ``model`` axis splits ``mlp`` (``d_ff`` divisible by
it), the products are Megatron's: ``w_gate`` / ``w_up`` (and ``b_up``)
column-parallel on the replicated input (``copy_to_model``), ``w_down``
row-parallel, its partial sums added over ``model``
(``tensor_parallel.row_parallel``), then ``b_down`` added once.  Weights
cut over ``data`` (``embed``, FSDP) are gathered just before use.  Which
split a leaf has is read from its shape: ``d_ff`` columns are whole,
fewer are this rank's block."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..distributed import tensor_parallel as tp
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


def mlp_forward(cfg, p, x: torch.Tensor,
                d_ff: int | None = None) -> torch.Tensor:
    """x (..., D) -> (..., D); ``d_ff`` the whole hidden width (None:
    ``cfg.d_ff``)."""
    d_ff = cfg.d_ff if d_ff is None else d_ff
    d = x.shape[-1]
    w_up = tp.gather_over_data(p["w_up"], 0, d).to(x.dtype)
    w_down = tp.gather_over_data(p["w_down"], 1, d).to(x.dtype)
    split = w_up.shape[1] != d_ff
    if split:
        x = tp.copy_to_model(x)
    down = tp.row_parallel if split else torch.matmul
    if cfg.mlp_type == "swiglu":
        w_gate = tp.gather_over_data(p["w_gate"], 0, d).to(x.dtype)
        return down(F.silu(x @ w_gate) * (x @ w_up), w_down)
    # jax.nn.gelu defaults to the tanh approximation
    h = F.gelu(x @ w_up + p["b_up"].to(x.dtype), approximate="tanh")
    return down(h, w_down) + p["b_down"].to(x.dtype)
