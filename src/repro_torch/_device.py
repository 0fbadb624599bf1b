"""Device resolution for the port's entry points.

Every entry point (``SGPR``, ``BayesianGPLVM``, ``extract_state``,
``PredictEngine``, ``load_state``, and for the LM ``init_params``,
``init_decode_cache`` and ``lm_params_from_numpy``) takes ``device=``.
``None`` means the card: the port is written for CUDA, so a machine
without one raises instead of silently running the plain CPU versions.  Callers that want the CPU (the tests) say
so with ``device="cpu"``.
"""
from __future__ import annotations

import os

import numpy as np
import torch


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda``; raise if CUDA is asked for and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on CUDA by default and no CUDA device is "
            "available; pass device='cpu' to run the plain CPU versions")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def rank_device(device=None) -> torch.device:
    """Like :func:`resolve_device`, but ``None`` is this process's card:
    ``cuda:{LOCAL_RANK}`` under a launcher (``torchrun``), else the current
    CUDA device; a CUDA device always comes back with its index.  The
    distributed entry points resolve through it."""
    dev = resolve_device("cuda" if device is None else device)
    if dev.type == "cuda" and dev.index is None:
        local = os.environ.get("LOCAL_RANK") if device is None else None
        dev = torch.device("cuda", int(local) if local is not None
                           else torch.cuda.current_device())
    return dev


def as_f64(v, device) -> torch.Tensor:
    """A tensor or array as an f64 tensor on ``device`` (arrays are copied,
    so read-only numpy buffers are fine)."""
    if not isinstance(v, torch.Tensor):
        v = torch.from_numpy(np.array(v, dtype=np.float64))
    return v.to(device=device, dtype=torch.float64)
