"""Carry weights across from the JAX package, as numpy arrays.

The port never imports ``repro``; a caller that has both hands over the
JAX objects' arrays (``np.asarray`` of each leaf) and gets the port's.
"""
from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch

from .serve.posterior import _ARRAY_FIELDS, PredictiveState


def _tensor(v, device, dtype=None) -> torch.Tensor:
    return torch.from_numpy(np.array(v)).to(device=device, dtype=dtype)


def params_from_numpy(params: Mapping, device,
                      dtype=torch.float64) -> dict:
    """``repro`` ``SGPR.params`` (``{"hyp": {...}, "z": ...}``) or
    ``BayesianGPLVM.params`` (also ``"mu"`` and ``"log_s"``) -> the port's
    params on ``device`` in ``dtype``."""
    out = {"hyp": {k: _tensor(v, device, dtype)
                   for k, v in params["hyp"].items()}}
    for k in ("z", "mu", "log_s"):
        if k in params:
            out[k] = _tensor(params[k], device, dtype)
    return out


def state_from_numpy(leaves: Mapping, device) -> PredictiveState:
    """A ``repro`` ``PredictiveState``'s leaves, as a mapping of field name
    to array (``hyp`` a mapping of its own), -> the port's state on
    ``device``, each leaf keeping its dtype.  The kernel is SE-ARD, the
    only one this slice ports."""
    return PredictiveState(
        hyp={k: _tensor(v, device) for k, v in leaves["hyp"].items()},
        **{f: _tensor(leaves[f], device) for f in _ARRAY_FIELDS})
