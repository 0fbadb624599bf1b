"""Carry weights across from the JAX package, as numpy arrays.

The port never imports ``repro``; a caller that has both hands over the
JAX objects' arrays (``np.asarray`` of each leaf) and gets the port's:
the GP params and serving state, and the LM params.
"""
from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch

from ._device import resolve_device
from .core.covariance import as_kernel
from .core.flat import tree_map
from .models.common import Leaf
from .models.transformer import param_spec
from .serve.posterior import _ARRAY_FIELDS, PredictiveState


def _tensor(v, device, dtype=None) -> torch.Tensor:
    return torch.from_numpy(np.array(v)).to(device=device, dtype=dtype)


def params_from_numpy(params: Mapping, device,
                      dtype=torch.float64) -> dict:
    """``repro`` ``SGPR.params`` (``{"hyp": {...}, "z": ...}``) or
    ``BayesianGPLVM.params`` (also ``"mu"`` and ``"log_s"``) -> the port's
    params on ``device`` in ``dtype``; ``hyp`` may nest (a combinator's
    children under ``"k0"``, ...)."""
    out = {"hyp": tree_map(lambda v: _tensor(v, device, dtype),
                           dict(params["hyp"]))}
    for k in ("z", "mu", "log_s"):
        if k in params:
            out[k] = _tensor(params[k], device, dtype)
    return out


def state_from_numpy(leaves: Mapping, device, kernel=None) -> PredictiveState:
    """A ``repro`` ``PredictiveState``'s leaves, as a mapping of field name
    to array (``hyp`` a mapping of its own, nested for a combinator), and
    its kernel expression (a spec or an expression, the state's
    ``kernel.to_spec()``; None: SE-ARD) -> the port's state on ``device``,
    each leaf keeping its dtype."""
    return PredictiveState(
        hyp=tree_map(lambda v: _tensor(v, device), dict(leaves["hyp"])),
        **{f: _tensor(leaves[f], device) for f in _ARRAY_FIELDS},
        kernel=as_kernel(kernel))


def lm_params_from_numpy(cfg, tree: Mapping, device=None) -> dict:
    """``repro.models.transformer.init_params``' params tree, each leaf an
    array, -> the port's params on ``device`` (None: the card), each leaf
    keeping its dtype.  Raises ``ValueError`` where the tree's keys or
    shapes are not those of ``cfg``."""
    dev = resolve_device(device)

    def conv(spec, sub, path):
        if isinstance(spec, Leaf):
            arr = np.array(sub)
            if arr.shape != spec.shape:
                raise ValueError(f"{path}: shape {arr.shape}, {cfg.name} "
                                 f"has {spec.shape}")
            return torch.from_numpy(arr).to(dev)
        if isinstance(spec, list):
            if not isinstance(sub, (list, tuple)) or len(sub) != len(spec):
                raise ValueError(f"{path}: {type(sub).__name__}, {cfg.name} "
                                 f"has a list of {len(spec)} layers")
            return [conv(s, u, f"{path}/{i}")
                    for i, (s, u) in enumerate(zip(spec, sub))]
        keys = sorted(sub) if isinstance(sub, Mapping) else type(sub).__name__
        if keys != sorted(spec):
            raise ValueError(f"{path}: keys {keys}, {cfg.name} has "
                             f"{sorted(spec)}")
        return {k: conv(spec[k], sub[k], f"{path}/{k}") for k in spec}

    return conv(param_spec(cfg), tree, "params")
