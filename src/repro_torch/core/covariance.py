"""Covariance expressions (counterpart of ``repro.core.covariance``).

This slice of the port carries only the paper's kernel, full-width SE-ARD.
Its JSON spec ``{"kind": "se", "dims": null}`` is the one the JAX package
writes into serving sidecars, so states cross between the two packages.
Every other expression (Matern32, Linear, Periodic, Sum, Product, SE on a
subset of dims) is queued in ROADMAP.md, Queue 1 ("Kernel zoo").
"""
from __future__ import annotations

import json
from dataclasses import dataclass

import numpy as np
import torch

from ..kernels.psi_stats import ops as psi_ops
from . import gp_kernels as gpk

_QUEUED = ("only the full-width SE-ARD kernel ({'kind': 'se', 'dims': null}) "
           "is ported; the rest of the kernel zoo is queued in ROADMAP.md, "
           "Queue 1 ('Kernel zoo')")


@dataclass(frozen=True)
class SEARD:
    """Squared-exponential ARD over all input dims: the paper's kernel."""

    kind = "se"
    dims: None = None

    def __post_init__(self):
        if self.dims is not None:
            raise NotImplementedError(_QUEUED)

    def K(self, hyp: dict, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return gpk.se_kernel(hyp, a, b)

    def kdiag(self, hyp: dict, a: torch.Tensor) -> torch.Tensor:
        return gpk.se_kdiag(hyp, a)

    # -- psi statistics under q(X) = N(mu, diag(s)): all closed form --------
    def psi0(self, hyp: dict, mu, s) -> torch.Tensor:
        return gpk.se_psi0(hyp, mu, s)

    def psi1(self, hyp: dict, z, mu, s) -> torch.Tensor:
        """(n, m): the psi1 kernel on CUDA, its plain version on the CPU."""
        return psi_ops.psi1(hyp, z, mu, s)

    def psi2(self, hyp: dict, z, mu, s, w) -> torch.Tensor:
        """Weighted Psi2, the D statistic (m, m): the psi2 kernel on CUDA,
        its plain version on the CPU."""
        return psi_ops.psi2(hyp, z, mu, s, w)

    def psi2_per_point(self, hyp: dict, z, mu, s) -> torch.Tensor:
        """(n, m, m) un-summed psi2 (plain; tests and oracles)."""
        return gpk.psi2_per_point(hyp, z, mu, s)

    def analytic_psi(self) -> bool:
        return True

    def variance_scale(self, hyp: dict) -> torch.Tensor:
        """The signal variance, which scales the Cholesky jitter."""
        return torch.exp(hyp["log_sf2"])

    def hyp_shapes(self, q: int) -> dict:
        return {"log_sf2": (), "log_ell": (q,)}

    def default_hyp(self, q: int, var_y: float = 1.0) -> dict:
        return {"log_sf2": np.log(var_y),
                "log_ell": np.ones((q,)) * 0.5 * np.log(max(q, 1))}

    def to_spec(self) -> dict:
        return {"kind": self.kind, "dims": None}


SE_ARD = SEARD()


def as_kernel(kernel) -> SEARD:
    """None -> SE-ARD; a spec string/dict -> parsed; an expression -> itself."""
    if kernel is None:
        return SE_ARD
    if isinstance(kernel, SEARD):
        return kernel
    if isinstance(kernel, (str, dict)):
        return kernel_from_spec(kernel)
    raise TypeError(f"not a kernel expression: {kernel!r}")


def is_fused_se(kernel) -> bool:
    """True for the full-width SE-ARD: the expression the hand-written
    kernels specialise.  It is the only one this slice ports."""
    return isinstance(as_kernel(kernel), SEARD)


def kernel_from_spec(spec: str | dict) -> SEARD:
    """Inverse of ``to_spec``; also takes the JSON string and the bare kind
    name ``"se"``.  Any other spec raises ``NotImplementedError``."""
    if isinstance(spec, str):
        spec = (json.loads(spec) if spec.lstrip().startswith(("{", "["))
                else {"kind": spec})
    spec = dict(spec)
    if spec.pop("kind", None) != "se" or spec.pop("dims", None) is not None \
            or spec:
        raise NotImplementedError(_QUEUED)
    return SE_ARD
