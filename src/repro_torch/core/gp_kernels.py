"""SE-ARD covariance on torch tensors (counterpart of ``repro.core.gp_kernels``).

    k(x, x') = sf2 * exp(-0.5 * sum_q (x_q - x'_q)^2 / ell_q^2)

Hyper-parameters are carried in log-space:
``hyp = {"log_sf2": (), "log_ell": (q,), "log_beta": ()}``.
"""
from __future__ import annotations

import torch


def sqdist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Pairwise squared distances between rows of ``a`` (n,q) and ``b`` (m,q).

    Expanded form, with both operands first shifted by a common detached
    anchor: squared distances are shift-invariant, and the shift removes the
    cancellation the raw ``a²+b²-2ab`` form suffers for large-magnitude
    inputs.  Clamped after expansion.

    The anchor is ``b``'s first row, not a batch statistic, so each output
    row depends only on its own inputs: chunked statistics equal monolithic
    ones and padded serving batches equal unpadded ones.
    """
    c = b[0].detach() if b.shape[0] else b.new_zeros(b.shape[-1:])
    ac = a - c
    bc = b - c
    a2 = (ac * ac).sum(-1)[:, None]
    b2 = (bc * bc).sum(-1)[None, :]
    return torch.clamp(a2 + b2 - 2.0 * ac @ bc.T, min=0.0)


def se_kernel(hyp: dict, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """K_ab for the SE-ARD kernel; a: (n,q), b: (m,q) -> (n,m)."""
    ell = torch.exp(hyp["log_ell"])
    sf2 = torch.exp(hyp["log_sf2"])
    return sf2 * torch.exp(-0.5 * sqdist(a / ell, b / ell))


def se_kdiag(hyp: dict, a: torch.Tensor) -> torch.Tensor:
    """diag(K_aa): the constant sf2 for the SE kernel."""
    sf2 = torch.exp(hyp["log_sf2"]).to(a.dtype)
    return sf2.expand(a.shape[:-1])
