"""Plain PyTorch versions of the psi-statistics kernels.

The SE-ARD closed forms of ``core.gp_kernels`` (direct exponent form), the
same functions as ``csrc/psi_stats.cu``, taken ``chunk`` rows at a time so
that the (chunk, m, m, q) broadcast of psi2 stays bounded and the plain
version runs at full width on the card.  The wrappers take these for CPU
tensors and for the backward recompute; ``chip_smoke.py`` holds the kernels
against them.
"""
from __future__ import annotations

import torch

from ...core import gp_kernels as gpk


def psi1_ref(log_sf2, log_ell, z, mu, s, chunk: int | None = None):
    """(n, m) ``<k(x_i, z_m)>`` under q(x_i) = N(mu_i, diag(s_i))."""
    hyp = {"log_sf2": log_sf2, "log_ell": log_ell}
    step = max(1, chunk or mu.shape[0])
    parts = [gpk.se_psi1(hyp, z, mu[lo:lo + step], s[lo:lo + step])
             for lo in range(0, mu.shape[0], step)]
    return torch.cat(parts) if parts else mu.new_zeros((0, z.shape[0]))


def psi2_ref(log_sf2, log_ell, z, mu, s, w, chunk: int | None = None):
    """(m, m) ``sum_i w_i <k(x_i, z_a) k(x_i, z_b)>`` under q(x_i)."""
    hyp = {"log_sf2": log_sf2, "log_ell": log_ell}
    step = max(1, chunk or mu.shape[0])
    out = mu.new_zeros((z.shape[0], z.shape[0]))
    for lo in range(0, mu.shape[0], step):
        sl = slice(lo, lo + step)
        out = out + torch.einsum("i,iab->ab", w[sl], gpk.psi2_per_point(
            hyp, z, mu[sl], s[sl]))
    return out
