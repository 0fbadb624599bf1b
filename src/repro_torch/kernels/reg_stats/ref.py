"""Plain PyTorch version of the fused regression-statistics kernel.

States the three statistics directly from the SE-ARD definition, the same
function as ``csrc/reg_stats.cu`` with the (n, m) slab held whole.  The
wrapper takes it for CPU tensors; ``chip_smoke.py`` holds the kernel against
it on the card.
"""
from __future__ import annotations

import torch


def reg_stats_ref(log_sf2, log_ell, z, x, y, w):
    """(b (), C (m, d), D (m, m)) of the weighted regression map step."""
    ell = torch.exp(log_ell)
    sf2 = torch.exp(log_sf2)
    diff = x[:, None, :] / ell - z[None, :, :] / ell
    knm = sf2 * torch.exp(-0.5 * (diff * diff).sum(-1))       # (n, m)
    b = sf2 * w.sum()                                         # k_ii = sf2 (SE)
    c = knm.T @ (w[:, None] * y)
    d_stat = (knm * w[:, None]).T @ knm
    return b, c, d_stat
