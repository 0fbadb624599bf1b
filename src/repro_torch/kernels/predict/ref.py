"""Plain PyTorch version of the fused serving predict kernel.

States the two serving statistics directly from the SE-ARD definition and
the state's precomputed contractions: the same function as
``csrc/predict.cu`` with the (t, m) slab held whole.
"""
from __future__ import annotations

import torch


def predict_ref(log_sf2, log_ell, z, a_mean, g, x):
    """(mean (t, d), quad (t,)) of the serving map against state (a_mean, g)."""
    ell = torch.exp(log_ell)
    sf2 = torch.exp(log_sf2)
    diff = x[:, None, :] / ell - z[None, :, :] / ell
    ksm = sf2 * torch.exp(-0.5 * (diff * diff).sum(-1))      # (t, m)
    mean = ksm @ a_mean
    quad = ((ksm @ g) * ksm).sum(1)
    return mean, quad
