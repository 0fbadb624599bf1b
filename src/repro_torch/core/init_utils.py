"""Initialisation helpers (numpy): PCA for latents, k-means for Z,
data-driven hyper-parameters.

A copy of ``repro.core.init_utils``, kept here so the port never imports
the JAX package; both give bitwise-equal arrays.
"""
from __future__ import annotations

import numpy as np


def pca(y: np.ndarray, q: int) -> np.ndarray:
    """PCA projection of Y (n, d) to q dims, unit-variance scaled (paper init)."""
    y = np.asarray(y, np.float64)
    yc = y - y.mean(axis=0, keepdims=True)
    # SVD of the centred data; principal components = U * S
    u, s_, _ = np.linalg.svd(yc, full_matrices=False)
    x = u[:, :q] * s_[:q]
    std = x.std(axis=0)
    std[std == 0] = 1.0
    return x / std


def kmeans(x: np.ndarray, k: int, iters: int = 20, seed: int = 0,
           noise: float = 1e-2) -> np.ndarray:
    """Lloyd's k-means centres with a dash of noise: the paper's Z init.

    Builds an (n, k, q) broadcast, so call it on a subsample for large n.
    """
    rng = np.random.default_rng(seed)
    x = np.asarray(x, np.float64)
    n = x.shape[0]
    if k >= n:
        reps = int(np.ceil(k / n))
        base = np.tile(x, (reps, 1))[:k]
        return base + noise * rng.standard_normal(base.shape)
    centres = x[rng.choice(n, size=k, replace=False)].copy()
    for _ in range(iters):
        d2 = ((x[:, None, :] - centres[None]) ** 2).sum(-1)
        assign = d2.argmin(axis=1)
        for j in range(k):
            pts = x[assign == j]
            if len(pts):
                centres[j] = pts.mean(axis=0)
    return centres + noise * rng.standard_normal(centres.shape)


def _var_y(y: np.ndarray) -> float:
    var_y = float(np.var(y))
    return var_y if var_y > 0 else 1.0


def default_hyp(y: np.ndarray, q: int) -> dict:
    """Data-driven hyper-parameter init (GPy-style)."""
    var_y = _var_y(y)
    return {
        "log_sf2": np.log(var_y),
        "log_ell": np.ones((q,)) * 0.5 * np.log(q),
        "log_beta": -np.log(0.01 * var_y),
    }


def default_hyp_for(kernel, y: np.ndarray, q: int) -> dict:
    """Data-driven init for any covariance expression: its own (possibly
    nested) parameter subtree plus the noise precision; equals
    :func:`default_hyp` for SE-ARD."""
    from .covariance import as_kernel

    var_y = _var_y(y)
    return {**as_kernel(kernel).default_hyp(q, var_y),
            "log_beta": -np.log(0.01 * var_y)}
