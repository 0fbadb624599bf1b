"""Synthetic datasets of the paper's GPLVM experiments (numpy).

Copies of ``repro.data.synthetic`` (``sines_dataset``, ``usps_like``,
``drop_pixels``), kept here so the port never imports the JAX package; the
same generator gives the same arrays.

* ``sines_dataset`` — the paper §4.2/fig 1 data: a 1D latent space mapped to
  3D observations "through linear functions with sines superimposed".
* ``usps_like`` — 16x16 synthetic digit-ish images (d=256) for the §4.5
  USPS model (``gplvm-usps``).
* ``drop_pixels`` — the §4.5 reconstruction protocol's fixed pixel mask.
"""
from __future__ import annotations

import numpy as np


def sines_dataset(rng: np.random.Generator, n: int = 100_000,
                  noise: float = 0.05):
    """1D latent -> 3D: linear + superimposed sines (paper fig 1). Returns
    (Y (n,3), latent (n,1))."""
    t = rng.uniform(-3.0, 3.0, size=(n, 1))
    w = np.array([[0.8, -0.6, 0.4]])
    a = np.array([[1.2, 0.9, 1.5]])
    ph = np.array([[0.0, 1.1, 2.3]])
    y = t @ w + np.sin(1.7 * t @ a + ph)
    y = y + noise * rng.standard_normal(y.shape)
    return y, t


def usps_like(rng: np.random.Generator, n: int = 4649, side: int = 16):
    """Synthetic 'digit' images: smooth strokes per class on a 16x16 grid.
    Returns (Y in [0,1]^(n,256), labels 0..9)."""
    labels = rng.integers(0, 10, size=n)
    yy, xx = np.mgrid[0:side, 0:side].astype(np.float64) / (side - 1)
    imgs = np.zeros((n, side, side))
    for i, c in enumerate(labels):
        # class-dependent stroke: parametric curve + per-sample jitter
        t = np.linspace(0, 1, 40)
        a = 0.6 + 0.04 * c + 0.02 * rng.standard_normal()
        b = 0.2 + 0.07 * c + 0.02 * rng.standard_normal()
        cx = 0.5 + 0.35 * np.cos(2 * np.pi * (a * t + 0.1 * c))
        cy = 0.5 + 0.35 * np.sin(2 * np.pi * (b * t + 0.05 * c))
        img = np.zeros((side, side))
        for px, py in zip(cx, cy):
            img += np.exp(-(((xx - px) ** 2 + (yy - py) ** 2) / 0.006))
        imgs[i] = img / img.max()
    return imgs.reshape(n, -1), labels


def drop_pixels(rng: np.random.Generator, y: np.ndarray, frac: float = 0.34):
    """Paper §4.5: drop a fraction of pixels; returns (y_masked, observed_mask).
    The same pixel mask is applied to every image (a fixed missing-sensor
    pattern), matching the reconstruction protocol."""
    d = y.shape[1]
    observed = np.ones(d, dtype=bool)
    observed[rng.choice(d, size=int(frac * d), replace=False)] = False
    return y * observed[None, :], observed
