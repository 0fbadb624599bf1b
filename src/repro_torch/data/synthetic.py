"""Synthetic datasets of the paper's GPLVM experiments (numpy).

Copies of ``repro.data.synthetic`` (``sines_dataset``, ``oilflow_like``,
``usps_like``, ``drop_pixels``, ``flight_like``), kept here so the port never imports the
JAX package; the same generator gives the same arrays.

* ``sines_dataset`` — the paper §4.2/fig 1 data: a 1D latent space mapped to
  3D observations "through linear functions with sines superimposed".
* ``oilflow_like`` — a 12-D, 3-class stand-in for the oil-flow set of
  Titsias & Lawrence (the paper's fig 4 embedding).
* ``usps_like`` — 16x16 synthetic digit-ish images (d=256) for the §4.5
  USPS model (``gplvm-usps``).
* ``drop_pixels`` — the §4.5 reconstruction protocol's fixed pixel mask.
* ``flight_like`` — the paper's §5 2M-row flight-delay regression shape
  (q = 8 covariates, d = 1), computed row by row on demand.
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


def oilflow_like(rng: np.random.Generator, n: int = 1000):
    """12-D, 3-class nonlinear embedding of a 2-D latent. Returns (Y, labels)."""
    labels = rng.integers(0, 3, size=n)
    centres = np.array([[-2.0, 0.0], [2.0, 0.5], [0.0, 2.2]])
    lat = centres[labels] + 0.35 * rng.standard_normal((n, 2))
    w1 = rng.standard_normal((2, 12)) * 0.9
    w2 = rng.standard_normal((2, 12)) * 0.7
    y = np.tanh(lat @ w1) + np.sin(lat @ w2) + 0.05 * rng.standard_normal((n, 12))
    return y, labels


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


def flight_like(n: int = 2_000_000, noise: float = 0.2, seed: int = 0):
    """Flight-delay-style regression at paper §5 scale, *chunk-addressable*.

    The paper's flagship run is GP regression on 2M flight records with 8
    covariates (month, day-of-month, day-of-week, departure/arrival time,
    airtime, distance, plane age) predicting delay.  This generator mimics
    that shape — q = 8 covariates with flight-like ranges, a nonlinear
    smooth delay surface plus heteroscedastic-ish noise — **without ever
    materialising the dataset**: it returns a ``data.stream``-protocol
    source whose ``read(start, stop)`` computes rows on demand,
    deterministically per row index (counter-based ``Philox`` streams
    seeded by ``seed``), so a 2M-row (or 2B-row) "file" costs O(window)
    host memory.  Fields: ``mu`` (n, 8) covariates, ``y`` (n, 1) delays.
    """
    from .stream import SyntheticSource

    def make_chunk(start: int, stop: int) -> dict:
        k = stop - start
        # Counter-based bit generator: jump to absolute row `start` so any
        # window is reproducible independently of read order (the stream
        # protocol's purity requirement).  Exactly 16 uniform draws per row
        # (8 covariates, 2 for Box-Muller noise, 6 spare) keeps the per-row
        # stride equal to the advance stride, so overlapping windows see
        # identical rows.  (standard_normal would break this: the ziggurat
        # consumes a data-dependent number of draws.)  Philox.advance counts
        # 128-bit counter blocks = 4 uint64 draws each, so 16 draws/row is
        # 4 blocks/row.
        bg = np.random.Philox(key=seed)
        bg = bg.advance(start * 4)
        r = np.random.Generator(bg)
        u = r.random((k, 16))
        eps = np.sqrt(-2.0 * np.log1p(-u[:, 8])) * np.cos(2 * np.pi * u[:, 9])
        x = np.empty((k, 8))
        x[:, 0] = 1 + np.floor(12 * u[:, 0])        # month
        x[:, 1] = 1 + np.floor(31 * u[:, 1])        # day of month
        x[:, 2] = 1 + np.floor(7 * u[:, 2])         # day of week
        x[:, 3] = 24.0 * u[:, 3]                    # departure hour
        x[:, 4] = 24.0 * u[:, 4]                    # arrival hour
        x[:, 5] = 30 + 570 * u[:, 5]                # airtime (min)
        x[:, 6] = 100 + 4800 * u[:, 6]              # distance (mi)
        x[:, 7] = 50 * u[:, 7]                      # plane age (yr)
        # Smooth nonlinear delay surface on standardised covariates.
        s = (x - _FLIGHT_MEAN) / _FLIGHT_STD
        f = (np.sin(1.3 * s[:, 3]) + 0.7 * np.cos(0.9 * s[:, 4])
             + 0.5 * s[:, 5] * np.exp(-0.5 * s[:, 6] ** 2)
             + 0.3 * np.tanh(s[:, 0] + 0.5 * s[:, 2]) - 0.2 * s[:, 7])
        y = f + noise * (1.0 + 0.3 * np.abs(s[:, 5])) * eps
        return {"mu": s, "y": y[:, None]}

    return SyntheticSource(n, make_chunk,
                           fields={"mu": (8,), "y": (1,)})


# Population moments of the flight_like covariate columns (uniform/discrete
# ranges above) — fixed constants so standardisation is row-independent.
_FLIGHT_MEAN = np.array([6.5, 16.0, 4.0, 12.0, 12.0, 315.0, 2500.0, 25.0])
_FLIGHT_STD = np.array([3.45, 8.94, 2.0, 6.93, 6.93, 164.5, 1385.6, 14.4])


def drop_pixels(rng: np.random.Generator, y: np.ndarray, frac: float = 0.34):
    """Paper §4.5: drop a fraction of pixels; returns (y_masked, observed_mask).
    The same pixel mask is applied to every image (a fixed missing-sensor
    pattern), matching the reconstruction protocol."""
    d = y.shape[1]
    observed = np.ones(d, dtype=bool)
    observed[rng.choice(d, size=int(frac * d), replace=False)] = False
    return y * observed[None, :], observed
