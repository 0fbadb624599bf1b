"""The GP workload configurations the port runs (copy of ``repro.configs.gp_paper``).

This slice carries the full-width SGPR configuration, which the serving path
drives on the card (``chip_smoke.py``).  The GPLVM and kernel-zoo entries
come with their slices.
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class GPConfig:
    name: str
    n: int             # data points
    d: int             # output dims
    q: int             # latent / input dims
    m: int             # inducing points
    latent: bool       # GPLVM (True) or regression (False)
    # Covariance expression as a spec for core.covariance.as_kernel;
    # "se" is the full-width SE-ARD, the paper's kernel.
    kernel: str = "se"
    source: str = ""


GP_CONFIGS: dict[str, GPConfig] = {
    c.name: c for c in [
        GPConfig("sgpr-synth-1m", n=1_000_000, d=4, q=8, m=512, latent=False,
                 source="beyond-paper scale point (512-chip headroom)"),
    ]
}
