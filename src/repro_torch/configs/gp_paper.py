"""The GP workload configurations the port runs (copy of ``repro.configs.gp_paper``).

This slice carries the SE-ARD configurations: the three GPLVM ones (the
paper's oil-flow, 100k sines and USPS models) and the full-width SGPR.
``chip_smoke.py`` drives ``sgpr-synth-1m`` and ``gplvm-usps`` on the card.
The kernel-zoo entry comes with its slice.
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
        GPConfig("gplvm-oilflow", n=1000, d=12, q=10, m=50, latent=True,
                 source="paper fig.4 (Titsias & Lawrence oil-flow)"),
        GPConfig("gplvm-synth-100k", n=100_000, d=3, q=2, m=100, latent=True,
                 source="paper §4.2-4.3 scaling dataset"),
        GPConfig("gplvm-usps", n=4649, d=256, q=10, m=150, latent=True,
                 source="paper §4.5 USPS"),
        GPConfig("sgpr-synth-1m", n=1_000_000, d=4, q=8, m=512, latent=False,
                 source="beyond-paper scale point (512-chip headroom)"),
    ]
}
