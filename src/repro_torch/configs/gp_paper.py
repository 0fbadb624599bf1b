"""The GP workload configurations the port runs (copy of ``repro.configs.gp_paper``).

The three GPLVM configurations (the paper's oil-flow, 100k sines and USPS
models), the full-width SGPR and the kernel-zoo composite
``sgpr-zoo-trend``.  ``chip_smoke.py`` drives ``sgpr-synth-1m``,
``gplvm-usps`` and ``sgpr-zoo-trend`` on the card.
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

    def kernel_expr(self):
        """The parsed covariance expression (``core.covariance.Kernel``)."""
        from ..core.covariance import as_kernel
        return as_kernel(self.kernel)


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
        GPConfig("sgpr-zoo-trend", n=100_000, d=2, q=4, m=128, latent=False,
                 kernel='{"kind": "sum", "parts": ['
                        '{"kind": "se", "dims": [0, 1]}, '
                        '{"kind": "linear", "dims": [2, 3]}], '
                        '"quad_order": 11}',
                 source="kernel-zoo composite (smooth + linear trend), "
                        "docs/kernels.md#kernel-zoo"),
    ]
}
