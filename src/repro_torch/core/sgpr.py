"""Sparse GP regression (Titsias 2009) via the paper's re-parametrised bound.

Counterpart of ``repro.core.SGPR`` for the serving path: build the reduced
statistics once (the fused map kernel on CUDA), evaluate the bound, freeze
the optimal q(u) into a ``PredictiveState`` and answer queries through the
block engine.  Training (``fit``, ``fit_svi``) and the online updates
(``update``, ``forget``) and ``sample`` come in later slices.
"""
from __future__ import annotations

import numpy as np
import torch

from .._device import resolve_device
from . import bound as bound_mod
from . import covariance as cov
from . import init_utils
from .posterior_cache import PosteriorCacheMixin
from .stats import partial_stats_chunked


class SGPR(PosteriorCacheMixin):
    """Sparse GP regression with inducing points Z (SE-ARD covariance).

    ``chunk_size``: if set, the map step folds the n rows in blocks of this
    many points (``stats.partial_stats_chunked``).  The default ``None``
    maps all rows at once, which on CUDA is one launch of the fused kernel
    (it never stores the (n, m) slab); on the CPU it holds the slab.

    ``device``: where the model lives (default CUDA; ``"cpu"`` runs the
    plain versions of the kernels).  Data and parameters are f64 there.
    """

    def __init__(self, x: np.ndarray, y: np.ndarray, num_inducing: int = 50,
                 hyp: dict | None = None, z: np.ndarray | None = None,
                 jitter: float = 1e-6, seed: int = 0,
                 chunk_size: int | None = None, kernel=None, device=None):
        self.device = resolve_device(device)
        self.x = self._f64(x)
        self.y = self._f64(y)
        self.n, self.q = self.x.shape
        self.d = self.y.shape[1]
        self.jitter = jitter
        self.chunk_size = chunk_size
        self.kernel = cov.as_kernel(kernel)
        z0 = (init_utils.kmeans(np.asarray(x), num_inducing, seed=seed)
              if z is None else z)
        hyp0 = (init_utils.default_hyp_for(self.kernel, np.asarray(y), self.q)
                if hyp is None else hyp)
        self.params = {
            "hyp": {k: self._f64(v) for k, v in hyp0.items()},
            "z": self._f64(z0),
        }
        self._init_posterior_caches()   # stats / PredictiveState / engine

    def _f64(self, v) -> torch.Tensor:
        """A tensor or array as an f64 tensor on the model's device (arrays
        are copied, so read-only numpy buffers are fine)."""
        if not isinstance(v, torch.Tensor):
            v = torch.from_numpy(np.array(v, dtype=np.float64))
        return v.to(device=self.device, dtype=torch.float64)

    def _map_stats(self, hyp, z, y, x):
        return partial_stats_chunked(hyp, z, y, x, s=None, latent=False,
                                     block_size=self.chunk_size,
                                     kernel=self.kernel)

    # -- objective ----------------------------------------------------------
    @torch.no_grad()
    def log_bound(self, params=None) -> float:
        """The collapsed bound at ``params`` (default: the model's)."""
        p = self.params if params is None else params
        st = self._map_stats(p["hyp"], p["z"], self.y, self.x)
        return float(bound_mod.collapsed_bound(p["hyp"], p["z"], st, self.d,
                                               jitter=self.jitter,
                                               kernel=self.kernel))

    # -- posterior ----------------------------------------------------------
    @torch.no_grad()
    def _stats(self):
        if self._stats_cache is None:
            self._stats_cache = self._map_stats(
                self.params["hyp"], self.params["z"], self.y, self.x)
        return self._stats_cache

    @torch.no_grad()
    def qu(self) -> bound_mod.QU:
        return bound_mod.optimal_qu(self.params["hyp"], self.params["z"],
                                    self._stats(), jitter=self.jitter,
                                    kernel=self.kernel)

    def predictive_state(self):
        """The frozen ``serve.PredictiveState`` for the current params,
        extracted once and cached."""
        if self._pstate_cache is None:
            from ..serve import state_from_model
            self._pstate_cache = state_from_model(self)
        return self._pstate_cache

    def serve_engine(self, block_size: int = 256, compute_dtype=None):
        """A fresh ``serve.PredictEngine`` over the current predictive state,
        on the model's device."""
        from ..serve import PredictEngine
        return PredictEngine(self.predictive_state(), block_size=block_size,
                             compute_dtype=compute_dtype, device=self.device)

    def predict(self, xstar: np.ndarray, include_noise: bool = False,
                full_cov: bool = False):
        """Predictions as numpy arrays, through the cached default engine."""
        if self._engine_cache is None:
            self._engine_cache = self.serve_engine()
        out = self._engine_cache(torch.as_tensor(xstar, dtype=torch.float64),
                                 include_noise=include_noise,
                                 full_cov=full_cov)
        return tuple(o.cpu().numpy() for o in out)
