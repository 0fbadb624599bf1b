"""Sparse GP regression (Titsias 2009) via the paper's re-parametrised bound.

Counterpart of ``repro.core.SGPR``: build the reduced statistics (the fused
map kernel on CUDA), evaluate the bound and its gradient (autograd; the
kernel's backward recomputes the dense map in row chunks), fit by SCG,
freeze the optimal q(u) into a ``PredictiveState`` and answer queries
through the block engine.  ``fit_svi``, the online updates (``update``,
``forget``) and ``sample`` come in later slices.
"""
from __future__ import annotations

import numpy as np
import torch

from .._device import as_f64, resolve_device
from . import bound as bound_mod
from . import covariance as cov
from . import init_utils
from .flat import fit_scg, neg_value_and_grad
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
        self.x = as_f64(x, self.device)
        self.y = as_f64(y, self.device)
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
            "hyp": {k: as_f64(v, self.device) for k, v in hyp0.items()},
            "z": as_f64(z0, self.device),
        }
        self._init_posterior_caches()   # stats / PredictiveState / engine

    def _map_stats(self, hyp, z, y, x):
        return partial_stats_chunked(hyp, z, y, x, s=None, latent=False,
                                     block_size=self.chunk_size,
                                     kernel=self.kernel)

    # -- objective ----------------------------------------------------------
    def _neg_bound(self, params) -> torch.Tensor:
        st = self._map_stats(params["hyp"], params["z"], self.y, self.x)
        return -bound_mod.collapsed_bound(params["hyp"], params["z"], st,
                                          self.d, jitter=self.jitter,
                                          kernel=self.kernel)

    @torch.no_grad()
    def log_bound(self, params=None) -> float:
        """The collapsed bound at ``params`` (default: the model's)."""
        return -float(self._neg_bound(self.params if params is None
                                      else params))

    def _neg_vg(self, params=None) -> tuple[float, np.ndarray]:
        """The negative bound and its gradient, flattened in the JAX
        package's ``ravel_pytree`` order (``core.flat``)."""
        return neg_value_and_grad(self._neg_bound, self.params
                                  if params is None else params)

    def fit(self, max_iters: int = 200, verbose: bool = False):
        """SCG on every parameter (hyp, Z); drops the posterior caches."""
        res, self.params = fit_scg(self._neg_bound, self.params, max_iters)
        self._invalidate_posterior()
        if verbose:
            print(f"SGPR fit: bound={-res.f:.4f} iters={res.n_iters} "
                  f"evals={res.n_evals} converged={res.converged}")
        return res

    # -- posterior ----------------------------------------------------------
    @torch.no_grad()
    def _stats(self):
        if self._stats_cache is None:
            self._stats_cache = self._map_stats(
                self.params["hyp"], self.params["z"], self.y, self.x)
        return self._stats_cache

    def predict(self, xstar: np.ndarray, include_noise: bool = False,
                full_cov: bool = False):
        """Predictions as numpy arrays, through the cached default engine."""
        if self._engine_cache is None:
            self._engine_cache = self.serve_engine()
        out = self._engine_cache(torch.as_tensor(xstar, dtype=torch.float64),
                                 include_noise=include_noise,
                                 full_cov=full_cov)
        return tuple(o.cpu().numpy() for o in out)
