"""Sparse GP regression (Titsias 2009) via the paper's re-parametrised bound.

Counterpart of ``repro.core.SGPR``: build the reduced statistics (the fused
map kernel on CUDA), evaluate the bound and its gradient (autograd; the
kernel's backward recomputes the dense map in row chunks), fit by SCG,
freeze the optimal q(u) into a ``PredictiveState`` and answer queries
through the block engine; or train by minibatch SVI (``fit_svi``, Adam on
the reweighted bound of ``batch_blocks`` sampled row blocks); absorb or
forget a block of rows without re-scanning the rest (``update``,
``forget``: the Stats fold, the serving factors take a rank-k refresh);
draw posterior functions (``sample``, through the engine's block sampler).
"""
from __future__ import annotations

import numpy as np
import torch

from .._device import as_f64, resolve_device
from . import bound as bound_mod
from . import covariance as cov
from . import init_utils
from .flat import fit_scg, neg_value_and_grad, tree_map
from .posterior_cache import PosteriorCacheMixin
from .stats import downdate_stats, fold_stats, partial_stats_chunked


class SGPR(PosteriorCacheMixin):
    """Sparse GP regression with inducing points Z and a covariance
    expression (``kernel=``: a ``core.covariance`` expression or its spec;
    default the full-width SE-ARD, the paper's).  The expression picks the
    map's route: the full-width SE-ARD takes the fused kernel on CUDA,
    every other expression its own plain ``K``/``kdiag``.

    ``chunk_size``: if set, the map step folds the n rows in blocks of this
    many points (``stats.partial_stats_chunked``).  The default ``None``
    maps all rows at once, which on CUDA is one launch of the fused kernel
    (it never stores the (n, m) slab); on the CPU it holds the slab.

    ``batch_blocks``: the default blocks a ``fit_svi`` step samples.

    ``device``: where the model lives (default CUDA; ``"cpu"`` runs the
    plain versions of the kernels).  Data and parameters are f64 there.
    """

    def __init__(self, x: np.ndarray, y: np.ndarray, num_inducing: int = 50,
                 hyp: dict | None = None, z: np.ndarray | None = None,
                 jitter: float = 1e-6, seed: int = 0,
                 chunk_size: int | None = None,
                 batch_blocks: int | None = None, kernel=None, device=None):
        self.device = resolve_device(device)
        self.x = as_f64(x, self.device)
        self.y = as_f64(y, self.device)
        self.n, self.q = self.x.shape
        self.d = self.y.shape[1]
        self.jitter = jitter
        self.chunk_size = chunk_size
        self.batch_blocks = batch_blocks
        self.kernel = cov.as_kernel(kernel)
        z0 = (init_utils.kmeans(np.asarray(x), num_inducing, seed=seed)
              if z is None else z)
        hyp0 = (init_utils.default_hyp_for(self.kernel, np.asarray(y), self.q)
                if hyp is None else hyp)
        self.params = {
            "hyp": tree_map(lambda v: as_f64(v, self.device), hyp0),
            "z": as_f64(z0, self.device),
        }
        self._init_posterior_caches()   # stats / PredictiveState / engine
        # [start, stop) rows of each block folded so far (block 0: the
        # constructor's data); ``forget`` pops one and renumbers the rest.
        self._blocks: list[tuple[int, int]] = [(0, self.n)]

    def _map_stats(self, hyp, z, y, x, batch_blocks=None, generator=None,
                   block_indices=None):
        return partial_stats_chunked(hyp, z, y, x, s=None, latent=False,
                                     block_size=self.chunk_size,
                                     batch_blocks=batch_blocks,
                                     generator=generator,
                                     block_indices=block_indices,
                                     kernel=self.kernel)

    # -- objective ----------------------------------------------------------
    def _neg_bound(self, params, **svi) -> torch.Tensor:
        """The negative bound; ``svi`` (``batch_blocks``, ``generator``,
        ``block_indices``) makes it the SVI estimate."""
        st = self._map_stats(params["hyp"], params["z"], self.y, self.x,
                             **svi)
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

    def fit_svi(self, steps: int = 500, lr: float = 1e-2,
                batch_blocks: int | None = None, seed: int = 0,
                verbose: bool = False):
        """Minibatch SVI (Hensman et al.): each Adam step samples
        ``batch_blocks`` of the ``ceil(n / chunk_size)`` row blocks and
        reweights their Stats by ``n_blocks / batch_blocks``, an unbiased
        estimate of the exact ones, so a step costs O(batch_blocks *
        chunk_size * m) whatever n is.  Draws come from a generator seeded
        with ``seed``.  Needs ``chunk_size``; ``batch_blocks`` defaults to
        the constructor's.  Returns a ``train.svi.SVIResult``; drops the
        posterior caches."""
        from ..train.svi import svi_fit, value_and_grad

        bb = self.batch_blocks if batch_blocks is None else batch_blocks
        if self.chunk_size is None or bb is None:
            raise ValueError(
                "fit_svi needs chunk_size (the block size) and batch_blocks "
                "(blocks per step), e.g. SGPR(..., chunk_size=1024, "
                "batch_blocks=4)")

        def neg_vg(params, generator):
            return value_and_grad(lambda p: self._neg_bound(
                p, batch_blocks=bb, generator=generator), params)

        res = svi_fit(neg_vg, self.params, torch.Generator().manual_seed(seed),
                      steps=steps, lr=lr)
        self.params = res.params
        self._invalidate_posterior()
        if verbose:
            print(f"SGPR fit_svi: est. bound={-res.history[-1]:.4f} "
                  f"steps={res.n_steps} (B={bb} blocks/step)")
        return res

    # -- online updates ---------------------------------------------------------
    @torch.no_grad()
    def update(self, x_new: np.ndarray, y_new: np.ndarray) -> int:
        """Absorb a new block of k rows without re-scanning the history:
        its exact Stats (the map's route: the fused kernel for the
        full-width SE-ARD on CUDA) fold into the cached reduced Stats, and a
        cached ``PredictiveState`` takes the rank-k refresh
        (``serve.online``, O(m²k), no m×m factorisation), swapped into the
        live engine.  Parameters stay; a later ``fit`` starts from them on
        all the data.  Returns the block's index for :meth:`forget`."""
        x_new = torch.atleast_2d(as_f64(x_new, self.device))
        y_new = torch.atleast_2d(as_f64(y_new, self.device))
        if x_new.shape[0] != y_new.shape[0]:
            raise ValueError(f"x_new/y_new row mismatch: {x_new.shape[0]} "
                             f"vs {y_new.shape[0]}")
        if x_new.shape[1] != self.q or y_new.shape[1] != self.d:
            raise ValueError(
                f"expected (k, {self.q}) inputs and (k, {self.d}) outputs, "
                f"got {tuple(x_new.shape)} / {tuple(y_new.shape)}")
        # Both scans exact: fold and downdate hold for unscaled Stats only.
        base = self._stats()
        delta = self._map_stats(self.params["hyp"], self.params["z"], y_new,
                                x_new)
        pstate = self._pstate_cache
        if pstate is not None:
            from ..serve import online
            pstate = online.update_state(pstate, x_new, y_new).state
        self.x = torch.cat([self.x, x_new])
        self.y = torch.cat([self.y, y_new])
        self.n = self.x.shape[0]
        self._blocks.append((self.n - x_new.shape[0], self.n))
        self._refresh_posterior(fold_stats(base, delta), pstate)
        return len(self._blocks) - 1

    @torch.no_grad()
    def forget(self, block: int):
        """Remove a block folded before (0: the constructor's data; negative
        indices count from the newest): its Stats are subtracted, a cached
        state takes the rank-k downdate (with the guarded refactorisation
        fallback), and later blocks renumber down by one, as ``list.pop``
        does.  Returns the removed ``(x, y)`` as numpy arrays."""
        nblocks = len(self._blocks)
        if not -nblocks <= block < nblocks:
            raise IndexError(
                f"block {block} out of range ({nblocks} blocks held)")
        start, stop = self._blocks[block % nblocks]
        x_old, y_old = self.x[start:stop], self.y[start:stop]
        base = self._stats()
        delta = self._map_stats(self.params["hyp"], self.params["z"], y_old,
                                x_old)
        pstate = self._pstate_cache
        if pstate is not None:
            from ..serve import online
            pstate = online.downdate_state(pstate, x_old, y_old).state
        k = stop - start
        self.x = torch.cat([self.x[:start], self.x[stop:]])
        self.y = torch.cat([self.y[:start], self.y[stop:]])
        self.n = self.x.shape[0]
        del self._blocks[block % nblocks]
        self._blocks = [(s - k, e - k) if s >= stop else (s, e)
                        for s, e in self._blocks]
        self._refresh_posterior(downdate_stats(base, delta), pstate)
        return x_old.cpu().numpy(), y_old.cpu().numpy()

    @property
    def num_blocks(self) -> int:
        """How many data blocks the model holds (fold order)."""
        return len(self._blocks)

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

    def sample(self, xstar: np.ndarray, num_samples: int, seed: int = 0,
               generator: torch.Generator | None = None,
               include_noise: bool = False) -> np.ndarray:
        """Posterior function draws at ``xstar``: (num_samples, t, d), a
        numpy array.  Delegates to the cached engine's
        ``PredictEngine.sample``: joint within each query block (the
        engine's block size), independent across blocks.  ``generator``
        (a ``torch.Generator``) takes the place of ``seed`` where given."""
        if self._engine_cache is None:
            self._engine_cache = self.serve_engine()
        smp = self._engine_cache.sample(
            torch.as_tensor(xstar, dtype=torch.float64), num_samples,
            seed if generator is None else generator,
            include_noise=include_noise)
        return smp.cpu().numpy()
