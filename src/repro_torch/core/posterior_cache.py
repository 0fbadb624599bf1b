"""Shared posterior-cache bookkeeping for the sequential models.

The model memoises the posterior chain: reduced Stats -> ``PredictiveState``
(the q(u) factor solves) -> the default ``PredictEngine`` holding that
state.  Every parameter- or data-mutating path (``fit``, ``fit_svi``,
``update``, ``forget``) must reset or refresh the whole chain together; one
mixin owns the attribute set so a new mutation path cannot forget a cache
that the others clear.

The mixin also carries what ``SGPR`` and ``BayesianGPLVM`` serve alike from
their reduced Stats (``_stats()``) and their ``params``/``jitter``/
``kernel``/``device``: the optimal q(u), the frozen state and an engine.
"""
from __future__ import annotations

import torch

from . import bound as bound_mod


class PosteriorCacheMixin:
    """Owns the model's memoised posterior chain and its invalidation."""

    #: every cached posterior quantity, in dependency order
    _POSTERIOR_CACHES = ("_stats_cache", "_pstate_cache", "_engine_cache")

    def _init_posterior_caches(self) -> None:
        for name in self._POSTERIOR_CACHES:
            setattr(self, name, None)

    def _invalidate_posterior(self) -> None:
        """New params (or new data without an incremental refresh) -> every
        cached posterior quantity is stale.  Every mutation path goes
        through here or through :meth:`_refresh_posterior`."""
        self._init_posterior_caches()

    def _refresh_posterior(self, stats, pstate) -> None:
        """The online-update alternative to invalidation: install folded
        Stats and an incrementally refreshed state, and swap the state into
        the live engine (``PredictEngine.swap_state``).  ``pstate=None``
        drops the downstream caches instead; they rebuild from the Stats."""
        self._stats_cache = stats
        self._pstate_cache = pstate
        if pstate is None:
            self._engine_cache = None
        elif self._engine_cache is not None:
            self._engine_cache.swap_state(pstate)

    @torch.no_grad()
    def qu(self) -> bound_mod.QU:
        return bound_mod.optimal_qu(self.params["hyp"], self.params["z"],
                                    self._stats(), jitter=self.jitter,
                                    kernel=self.kernel)

    def predictive_state(self):
        """The frozen ``serve.PredictiveState`` for the current params,
        extracted once and cached until a fit moves them."""
        if self._pstate_cache is None:
            from ..serve import state_from_model
            self._pstate_cache = state_from_model(self)
        return self._pstate_cache

    def serve_engine(self, block_size: int = 256, compute_dtype=None,
                     group=None, donate: bool = False):
        """A fresh ``serve.PredictEngine`` over the current predictive state,
        on the model's device; ``group`` shards each batch's rows over a
        process group's ranks (each holding the same model), ``donate`` is
        the JAX engine's flag and changes nothing.  A GPLVM's engine answers
        latent queries (pair it with ``reconstruct`` for observed ones)."""
        from ..serve import PredictEngine
        return PredictEngine(self.predictive_state(), block_size=block_size,
                             compute_dtype=compute_dtype, device=self.device,
                             group=group, donate=donate)
