"""Shared posterior-cache bookkeeping for the sequential models.

The model memoises the posterior chain: reduced Stats -> ``PredictiveState``
(the q(u) factor solves) -> the default ``PredictEngine`` holding that
state.  Every parameter- or data-mutating path must reset the whole chain
together; one mixin owns the attribute set so a new mutation path cannot
forget a cache that the others clear.  (The JAX package's
``_refresh_posterior`` comes with the online updates, which need
``PredictEngine.swap_state``.)
"""
from __future__ import annotations


class PosteriorCacheMixin:
    """Owns the model's memoised posterior chain and its invalidation."""

    #: every cached posterior quantity, in dependency order
    _POSTERIOR_CACHES = ("_stats_cache", "_pstate_cache", "_engine_cache")

    def _init_posterior_caches(self) -> None:
        for name in self._POSTERIOR_CACHES:
            setattr(self, name, None)

    def _invalidate_posterior(self) -> None:
        """New params -> every cached posterior quantity is stale."""
        self._init_posterior_caches()
