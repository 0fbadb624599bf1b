"""Serving: the frozen predictive state and its sampling (``posterior``),
the block predict engine and the fleet engine (``engine``), the online
refresh of a served state (``online``), the async micro-batching
front-end (``frontend``) and its constant-memory SLO accounting
(``slo``).  Every name of ``repro.serve.__all__``, and
``serve_follower``: the loop of a follower rank of a sharded engine's
front-end."""
from . import engine, frontend, online, posterior, slo
from .engine import (MultiPredictEngine, PredictEngine, mixture_moments,
                     stack_states)
from .frontend import (Frontend, FrontendError, QueueFull, ServeResult,
                       SLOExceeded, serve_follower)
from .online import (RefreshResult, downdate_state, refresh_state,
                     update_state)
from .posterior import (PredictiveState, extract_state, load_state,
                        predict_full_cov, predict_mean_var, sample_block,
                        sample_joint, save_state, state_from_model)
from .slo import QuantileSketch, SLOMetrics

__all__ = [
    "engine", "frontend", "online", "posterior", "slo",
    "Frontend", "FrontendError", "MultiPredictEngine", "PredictEngine",
    "PredictiveState", "QuantileSketch", "QueueFull", "RefreshResult",
    "SLOExceeded", "SLOMetrics", "ServeResult", "downdate_state",
    "extract_state", "load_state", "mixture_moments", "predict_full_cov",
    "predict_mean_var", "refresh_state", "sample_block", "sample_joint",
    "save_state", "serve_follower", "stack_states", "state_from_model",
    "update_state",
]
