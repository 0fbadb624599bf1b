"""Serving: the frozen predictive state, the block predict engine and the
online refresh of a served state (``online``)."""
from .engine import PredictEngine
from .online import (RefreshResult, downdate_state, refresh_state,
                     update_state)
from .posterior import (PredictiveState, extract_state, load_state,
                        predict_full_cov, predict_mean_var, save_state,
                        state_from_model)

__all__ = ["PredictEngine", "PredictiveState", "RefreshResult",
           "downdate_state", "extract_state", "load_state",
           "predict_full_cov", "predict_mean_var", "refresh_state",
           "save_state", "state_from_model", "update_state"]
