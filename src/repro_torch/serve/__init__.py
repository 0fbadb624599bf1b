"""Serving: the frozen predictive state and the block predict engine."""
from .engine import PredictEngine
from .posterior import (PredictiveState, extract_state, load_state,
                        predict_full_cov, predict_mean_var, save_state,
                        state_from_model)

__all__ = ["PredictEngine", "PredictiveState", "extract_state", "load_state",
           "predict_full_cov", "predict_mean_var", "save_state",
           "state_from_model"]
