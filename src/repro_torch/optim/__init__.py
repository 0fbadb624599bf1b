"""Optimisers of the LM substrate (port of ``repro.optim``): AdamW and int8
error-feedback gradient compression."""
