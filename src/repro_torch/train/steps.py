"""Serving step builders of the LM substrate (port of the prefill and serve
builders of ``repro.train.steps``).

Each returns a plain function over the caller's tensors, run under
``torch.no_grad()``: serving takes no gradient, and the flash kernel has no
backward.  The train step comes with training (ROADMAP Queue 1 item 12).
"""
from __future__ import annotations

import torch

from ..configs.base import ModelConfig
from ..models import transformer as tf


def make_prefill_step(cfg: ModelConfig):
    def prefill_step(params, batch):
        with torch.no_grad():
            return tf.forward_prefill(cfg, params, batch)

    return prefill_step


def make_serve_step(cfg: ModelConfig):
    def serve_step(params, caches, tokens_t, pos):
        with torch.no_grad():
            return tf.decode_step(cfg, params, caches, tokens_t, pos)

    return serve_step
