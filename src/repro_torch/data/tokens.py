"""Synthetic token stream of the LM substrate (port of
``repro.data.tokens``).

Deterministic, seekable and restart-safe: a (seed, step) pair fully
determines a batch, so a resume from step k replays the exact stream
without storing data state beyond the step counter.  Sequences follow a
Zipfian unigram mixed with a repeating-ngram process (with probability 0.5
a row's second half repeats its first), so the loss has learnable
structure.

Each batch draws from one CPU ``torch.Generator`` seeded from
``np.random.SeedSequence([seed, step])``, so the same step gives the same
tokens on any device.  The draws are not ``jax.random``'s: tests that hold
the port against the JAX package feed both the JAX stream's
``host_batch`` tokens.
"""
from __future__ import annotations

import numpy as np
import torch

from .._device import resolve_device


def zipf_logits(vocab_size: int, alpha: float = 1.2) -> np.ndarray:
    ranks = np.arange(1, vocab_size + 1, dtype=np.float64)
    p = 1.0 / ranks**alpha
    return np.log(p / p.sum())


class TokenStream:
    """Stateless-per-step synthetic LM data: ``batch(step)`` -> int32
    ``tokens`` and ``labels`` (B, T) on ``device`` (None: the card), the
    labels the tokens shifted by one."""

    def __init__(self, vocab_size: int, seq_len: int, global_batch: int,
                 seed: int = 0, alpha: float = 1.2, device=None):
        self.vocab_size = vocab_size
        self.seq_len = seq_len
        self.global_batch = global_batch
        self.seed = seed
        self.device = resolve_device(device)
        self._cdf = torch.from_numpy(np.cumsum(np.exp(
            zipf_logits(vocab_size, alpha))))

    def _generator(self, step: int) -> torch.Generator:
        word = np.random.SeedSequence([self.seed, step]).generate_state(
            1, np.uint64)[0]
        return torch.Generator().manual_seed(int(word >> np.uint64(1)))

    def batch(self, step: int) -> dict[str, torch.Tensor]:
        gen = self._generator(step)
        b, t = self.global_batch, self.seq_len
        u = torch.rand((b, t + 1), generator=gen, dtype=torch.float64)
        base = torch.searchsorted(self._cdf, u).clamp(max=self.vocab_size - 1)
        # inject copy-structure: with p=0.5 per row, second half repeats first
        half = (t + 1) // 2
        rep = torch.cat([base[:, :half], base[:, :t + 1 - half]], dim=1)
        use_rep = torch.rand((b, 1), generator=gen) < 0.5
        seq = torch.where(use_rep, rep, base).to(torch.int32)
        return {"tokens": seq[:, :-1].to(self.device),
                "labels": seq[:, 1:].to(self.device)}

    def host_batch(self, step: int) -> dict[str, np.ndarray]:
        return {k: v.cpu().numpy() for k, v in self.batch(step).items()}
