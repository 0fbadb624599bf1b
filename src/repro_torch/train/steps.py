"""Step builders (port of ``repro.train.steps``): the distributed GP train
step, and the prefill and serve steps of the LM substrate.

The LM builders return plain functions over the caller's tensors, run under
``torch.no_grad()``: serving takes no gradient, and the flash kernel has no
backward.  The LM train step comes with training (ROADMAP Queue 1 item
12), the async and update GP steps with items 11 and 7.
"""
from __future__ import annotations

import torch

from ..configs.base import ModelConfig
from ..models import transformer as tf


def make_gp_train_step(group, d: int, *, latent: bool = False,
                       failure_mode: str = "drop",
                       chunk_size: int | None = None, argnums=(0, 1),
                       kernel=None, device=None, batch_blocks=None,
                       reduce_mode: str = "serial", psi2_fn=None,
                       reg_stats_fn=None):
    """Distributed GP map-reduce step: ``(engine, step)``, ``step`` the
    (value, grad) of the negative collapsed bound,
    ``step(hyp, z, mu, s, y, w, fmask, n_full)`` with ``mu``, ``s``, ``y``,
    ``w`` this rank's rows from ``engine.put_data``, ``fmask`` (n_shards,)
    the same on every rank and ``n_full`` the unpadded n.

    ``group`` is the process group of the data shards
    (``launch.make_data_group``; None: the default group, or a world of
    one).  ``batch_blocks`` (with ``chunk_size``) makes it the SVI step,
    which takes a trailing per-step ``draw`` (a ``torch.Generator``, or
    this rank's block indices).  ``psi2_fn`` replaces the kernel's psi2 in
    the latent map.  ``reduce_mode`` other than ``"serial"`` and the
    ``reg_stats_fn`` hook are not ported yet: ``DistributedGP`` refuses
    them, naming their ROADMAP items, after refusing invalid values with
    ``ValueError`` as the JAX engine does.
    """
    from ..core.distributed import DistributedGP

    eng = DistributedGP(group, latent=latent, failure_mode=failure_mode,
                        chunk_size=chunk_size, kernel=kernel, device=device,
                        batch_blocks=batch_blocks, reduce_mode=reduce_mode,
                        psi2_fn=psi2_fn, reg_stats_fn=reg_stats_fn)
    return eng, eng.make_value_and_grad(d, argnums=argnums)


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
