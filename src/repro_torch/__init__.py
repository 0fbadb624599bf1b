"""PyTorch + CUDA port of the distributed sparse-GP system (``repro``).

A second package beside the JAX one, which stays the reference.  It imports
torch and numpy, never jax or ``repro``.  Entry points run on CUDA unless
the caller passes ``device="cpu"``.  The device and the kernel expression
pick the route: on CUDA the full-width SE-ARD's map steps (regression and
latent) and predict step, and LM prefill attention, go through hand-written
kernels (``kernels/``, ``csrc/``), built with ``nvcc`` at first use; every
other covariance expression takes the plain torch math, as on the CPU.

Ported so far: ``SGPR`` and ``BayesianGPLVM`` (map statistics, bound and
gradient, SCG ``fit``, optimal q(u)), ``extract_state`` / ``save_state`` /
``load_state`` and ``PredictEngine``; the distributed Map-Reduce
``DistributedGP`` on ``torch.distributed`` with the §5.2 failure masks
(``distributed``, ``launch.make_data_group``,
``train.steps.make_gp_train_step``); SVI (``fit_svi``, ``train.svi``,
``DistributedGP(batch_blocks=...)``) and host streaming (``data.stream``,
the ``streamed_*`` methods, ``PredictEngine.predict_stream``); the kernel
zoo (``core.covariance``) and online updates (``SGPR.update`` / ``forget``,
``serve.online``, ``PredictEngine.ingest`` / ``forget`` / ``swap_state``);
posterior sampling (``PredictEngine.sample`` / ``sample_stream``,
``SGPR.sample``), the fleet engine (``serve.MultiPredictEngine``) and the
async serving front-end (``serve.Frontend``, ``serve.slo``); the LM
substrate's ten configs, trained and served (``models``: GQA, local
windows, MLA, SSD, RG-LRU, dense MoE, enc-dec; ``train.steps``,
``launch.train``).
"""
from .core import SGPR, BayesianGPLVM, DistributedGP
from .serve import (PredictEngine, PredictiveState, extract_state, load_state,
                    save_state, state_from_model)

__all__ = ["SGPR", "BayesianGPLVM", "DistributedGP", "PredictEngine",
           "PredictiveState", "extract_state", "load_state", "save_state",
           "state_from_model"]
