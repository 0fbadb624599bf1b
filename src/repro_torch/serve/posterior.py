"""Frozen predictive state: the training -> serving handoff.

Counterpart of ``repro.serve.posterior``.  :func:`extract_state` performs
every query-independent solve once,

    L  = chol(Kmm),  LB = chol(I + b L^-1 D L^-T),  c2 = LB^-1 L^-1 C,

and folds them into the two serving contractions the per-query path uses,

    a_mean = b L^-T LB^-T c2     (m, d)   mean = K*m @ a_mean
    g      = Kmm^-1 - Sigma^-1   (m, m)   var  = k** - rowsum((K*m @ g) * K*m)

so a server answers queries with no triangular solve.  ``save_state`` /
``load_state`` write the JAX package's checkpoint format, leaf for leaf.
"""
from __future__ import annotations

import dataclasses
import json
import pathlib

import torch

from .. import checkpoint as ckpt
from .._device import resolve_device
from ..core import covariance as cov
from ..core.bound import DEFAULT_JITTER, _whitened
from ..core.stats import Stats
from ..kernels.predict import ops as p_ops


@dataclasses.dataclass(frozen=True)
class PredictiveState:
    """Everything prediction needs, none of it query-dependent.

    ``chol_kmm``/``chol_sigma``/``c2`` are the raw q(u) factors;
    ``a_mean``/``g`` are the serving contractions.  ``kernel`` is static
    (it rides in the checkpoint sidecar as its spec, not as a leaf).
    """

    hyp: dict                  # {"log_sf2", "log_ell", "log_beta"}
    z: torch.Tensor            # (m, q) inducing inputs
    chol_kmm: torch.Tensor     # (m, m) L = chol(Kmm + jitter)
    chol_sigma: torch.Tensor   # (m, m) LB = chol(I + b L^-1 D L^-T)
    c2: torch.Tensor           # (m, d) LB^-1 L^-1 C
    a_mean: torch.Tensor       # (m, d) b L^-T LB^-T c2
    g: torch.Tensor            # (m, m) Kmm^-1 - Sigma^-1
    kernel: cov.SEARD = cov.SE_ARD

    @property
    def m(self) -> int:
        return self.z.shape[0]

    @property
    def q(self) -> int:
        return self.z.shape[1]

    @property
    def d(self) -> int:
        return self.c2.shape[1]

    @property
    def dtype(self) -> torch.dtype:
        return self.z.dtype

    def _to(self, device=None, dtype=None) -> "PredictiveState":
        """Every leaf, hypers included, moved/cast; what the engine needs to
        hold its compute-width copy on its device."""
        def conv(t):
            return t.to(device=device, dtype=dtype)
        return dataclasses.replace(
            self, hyp={k: conv(v) for k, v in self.hyp.items()},
            **{f: conv(getattr(self, f)) for f in _ARRAY_FIELDS})


_ARRAY_FIELDS = ("z", "chol_kmm", "chol_sigma", "c2", "a_mean", "g")


@torch.no_grad()
def extract_state(hyp: dict, z, stats: Stats, jitter: float = DEFAULT_JITTER,
                  kernel=None, device=None) -> PredictiveState:
    """One-time extraction: all query-independent factorisations and solves
    (O(m^3) once), in the inputs' dtype, on ``device`` (default CUDA)."""
    dev = resolve_device(device)
    kernel = cov.as_kernel(kernel)
    hyp = {k: v.to(dev) for k, v in hyp.items()}
    z = z.to(dev)
    stats = Stats(*(t.to(dev) for t in stats))
    beta = torch.exp(hyp["log_beta"])
    L, LB, _, c2 = _whitened(hyp, z, stats, jitter, kernel)
    eye = torch.eye(z.shape[0], dtype=z.dtype, device=dev)
    v1 = torch.linalg.solve_triangular(L, eye, upper=False).T     # L^-T
    v2 = v1 @ torch.linalg.solve_triangular(LB, eye, upper=False).T
    return PredictiveState(hyp=hyp, z=z, chol_kmm=L, chol_sigma=LB, c2=c2,
                           a_mean=beta * (v2 @ c2), g=v1 @ v1.T - v2 @ v2.T,
                           kernel=kernel)


def state_from_model(model) -> PredictiveState:
    """Extract from a fitted ``SGPR`` or ``BayesianGPLVM``: its exact
    map-reduce once for the reduced Stats, then :func:`extract_state` on the
    model's device (a GPLVM's state answers latent queries)."""
    return extract_state(model.params["hyp"], model.params["z"],
                         model._stats(), jitter=model.jitter,
                         kernel=model.kernel, device=model.device)


# -- query-side math (the engine runs it per batch) -------------------------

def predict_mean_var(state: PredictiveState, xstar):
    """Diag-variance predictive posterior at ``xstar`` (t, q): noise-free
    ``(mean (t, d), var (t,))``.  ``mean``/``quad`` come from the fused
    predict kernel on CUDA, from its plain version on the CPU."""
    mean, quad = p_ops.predict_stats(state.hyp, state.z, state.a_mean,
                                     state.g, xstar)
    return mean, state.kernel.kdiag(state.hyp, xstar) - quad


def predict_full_cov(state: PredictiveState, xstar):
    """Full predictive covariance: ``(mean (t, d), cov (t, t))``, noise-free.
    Cross-covariances couple every query pair, so this is one piece (the
    small-t mode); the mean comes from the predict kernel."""
    mean, _ = p_ops.predict_stats(state.hyp, state.z, state.a_mean, state.g,
                                  xstar)
    ksm = state.kernel.K(state.hyp, xstar, state.z)
    kss = state.kernel.K(state.hyp, xstar, xstar)
    return mean, kss - ksm @ state.g @ ksm.T


# -- persistence (the JAX package's checkpoint format) -----------------------

_RESERVED = {"m", "q", "d", "dtype", "kernel"}


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


def save_state(path: str | pathlib.Path, state: PredictiveState,
               metadata: dict | None = None) -> pathlib.Path:
    """Atomic write; shape metadata rides in the sidecar so
    :func:`load_state` needs no template.  ``m``/``q``/``d``/``dtype``/
    ``kernel`` are reserved for that template."""
    clash = _RESERVED & set(metadata or ())
    if clash:
        raise ValueError(
            f"metadata keys {sorted(clash)} are reserved for the restore "
            "template — rename them")
    meta = {**(metadata or {}), "m": state.m, "q": state.q, "d": state.d,
            "dtype": _dtype_name(state.dtype), "kernel": state.kernel.to_spec()}
    return ckpt.save(path, state, metadata=meta)


def load_state(path: str | pathlib.Path, device=None
               ) -> tuple[PredictiveState, dict]:
    """Restore a :class:`PredictiveState` (plus metadata) onto ``device``
    (default CUDA) from the sidecar's (m, q, d, dtype, kernel) alone.
    Reads files written by this package or by ``repro.serve.save_state``."""
    dev = resolve_device(device)
    md = json.loads(pathlib.Path(path).with_suffix(".json").read_text())[
        "metadata"]
    m, q, d = md["m"], md["q"], md["d"]
    dt = getattr(torch, md.get("dtype", "float64"))
    kernel = cov.kernel_from_spec(md.get("kernel", {"kind": "se"}))

    def like(*shape):
        return torch.empty(shape, dtype=dt, device="meta")

    template = PredictiveState(
        hyp={**{k: like(*s) for k, s in kernel.hyp_shapes(q).items()},
             "log_beta": like()},
        z=like(m, q), chol_kmm=like(m, m), chol_sigma=like(m, m),
        c2=like(m, d), a_mean=like(m, d), g=like(m, m), kernel=kernel)
    return ckpt.restore(path, template, dev)
