"""Frozen predictive state: the training -> serving handoff.

Counterpart of ``repro.serve.posterior``.  :func:`extract_state` performs
every query-independent solve once,

    L  = chol(Kmm),  LB = chol(I + b L^-1 D L^-T),  c2 = LB^-1 L^-1 C,

and folds them into the two serving contractions the per-query path uses,

    a_mean = b L^-T LB^-T c2     (m, d)   mean = K*m @ a_mean
    g      = Kmm^-1 - Sigma^-1   (m, m)   var  = k** - rowsum((K*m @ g) * K*m)

so a server answers queries with no triangular solve.  ``save_state`` /
``load_state`` write the JAX package's checkpoint format, leaf for leaf.

``sample_block`` / ``sample_joint`` draw joint posterior functions through
the stored factors (``_mean_cov_from_factors``) and a jittered f64
Cholesky; ``_sample_from_normals`` is their body given the standard
normals, so tests can feed both packages the same draws (torch's and
``jax.random``'s generators differ).  Where JAX's Cholesky of an
indefinite block returns NaN draws, torch's raises.
"""
from __future__ import annotations

import dataclasses
import json
import pathlib

import numpy as np
import torch

from .. import checkpoint as ckpt
from .._device import resolve_device
from ..core import covariance as cov
from ..core.bound import DEFAULT_JITTER, _whitened
from ..core.flat import tree_leaves, tree_map
from ..core.stats import Stats
from ..kernels.predict import ops as p_ops


@dataclasses.dataclass(frozen=True)
class PredictiveState:
    """Everything prediction needs, none of it query-dependent.

    ``chol_kmm``/``chol_sigma``/``c2`` are the raw q(u) factors;
    ``a_mean``/``g`` are the serving contractions.  ``kernel`` is static
    (it rides in the checkpoint sidecar as its spec, not as a leaf).
    """

    hyp: dict                  # the expression's (nested) tree + "log_beta"
    z: torch.Tensor            # (m, q) inducing inputs
    chol_kmm: torch.Tensor     # (m, m) L = chol(Kmm + jitter)
    chol_sigma: torch.Tensor   # (m, m) LB = chol(I + b L^-1 D L^-T)
    c2: torch.Tensor           # (m, d) LB^-1 L^-1 C
    a_mean: torch.Tensor       # (m, d) b L^-T LB^-T c2
    g: torch.Tensor            # (m, m) Kmm^-1 - Sigma^-1
    kernel: cov.Kernel = cov.SE_ARD

    # Counted from the right, so a stacked state (``serve.stack_states``:
    # a leading model axis) reads the same m, q and d.
    @property
    def m(self) -> int:
        return self.z.shape[-2]

    @property
    def q(self) -> int:
        return self.z.shape[-1]

    @property
    def d(self) -> int:
        return self.c2.shape[-1]

    @property
    def dtype(self) -> torch.dtype:
        return self.z.dtype

    def astype(self, dtype) -> "PredictiveState":
        """Every leaf, hyper-parameters included, quantized (or widened) to
        ``dtype``, on the leaves' own device: the wire and disk format a
        server is shipped (``astype(torch.bfloat16)`` quarters the f64
        bytes).  An engine lifts a sub-f32 state once to its compute dtype,
        so the loss is the storage rounding alone.

        Rounds as the JAX package's ``astype`` does, bit for bit: torch's
        cast rounds an f64 to f16 through f32, twice (a few values in 1e5
        land one f16 step off), where JAX rounds once; f16 is therefore
        rounded on the host by numpy, which rounds once.  The other dtypes
        take torch's cast, which gives JAX's bits."""
        return self._map(lambda t: _cast(t, dtype))

    @property
    def nbytes(self) -> int:
        """Total bytes of the state's leaves (what ships to a server)."""
        return sum(t.numel() * t.element_size() for t in self._leaves())

    def _leaves(self):
        return [*tree_leaves(self.hyp),
                *(getattr(self, f) for f in _ARRAY_FIELDS)]

    def _map(self, fn) -> "PredictiveState":
        return dataclasses.replace(
            self, hyp=tree_map(fn, self.hyp),
            **{f: fn(getattr(self, f)) for f in _ARRAY_FIELDS})

    def _to(self, device=None, dtype=None) -> "PredictiveState":
        """Every leaf, hypers included, moved/cast; what the engine needs to
        hold its compute-width copy on its device."""
        return self._map(lambda t: t.to(device=device, dtype=dtype))


_ARRAY_FIELDS = ("z", "chol_kmm", "chol_sigma", "c2", "a_mean", "g")


def _cast(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``t`` in ``dtype``, rounded once (see ``PredictiveState.astype``)."""
    if dtype != torch.float16 or t.dtype in (torch.float16, torch.float32):
        return t.to(dtype)
    host = t.detach().cpu()
    if host.dtype == torch.bfloat16:   # numpy has no bf16; f32 holds it exactly
        host = host.float()
    return torch.from_numpy(host.numpy().astype(np.float16)).to(t.device)


@torch.no_grad()
def extract_state(hyp: dict, z, stats: Stats, jitter: float = DEFAULT_JITTER,
                  kernel=None, device=None) -> PredictiveState:
    """One-time extraction: all query-independent factorisations and solves
    (O(m^3) once), in the inputs' dtype, on ``device`` (default CUDA)."""
    dev = resolve_device(device)
    kernel = cov.as_kernel(kernel)
    hyp = tree_map(lambda v: v.to(dev), hyp)
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
    ``(mean (t, d), var (t,))``.  The state's expression picks the route
    (``kernels.predict.predict_fn_for_engine``): for the full-width SE-ARD
    ``mean``/``quad`` come from the fused predict kernel on CUDA and its
    plain version on the CPU; every other expression answers through
    :func:`predict_mean_var_plain` on any device."""
    return p_ops.predict_fn_for_engine(state.kernel)(state, xstar)


def predict_mean_var_plain(state: PredictiveState, xstar):
    """:func:`predict_mean_var` as plain torch matmuls on any device, which
    autograd differentiates in ``xstar``: ``(mean (t, d), var (t,))``,
    noise-free.

    The differentiable route of ``BayesianGPLVM.reconstruct``'s objective.
    The JAX package's Pallas predict has no VJP either
    (``src/repro/kernels/predict/ops.py:13-17``), and its ``reconstruct``
    differentiates the plain XLA composition of these same products
    (``src/repro/serve/posterior.py:158-169``); so does this one.  A
    prediction that needs no gradient takes the kernel."""
    ksm = state.kernel.K(state.hyp, xstar, state.z)          # (t, m)
    mean = ksm @ state.a_mean
    quad = ((ksm @ state.g) * ksm).sum(1)
    return mean, state.kernel.kdiag(state.hyp, xstar) - quad


def predict_full_cov(state: PredictiveState, xstar):
    """Full predictive covariance: ``(mean (t, d), cov (t, t))``, noise-free.
    Cross-covariances couple every query pair, so this is one piece (the
    small-t mode); the mean comes from the predict kernel for the full-width
    SE-ARD, from the plain product otherwise."""
    ksm = state.kernel.K(state.hyp, xstar, state.z)
    mean = (p_ops.predict_stats(state.hyp, state.z, state.a_mean, state.g,
                                xstar)[0] if cov.is_fused_se(state.kernel)
            else ksm @ state.a_mean)
    kss = state.kernel.K(state.hyp, xstar, xstar)
    return mean, kss - ksm @ state.g @ ksm.T


# -- posterior sampling ---------------------------------------------------------

def _mean_cov_from_factors(state: PredictiveState, xstar):
    """Joint moments through the stored Cholesky factors, not ``g``:
    ``cov = kss - a1^T a1 + a2^T a2`` with ``a1 = L^-1 Km*`` and
    ``a2 = LB^-1 a1``.  Every intermediate stays O(kss), where ``g``'s
    O(cond(Kmm)) entries cancel: fine for a variance read once, fatal for a
    matrix that must stay positive definite enough to factor."""
    ksm = state.kernel.K(state.hyp, xstar, state.z)
    mean = ksm @ state.a_mean
    a1 = torch.linalg.solve_triangular(state.chol_kmm, ksm.T, upper=False)
    a2 = torch.linalg.solve_triangular(state.chol_sigma, a1, upper=False)
    kss = state.kernel.K(state.hyp, xstar, xstar)
    return mean, kss - a1.T @ a1 + a2.T @ a2


def _jittered_chol(state: PredictiveState, covm, t: int, jitter: float,
                   include_noise: bool):
    """``chol(cov + jitter * vs * I [+ I / beta])``, the sampling factor.
    The jitter is scaled by the expression's signal variance (the
    ``_chol_kmm`` convention); it also keeps the factor defined on a padded
    block, whose duplicated zero rows make ``cov`` exactly singular."""
    diag = jitter * state.kernel.variance_scale(state.hyp) + 1e-12
    if include_noise:
        diag = diag + torch.exp(-state.hyp["log_beta"])
    eye = torch.eye(t, dtype=covm.dtype, device=covm.device)
    return torch.linalg.cholesky(covm + diag * eye)


def _check_sampling_state(state: PredictiveState) -> None:
    if torch.finfo(state.dtype).bits < 32:
        raise ValueError(
            "sampling rebuilds the predictive covariance from the stored "
            "chol factors, and sub-f32 storage rounding can make it "
            "indefinite beyond any reasonable jitter; sample from an "
            "f32/f64 PredictiveState (quantized states serve mean/var only)")


def _sample_from_normals(state: PredictiveState, x_blk, eps,
                         jitter: float = DEFAULT_JITTER,
                         include_noise: bool = False):
    """Joint draws over one query block from given standard normals:
    ``mean + chol(cov) @ eps`` for ``eps`` (num_samples, t, d), in
    ``x_blk``'s dtype.  The moments and the factor are computed in f64
    whatever the compute dtype (the covariance of nearby queries is
    near-singular by nature), and the draws are cast back.  Row i of a
    draw reads covariance rows 0..i only (the factor is lower-triangular),
    so pad rows after the real ones never change them."""
    _check_sampling_state(state)
    f64 = torch.float64
    st = state if state.dtype == f64 else state._to(dtype=f64)
    mean, covm = _mean_cov_from_factors(st, x_blk.to(f64))
    lc = _jittered_chol(st, covm, x_blk.shape[0], jitter, include_noise)
    draws = mean[None] + torch.einsum("ij,sjd->sid", lc, eps.to(f64))
    return draws.to(x_blk.dtype)


def _generator(key, device) -> torch.Generator:
    """A ``torch.Generator`` as given, or a fresh one on ``device`` seeded
    with the integer ``key``."""
    if isinstance(key, torch.Generator):
        return key
    return torch.Generator(device=device).manual_seed(int(key))


def sample_block(state: PredictiveState, x_blk, key, num_samples: int,
                 jitter: float = DEFAULT_JITTER, include_noise: bool = False):
    """Joint posterior samples over one query block: (num_samples, t, d).

    ``key`` is a ``torch.Generator`` on the state's device or an integer
    seed (the counterpart of a ``jax.random`` key); the standard normals
    are drawn from it in f64 on the state's device, then
    :func:`_sample_from_normals` turns them into draws.  The output dims
    share one (t, t) factor (the SGPR predictive factorises over d)."""
    dev = state.z.device
    eps = torch.randn((num_samples, x_blk.shape[0], state.d),
                      generator=_generator(key, dev), dtype=torch.float64,
                      device=dev)
    return _sample_from_normals(state, x_blk, eps, jitter, include_noise)


def sample_joint(state: PredictiveState, xstar, key, num_samples: int,
                 jitter: float = DEFAULT_JITTER, include_noise: bool = False):
    """One-piece joint samples over all queries: (num_samples, t, d), the
    small-t analogue of :func:`predict_full_cov` (O(t^2) memory, O(t^3)
    factor).  ``PredictEngine.sample`` draws jointly within fixed-size
    blocks and independently across them."""
    x = torch.as_tensor(xstar).to(device=state.z.device, dtype=state.dtype)
    return sample_block(state, x, key, num_samples, jitter=jitter,
                        include_noise=include_noise)


# -- persistence (the JAX package's checkpoint format) -----------------------

_RESERVED = {"m", "q", "d", "dtype", "kernel"}


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


def state_metadata(state: PredictiveState, metadata: dict | None = None
                   ) -> dict:
    """The sidecar of a saved state: ``metadata`` plus the restore
    template's ``m``/``q``/``d``/``dtype``/``kernel``, which it may not
    shadow.  ``checkpoint.save`` (or ``AsyncCheckpointer.save``) of a state
    with this metadata is what :func:`save_state` writes."""
    clash = _RESERVED & set(metadata or ())
    if clash:
        raise ValueError(
            f"metadata keys {sorted(clash)} are reserved for the restore "
            "template — rename them")
    return {**(metadata or {}), "m": state.m, "q": state.q, "d": state.d,
            "dtype": _dtype_name(state.dtype), "kernel": state.kernel.to_spec()}


def save_state(path: str | pathlib.Path, state: PredictiveState,
               metadata: dict | None = None) -> pathlib.Path:
    """Atomic write; shape metadata rides in the sidecar so
    :func:`load_state` needs no template.  ``m``/``q``/``d``/``dtype``/
    ``kernel`` are reserved for that template.  A ``<base>_step<N>`` path
    rotates as ``checkpoint.save`` does (3 kept)."""
    return ckpt.save(path, state, metadata=state_metadata(state, metadata))


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

    def like(shape):
        return torch.empty(shape, dtype=dt, device="meta")

    template = PredictiveState(
        hyp=tree_map(like, cov.full_hyp_shapes(kernel, q)),
        z=like((m, q)), chol_kmm=like((m, m)), chol_sigma=like((m, m)),
        c2=like((m, d)), a_mean=like((m, d)), g=like((m, m)), kernel=kernel)
    return ckpt.restore(path, template, dev)
