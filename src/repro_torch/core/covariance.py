"""Compositional covariance expressions with psi-statistics dispatch
(counterpart of ``repro.core.covariance``).

Primitive kernels are frozen dataclasses (hashable structure; every number
lives in the ``hyp`` dict) with one interface:

    K(hyp, a, b)            (n, m)  cross-covariance
    kdiag(hyp, a)           (n,)    diag(K_aa)
    psi0(hyp, mu, s)        (n,)    <k(x_i, x_i)>_q
    psi1(hyp, z, mu, s)     (n, m)  <k(x_i, z_m)>_q
    psi2_per_point(...)     (n, m, m)
    psi2(hyp, z, mu, s, w)  (m, m)  Sum_i w_i <k(x_i,z_a) k(x_i,z_b)>_q

Primitives read their own keys (``log_sf2``/``log_ell``/``log_sv2``/
``log_period``) and ignore the others (``log_beta`` rides in the same
dict); combinators nest each child's parameters under ``"k0"``, ``"k1"``,
... .  Psi statistics are analytic where a closed form exists (SE-ARD,
Linear, disjoint-dims compositions) and tensor-product Gauss–Hermite
quadrature otherwise (Matern32, Periodic, overlapping compositions), as in
the JAX package.  ``to_spec()`` / :func:`kernel_from_spec` give the JAX
package's JSON, key for key, so serving sidecars cross between the
packages.

The route on CUDA.  The hand-written kernels specialise the full-width
SE-ARD (:func:`is_fused_se`): its ``psi1``/``psi2`` are the psi kernels,
and the map and serving shims (``kernels.*.ops``) send its regression
statistics and predictions to the ``reg_stats`` and ``predict`` kernels.
Every other expression takes the plain torch math below, on any device, as
the JAX package's shims keep Pallas for ``is_fused_se`` only.  Inside a
combinator, one child reaches a kernel: a full-width SE-ARD child's
``psi1``, through ``Sum.psi1`` (linearity calls each child's own psi1).
Such a child never makes a Sum or Product pairwise disjoint, so their
psi2 (and a Product's psi0/psi1) take the quadrature, which reads only
``K``/``kdiag`` and launches nothing.  The kernels' launch counters show
each route (``tests/test_torch_cuda.py``).
"""
from __future__ import annotations

import dataclasses
import json
import math
from dataclasses import dataclass
from typing import ClassVar

import numpy as np
import torch

from ..kernels.psi_stats import ops as psi_ops
from . import gp_kernels as gpk

# -- registry ----------------------------------------------------------------

_REGISTRY: dict[str, type] = {}


def register_kernel(name: str):
    """Class decorator: add a kernel expression class to the spec registry."""

    def wrap(cls):
        cls.kind = name
        _REGISTRY[name] = cls
        return cls

    return wrap


def kernel_names() -> tuple[str, ...]:
    """Registered expression kinds (primitives and combinators)."""
    return tuple(sorted(_REGISTRY))


# -- Gauss–Hermite quadrature fallback ---------------------------------------

def _gh_grid(n_dims: int, order: int):
    """Tensor-product Gauss–Hermite grid for E_{t~N(0,I)}[f(t)] over
    ``n_dims`` dims: unit-Gaussian nodes (J, n_dims) and weights (J,), with
    J = order**n_dims (numpy)."""
    t, w = np.polynomial.hermite.hermgauss(order)   # ∫ e^{-t²} f(t) dt
    t = t * np.sqrt(2.0)                            # unit-Gaussian nodes
    w = w / np.sqrt(np.pi)
    grids = np.meshgrid(*([t] * n_dims), indexing="ij")
    nodes = np.stack([g.ravel() for g in grids], axis=-1)
    ws = np.ones((order ** n_dims,))
    for g in np.meshgrid(*([w] * n_dims), indexing="ij"):
        ws = ws * g.ravel()
    return nodes, ws


def _gh_points(kernel: "Kernel", mu: torch.Tensor, s: torch.Tensor):
    """Sample points of q(X) on the kernel's support dims: ``(xs (n, J, q),
    ws (J,))``, the other dims pinned at mu (the kernel never reads them)."""
    n, q = mu.shape
    dims = kernel.support_dims(q)
    nodes, ws = _gh_grid(len(dims), kernel.quad_order)
    nodes = torch.as_tensor(nodes, dtype=mu.dtype, device=mu.device)
    ws = torch.as_tensor(ws, dtype=mu.dtype, device=mu.device)
    j = nodes.shape[0]
    pos = {d: i for i, d in enumerate(dims)}
    cols = [mu[:, c, None] + torch.sqrt(s[:, c, None]) * nodes[None, :, pos[c]]
            if c in pos else mu[:, c, None].expand(n, j) for c in range(q)]
    return torch.stack(cols, -1), ws


def psi0_quad(kernel: "Kernel", hyp: dict, mu, s) -> torch.Tensor:
    """<k(x_i, x_i)> by Gauss–Hermite quadrature: (n,)."""
    xs, ws = _gh_points(kernel, mu, s)
    n, j, q = xs.shape
    return kernel.kdiag(hyp, xs.reshape(n * j, q)).reshape(n, j) @ ws


def psi1_quad(kernel: "Kernel", hyp: dict, z, mu, s) -> torch.Tensor:
    """<k(x_i, z_m)> by Gauss–Hermite quadrature: (n, m)."""
    xs, ws = _gh_points(kernel, mu, s)
    n, j, q = xs.shape
    k = kernel.K(hyp, xs.reshape(n * j, q), z).reshape(n, j, -1)
    return torch.einsum("j,njm->nm", ws, k)


def psi2_per_point_quad(kernel: "Kernel", hyp: dict, z, mu, s
                        ) -> torch.Tensor:
    """<k(x_i, z_a) k(x_i, z_b)> by Gauss–Hermite quadrature: (n, m, m)."""
    xs, ws = _gh_points(kernel, mu, s)
    n, j, q = xs.shape
    k = kernel.K(hyp, xs.reshape(n * j, q), z).reshape(n, j, -1)
    return torch.einsum("j,nja,njb->nab", ws, k, k)


# -- the expression interface ------------------------------------------------

@dataclass(frozen=True)
class Kernel:
    """Base covariance expression: frozen structure, numbers in ``hyp``."""

    kind: ClassVar[str] = "?"

    # The quadrature order of the fallback psi statistics; analytic
    # expressions never read it.
    quad_order: ClassVar[int] = 11

    def K(self, hyp: dict, a, b) -> torch.Tensor:
        raise NotImplementedError

    def kdiag(self, hyp: dict, a) -> torch.Tensor:
        raise NotImplementedError

    # -- psi statistics (defaults: the quadrature fallback) -----------------
    def psi0(self, hyp: dict, mu, s) -> torch.Tensor:
        return psi0_quad(self, hyp, mu, s)

    def psi1(self, hyp: dict, z, mu, s) -> torch.Tensor:
        return psi1_quad(self, hyp, z, mu, s)

    def psi2_per_point(self, hyp: dict, z, mu, s) -> torch.Tensor:
        return psi2_per_point_quad(self, hyp, z, mu, s)

    def psi2(self, hyp: dict, z, mu, s, w) -> torch.Tensor:
        """Weighted Psi2 (the D statistic): the per-point form contracted
        with ``w``."""
        return torch.einsum("i,iab->ab", w, self.psi2_per_point(hyp, z, mu,
                                                                s))

    # -- structure -----------------------------------------------------------
    def support_dims(self, q: int) -> tuple[int, ...]:
        """Input dims this expression reads (quadrature integrates these)."""
        dims = getattr(self, "dims", None)
        return tuple(range(q)) if dims is None else tuple(dims)

    def analytic_psi(self) -> bool:
        """True when every psi statistic has a closed form."""
        return False

    def variance_scale(self, hyp: dict) -> torch.Tensor:
        """An O(signal-variance) scalar that scales the Cholesky jitter."""
        raise NotImplementedError

    def hyp_shapes(self, q: int) -> dict:
        """Shape tree of the expression's parameters (``log_beta``, a model
        parameter, excluded)."""
        raise NotImplementedError

    def default_hyp(self, q: int, var_y: float = 1.0) -> dict:
        """Data-driven init of the parameter subtree (numpy)."""
        raise NotImplementedError

    # -- serialisation -------------------------------------------------------
    def to_spec(self) -> dict:
        """JSON-able spec, the JAX package's; :func:`kernel_from_spec`
        inverts it."""
        out = {"kind": self.kind}
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if f.name == "parts":
                v = [p.to_spec() for p in v]
            elif isinstance(v, tuple):
                v = list(v)
            out[f.name] = v
        return out

    def __str__(self) -> str:
        return json.dumps(self.to_spec())


def _as_dims(dims) -> tuple[int, ...] | None:
    return None if dims is None else tuple(int(d) for d in dims)


def _sl(a: torch.Tensor, dims: tuple[int, ...] | None) -> torch.Tensor:
    """The active dims of the trailing axis (``a`` itself when None)."""
    return a if dims is None else a[..., list(dims)]


def _q_eff(q: int, dims) -> int:
    return q if dims is None else len(dims)


def _const(hyp_val: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """``hyp_val`` broadcast over ``like``'s leading dims, in its dtype."""
    return hyp_val.to(like.dtype).expand(like.shape[:-1])


# -- primitives --------------------------------------------------------------

@register_kernel("se")
@dataclass(frozen=True)
class SEARD(Kernel):
    """Squared-exponential ARD, the paper's kernel; every psi statistic in
    closed form (``gp_kernels``).  At full width its psi1/psi2 are the psi
    kernels on CUDA (their plain versions on the CPU)."""

    dims: tuple[int, ...] | None = None

    def __post_init__(self):
        object.__setattr__(self, "dims", _as_dims(self.dims))

    def K(self, hyp, a, b):
        return gpk.se_kernel(hyp, _sl(a, self.dims), _sl(b, self.dims))

    def kdiag(self, hyp, a):
        return gpk.se_kdiag(hyp, _sl(a, self.dims))

    def psi0(self, hyp, mu, s):
        return gpk.se_psi0(hyp, _sl(mu, self.dims), _sl(s, self.dims))

    def psi1(self, hyp, z, mu, s):
        if self.dims is None:
            return psi_ops.psi1(hyp, z, mu, s)
        return gpk.se_psi1(hyp, _sl(z, self.dims), _sl(mu, self.dims),
                           _sl(s, self.dims))

    def psi2(self, hyp, z, mu, s, w):
        if self.dims is None:
            return psi_ops.psi2(hyp, z, mu, s, w)
        return super().psi2(hyp, z, mu, s, w)

    def psi2_per_point(self, hyp, z, mu, s):
        return gpk.psi2_per_point(hyp, _sl(z, self.dims), _sl(mu, self.dims),
                                  _sl(s, self.dims))

    def analytic_psi(self):
        return True

    def variance_scale(self, hyp):
        return torch.exp(hyp["log_sf2"])

    def hyp_shapes(self, q):
        return {"log_sf2": (), "log_ell": (_q_eff(q, self.dims),)}

    def default_hyp(self, q, var_y=1.0):
        qe = _q_eff(q, self.dims)
        return {"log_sf2": np.log(var_y),
                "log_ell": np.ones((qe,)) * 0.5 * np.log(max(qe, 1))}


@register_kernel("matern32")
@dataclass(frozen=True)
class Matern32(Kernel):
    """Matérn-3/2 with ARD lengthscales, ``sf2 (1 + √3 r) exp(−√3 r)``;
    psi1/psi2 by quadrature (no closed form), psi0 = sf2."""

    dims: tuple[int, ...] | None = None
    quad_order: int = 11

    def __post_init__(self):
        object.__setattr__(self, "dims", _as_dims(self.dims))

    def K(self, hyp, a, b):
        ell = torch.exp(hyp["log_ell"])
        sf2 = torch.exp(hyp["log_sf2"])
        r2 = gpk.sqdist(_sl(a, self.dims) / ell, _sl(b, self.dims) / ell)
        # Safe sqrt: the clamp keeps the derivative finite at r = 0.
        sr3 = math.sqrt(3.0) * torch.sqrt(torch.clamp(r2, min=1e-36))
        return sf2 * (1.0 + sr3) * torch.exp(-sr3)

    def kdiag(self, hyp, a):
        return _const(torch.exp(hyp["log_sf2"]), a)

    def psi0(self, hyp, mu, s):
        # <k(x,x)> = sf2 exactly (stationary): no quadrature.
        return _const(torch.exp(hyp["log_sf2"]), mu)

    def variance_scale(self, hyp):
        return torch.exp(hyp["log_sf2"])

    def hyp_shapes(self, q):
        return {"log_sf2": (), "log_ell": (_q_eff(q, self.dims),)}

    def default_hyp(self, q, var_y=1.0):
        qe = _q_eff(q, self.dims)
        return {"log_sf2": np.log(var_y),
                "log_ell": np.ones((qe,)) * 0.5 * np.log(max(qe, 1))}


@register_kernel("linear")
@dataclass(frozen=True)
class Linear(Kernel):
    """Linear kernel with per-dim variances, ``Σ_q sv2_q x_q x'_q``; every
    psi statistic in closed form (Gaussian second moments)."""

    dims: tuple[int, ...] | None = None

    def __post_init__(self):
        object.__setattr__(self, "dims", _as_dims(self.dims))

    def _sv2(self, hyp):
        return torch.exp(hyp["log_sv2"])

    def K(self, hyp, a, b):
        return (_sl(a, self.dims) * self._sv2(hyp)) @ _sl(b, self.dims).T

    def kdiag(self, hyp, a):
        ad = _sl(a, self.dims)
        return (self._sv2(hyp) * ad * ad).sum(-1)

    def psi0(self, hyp, mu, s):
        mud, sd = _sl(mu, self.dims), _sl(s, self.dims)
        return (self._sv2(hyp) * (mud * mud + sd)).sum(-1)

    def psi1(self, hyp, z, mu, s):
        return (_sl(mu, self.dims) * self._sv2(hyp)) @ _sl(z, self.dims).T

    def psi2_per_point(self, hyp, z, mu, s):
        # <k(x,za) k(x,zb)> = (zaᵀΛμ)(zbᵀΛμ) + zaᵀ Λ diag(S) Λ zb
        sv2 = self._sv2(hyp)
        zd, mud, sd = _sl(z, self.dims), _sl(mu, self.dims), _sl(s, self.dims)
        p1 = (mud * sv2) @ zd.T                               # (n, m)
        t2 = torch.einsum("aq,nq,bq->nab", zd, (sv2 * sv2) * sd, zd)
        return p1[:, :, None] * p1[:, None, :] + t2

    def analytic_psi(self):
        return True

    def variance_scale(self, hyp):
        return torch.mean(self._sv2(hyp))

    def hyp_shapes(self, q):
        return {"log_sv2": (_q_eff(q, self.dims),)}

    def default_hyp(self, q, var_y=1.0):
        qe = _q_eff(q, self.dims)
        return {"log_sv2": np.full((qe,), np.log(var_y / max(qe, 1)))}


@register_kernel("periodic")
@dataclass(frozen=True)
class Periodic(Kernel):
    """Exp-sine-squared (MacKay) kernel, ARD per dim,
    ``sf2 exp(−2 Σ_q sin²(π d_q / p_q) / ℓ_q²)``; psi1/psi2 by quadrature,
    psi0 = sf2."""

    dims: tuple[int, ...] | None = None
    quad_order: int = 11

    def __post_init__(self):
        object.__setattr__(self, "dims", _as_dims(self.dims))

    def K(self, hyp, a, b):
        ell2 = torch.exp(2.0 * hyp["log_ell"])
        per = torch.exp(hyp["log_period"])
        sf2 = torch.exp(hyp["log_sf2"])
        d = _sl(a, self.dims)[:, None, :] - _sl(b, self.dims)[None, :, :]
        sin2 = torch.sin(math.pi * d / per) ** 2
        return sf2 * torch.exp(-2.0 * (sin2 / ell2).sum(-1))

    def kdiag(self, hyp, a):
        return _const(torch.exp(hyp["log_sf2"]), a)

    def psi0(self, hyp, mu, s):
        return _const(torch.exp(hyp["log_sf2"]), mu)

    def variance_scale(self, hyp):
        return torch.exp(hyp["log_sf2"])

    def hyp_shapes(self, q):
        qe = _q_eff(q, self.dims)
        return {"log_sf2": (), "log_ell": (qe,), "log_period": (qe,)}

    def default_hyp(self, q, var_y=1.0):
        qe = _q_eff(q, self.dims)
        return {"log_sf2": np.log(var_y), "log_ell": np.zeros((qe,)),
                "log_period": np.zeros((qe,))}


# -- combinators -------------------------------------------------------------

def _sub(hyp: dict, i: int) -> dict:
    return hyp[f"k{i}"]


def _pairwise_disjoint(parts) -> bool:
    """True when every child declares ``dims`` and no dim is shared: under a
    diagonal q(X) the children are then independent functions of x, so
    cross-expectations factor."""
    seen: set[int] = set()
    for p in parts:
        dims = getattr(p, "dims", None)
        if dims is None or seen & set(dims):
            return False
        seen |= set(dims)
    return True


def _prod(terms):
    out = terms[0]
    for t in terms[1:]:
        out = out * t
    return out


@dataclass(frozen=True, init=False)
class _Combinator(Kernel):
    parts: tuple[Kernel, ...]
    quad_order: int

    def __init__(self, *parts: Kernel, quad_order: int = 11):
        if len(parts) < 2:
            raise ValueError(f"{type(self).__name__} needs >= 2 child "
                             f"kernels, got {len(parts)}")
        object.__setattr__(self, "parts", tuple(parts))
        object.__setattr__(self, "quad_order", int(quad_order))

    def _each(self, method: str, hyp: dict, *args) -> list:
        return [getattr(p, method)(_sub(hyp, i), *args)
                for i, p in enumerate(self.parts)]

    def support_dims(self, q):
        dims: set[int] = set()
        for p in self.parts:
            dims |= set(p.support_dims(q))
        return tuple(sorted(dims))

    def analytic_psi(self):
        return (all(p.analytic_psi() for p in self.parts)
                and _pairwise_disjoint(self.parts))

    def hyp_shapes(self, q):
        return {f"k{i}": p.hyp_shapes(q) for i, p in enumerate(self.parts)}

    def to_spec(self):
        return {"kind": self.kind,
                "parts": [p.to_spec() for p in self.parts],
                "quad_order": self.quad_order}


@register_kernel("sum")
@dataclass(frozen=True, init=False)
class Sum(_Combinator):
    """``k = Σ_i k_i``: psi0/psi1 exact by linearity; psi2 cross terms
    factor for disjoint-dims children, else the composite's quadrature."""

    def K(self, hyp, a, b):
        return sum(self._each("K", hyp, a, b))

    def kdiag(self, hyp, a):
        return sum(self._each("kdiag", hyp, a))

    def psi0(self, hyp, mu, s):
        return sum(self._each("psi0", hyp, mu, s))

    def psi1(self, hyp, z, mu, s):
        return sum(self._each("psi1", hyp, z, mu, s))

    def psi2_per_point(self, hyp, z, mu, s):
        if not _pairwise_disjoint(self.parts):
            return psi2_per_point_quad(self, hyp, z, mu, s)
        p1s = self._each("psi1", hyp, z, mu, s)
        out = sum(self._each("psi2_per_point", hyp, z, mu, s))
        for i in range(len(self.parts)):
            for j in range(i + 1, len(self.parts)):
                cross = p1s[i][:, :, None] * p1s[j][:, None, :]
                out = out + cross + cross.transpose(1, 2)
        return out

    def variance_scale(self, hyp):
        return sum(self._each("variance_scale", hyp))

    def default_hyp(self, q, var_y=1.0):
        share = var_y / len(self.parts)
        return {f"k{i}": p.default_hyp(q, share)
                for i, p in enumerate(self.parts)}


@register_kernel("product")
@dataclass(frozen=True, init=False)
class Product(_Combinator):
    """``k = Π_i k_i``: every psi statistic factors into the children's for
    pairwise-disjoint children, else the composite's quadrature."""

    def K(self, hyp, a, b):
        return _prod(self._each("K", hyp, a, b))

    def kdiag(self, hyp, a):
        return _prod(self._each("kdiag", hyp, a))

    def psi0(self, hyp, mu, s):
        if not _pairwise_disjoint(self.parts):
            return psi0_quad(self, hyp, mu, s)
        return _prod(self._each("psi0", hyp, mu, s))

    def psi1(self, hyp, z, mu, s):
        if not _pairwise_disjoint(self.parts):
            return psi1_quad(self, hyp, z, mu, s)
        return _prod(self._each("psi1", hyp, z, mu, s))

    def psi2_per_point(self, hyp, z, mu, s):
        if not _pairwise_disjoint(self.parts):
            return psi2_per_point_quad(self, hyp, z, mu, s)
        return _prod(self._each("psi2_per_point", hyp, z, mu, s))

    def variance_scale(self, hyp):
        return _prod(self._each("variance_scale", hyp))

    def default_hyp(self, q, var_y=1.0):
        share = var_y ** (1.0 / len(self.parts))
        return {f"k{i}": p.default_hyp(q, share)
                for i, p in enumerate(self.parts)}


# -- defaults and dispatch helpers -------------------------------------------

SE_ARD = SEARD()


def default_kernel() -> SEARD:
    """The default covariance: the paper's SE-ARD at full width."""
    return SE_ARD


def as_kernel(kernel) -> Kernel:
    """None -> SE-ARD; a spec string/dict -> parsed; an expression -> itself."""
    if kernel is None:
        return SE_ARD
    if isinstance(kernel, Kernel):
        return kernel
    if isinstance(kernel, (str, dict)):
        return kernel_from_spec(kernel)
    raise TypeError(f"not a kernel expression: {kernel!r}")


def is_fused_se(kernel) -> bool:
    """True for the full-width SE-ARD: the expression the hand-written
    kernels specialise, and so the one the shims send to them on CUDA."""
    kernel = as_kernel(kernel)
    return isinstance(kernel, SEARD) and kernel.dims is None


def kernel_from_spec(spec: str | dict) -> Kernel:
    """Inverse of ``Kernel.to_spec()``; also takes the JSON string form and
    a bare kind name (``"se"``, ``"matern32"``, ...) for that primitive at
    its defaults."""
    if isinstance(spec, str):
        spec = (json.loads(spec) if spec.lstrip().startswith(("{", "["))
                else {"kind": spec})
    spec = dict(spec)
    kind = spec.pop("kind")
    try:
        cls = _REGISTRY[kind]
    except KeyError:
        raise ValueError(f"unknown kernel kind {kind!r}; registered: "
                         f"{kernel_names()}") from None
    if issubclass(cls, _Combinator):
        parts = [kernel_from_spec(p) for p in spec.pop("parts")]
        return cls(*parts, **spec)
    if spec.get("dims") is not None:
        spec["dims"] = tuple(spec["dims"])
    return cls(**spec)


def full_hyp_shapes(kernel: Kernel, q: int) -> dict:
    """The model's hyper-parameter shape tree: the expression's subtree plus
    the noise precision (restore templates)."""
    return {**as_kernel(kernel).hyp_shapes(q), "log_beta": ()}
