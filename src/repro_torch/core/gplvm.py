"""Bayesian GPLVM (Titsias & Lawrence 2010) via the re-parametrised bound.

Counterpart of ``repro.core.BayesianGPLVM``.  Latent inputs get a
factorised Gaussian ``q(X_i) = N(mu_i, diag(S_i))``; the psi statistics
(the psi1/psi2 kernels on CUDA) replace kernel evaluations and the KL term
appears in the bound.  Optimisation follows the paper: SCG over the global
parameters G = (hyp, Z) and the local parameters L = (mu, log S), either
jointly (``fit(joint=True)``, what GPy does) or in the paper's alternation
of G-steps and L-steps (``fit(joint=False)``).  The fitted model serves
latent queries through ``predictive_state`` -> ``PredictEngine``.
``fit_svi`` trains every parameter by minibatch SVI (Adam).
``reconstruct`` fills in the missing dimensions of new points (the paper's
§4.5 USPS experiment).
"""
from __future__ import annotations

import numpy as np
import torch

from .._device import as_f64, resolve_device
from . import bound as bound_mod
from . import covariance as cov
from . import init_utils
from .flat import fit_scg, neg_value_and_grad, tree_map
from .posterior_cache import PosteriorCacheMixin
from .stats import partial_stats_chunked


class BayesianGPLVM(PosteriorCacheMixin):
    """``chunk_size``: if set, the map step folds rows in blocks of this
    many points (``stats.partial_stats_chunked``); the default ``None`` maps
    all rows at once, one launch of each psi kernel on CUDA, which never
    stores the (n, m, m) per-point psi2.

    ``batch_blocks``: the default blocks a ``fit_svi`` step samples.

    ``device``: where the model lives (default CUDA; ``"cpu"`` runs the
    plain versions of the kernels).  Data and parameters are f64 there,
    and the init (PCA latents, k-means Z, data-driven hyp) is the JAX
    package's numpy one, bit for bit.
    """

    def __init__(self, y: np.ndarray, q: int, num_inducing: int = 50,
                 jitter: float = 1e-6, seed: int = 0, s0: float = 0.5,
                 chunk_size: int | None = None,
                 batch_blocks: int | None = None, kernel=None, device=None):
        self.device = resolve_device(device)
        self.y = as_f64(y, self.device)
        self.n, self.d = self.y.shape
        self.q = q
        self.jitter = jitter
        self.chunk_size = chunk_size
        self.batch_blocks = batch_blocks
        self.kernel = cov.as_kernel(kernel)
        mu0 = init_utils.pca(np.asarray(y), q)
        z0 = init_utils.kmeans(mu0, num_inducing, seed=seed)
        hyp0 = init_utils.default_hyp_for(self.kernel, np.asarray(y), q)
        self.params = {
            "hyp": tree_map(lambda v: as_f64(v, self.device), hyp0),
            "z": as_f64(z0, self.device),
            "mu": as_f64(mu0, self.device),
            "log_s": torch.full((self.n, q), float(np.log(s0)),
                                dtype=torch.float64, device=self.device),
        }
        self._init_posterior_caches()   # stats / PredictiveState / engine

    def _map_stats(self, hyp, z, y, mu, s, batch_blocks=None, generator=None,
                   block_indices=None):
        return partial_stats_chunked(hyp, z, y, mu, s=s, latent=True,
                                     block_size=self.chunk_size,
                                     batch_blocks=batch_blocks,
                                     generator=generator,
                                     block_indices=block_indices,
                                     kernel=self.kernel)

    # -- objective ----------------------------------------------------------
    def _neg_bound(self, params, **svi) -> torch.Tensor:
        """The negative bound; ``svi`` (``batch_blocks``, ``generator``,
        ``block_indices``) makes it the SVI estimate."""
        st = self._map_stats(params["hyp"], params["z"], self.y,
                             params["mu"], torch.exp(params["log_s"]), **svi)
        return -bound_mod.collapsed_bound(params["hyp"], params["z"], st,
                                          self.d, jitter=self.jitter,
                                          kernel=self.kernel)

    @torch.no_grad()
    def log_bound(self, params=None) -> float:
        return -float(self._neg_bound(self.params if params is None
                                      else params))

    def _neg_vg(self, params=None) -> tuple[float, np.ndarray]:
        """The negative bound and its gradient, flattened in the JAX
        package's ``ravel_pytree`` order: hyp/{log_beta, log_ell, log_sf2},
        log_s, mu, z (``core.flat``)."""
        return neg_value_and_grad(self._neg_bound, self.params
                                  if params is None else params)

    # -- optimisation --------------------------------------------------------
    def fit(self, max_iters: int = 200, joint: bool = True,
            outer_rounds: int = 10, verbose: bool = False):
        if joint:
            return self._fit_joint(max_iters, verbose)
        return self._fit_alternating(max_iters, outer_rounds, verbose)

    def _fit_joint(self, max_iters, verbose):
        res, self.params = fit_scg(self._neg_bound, self.params, max_iters)
        self._invalidate_posterior()
        if verbose:
            print(f"GPLVM fit(joint): bound={-res.f:.4f} iters={res.n_iters}")
        return res

    def fit_svi(self, steps: int = 500, lr: float = 1e-2,
                batch_blocks: int | None = None, seed: int = 0,
                verbose: bool = False):
        """Minibatch SVI of every parameter (hyp, Z, mu, log S): the
        estimator of ``SGPR.fit_svi``, the per-point KL reweighted with the
        data terms.  A step gives gradients only to the sampled blocks'
        (mu, log S) rows; the others coast on Adam's decaying momentum.
        Needs ``chunk_size``; returns a ``train.svi.SVIResult``."""
        from ..train.svi import svi_fit, value_and_grad

        bb = self.batch_blocks if batch_blocks is None else batch_blocks
        if self.chunk_size is None or bb is None:
            raise ValueError(
                "fit_svi needs chunk_size and batch_blocks, e.g. "
                "BayesianGPLVM(..., chunk_size=1024, batch_blocks=4)")

        def neg_vg(params, generator):
            return value_and_grad(lambda p: self._neg_bound(
                p, batch_blocks=bb, generator=generator), params)

        res = svi_fit(neg_vg, self.params, torch.Generator().manual_seed(seed),
                      steps=steps, lr=lr)
        self.params = res.params
        self._invalidate_posterior()
        if verbose:
            print(f"GPLVM fit_svi: est. bound={-res.history[-1]:.4f} "
                  f"steps={res.n_steps} (B={bb} blocks/step)")
        return res

    def _fit_alternating(self, max_iters, outer_rounds, verbose):
        """Paper §3.2 schedule: alternate G-steps and (parallelisable)
        L-steps, each an SCG run of ``max_iters // (2 outer_rounds)``
        iterations with the other block held fixed."""
        g = {"hyp": self.params["hyp"], "z": self.params["z"]}
        l = {"mu": self.params["mu"], "log_s": self.params["log_s"]}
        inner = max(1, max_iters // (2 * outer_rounds))
        res = None
        for r in range(outer_rounds):
            _, g = fit_scg(self._neg_bound, g, inner, fixed=l)
            res, l = fit_scg(self._neg_bound, l, inner, fixed=g)
            if verbose:
                print(f"  round {r}: bound={-res.f:.4f}")
        self.params = {**g, **l}
        self._invalidate_posterior()
        return res

    # -- posterior / diagnostics ---------------------------------------------
    @torch.no_grad()
    def _stats(self):
        if self._stats_cache is None:
            self._stats_cache = self._map_stats(
                self.params["hyp"], self.params["z"], self.y,
                self.params["mu"], torch.exp(self.params["log_s"]))
        return self._stats_cache

    def ard_weights(self) -> np.ndarray:
        """1/ell^2: the per-dimension relevance the paper inspects (fig 4/7),
        for a kernel with top-level ARD lengthscales; any other expression
        raises ``ValueError``."""
        if "log_ell" not in self.params["hyp"]:
            raise ValueError(
                "ard_weights needs a kernel with top-level ARD lengthscales "
                f"(hyp has {sorted(self.params['hyp'])}); inspect the "
                "expression's own subtree instead")
        return torch.exp(-2.0 * self.params["hyp"]["log_ell"]).cpu().numpy()

    def latent_mean(self) -> np.ndarray:
        return self.params["mu"].cpu().numpy()

    # -- reconstruction (paper §4.5) ----------------------------------------
    #: elements of the (rows, n, d) block of the nearest-neighbour search
    NN_ELEMS = 1 << 24

    def _nearest(self, yp: torch.Tensor, obs: torch.Tensor) -> torch.Tensor:
        """For each row of ``yp``, the training point whose observed
        dimensions come nearest (masked squared distance), in blocks of
        rows: the JAX package's (t, n, d) arithmetic, element for element,
        without the whole (t, n, d) array."""
        rows = max(1, self.NN_ELEMS // max(1, self.n * self.d))
        out = []
        for lo in range(0, yp.shape[0], rows):
            diff = yp[lo:lo + rows, None, :] - self.y[None, :, :]
            d2 = torch.where(obs[None, None, :], diff * diff,
                             torch.zeros((), dtype=diff.dtype,
                                         device=diff.device)).sum(-1)
            out.append(torch.argmin(d2, dim=1))
        return torch.cat(out)

    def _reconstruct_objective(self, yp, obs, state):
        """The negative of the observed dimensions' expected
        log-likelihood under q(X*) = N(mu, diag(exp(log_s))) plus its KL,
        through the trained posterior's mean and variance: a function of
        ``{"mu", "log_s"}``."""
        from ..serve import posterior

        hyp = self.params["hyp"]
        t = yp.shape[0]
        n_obs = obs.sum().to(yp.dtype)
        zero = torch.zeros((), dtype=yp.dtype, device=yp.device)

        def neg(local):
            mu, log_s = local["mu"], local["log_s"]
            # Differentiated in mu: the plain composition, not the kernel.
            mean, var = posterior.predict_mean_var_plain(state, mu)
            beta = torch.exp(hyp["log_beta"])
            resid = torch.where(obs[None, :], yp - mean, zero)
            ll = (-0.5 * beta * (resid * resid).sum()
                  - 0.5 * beta * n_obs * var.sum()
                  + 0.5 * t * n_obs * hyp["log_beta"])
            s = torch.exp(log_s)
            kl = 0.5 * (s + mu * mu - log_s - 1.0).sum()
            return -(ll - kl)
        return neg

    def _reconstruct_init(self, yp, obs) -> dict:
        """q(X*) starts at the nearest training latent, ``log_s = log 0.1``:
        more data, denser latent coverage, better reconstructions (the
        paper's §4.5 finding)."""
        nn = self._nearest(yp, obs)
        return {"log_s": torch.full((yp.shape[0], self.q), float(np.log(0.1)),
                                    dtype=torch.float64, device=self.device),
                "mu": self.params["mu"][nn]}

    def reconstruct(self, y_partial: np.ndarray, observed: np.ndarray,
                    iters: int = 50) -> np.ndarray:
        """Reconstruct the missing dimensions of new points (USPS-style,
        paper §4.5): optimise a q(X*) for each row of ``y_partial`` (t, d)
        against its ``observed`` (d,) dimensions only, by SCG over the flat
        ``(mu, log_s)``, then predict every output dimension from the
        served state (the predict kernel on the card).  Returns the
        predicted mean (t, d)."""
        from ..serve import posterior

        obs = torch.as_tensor(np.asarray(observed, bool), device=self.device)
        yp = as_f64(y_partial, self.device)
        if yp.shape[0] == 0:
            return np.zeros((0, self.d))
        state = self.predictive_state()
        _, local = fit_scg(self._reconstruct_objective(yp, obs, state),
                           self._reconstruct_init(yp, obs), iters)
        with torch.no_grad():
            mean, _ = posterior.predict_mean_var(state, local["mu"])
        return mean.cpu().numpy()
