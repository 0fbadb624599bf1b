"""SE-ARD covariance and its closed-form psi statistics on torch tensors
(counterpart of ``repro.core.gp_kernels``).

    k(x, x') = sf2 * exp(-0.5 * sum_q (x_q - x'_q)^2 / ell_q^2)

Under a diagonal Gaussian ``q(X_i) = N(mu_i, diag(S_i))`` the kernel
expectations (psi statistics) are analytic; ``S_i = 0``, ``mu_i = X_i``
recovers plain kernel evaluations (the paper's unifying view).  These are
the plain math of the psi wrappers (``kernels.psi_stats``).  The old
``ard_*`` / bare ``psi*`` names stay as deprecated aliases that warn once.
``psi2_mxu`` and ``psi2_mxu_sym`` are the JAX package's matmul
reformulations of psi2 (plain XLA there, no Pallas kernel), here plain
torch: usable as the map's ``psi2_fn`` hook.

Hyper-parameters are carried in log-space:
``hyp = {"log_sf2": (), "log_ell": (q,), "log_beta": ()}``.
"""
from __future__ import annotations

import warnings

import torch

_DEPRECATION_WARNED: set = set()


def _warn_deprecated(old: str, new: str) -> None:
    if old in _DEPRECATION_WARNED:
        return
    _DEPRECATION_WARNED.add(old)
    warnings.warn(
        f"repro_torch.core.gp_kernels.{old} is deprecated; use "
        f"gp_kernels.{new} or a covariance.SEARD kernel expression",
        DeprecationWarning, stacklevel=3)


def sqdist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Pairwise squared distances between rows of ``a`` (n,q) and ``b`` (m,q).

    Expanded form, with both operands first shifted by a common detached
    anchor: squared distances are shift-invariant, and the shift removes the
    cancellation the raw ``a²+b²-2ab`` form suffers for large-magnitude
    inputs.  Clamped after expansion.

    The anchor is ``b``'s first row, not a batch statistic, so each output
    row depends only on its own inputs: chunked statistics equal monolithic
    ones and padded serving batches equal unpadded ones.
    """
    c = b[0].detach() if b.shape[0] else b.new_zeros(b.shape[-1:])
    ac = a - c
    bc = b - c
    a2 = (ac * ac).sum(-1)[:, None]
    b2 = (bc * bc).sum(-1)[None, :]
    return torch.clamp(a2 + b2 - 2.0 * ac @ bc.T, min=0.0)


def se_kernel(hyp: dict, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """K_ab for the SE-ARD kernel; a: (n,q), b: (m,q) -> (n,m)."""
    ell = torch.exp(hyp["log_ell"])
    sf2 = torch.exp(hyp["log_sf2"])
    return sf2 * torch.exp(-0.5 * sqdist(a / ell, b / ell))


def se_kdiag(hyp: dict, a: torch.Tensor) -> torch.Tensor:
    """diag(K_aa): the constant sf2 for the SE kernel."""
    sf2 = torch.exp(hyp["log_sf2"]).to(a.dtype)
    return sf2.expand(a.shape[:-1])


# -- psi statistics (closed form, SE-ARD, diagonal Gaussian q(X)) -----------

def se_psi0(hyp: dict, mu: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """<k(x_i, x_i)> per point: (n,). For SE this is sf2 whatever q(X) is."""
    del s
    sf2 = torch.exp(hyp["log_sf2"]).to(mu.dtype)
    return sf2.expand(mu.shape[:-1])


def se_psi1(hyp: dict, z: torch.Tensor, mu: torch.Tensor,
            s: torch.Tensor) -> torch.Tensor:
    """<k(x_i, z_m)>: (n, m).

    Psi1[i,m] = sf2 * prod_q (1 + S_iq/l_q^2)^(-1/2)
                    * exp(-0.5 (mu_iq - z_mq)^2 / (l_q^2 + S_iq))
    """
    ell2 = torch.exp(2.0 * hyp["log_ell"])
    sf2 = torch.exp(hyp["log_sf2"])
    denom = ell2[None, :] + s
    lognorm = -0.5 * torch.log1p(s / ell2[None, :]).sum(-1)
    d = mu[:, None, :] - z[None, :, :]
    expo = -0.5 * (d * d / denom[:, None, :]).sum(-1)
    return sf2 * torch.exp(lognorm[:, None] + expo)


def se_psi2(hyp: dict, z: torch.Tensor, mu: torch.Tensor,
            s: torch.Tensor) -> torch.Tensor:
    """Sum_i <k(x_i, z_m) k(x_i, z_m')>: (m, m), the D statistic of the
    paper (unweighted; :func:`psi2_per_point` summed over points)."""
    return psi2_per_point(hyp, z, mu, s).sum(0)


# -- deprecated aliases (the pre-compositional names; warn once) -------------

def ard_kernel(hyp: dict, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Deprecated alias of :func:`se_kernel`."""
    _warn_deprecated("ard_kernel", "se_kernel")
    return se_kernel(hyp, a, b)


def ard_kdiag(hyp: dict, a: torch.Tensor) -> torch.Tensor:
    """Deprecated alias of :func:`se_kdiag`."""
    _warn_deprecated("ard_kdiag", "se_kdiag")
    return se_kdiag(hyp, a)


def psi0(hyp: dict, mu: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """Deprecated alias of :func:`se_psi0`."""
    _warn_deprecated("psi0", "se_psi0")
    return se_psi0(hyp, mu, s)


def psi1(hyp: dict, z: torch.Tensor, mu: torch.Tensor,
         s: torch.Tensor) -> torch.Tensor:
    """Deprecated alias of :func:`se_psi1`."""
    _warn_deprecated("psi1", "se_psi1")
    return se_psi1(hyp, z, mu, s)


def psi2(hyp: dict, z: torch.Tensor, mu: torch.Tensor,
         s: torch.Tensor) -> torch.Tensor:
    """Deprecated alias of :func:`se_psi2`."""
    _warn_deprecated("psi2", "se_psi2")
    return se_psi2(hyp, z, mu, s)


def psi2_per_point(hyp: dict, z: torch.Tensor, mu: torch.Tensor,
                   s: torch.Tensor) -> torch.Tensor:
    """(n, m, m) un-summed psi2:

      psi2_i[m,m'] = sf2^2 * prod_q (1 + 2 S_iq/l_q^2)^(-1/2)
          * exp(-(z_mq - z_m'q)^2 / (4 l_q^2) - (mu_iq - zbar_q)^2 / (l_q^2 + 2 S_iq))

    with zbar = (z_m + z_m') / 2, summed over q in the exponent.
    """
    ell2 = torch.exp(2.0 * hyp["log_ell"])
    sf2 = torch.exp(hyp["log_sf2"])
    dz = z[:, None, :] - z[None, :, :]
    static = -0.25 * (dz * dz / ell2).sum(-1)                    # (m, m)
    zbar = 0.5 * (z[:, None, :] + z[None, :, :])                 # (m, m, q)
    denom = ell2[None, :] + 2.0 * s                              # (n, q)
    lognorm = -0.5 * torch.log1p(2.0 * s / ell2[None, :]).sum(-1)
    d = mu[:, None, None, :] - zbar[None]                        # (n, m, m, q)
    expo = -(d * d / denom[:, None, None, :]).sum(-1)
    return (sf2 * sf2) * torch.exp(lognorm[:, None, None] + static[None]
                                   + expo)


def psi2_chunked(hyp: dict, z: torch.Tensor, mu: torch.Tensor,
                 s: torch.Tensor, chunk: int = 256) -> torch.Tensor:
    """Memory-bounded Sum_i psi2_i (m, m): :func:`psi2_per_point` folded
    over ``chunk`` rows at a time, so the (n, m, m, q) broadcast is never
    whole."""
    out = mu.new_zeros((z.shape[0], z.shape[0]))
    for lo in range(0, mu.shape[0], chunk):
        out = out + psi2_per_point(hyp, z, mu[lo:lo + chunk],
                                   s[lo:lo + chunk]).sum(0)
    return out


def kl_to_standard_normal(mu: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """Sum_i KL(N(mu_i, diag(S_i)) || N(0, I)) — the paper's KL term."""
    return 0.5 * (s + mu * mu - torch.log(s) - 1.0).sum()


# -- psi2 as matmuls (the JAX package's XLA reformulations) ------------------

def _pair_terms(z_a, z_b, ell2):
    """The inducing-pair half of psi2's exponent for the pairs (a, b) of
    ``z_a`` x ``z_b``: ``(Zb (2q, pairs), static (1, pairs))``, with
    ``Zb = [zbar; zbar^2]`` and ``static = -sum_q (z_a - z_b)^2 / (4 l^2)``."""
    zbar = 0.5 * (z_a[:, None, :] + z_b[None, :, :])
    pairs = zbar.shape[0] * zbar.shape[1]
    zb_mat = torch.cat([zbar, zbar * zbar], -1).reshape(pairs, -1).T
    dz = z_a[:, None, :] - z_b[None, :, :]
    static = (-0.25 * (dz * dz / ell2).sum(-1)).reshape(1, pairs)
    return zb_mat, static


def _psi2_pairs(ell2, zb_mat, static, mu, s, w, chunk):
    """sum_i w_i exp(E_i) over the pairs of ``zb_mat``, the exponent split
    as E_i = alpha_i + M_i Zb + static, ``chunk`` rows at a time."""
    acc = mu.new_zeros((zb_mat.shape[1],))
    for lo in range(0, mu.shape[0], chunk):
        mu_c, s_c, w_c = mu[lo:lo + chunk], s[lo:lo + chunk], w[lo:lo + chunk]
        den = ell2[None, :] + 2.0 * s_c
        inv = 1.0 / den
        lognorm = -0.5 * (torch.log(den) - torch.log(ell2)[None, :]).sum(1)
        alpha = lognorm - (mu_c * mu_c * inv).sum(1)              # (chunk,)
        m_mat = torch.cat([2.0 * mu_c * inv, -inv], 1)            # (chunk, 2q)
        e = alpha[:, None] + m_mat @ zb_mat + static
        acc = acc + (w_c[None, :] @ torch.exp(e))[0]
    return acc


def psi2_mxu(hyp: dict, z: torch.Tensor, mu: torch.Tensor, s: torch.Tensor,
             w: torch.Tensor, chunk: int = 1024) -> torch.Tensor:
    """Weighted psi2 (m, m) with the exponent decoupled into a data part and
    an inducing-pair part, E_i = alpha_i + M_i . Zb_ab, so the O(n m^2 q)
    work is two (chunk, 2q) @ (2q, m^2) matmuls, an exp and a
    (1, chunk) @ (chunk, m^2) reduce per chunk, and the (n, m, m, q)
    broadcast is never formed: ``repro.core.gp_kernels.psi2_mxu``."""
    ell2 = torch.exp(2.0 * hyp["log_ell"])
    sf4 = torch.exp(2.0 * hyp["log_sf2"])
    m = z.shape[0]
    zb_mat, static = _pair_terms(z, z, ell2)
    return sf4 * _psi2_pairs(ell2, zb_mat, static, mu, s, w,
                             chunk).reshape(m, m)


def psi2_mxu_sym(hyp: dict, z: torch.Tensor, mu: torch.Tensor,
                 s: torch.Tensor, w: torch.Tensor, chunk: int = 1024,
                 tile: int = 64) -> torch.Tensor:
    """:func:`psi2_mxu` over the inducing-pair tiles with a <= b only, the
    strict lower triangle mirrored (psi2 is symmetric): about half the
    work, ``repro.core.gp_kernels.psi2_mxu_sym``."""
    ell2 = torch.exp(2.0 * hyp["log_ell"])
    sf4 = torch.exp(2.0 * hyp["log_sf2"])
    m = z.shape[0]
    z_p = torch.cat([z, z.new_zeros(((-m) % tile, z.shape[1]))])
    nt = z_p.shape[0] // tile
    tiles = [z_p[i * tile:(i + 1) * tile] for i in range(nt)]
    blocks = {}
    for a in range(nt):
        for b in range(a, nt):
            zb_mat, static = _pair_terms(tiles[a], tiles[b], ell2)
            blocks[a, b] = _psi2_pairs(ell2, zb_mat, static, mu, s, w,
                                       chunk).reshape(tile, tile)
    rows = [torch.cat([blocks[a, b] if a <= b else blocks[b, a].T
                       for b in range(nt)], 1) for a in range(nt)]
    return (sf4 * torch.cat(rows, 0))[:m, :m]
