"""SE-ARD covariance and its closed-form psi statistics on torch tensors
(counterpart of ``repro.core.gp_kernels``).

    k(x, x') = sf2 * exp(-0.5 * sum_q (x_q - x'_q)^2 / ell_q^2)

Under a diagonal Gaussian ``q(X_i) = N(mu_i, diag(S_i))`` the kernel
expectations (psi statistics) are analytic; ``S_i = 0``, ``mu_i = X_i``
recovers plain kernel evaluations (the paper's unifying view).  These are
the plain math of the psi wrappers (``kernels.psi_stats``); the deprecated
``ard_*``/bare ``psi*`` aliases, ``psi2_mxu`` and ``psi2_mxu_sym`` are
queued in ROADMAP.md.

Hyper-parameters are carried in log-space:
``hyp = {"log_sf2": (), "log_ell": (q,), "log_beta": ()}``.
"""
from __future__ import annotations

import torch


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
