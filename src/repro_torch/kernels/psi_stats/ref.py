"""Plain PyTorch versions of the psi-statistics kernels.

The SE-ARD closed forms of ``core.gp_kernels`` (direct exponent form), the
same functions as ``csrc/psi_stats.cu``, taken ``chunk`` rows at a time so
that the (chunk, m, m, q) broadcast of psi2 stays bounded and the plain
version runs at full width on the card.  The wrappers take these for CPU
tensors and for the backward recompute; ``chip_smoke.py`` holds the kernels
against them.
"""
from __future__ import annotations

import torch

from ...core import gp_kernels as gpk


def psi1_ref(log_sf2, log_ell, z, mu, s, chunk: int | None = None):
    """(n, m) ``<k(x_i, z_m)>`` under q(x_i) = N(mu_i, diag(s_i))."""
    hyp = {"log_sf2": log_sf2, "log_ell": log_ell}
    step = max(1, chunk or mu.shape[0])
    parts = [gpk.se_psi1(hyp, z, mu[lo:lo + step], s[lo:lo + step])
             for lo in range(0, mu.shape[0], step)]
    return torch.cat(parts) if parts else mu.new_zeros((0, z.shape[0]))


def psi1_vjp_ref(log_sf2, log_ell, z, mu, s, g, needs,
                 chunk: int | None = None, absolute: bool = False):
    """Gradients of ``<g, psi1_ref(...)>`` in closed form, without
    autograd: the function ``csrc/psi1_bwd.cu`` computes.

    With Ψ = psi1, E = g ⊙ Ψ (n, m), a_nq = 1/(ℓ_q² + S_nq) and
    r = μ_nq - z_jq::

        d log_sf2   = ΣE
        d z_jq      = Σₙ E_nj r a_nq
        d μ_nq      = -Σⱼ E_nj r a_nq
        d S_nq      = ½ Σⱼ E_nj (r² a_nq² - a_nq)
        d log_ell_q = Σ E_nj (S_nq a_nq + ℓ_q² r² a_nq²)

    r in the direct form.  Rows are taken ``chunk`` at a time (default:
    about 2^25 elements of the (rows, m, q) difference).  ``needs``: input
    by input (log_sf2, log_ell, z, mu, s), whether a gradient is wanted;
    None where not.  ``absolute``: every term of every sum by its
    absolute value (g and r by theirs, the -a term of d S positive), the
    scale of the rounding error of a kernel that forms the same sums.
    """
    ab = torch.abs if absolute else (lambda t: t)
    n, q = mu.shape
    m = z.shape[0]
    ell2 = torch.exp(2.0 * log_ell)
    step = max(1, chunk or (1 << 25) // max(1, m * q))
    d_sf2 = ell2.new_zeros(())
    d_ell = ell2.new_zeros((q,))
    d_z = z.new_zeros((m, q))
    rows = {3: [], 4: []}
    for lo in range(0, n, step):
        mus, ss = mu[lo:lo + step], s[lo:lo + step]
        e = ab(g[lo:lo + step]) * psi1_ref(log_sf2, log_ell, z, mus, ss)
        a = 1.0 / (ell2 + ss)                                   # (r, q)
        r = mus[:, None, :] - z[None, :, :]                     # (r, m, q)
        e0 = e.sum(1)                                           # (r,)
        e1 = torch.einsum("nj,njq->nq", e, ab(r))
        e2 = torch.einsum("nj,njq->nq", e, r * r)
        d_sf2 = d_sf2 + e0.sum()
        if needs[1]:
            d_ell = d_ell + (e0[:, None] * ss * a + ell2 * a * a * e2).sum(0)
        if needs[2]:
            d_z = d_z + torch.einsum("nj,njq->jq", e, ab(r) * a[:, None, :])
        if needs[3]:
            rows[3].append((1.0 if absolute else -1.0) * a * e1)
        if needs[4]:
            rows[4].append(0.5 * a * (a * e2 + (1.0 if absolute else -1.0)
                                      * e0[:, None]))
    out = [d_sf2, d_ell, d_z]
    for i, t in ((3, mu), (4, s)):
        out.append((torch.cat(rows[i]) if rows[i] else torch.zeros_like(t))
                   if needs[i] else None)
    return [t if need else None for t, need in zip(out[:3], needs[:3])] \
        + out[3:]


def psi2_ref(log_sf2, log_ell, z, mu, s, w, chunk: int | None = None):
    """(m, m) ``sum_i w_i <k(x_i, z_a) k(x_i, z_b)>`` under q(x_i)."""
    hyp = {"log_sf2": log_sf2, "log_ell": log_ell}
    step = max(1, chunk or mu.shape[0])
    out = mu.new_zeros((z.shape[0], z.shape[0]))
    for lo in range(0, mu.shape[0], step):
        sl = slice(lo, lo + step)
        out = out + torch.einsum("i,iab->ab", w[sl], gpk.psi2_per_point(
            hyp, z, mu[sl], s[sl]))
    return out


def psi2_vjp_ref(log_sf2, log_ell, z, mu, s, w, g, needs,
                 chunk: int | None = None, absolute: bool = False):
    """Gradients of ``<g, psi2_ref(...)>`` in closed form, without
    autograd: the function ``csrc/psi2_bwd.cu`` computes.

    With ψₙ[j,k] the per-point psi2, F_njk = wₙ g_jk ψₙ[j,k],
    D_nq = ℓ_q² + 2S_nq and r = μ_nq - z̄_jkq (z̄ the pair's midpoint)::

        d μ_nq      = -2 Σ_jk F r / D
        d S_nq      = Σ_jk F (2r²/D² - 1/D)
        d z_jq      = Σ_{n,k} (F_njk + F_nkj) (r/D - (z_jq - z_kq)/(2ℓ_q²))
        d log_ell_q = 2ℓ_q² Σ F (S/(ℓ_q² D) + (z_jq - z_kq)²/(4ℓ_q⁴) + r²/D²)
        d log_sf2   = 2ΣF
        d w_n       = Σ_jk g_jk ψₙ[j,k]

    in the direct form (r itself, never expanded in μ², z̄²).  Rows are
    taken ``chunk`` at a time (default: about 2^25 elements of the (rows,
    m, m, q) difference).  ``needs``: input by input, whether a gradient is
    wanted; None where not.  ``absolute``: every term of every sum by its
    absolute value (g, w, r and z_j - z_k by theirs, the -1/D term of
    d S positive), the scale of the rounding error of a kernel that forms
    the same sums.
    """
    ab = torch.abs if absolute else (lambda t: t)
    n, q = mu.shape
    m = z.shape[0]
    ell2 = torch.exp(2.0 * log_ell)
    sf4 = torch.exp(log_sf2) * torch.exp(log_sf2)
    g_ = ab(g)
    dz_pair = z[:, None, :] - z[None, :, :]                       # (m, m, q)
    static = -0.25 * (dz_pair * dz_pair / ell2).sum(-1)           # (m, m)
    zbar = 0.5 * (z[:, None, :] + z[None, :, :])
    step = max(1, chunk or (1 << 25) // max(1, m * m * q))
    d_sf2 = sf4.new_zeros(())
    d_ell = ell2.new_zeros((q,))
    d_z = z.new_zeros((m, q))
    f_sum = z.new_zeros((m, m))
    rows = {3: [], 4: [], 5: []}
    for lo in range(0, n, step):
        mus, ss, ws = mu[lo:lo + step], s[lo:lo + step], ab(w[lo:lo + step])
        den = ell2 + 2.0 * ss                                     # (r, q)
        lognorm = -0.5 * torch.log1p(2.0 * ss / ell2).sum(-1)
        r = mus[:, None, None, :] - zbar[None]                    # (r, m, m, q)
        expo = -(r * r / den[:, None, None, :]).sum(-1)
        psi = sf4 * torch.exp(lognorm[:, None, None] + static[None] + expo)
        f = ws[:, None, None] * g_[None] * psi                   # (r, m, m)
        f_all = f.sum((1, 2))                                     # (r,)
        fr = torch.einsum("njk,njkq->nq", f, ab(r))
        fr2 = torch.einsum("njk,njkq->nq", f, r * r)
        d_sf2 = d_sf2 + 2.0 * f_all.sum()
        f_sum = f_sum + f.sum(0)
        if needs[1]:
            d_ell = d_ell + 2.0 * (f_all[:, None] * ss / den).sum(0) \
                + 2.0 * ell2 * (fr2 / (den * den)).sum(0)
        if needs[2]:
            fs = f + f.transpose(1, 2)
            d_z = d_z + torch.einsum("njk,njkq->jq", fs,
                                     ab(r) / den[:, None, None, :])
        if needs[3]:
            rows[3].append((2.0 if absolute else -2.0) * fr / den)
        if needs[4]:
            rows[4].append(2.0 * fr2 / (den * den)
                           + (1.0 if absolute else -1.0) * f_all[:, None] / den)
        if needs[5]:
            rows[5].append((g_[None] * psi).sum((1, 2)))
    if needs[1]:
        d_ell = d_ell + 0.5 * torch.einsum("jk,jkq->q", f_sum,
                                           dz_pair * dz_pair) / ell2
    if needs[2]:
        fs = f_sum + f_sum.T
        d_z = d_z + (1.0 if absolute else -1.0) * torch.einsum(
            "jk,jkq->jq", fs, ab(dz_pair)) / (2.0 * ell2)
    out = [d_sf2, d_ell, d_z]
    for i, t in ((3, mu), (4, s), (5, w)):
        out.append((torch.cat(rows[i]) if rows[i] else torch.zeros_like(t))
                   if needs[i] else None)
    return [g if need else None for g, need in zip(out[:3], needs[:3])] \
        + out[3:]


def psi2_vjp_products(log_sf2, log_ell, z, mu, s, w, g, needs):
    """:func:`psi2_vjp_ref`'s function by the arithmetic of
    ``csrc/psi2_bwd.cu``: the reference's factorisation
    (``core.gp_kernels.psi2_mxu``) with μ and z centred, three matrix
    products and an elementwise chain.  Only the tests call it.

    With c the mean of z, μ' = μ - c, z̄' the pair's centred midpoint,
    D = ℓ² + 2S and the upper pairs p = (j <= k) carrying g_jk + g_kj
    (g_jj on the diagonal)::

        A = [2μ'/D, -1/D (per feature), α, 1]      (n, 2q + 2)
        B = [z̄', z̄'² (per feature), 1, static]    (pairs, 2q + 2)
        E = A Bᵀ,  G = sf2² g_p exp(E),  F = w G
        H = G B    (rows: Σ G z̄', Σ G z̄'², Σ G)
        Q = Fᵀ A   (pairs: Σ F 2μ'/D, -Σ F/D, ·, Σ F)

    with α = -½ Σ log1p(2S/ℓ²) - Σ μ'²/D and static = -¼ Σ (z_j - z_k)²/ℓ²;
    the gradients follow per row from H and per pair from Q.  The shift
    by c cancels in E, so the expansion of (μ' - z̄')² loses nothing to
    an offset common to μ and z."""
    n, q = mu.shape
    m = z.shape[0]
    ell2 = torch.exp(2.0 * log_ell)
    sf4 = torch.exp(2.0 * log_sf2)
    c = z.mean(0)
    zc, muc = z - c, mu - c
    j, k = torch.triu_indices(m, m)
    gp = torch.where(j == k, g[j, k], g[j, k] + g[k, j])
    zbar = 0.5 * (zc[j] + zc[k])                                  # (P, q)
    dzp = zc[j] - zc[k]
    static = -0.25 * (dzp * dzp / ell2).sum(-1)
    inv = 1.0 / (ell2 + 2.0 * s)
    alpha = -0.5 * torch.log1p(2.0 * s / ell2).sum(-1) \
        - (muc * muc * inv).sum(-1)
    a = torch.cat([torch.stack([2.0 * muc * inv, -inv], -1).reshape(n, 2 * q),
                   alpha[:, None], torch.ones_like(alpha)[:, None]], 1)
    b = torch.cat([torch.stack([zbar, zbar * zbar], -1).reshape(-1, 2 * q),
                   torch.ones_like(static)[:, None], static[:, None]], 1)
    gm = sf4 * gp * torch.exp(a @ b.T)                            # (n, P)
    h = gm @ b
    qm = (w[:, None] * gm).T @ a
    h0, h1, h2 = h[:, 2 * q], h[:, 0:2 * q:2], h[:, 1:2 * q:2]
    sr2 = muc * muc * h0[:, None] - 2.0 * muc * h1 + h2          # Σ G r²
    wc = w[:, None]
    d_ell = (wc * (2.0 * s * inv * h0[:, None]
                   + 2.0 * ell2 * sr2 * inv * inv)).sum(0)
    dzbar = qm[:, 0:2 * q:2] + 2.0 * zbar * qm[:, 1:2 * q:2]
    u = 0.5 * qm[:, 2 * q + 1, None] * dzp / ell2
    d_z = torch.zeros_like(z).index_add_(0, j, 0.5 * dzbar - u) \
        .index_add_(0, k, 0.5 * dzbar + u)
    out = [2.0 * (w * h0).sum(), d_ell + (u * dzp).sum(0), d_z,
           2.0 * wc * inv * (h1 - muc * h0[:, None]),
           wc * (2.0 * sr2 * inv * inv - h0[:, None] * inv), h0]
    return [t if need else None for t, need in zip(out, needs)]
