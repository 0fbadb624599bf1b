"""Plain PyTorch version of the fused regression-statistics kernel.

States the three statistics directly from the SE-ARD definition, the same
function as ``csrc/reg_stats.cu`` with the (n, m) slab held whole.  The
wrapper takes it for CPU tensors; ``chip_smoke.py`` holds the kernel against
it on the card.
"""
from __future__ import annotations

import torch


def reg_stats_ref(log_sf2, log_ell, z, x, y, w):
    """(b (), C (m, d), D (m, m)) of the weighted regression map step."""
    ell = torch.exp(log_ell)
    sf2 = torch.exp(log_sf2)
    diff = x[:, None, :] / ell - z[None, :, :] / ell
    knm = sf2 * torch.exp(-0.5 * (diff * diff).sum(-1))       # (n, m)
    b = sf2 * w.sum()                                         # k_ii = sf2 (SE)
    c = knm.T @ (w[:, None] * y)
    d_stat = (knm * w[:, None]).T @ knm
    return b, c, d_stat


def reg_stats_vjp_ref(log_sf2, log_ell, z, x, y, w, gb, gc, gd, needs,
                      chunk: int | None = None, absolute: bool = False):
    """Gradients of ``<(gb, gc, gd), reg_stats_ref(...)>`` in closed form,
    without autograd: the function ``csrc/reg_stats_bwd.cu`` computes.

    With K = knm, S = gd + gdᵀ and P = Y gcᵀ (n, m), G = w ⊙ (K S + P) is
    the cotangent of K and E = G ⊙ K; with r = x_n - z_j (per feature)
    and ℓ² = exp(2 log_ell)::

        d log_sf2   = ΣE + gb·b
        d z_jq      = Σₙ E_nj r / ℓ_q²
        d x_nq      = -Σⱼ E_nj r / ℓ_q²
        d log_ell_q = Σ E_nj r² / ℓ_q²
        d y_n       = w_n Kₙ gc
        d w_n       = sf2·gb + Kₙ·(½ (K S)ₙ + Pₙ)

    The exponent and r are in the direct form (no expansion of (x - z)²,
    which cancels for inputs far from the origin).  Rows are taken
    ``chunk`` at a time (default: about 2^25 elements of the (rows, m, q)
    difference), so it runs at full width on the card.  ``needs`` says,
    input by input, whether a gradient is wanted; None where not.
    ``absolute``: every term of every sum by its absolute value (the
    cotangents, y, w and r by theirs), the scale of the rounding error of
    a kernel that forms the same sums.
    """
    ab = torch.abs if absolute else (lambda t: t)
    n, q = x.shape
    m = z.shape[0]
    inv = torch.exp(-2.0 * log_ell)
    sf2 = torch.exp(log_sf2)
    s_mat = ab(gd) + ab(gd).T
    gc_, gb_, w_ = ab(gc), ab(gb), ab(w)
    step = max(1, chunk or (1 << 25) // max(1, m * q))
    sign = 1.0 if absolute else -1.0
    d_sf2 = sf2.new_zeros(())
    d_z = z.new_zeros((m, q))
    d_ell = inv.new_zeros((q,))
    rows = {3: [], 4: [], 5: []}
    for lo in range(0, n, step):
        xs, ys, ws = x[lo:lo + step], ab(y[lo:lo + step]), w_[lo:lo + step]
        diff = xs[:, None, :] - z[None, :, :]                  # (r, m, q)
        knm = sf2 * torch.exp(-0.5 * (diff * diff * inv).sum(-1))
        ks = knm @ s_mat
        p = ys @ gc_.T
        e = ws[:, None] * knm * (ks + p)
        ad = ab(diff)
        d_sf2 = d_sf2 + e.sum()
        if needs[2]:
            d_z = d_z + torch.einsum("nj,njq->jq", e, ad) * inv
        if needs[1]:
            d_ell = d_ell + torch.einsum("nj,njq->q", e, diff * diff) * inv
        if needs[3]:
            rows[3].append(sign * torch.einsum("nj,njq->nq", e, ad) * inv)
        if needs[4]:
            rows[4].append(ws[:, None] * (knm @ gc_))
        if needs[5]:
            rows[5].append(sf2 * gb_ + (knm * (0.5 * ks + p)).sum(1))
    d_sf2 = d_sf2 + gb_ * sf2 * w_.sum()
    out = [d_sf2, d_ell, d_z]
    for i, t in ((3, x), (4, y), (5, w)):
        out.append((torch.cat(rows[i]) if rows[i] else torch.zeros_like(t))
                   if needs[i] else None)
    return [g if need else None for g, need in zip(out[:3], needs[:3])] \
        + out[3:]
