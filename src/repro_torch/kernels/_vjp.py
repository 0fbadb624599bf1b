"""A fused kernel's backward by its plain version, recomputed in row chunks.

The JAX package's ``custom_vjp`` backward recomputes through the XLA
formulation.  Here ``reg_stats``, ``psi2`` and ``psi1`` have hand-written
backward kernels (``csrc/reg_stats_bwd.cu``, ``csrc/psi2_bwd.cu``,
``csrc/psi1_bwd.cu``), which their ``torch.autograd.Function``s launch;
``reg_stats_vjp`` / ``psi2_vjp`` / ``psi1_vjp``, built on
:func:`chunked_vjp`, stay as the backward kernels' oracles for the tests
and ``tools/``, and no path calls them.  Rows are taken a chunk at a time,
so the autograd graph of one chunk is alive at a time: O(chunk·m) for
``reg_stats`` and ``psi1``, O(chunk·m²·q) for ``psi2``, whatever n is.
"""
from __future__ import annotations

import torch

#: elements of the largest per-chunk intermediate the recompute may hold
CHUNK_ELEMS = 1 << 25


def rows_per_chunk(elems_per_row: int) -> int:
    """Rows whose largest intermediate holds about :data:`CHUNK_ELEMS`."""
    return max(1, CHUNK_ELEMS // max(1, elems_per_row))


def chunked_vjp(fn, shared, rows, cotangents, needs, chunk: int,
                per_row: bool = False):
    """Vector-Jacobian product of ``fn(*shared, *rows)`` over row chunks.

    ``fn`` returns a tuple of outputs.  Either every output is a sum over
    rows (``per_row=False``: ``reg_stats``, ``psi2``), so each chunk takes
    the whole cotangent, or every output is row by row (``per_row=True``:
    ``psi1``), so each chunk takes its rows of it.  ``needs`` says, input by
    input (``shared`` then ``rows``), whether a gradient is wanted.  Returns
    one gradient per input, None where not wanted: a shared input's gradient
    is summed over chunks, a row input's concatenated.  Runs with grad
    enabled whatever the caller's mode, on any device.
    """
    n = rows[0].shape[0]
    ns = len(shared)
    grads: list = [None] * (ns + len(rows))
    row_parts: list[list] = [[] for _ in rows]
    for lo in range(0, n, chunk):
        with torch.enable_grad():
            ins = [t.detach().requires_grad_(need)
                   for t, need in zip(shared, needs)]
            ins += [t[lo:lo + chunk].detach().requires_grad_(need)
                    for t, need in zip(rows, needs[ns:])]
            outs = fn(*ins)
            # Outputs that do not depend on a wanted input take no part.
            live = [(o, ct[lo:lo + chunk] if per_row else ct)
                    for o, ct in zip(outs, cotangents) if o.requires_grad]
            wanted = [t for t in ins if t.requires_grad]
            got = iter(torch.autograd.grad([o for o, _ in live], wanted,
                                           [c for _, c in live],
                                           allow_unused=True)
                       if live else [None] * len(wanted))
        for i, t in enumerate(ins):
            if not t.requires_grad:
                continue
            g = next(got)
            g = torch.zeros_like(t) if g is None else g
            if i < ns:
                grads[i] = g if grads[i] is None else grads[i] + g
            else:
                row_parts[i - ns].append(g)
    for j, (t, need) in enumerate(zip(rows, needs[ns:])):
        if need:
            grads[ns + j] = (torch.cat(row_parts[j]) if row_parts[j]
                             else torch.zeros_like(t))
    for i, (t, need) in enumerate(zip(shared, needs)):
        if need and grads[i] is None:
            grads[i] = torch.zeros_like(t)
    return grads
