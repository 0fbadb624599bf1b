"""Tensor parallelism's collectives over the context mesh.

The reference partitions every LM parameter by the logical-axis rules
under ``jit`` and lets XLA's SPMD partitioner insert the collectives.  The
port runs one process a rank and says each collective itself: the model
code calls the functions below, which read the mesh that
``distributed.sharding.use_mesh`` set.  With no mesh, no such axis, or an
axis of one rank, each is the identity and launches nothing, so the
unsharded path stays bit for bit what it was.

Megatron's pair over the ``model`` axis, for a loss that every rank of a
``model`` group computes alike (the activations between layers are
replicated across the group):

* ``copy_to_model``: the identity; its backward sums the gradient over
  ``model`` (the input of a column-parallel product, or a replicated
  weight of which each rank uses a part);
* ``reduce_from_model``: the sum over ``model``; its backward is the
  identity;
* ``row_parallel``: a row-parallel product summed over ``model``.  Each
  rank keeps its partial product in f32 (a 16-bit product too: not
  rounded per rank), an all_to_all hands every rank the ranks' partials of
  its 1 / model of the columns, it adds them in rank order and rounds
  once, and an all_gather puts the columns together.  That moves what a
  ring all_reduce moves, and the sum has the same bits on every rank and
  every backend (NCCL or gloo); an all_reduce's order is the backend's.
  With 16-bit partial sums added in 16 bits (XLA's partitioned dot),
  qwen3-moe's split layers left the one-process path by 2.6e-2 relative
  RMS at full width, past the 2e-2 tier, and with f32 all_reduces NCCL
  and gloo meshes routed its MoE differently (``PERF.md``);
* ``gather_from_model``: the ranks' blocks concatenated along a dimension;
  its backward keeps the rank's block (vocab-parallel logits);
* ``gather_over_model``: the ranks' blocks concatenated where each rank
  then uses the whole otherwise (RG-LRU's gates, column-parallel on the
  gathered conv output); its backward is a reduce_scatter, which sums the
  ranks' partial gradients of the rank's block;
* ``sum_over_model``: a small f32 tensor summed over ``model`` in rank
  order (an all_gather, then the sum), the same bits on every rank and
  every backend (the SSD's gated RMSNorm over the split channels); each
  rank uses the sum for its own channels only, so its backward is the
  same ordered sum of the ranks' gradients;
* ``gather_over_data``: FSDP.  A weight's ``data`` shards all-gathered
  along their dimension just before its layer runs (and dropped with the
  layer's other temporaries); its backward is a reduce_scatter, which
  sums the ranks' partial gradients of the shard;
* ``reduce_over_batch``: the sum over the batch axes (``pod``, ``data``),
  one axis after the other; its backward is the identity (the loss's
  global sums).

Under these rules, after the backward of a loss computed alike on every
rank of a ``model`` group, each rank holds the complete gradient of its
data shard's share of the loss for its block of every leaf; the leaves
not sharded over a batch axis still need the sum over that axis
(``train.steps.loss_and_grads``).

The raw collectives (``all_reduce``, ``all_gather``, ``reduce_scatter``,
``all_to_all``; the MoE's exchanges call them too) are module functions,
so a caller can wrap them to time them.  Over gloo with CUDA tensors each
stages through the host (``launch.mesh.via_host``).  ``COUNTS`` records
the calls and bytes of each kind since ``reset_counts``: the bytes of
each call's result, as the reference's ``hlo_stats.collective_bytes``
counts an HLO collective's result shape (an all_reduce its tensor, an
all_gather the gathered tensor, a reduce_scatter the rank's block).
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.distributed as dist

from ..launch.mesh import via_host
from . import sharding as shlib

KINDS = ("all_reduce", "all_gather", "reduce_scatter", "all_to_all")
COUNTS = {k: {"calls": 0, "bytes": 0} for k in KINDS}
BATCH_AXES = ("pod", "data")


def reset_counts() -> None:
    for c in COUNTS.values():
        c["calls"] = c["bytes"] = 0


def counts() -> dict:
    """A copy of ``COUNTS`` with the bytes of every kind as ``total``."""
    out = {k: dict(v) for k, v in COUNTS.items()}
    out["total"] = sum(v["bytes"] for v in COUNTS.values())
    return out


def record(kind: str, result: torch.Tensor) -> None:
    """Count one collective of ``kind`` whose result is ``result`` (also
    called by ``core.distributed.DistributedGP``'s own all_reduce)."""
    COUNTS[kind]["calls"] += 1
    COUNTS[kind]["bytes"] += result.numel() * result.element_size()


# ---------------------------------------------------------------------------
# the raw collectives over a process group
# ---------------------------------------------------------------------------

def all_reduce(t: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """The group's reduction of ``t`` (a new tensor)."""
    host = via_host(group, t.device)
    buf = t.cpu() if host else t.clone()
    dist.all_reduce(buf, op=op, group=group)
    record("all_reduce", buf)
    return buf.to(t.device) if host else buf


def all_gather(t: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """The group's ``t`` concatenated along ``dim``, in rank order."""
    host = via_host(group, t.device)
    src = t.cpu() if host else t.contiguous()
    parts = [torch.empty_like(src) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, src, group=group)
    out = torch.cat(parts, dim)
    record("all_gather", out)
    return out.to(t.device) if host else out


def reduce_scatter(t: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """Block ``rank`` along ``dim`` of the group's sum of ``t``."""
    host = via_host(group, t.device)
    n = dist.get_world_size(group)
    src = t.movedim(dim, 0).contiguous()
    src = src.cpu() if host else src
    out = src.new_empty((src.shape[0] // n, *src.shape[1:]))
    dist.reduce_scatter_tensor(out, src, group=group)
    record("reduce_scatter", out)
    out = out.movedim(0, dim)
    return out.to(t.device) if host else out


def all_to_all(t: torch.Tensor, group) -> torch.Tensor:
    """``all_to_all_single`` of ``t`` (n, ...): chunk j goes to rank j;
    chunk j of the result came from rank j."""
    host = via_host(group, t.device)
    src = t.cpu() if host else t.contiguous()
    out = torch.empty_like(src)
    dist.all_to_all_single(out, src, group=group)
    record("all_to_all", out)
    return out.to(t.device) if host else out


# ---------------------------------------------------------------------------
# the context mesh's axes
# ---------------------------------------------------------------------------

class Axis(NamedTuple):
    group: object
    index: int
    size: int


def axis(name: str) -> Axis | None:
    """The context mesh's axis ``name`` (its process group, this rank's
    index along it, its size), or None where there is no mesh, no such
    axis, or it has one rank.  A mesh given only as axis sizes (an object
    with a ``shape`` dict, which the rules read) has no process groups:
    none of its axes has a collective."""
    mesh = shlib._CTX["mesh"]
    if mesh is None or not hasattr(mesh, "get_group"):
        return None
    size = shlib.mesh_sizes(mesh).get(name, 1)
    if size == 1:
        return None
    return Axis(mesh.get_group(name), mesh.get_local_rank(name), size)


def model_size() -> int:
    mesh = shlib._CTX["mesh"]
    return 1 if mesh is None else shlib.mesh_sizes(mesh).get("model", 1)


def model_index() -> int:
    ax = axis("model")
    return 0 if ax is None else ax.index


# ---------------------------------------------------------------------------
# the autograd pairs
# ---------------------------------------------------------------------------

class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.group), None


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, index, dim):
        ctx.block = (index, dim, x.shape[dim])
        return all_gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        index, dim, n = ctx.block
        return g.narrow(dim, index * n, n), None, None, None


class _GatherScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, w, group, dim):
        ctx.args = (group, dim)
        return all_gather(w, group, dim)

    @staticmethod
    def backward(ctx, g):
        group, dim = ctx.args
        return reduce_scatter(g, group, dim), None, None


class _MatmulF32(torch.autograd.Function):
    """x (..., K) @ w (K, N) of 16-bit operands with an f32 result (the
    products' f32 sums, not rounded to 16 bits); the backward's products in
    the operands' dtype, as a 16-bit product's."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        x2 = x.reshape(-1, x.shape[-1])
        if x.is_cuda:
            y = torch.mm(x2, w, out_dtype=torch.float32)
        else:
            y = x2.float() @ w.float()
        return y.reshape(*x.shape[:-1], w.shape[1])

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g = g.to(x.dtype)
        gw = x.reshape(-1, x.shape[-1]).T @ g.reshape(-1, g.shape[-1])
        return g @ w.T, gw


class _RowSum(torch.autograd.Function):
    """y (..., D), this rank's f32 partial, summed over the group in rank
    order (module doc) and rounded once to ``dtype``; the backward is the
    identity, as ``_Reduce``'s."""

    @staticmethod
    def forward(ctx, y, group, size, dtype):
        *lead, d = y.shape
        blocks = y.reshape(-1, size, d // size).transpose(0, 1).contiguous()
        parts = all_to_all(blocks, group)     # block j: rank j's partial
        acc = parts[0]
        for part in parts[1:]:
            acc = acc + part
        return all_gather(acc.to(dtype), group, 1).reshape(*lead, d)

    @staticmethod
    def backward(ctx, g):
        return g.float(), None, None, None


def row_parallel(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` with ``w`` this rank's rows and ``x`` its columns of the
    activations, summed over ``model`` (module doc); ``x @ w`` with no
    ``model`` axis."""
    ax = axis("model")
    if ax is None:
        return x @ w
    if w.shape[1] % ax.size:
        raise ValueError(f"row_parallel: {w.shape[1]} output columns do not "
                         f"split over model = {ax.size}")
    if x.dtype in (torch.bfloat16, torch.float16):
        y = _MatmulF32.apply(x, w)
    else:
        y = x @ w
    return _RowSum.apply(y, ax.group, ax.size, x.dtype)


def copy_to_model(x: torch.Tensor) -> torch.Tensor:
    ax = axis("model")
    return x if ax is None else _Copy.apply(x, ax.group)


def reduce_from_model(x: torch.Tensor) -> torch.Tensor:
    ax = axis("model")
    return x if ax is None else _Reduce.apply(x, ax.group)


def gather_from_model(x: torch.Tensor, dim: int) -> torch.Tensor:
    ax = axis("model")
    if ax is None:
        return x
    return _Gather.apply(x, ax.group, ax.index, dim % x.ndim)


def _ordered_sum(x: torch.Tensor, group) -> torch.Tensor:
    parts = all_gather(x[None], group, 0)
    acc = parts[0]
    for part in parts[1:]:
        acc = acc + part
    return acc


class _OrderedSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _ordered_sum(x, group)

    @staticmethod
    def backward(ctx, g):
        return _ordered_sum(g, ctx.group), None


def gather_over_model(x: torch.Tensor, dim: int) -> torch.Tensor:
    ax = axis("model")
    if ax is None:
        return x
    return _GatherScatter.apply(x, ax.group, dim % x.ndim)


def sum_over_model(x: torch.Tensor) -> torch.Tensor:
    ax = axis("model")
    return x if ax is None else _OrderedSum.apply(x, ax.group)


def max_over_model(x: torch.Tensor) -> torch.Tensor:
    """The elementwise max over ``model`` (no gradient: a shift)."""
    ax = axis("model")
    return x if ax is None else all_reduce(x, ax.group, dist.ReduceOp.MAX)


def gather_over_data(w: torch.Tensor, dim: int, full: int) -> torch.Tensor:
    """``w`` whole along ``dim`` (of size ``full``): its ``data`` shards
    all-gathered, or ``w`` itself where it is whole already."""
    if w.shape[dim] == full:
        return w
    ax = axis("data")
    if ax is None or w.shape[dim] * ax.size != full:
        raise ValueError(f"gather_over_data: a dimension of {w.shape[dim]} "
                         f"is neither whole ({full}) nor a data shard of it")
    return _GatherScatter.apply(w, ax.group, dim % w.ndim)


def reduce_over_batch(x: torch.Tensor) -> torch.Tensor:
    for name in BATCH_AXES:
        ax = axis(name)
        if ax is not None:
            x = _Reduce.apply(x, ax.group)
    return x
