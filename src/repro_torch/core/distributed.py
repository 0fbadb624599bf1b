"""Distributed Map-Reduce engine (paper §3.2) on ``torch.distributed``:
counterpart of ``repro.core.distributed``.

JAX runs one SPMD program over a mesh; here each rank of a process group
(``launch.make_data_group``) is one data shard, holding the contiguous
block of rows that ``NamedSharding(P("data"))`` gives device k.  Per step:

  map    : every rank computes the partial Stats of its rows (the
           hand-written kernels on CUDA tensors), no communication;
  reduce : one ``all_reduce(SUM)`` of the Stats packed into one flat f64
           buffer of m² + m·d + 4 numbers, whatever n is;
  global : every rank evaluates the collapsed bound from the reduced Stats,
           which are the same bits on every rank.

Gradients.  In JAX the transpose of ``psum`` is replication.  Autograd
through an all_reduce would instead sum cotangents that are already the
same on every rank, and summing each rank's whole (hyp, z) gradient would
count the bound's direct Kmm terms once per rank; both are wrong past one
rank.  So the engine takes the paper's step 3 by hand: on every rank the
bound of the reduced Stats, taken as leaves, gives ∂F/∂S and the direct
∂F/∂θ; each rank pulls ∂F/∂S back through its own map
(``torch.autograd.grad`` with ``grad_outputs``, through the kernels'
``autograd.Function``\\ s); one all_reduce sums those parts (m·q + q + 2
numbers for the SGPR) and the direct part is added once.  mu/s gradients
stay on their rank, as JAX's stay sharded.

Node failure (paper §5.2): ``fmask[rank]`` zeroes a rank's weights.
``"drop"`` keeps the surviving sums and sets n to ``n_full``;
``"rescale"`` divides A, B, C, D and KL by n_live / n_full, n_live being
the reduced count, which rides in the same all_reduce.  Every rank must be
given the same ``fmask`` (e.g. drawn from ``distributed.FailureSimulator``
with one seed on every rank).

No rank waits forever: a failed Cholesky in the global step happens on
every rank at once (same bits) and gives a NaN value and gradient, and
every rank still enters the gradient's all_reduce.  A rank that dies fails
the others' collective at the group's timeout.

SVI (``batch_blocks``): each rank folds ``batch_blocks`` of its own row
blocks a step, drawn independently per rank, and scales its Stats by
``n_local_blocks / batch_blocks`` before the one all_reduce; the step's
trailing ``draw`` is a ``torch.Generator`` (each rank derives its own
stream from it and its rank, as JAX folds the shard index into the step
key) or this rank's explicit ``(batch_blocks,)`` block indices.

Host streaming (``put_data(stream=...)``): a ``data.stream.BlockStream``
over a host source; each rank reads only its own window of each chunk
(``n / W`` rows a pass), stages it on its device (pinned memory, a side
stream) one chunk ahead of the fold, and threads a constant-size carry
through ``stats.partial_stats_chunked(init=...)``; one all_reduce follows
the last chunk.  Streamed Stats, bound and predictive state are bitwise the
in-memory engine's over the same rows; the exact streamed gradient takes a
second pass (f64 tolerance), the streamed SVI step one pass over the
sampled chunks.

Serving: :meth:`DistributedGP.predict_engine` shards query batches over
the same group (``serve.PredictEngine(group=...)``): each rank computes its
W-th of the rows, one all_gather gives every rank all of them.

Online updates: :meth:`DistributedGP.update_stats_fn` folds a new sharded
block into reduced Stats (each rank maps its slice with the exact fold, one
all_reduce, the base added); :meth:`update_predictive_state` and
:meth:`downdate_predictive_state` refresh a served state by the rank-k
path of ``serve.online``, with no collective.

The kernel expression picks the map's route through the ``reg_stats_fn``
and ``psi2_fn`` hooks (default: ``kernels.reg_stats.
reg_stats_fn_for_engine`` and ``kernels.psi_stats.psi2_fn_for_engine`` of
the engine's kernel): the hand-written kernels for the full-width SE-ARD on
CUDA, the expression's plain math otherwise.

Serving: :meth:`DistributedGP.predict_engine` and
:meth:`multi_predict_engine` shard each query batch's rows over the group.

The overlapped reduce (``reduce_mode="overlap"``, needs ``chunk_size``):
:meth:`bound_fn` and :meth:`make_value_and_grad` reduce each block's packed
Stats with an async ``all_reduce`` as soon as the block is mapped, waited
on one block later, after the next block's map is launched
(``"overlap_eager"``: in its own block), and fold the reduced values in
block order (``stats.partial_stats_chunked(block_reduce_fn=...)``): one
collective a block instead of one after the map, each riding behind the
next block's map.  The gradient is step 3 as above: ∂F/∂S from the
overlapped Stats, pulled back through the rank's own unreduced fold of the
blocks, one all_reduce of the pulled (hyp, z) parts.  In a world of one it
is bitwise the serial step; across ranks the sums associate per block,
equal to f64 rounding.  The exact-Stats programs (:meth:`reduced_stats`,
:meth:`predictive_state`, :meth:`update_stats_fn`, the ``streamed_*``
methods) keep the one serial reduce, as the JAX engine's do.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from .._device import as_f64, rank_device
from ..data.stream import BlockStream, padded_rows, prefetch, stage_to_device
from ..launch.mesh import via_host
from . import covariance as cov
from .bound import DEFAULT_JITTER, collapsed_bound
from .flat import tree_items, tree_map, tree_unflatten
from .stats import (Stats, fold_in, fold_stats, pack_stats,
                    partial_stats_chunked, sample_block_indices, unpack_stats,
                    zero_stats)


def num_shards(group=None) -> int:
    """Data shards of ``group``: its world size (1 without a group)."""
    return 1 if group is None else dist.get_world_size(group)


def pad_and_shard(arrs: dict, n_shards: int, block: int | None = None):
    """Pad the leading dim of host arrays to a multiple of ``n_shards``
    (times ``block`` if set); returns ``(padded dict, weights)``.

    Keys ``"s"``/``"S"`` (q(X) variances) are padded with 1s (log-safe),
    everything else with 0s; ``weights`` (n_padded,) is 1.0 on real rows and
    0.0 on padding.  The padded n is never empty: n = 0 pads to one full
    multiple.  Numpy in, numpy out, as in the JAX package.
    """
    n = next(iter(arrs.values())).shape[0]
    pad = padded_rows(n, n_shards * (block or 1)) - n
    out = {}
    for k, a in arrs.items():
        a = np.asarray(a)
        widths = [(0, pad)] + [(0, 0)] * (a.ndim - 1)
        out[k] = np.pad(a, widths,
                        constant_values=1.0 if k in ("s", "S") else 0.0)
    w = np.concatenate([np.ones((n,), np.float64), np.zeros((pad,), np.float64)])
    return out, w


def unpad(arrs, n: int):
    """Strip the row padding :func:`pad_and_shard` added (a dict, or one
    array): the exact inverse of the padding."""
    if isinstance(arrs, dict):
        return {k: a[:n] for k, a in arrs.items()}
    return arrs[:n]


def _leaf(t, need: bool):
    """A fresh autograd leaf of ``t`` (each leaf of a dict), or ``t``."""
    if t is None or not need:
        return t
    return tree_map(lambda v: v.detach().requires_grad_(), t)


def _grads(outputs, inputs, grad_outputs=None):
    """``torch.autograd.grad`` of ``outputs`` over the ``inputs`` that
    require grad; zeros for the other inputs and for unused ones."""
    live = [t for t in inputs if t.requires_grad]
    got = iter(torch.autograd.grad(outputs, live, grad_outputs,
                                   allow_unused=True)
               if live and outputs else [None] * len(live))
    out = []
    for t in inputs:
        g = next(got) if t.requires_grad else None
        out.append(torch.zeros_like(t) if g is None else g)
    return out




class DistributedGP:
    """Distributed bound, gradient, streaming and serving handoff for SGPR
    (``latent=False``) and the Bayesian GPLVM (``latent=True``).

    ``group``: the process group whose ranks are the data shards (default:
    the process's default group if it joined one, else a world of one with
    no communication).  ``device``: this rank's device (default the card,
    ``cuda:{LOCAL_RANK}``; raises without CUDA; ``"cpu"`` runs the plain
    versions).  Over gloo, CUDA buffers are reduced through host copies.

    ``chunk_size``: each rank's map folds its rows in blocks of this many
    (``stats.partial_stats_chunked``); ``put_data`` then pads n to a
    multiple of ``n_shards * chunk_size``, and streaming needs it.

    ``batch_blocks`` (needs ``chunk_size``): the SVI bound; :meth:`bound_fn`
    and :meth:`make_value_and_grad`'s step then take a trailing ``draw``
    per step (a generator, or this rank's block indices).

    ``kernel``: any ``core.covariance`` expression or its spec (default
    the full-width SE-ARD).  ``psi2_fn`` / ``reg_stats_fn``: the latent
    and regression map hooks of ``core.stats.partial_stats`` (in memory,
    SVI and streamed), bound to the expression; by default the shims
    ``kernels.psi_stats.psi2_fn_for_engine(kernel=...)`` and
    ``kernels.reg_stats.reg_stats_fn_for_engine(kernel=...)``, which the
    JAX engine installs for its Pallas backend.  A given hook replaces its
    shim (e.g. ``core.gp_kernels.psi2_mxu``).

    ``reduce_mode``: ``"serial"`` (one all_reduce after the map),
    ``"overlap"`` (one a block, waited on one block later) or
    ``"overlap_eager"`` (one a block, waited on in its block: the same
    bits as ``"overlap"``); the non-serial modes need ``chunk_size``
    (module docstring).  Invalid arguments raise ``ValueError`` as the JAX
    engine's do.
    """

    def __init__(self, group=None, latent: bool = False,
                 failure_mode: str = "drop", chunk_size: int | None = None,
                 kernel=None, device=None, *, batch_blocks=None,
                 reduce_mode: str = "serial", psi2_fn=None,
                 reg_stats_fn=None):
        if chunk_size is not None and chunk_size < 1:
            raise ValueError(f"chunk_size must be >= 1, got {chunk_size}")
        if batch_blocks is not None:
            if chunk_size is None:
                raise ValueError(
                    "batch_blocks (SVI mode) requires chunk_size: the "
                    "minibatch is a subset of the streaming row blocks")
            if batch_blocks < 1:
                raise ValueError(
                    f"batch_blocks must be >= 1, got {batch_blocks}")
        if reduce_mode not in ("serial", "overlap", "overlap_eager"):
            raise ValueError(
                "reduce_mode must be 'serial', 'overlap' or 'overlap_eager'"
                f", got {reduce_mode!r}")
        if reduce_mode != "serial" and chunk_size is None:
            raise ValueError(
                "reduce_mode='overlap' requires chunk_size: the per-block "
                "collective needs scan blocks to hide behind")
        if failure_mode not in ("drop", "rescale"):
            raise ValueError("failure_mode must be 'drop' or 'rescale', got "
                             f"{failure_mode!r}")
        from ..kernels.psi_stats.ops import psi2_fn_for_engine
        from ..kernels.reg_stats.ops import reg_stats_fn_for_engine

        self.kernel = cov.as_kernel(kernel)
        self.device = rank_device(device)
        if group is None and dist.is_available() and dist.is_initialized():
            group = dist.group.WORLD
        self.group = group
        self.rank = 0 if group is None else dist.get_rank(group)
        self.n_shards = num_shards(group)
        self.latent = latent
        self.psi2_fn = psi2_fn or psi2_fn_for_engine(kernel=self.kernel)
        self.reg_stats_fn = reg_stats_fn or reg_stats_fn_for_engine(
            kernel=self.kernel)
        self.failure_mode = failure_mode
        self.chunk_size = chunk_size
        self.batch_blocks = batch_blocks
        self.reduce_mode = reduce_mode
        self._via_host = via_host(group, self.device)
        #: real rows this rank has read from streams (the read path's count)
        self.rows_read = 0

    # -- data -----------------------------------------------------------------
    def put_data(self, stream=None, blocks_per_chunk: int = 1, **arrs):
        """In memory (``put_data(y=..., mu=..., s=...)``): pad the full host
        arrays as the JAX engine does and keep this rank's contiguous block
        of n_pad / W rows, and its weights, in f64 on the engine's device:
        ``(dict, w)``.

        Streaming (``put_data(stream=source)``): nothing is staged; returns
        :meth:`open_stream`'s ``BlockStream`` of ``blocks_per_chunk`` blocks
        per shard per chunk, for the ``streamed_*`` methods."""
        if stream is not None:
            if arrs:
                raise ValueError("put_data takes either stream=... or "
                                 "in-memory arrays, not both")
            return self.open_stream(stream, blocks_per_chunk=blocks_per_chunk)
        padded, w = pad_and_shard(arrs, self.n_shards, block=self.chunk_size)
        rows = w.shape[0] // self.n_shards
        mine = slice(self.rank * rows, (self.rank + 1) * rows)
        return ({k: as_f64(v[mine], self.device) for k, v in padded.items()},
                as_f64(w[mine], self.device))

    def open_stream(self, source, blocks_per_chunk: int = 1) -> BlockStream:
        """A ``BlockStream`` of ``source`` (a dict of host arrays, a
        ``MemmapSource``/``SyntheticSource``, any ``(n, fields, read)``) with
        this engine's geometry (``n_shards`` shards, ``chunk_size``-row
        blocks): the layout under which streaming is bitwise the in-memory
        path.  A ``BlockStream`` of that geometry passes through."""
        if self.chunk_size is None:
            raise ValueError("streaming requires chunk_size: the host chunks "
                             "are multiples of the fold's block")
        if isinstance(source, BlockStream):
            if (source.n_shards != self.n_shards
                    or source.block_size != self.chunk_size):
                raise ValueError(
                    f"stream geometry ({source.n_shards} shards x "
                    f"{source.block_size}-row blocks) does not match the "
                    f"engine ({self.n_shards} x {self.chunk_size}): open the "
                    "stream through this engine")
            return source
        return BlockStream(source, n_shards=self.n_shards,
                           block_size=self.chunk_size,
                           blocks_per_chunk=blocks_per_chunk)

    # -- the map, the reduce, the global step -----------------------------------
    def _draw(self, draw):
        """This rank's SVI draw: ``(generator, block_indices)``."""
        if draw is None:
            raise ValueError("SVI mode (batch_blocks) needs a per-step draw: "
                             "a torch.Generator, or this rank's "
                             "(batch_blocks,) block indices")
        if isinstance(draw, torch.Generator):
            return fold_in(draw, self.rank), None
        return None, draw

    def _local_stats(self, hyp, z, y, mu, s, w, draw=None, exact=False,
                     init=None, block_reduce_fn=None) -> Stats:
        """This rank's map: under ``batch_blocks`` the sampled and
        reweighted fold of ``draw``, else (or ``exact``) the exact fold,
        continuing ``init``; each block reduced by ``block_reduce_fn`` in
        the engine's overlap mode if it is given."""
        svi = self.batch_blocks is not None and not exact
        gen, idx = self._draw(draw) if svi else (None, None)
        return partial_stats_chunked(hyp, z, y, mu, s, weights=w,
                                     latent=self.latent,
                                     block_size=self.chunk_size,
                                     kernel=self.kernel, force_scan=True,
                                     batch_blocks=self.batch_blocks
                                     if svi else None,
                                     generator=gen, block_indices=idx,
                                     init=init, psi2_fn=self.psi2_fn,
                                     reg_stats_fn=self.reg_stats_fn,
                                     block_reduce_fn=block_reduce_fn,
                                     reduce_buffered=self.reduce_mode
                                     != "overlap_eager")

    def _all_reduce(self, buf: torch.Tensor) -> torch.Tensor:
        """The constant-size sum over ranks (the paper's reduce)."""
        return self._all_reduce_start(buf)()

    def _all_reduce_start(self, buf: torch.Tensor):
        """Start the sum over ranks of ``buf`` (``async_op``); returns a
        callable that waits for it and returns the sum on ``buf``'s device.
        Over gloo the host copy is made before the call and the copy back
        after the wait.  Counted in ``tensor_parallel.COUNTS``."""
        # here, not at import: the distributed package imports this module
        from ..distributed.tensor_parallel import record

        if self.group is None:
            return lambda: buf
        host = buf.cpu() if self._via_host else buf
        work = dist.all_reduce(host, op=dist.ReduceOp.SUM, group=self.group,
                               async_op=True)
        record("all_reduce", host)

        def wait():
            work.wait()
            return host.to(buf.device) if self._via_host else host
        return wait

    def _overlapped(self, hyp, z, y, mu, s, w, draw=None):
        """This rank's map under the overlapped reduce: ``(local,
        reduced)``.  Each block's Stats go, packed and detached, into an
        async all_reduce as soon as the block is mapped; ``reduced`` is the
        fold of the reduced blocks in block order, ``local`` this rank's
        own fold of the same blocks, with their graph (the gradient's
        pull-back), scaled as the SVI map scales."""
        m, d = z.shape[0], y.shape[1]
        raws = []

        def reduce_block(raw: Stats):
            raws.append(raw)
            with torch.no_grad():
                wait = self._all_reduce_start(pack_stats(raw))
            return lambda: unpack_stats(wait(), m, d)

        reduced = self._local_stats(hyp, z, y, mu, s, w, draw,
                                    block_reduce_fn=reduce_block)
        local = zero_stats(m, d, dtype=y.dtype, device=y.device)
        for raw in raws:
            local = local + raw
        scale = -(-y.shape[0] // self.chunk_size) / len(raws)
        return (local.scale(scale) if scale != 1.0 else local), reduced

    def _map_reduce(self, hyp, z, y, mu, s, wm, draw):
        """This rank's map and the reduce, in the engine's ``reduce_mode``:
        ``(local, reduced, n_live)``, n_live the SVI's deterministic live
        count (None outside SVI), which rides in the serial reduce's buffer
        and takes a scalar all_reduce of its own when overlapped."""
        live_w = wm if self.batch_blocks is not None else None
        if self.reduce_mode == "serial":
            local = self._local_stats(hyp, z, y, mu, s, wm, draw)
            return (local, *self._reduce(local, live_w))
        local, st = self._overlapped(hyp, z, y, mu, s, wm, draw)
        n_live = (None if live_w is None
                  else self._all_reduce(live_w.sum().reshape(1))[0])
        return local, st, n_live

    def _reduce(self, local: Stats, live_w=None):
        """One all_reduce of the packed local Stats -> ``(Stats, n_live)``.
        ``live_w`` (SVI): this rank's pre-sampling weights, whose sum rides
        in the same buffer as the deterministic live count; else n_live is
        None and the reduced ``n`` is the live count."""
        m, d = local.C.shape
        buf = pack_stats(local).detach()
        if live_w is not None:
            buf = torch.cat([buf, live_w.sum().reshape(1)])
        buf = self._all_reduce(buf)
        if live_w is None:
            return unpack_stats(buf, m, d), None
        return unpack_stats(buf[:-1], m, d), buf[-1]

    def _masked(self, w, fmask):
        """This rank's weights with its entry of the failure mask (a host
        scalar: no copy to the device for each streamed chunk)."""
        return w * float(fmask[self.rank])

    def _reduced(self, hyp, z, y, mu, s, w, fmask) -> Stats:
        """The exact reduced Stats (whatever ``batch_blocks`` is)."""
        with torch.no_grad():
            st = self._local_stats(hyp, z, y, mu, s, self._masked(w, fmask),
                                   exact=True)
            return self._reduce(st)[0]

    def _bound(self, hyp, z, st: Stats, d: int, n_full, n_live=None):
        """The failure mode's n handling, then the collapsed bound.  Under
        ``rescale`` the sums are divided by n_live / n_full, n_live the
        reduced ``n``, or under SVI the deterministic pre-sampling live
        count (the sampled ``n`` is an estimate)."""
        n_full = torch.as_tensor(n_full, dtype=st.n.dtype, device=st.n.device)
        if self.failure_mode == "rescale":
            live = (st.n if n_live is None else n_live) / n_full
            st = Stats(A=st.A / live, B=st.B / live, C=st.C / live,
                       D=st.D / live, KL=st.KL / live, n=n_full)
        else:
            st = st._replace(n=n_full)
        return collapsed_bound(hyp, z, st, d, kernel=self.kernel)

    def _safe_bound(self, hyp, z, st, d, n_full, n_live=None):
        """:meth:`_bound` without a graph; NaN where its Cholesky fails."""
        with torch.no_grad():
            try:
                return self._bound(hyp, z, st, d, n_full, n_live)
            except torch.linalg.LinAlgError:
                return torch.full((), float("nan"), dtype=st.n.dtype,
                                  device=st.n.device)

    def bound_fn(self, d: int):
        """The bound, the same on every rank: ``(hyp, z, y, mu, s, w,
        fmask, n_full) -> ()``, plus a trailing ``draw`` under
        ``batch_blocks``; NaN where the global step's Cholesky fails.
        Value only: the gradient is :meth:`make_value_and_grad`'s."""
        def bound(hyp, z, y, mu, s, w, fmask, n_full, draw=None):
            with torch.no_grad():
                _, st, n_live = self._map_reduce(hyp, z, y, mu, s,
                                                 self._masked(w, fmask), draw)
            return self._safe_bound(hyp, z, st, d, n_full, n_live)
        return bound

    # -- the gradient: the paper's step 3, by hand --------------------------------
    def _direct(self, hyp, z, st: Stats, d: int, n_full, n_live, theta):
        """The negative bound of the reduced Stats taken as leaves:
        ``(value, dF/dtheta direct, dF/dS)``, the same on every rank; NaN
        where the Cholesky fails."""
        st = Stats(*(t.detach().requires_grad_() for t in st))
        try:
            with torch.enable_grad():
                neg = -self._bound(hyp, z, st, d, n_full, n_live)
                direct = _grads([neg], theta + list(st))
        except torch.linalg.LinAlgError:
            neg = torch.full((), float("nan"), dtype=st.n.dtype,
                             device=st.n.device)
            direct = [torch.full_like(t, float("nan"))
                      for t in theta + list(st)]
        return neg.detach(), direct[:len(theta)], direct[len(theta):]

    @staticmethod
    def _pull(local: Stats, g_st, inputs):
        """dF/dS pulled back through a map's graph: the gradients of
        ``<local, g_st>`` with respect to ``inputs``."""
        outs = [(o, g) for o, g in zip(local, g_st) if o.requires_grad]
        return _grads([o for o, _ in outs], inputs, [g for _, g in outs])

    def _summed(self, g_direct, pulled, paths):
        """One all_reduce of the ranks' pulled-back (hyp, z) parts, then the
        direct part added once: ``(hyp grads dict, z grad)``, hyp's nested
        as the hyper-parameters are (``paths``)."""
        parts = self._all_reduce(torch.cat([g.reshape(-1) for g in pulled]))
        summed = [g + p.reshape(g.shape) for g, p in zip(
            g_direct, parts.split([g.numel() for g in g_direct]))]
        return tree_unflatten(paths, summed[:-1]), summed[-1]

    def _value_and_grad(self, d, argnums, hyp, z, mu, s, n_full, map_fn):
        """(value, grads) of the negative bound through the reduce:
        ``map_fn(hyp, z, mu, s) -> (local, reduced, n_live)``, this rank's
        Stats and their reduce (:meth:`_map_reduce`); steps 1-5 below."""
        if 3 in argnums and s is None:
            raise ValueError("argnums holds 3 (s), but s is None")
        hyp, z, mu, s = (_leaf(p, i in argnums)
                         for i, p in enumerate((hyp, z, mu, s)))
        paths, leaves = zip(*tree_items(hyp))
        theta = [*leaves, z]                              # global params
        rows = [mu] + ([] if s is None else [s])          # this rank's
        # 1. the map on this rank's rows, its graph kept for step 3, and
        #    the reduce
        with torch.enable_grad():
            local, st, n_live = map_fn(hyp, z, mu, s)
        # 2. the bound of the reduced Stats as leaves gives dF/dS and the
        #    direct dF/dtheta, the same on every rank
        neg, g_theta, g_st = self._direct(hyp, z, st, d, n_full, n_live,
                                          theta)
        # 3. dF/dS pulled back through this rank's map
        pulled = self._pull(local, g_st, theta + rows)
        grads = {i: g for i, g in zip((2, 3), pulled[len(theta):])}
        # 4. one all_reduce of the ranks' (hyp, z) parts; 5. the direct
        #    part added once
        if {0, 1} & set(argnums):
            grads[0], grads[1] = self._summed(g_theta, pulled[:len(theta)],
                                              paths)
        return neg, tuple(grads[i] for i in argnums)

    @staticmethod
    def _argnums(argnums, allowed):
        single = isinstance(argnums, int)
        argnums = (argnums,) if single else tuple(argnums)
        if not set(argnums) <= set(allowed):
            raise ValueError(f"argnums must index {allowed} of (hyp, z, mu, "
                             f"s), got {argnums}")
        return single, argnums

    def make_value_and_grad(self, d: int, argnums=(0, 1)):
        """(value, grad) of the NEGATIVE bound with respect to the chosen
        arguments: ``step(hyp, z, mu, s, y, w, fmask, n_full)``, plus a
        trailing ``draw`` under ``batch_blocks`` (an unbiased estimate
        then).

        ``argnums`` indexes (hyp, z, mu, s): (0, 1) for the SGPR, add 2 and
        3 for the GPLVM (gradients with respect to the variances s).  The
        gradients come back in that order (one, not a tuple, for an int);
        hyp's as a dict.  hyp and z gradients are the same on every rank;
        mu and s gradients are this rank's rows.
        """
        single, argnums = self._argnums(argnums, (0, 1, 2, 3))

        def step(hyp, z, mu, s, y, w, fmask, n_full, draw=None):
            wm = self._masked(w, fmask)
            neg, out = self._value_and_grad(
                d, argnums, hyp, z, mu, s, n_full,
                lambda h, zz, m, ss: self._map_reduce(h, zz, y, m, ss, wm,
                                                      draw))
            return neg, (out[0] if single else out)

        return step

    def reduced_stats(self, d: int):
        """The exact reduced Stats, the same on every rank: ``(hyp, z, y,
        mu, s, w, fmask) -> Stats`` (the failure mask applied, n the live
        count), whatever ``batch_blocks`` is."""
        del d
        return self._reduced

    # -- host streaming -----------------------------------------------------------
    def _read(self, stream: BlockStream, indices=None):
        """This rank's windows of the stream's chunks (all, or ``indices``),
        read from the host source in order: n / W real rows a full pass,
        counted in :attr:`rows_read`."""
        for c in range(stream.n_chunks) if indices is None else indices:
            arrs, w = stream.shard_chunk(int(c), self.rank)
            self.rows_read += int(np.count_nonzero(w))
            yield arrs, w

    def _staged(self, stream: BlockStream, prefetch_depth: int):
        """This rank's chunks on its device, each staged one chunk (or
        ``prefetch_depth``) ahead of the caller's fold."""
        stager = stage_to_device(self.device, depth=prefetch_depth)
        it = prefetch(self._read(stream), stager, depth=prefetch_depth)
        try:
            for staged in it:
                yield stager.ready(staged)
        finally:
            it.close()

    def _stream_args(self, stream, fmask, n_full):
        stream = self.open_stream(stream)
        fmask = np.ones((self.n_shards,)) if fmask is None else fmask
        return stream, fmask, float(stream.n) if n_full is None else n_full

    def _stream_carry(self, hyp, z, stream, fmask, prefetch_depth) -> Stats:
        """Every chunk of this rank folded into one local carry, no
        collective yet: the in-memory fold's additions, in its order."""
        carry = None
        with torch.no_grad():
            for arrs, w in self._staged(stream, prefetch_depth):
                carry = self._local_stats(hyp, z, arrs["y"], arrs["mu"],
                                          arrs.get("s"),
                                          self._masked(w, fmask),
                                          exact=True, init=carry)
        if carry is None:   # a stream has at least one chunk; kept total
            carry = zero_stats(z.shape[0], stream.fields["y"][0],
                               device=self.device)
        return carry

    def streamed_stats(self, hyp, z, stream, fmask=None,
                       prefetch_depth: int = 2) -> Stats:
        """The exact reduced Stats from a host stream: bitwise
        :meth:`reduced_stats` over the same rows, with O(chunk) rows on the
        device.  ``stream``: anything :meth:`open_stream` takes."""
        stream, fmask, _ = self._stream_args(stream, fmask, None)
        carry = self._stream_carry(hyp, z, stream, fmask, prefetch_depth)
        with torch.no_grad():
            return self._reduce(carry)[0]

    def streamed_bound(self, hyp, z, stream, d: int, fmask=None,
                       n_full=None, prefetch_depth: int = 2):
        """The bound from a host stream: bitwise :meth:`bound_fn` (exact) on
        the same rows in memory.  ``n_full`` defaults to the stream's n."""
        stream, fmask, n_full = self._stream_args(stream, fmask, n_full)
        st = self.streamed_stats(hyp, z, stream, fmask, prefetch_depth)
        return self._safe_bound(hyp, z, st, d, n_full)

    def streamed_value_and_grad(self, d: int, argnums=(0, 1)):
        """The exact streamed (value, grad) of the NEGATIVE bound with
        respect to (hyp, z), in two passes: pass 1 builds the reduced Stats
        S (bitwise the in-memory ones) and the bound of S as leaves gives
        dF/dS and the direct dF/dtheta; pass 2 pulls dF/dS back through each
        chunk's map and sums the (hyp, z) parts on this rank; one
        all_reduce after the last chunk, and the direct part added once.
        The value is bitwise :meth:`make_value_and_grad`'s, the gradient
        equal to f64 rounding (the per-chunk sums associate otherwise).

        Returns ``step(hyp, z, stream, fmask=None, n_full=None,
        prefetch_depth=2) -> (value, grads)``; ``argnums`` within (0, 1):
        mu and s gradients are data-sized, which streaming avoids.
        """
        single, argnums = self._argnums(argnums, (0, 1))

        def step(hyp, z, stream, fmask=None, n_full=None,
                 prefetch_depth: int = 2):
            stream, fmask, n_full = self._stream_args(stream, fmask, n_full)
            hyp, z = _leaf(hyp, True), _leaf(z, True)
            paths, leaves = zip(*tree_items(hyp))
            theta = [*leaves, z]
            st = self.streamed_stats(hyp, z, stream, fmask, prefetch_depth)
            neg, g_theta, g_st = self._direct(hyp, z, st, d, n_full, None,
                                              theta)
            parts = [torch.zeros_like(t) for t in theta]
            for arrs, w in self._staged(stream, prefetch_depth):
                with torch.enable_grad():
                    local = self._local_stats(hyp, z, arrs["y"], arrs["mu"],
                                              arrs.get("s"),
                                              self._masked(w, fmask),
                                              exact=True)
                parts = [p + g for p, g in zip(
                    parts, self._pull(local, g_st, theta))]
            g_hyp, g_z = self._summed(g_theta, parts, paths)
            grads = tuple((g_hyp, g_z)[a] for a in argnums)
            return neg, (grads[0] if single else grads)

        return step

    def streamed_svi_value_and_grad(self, d: int, batch_chunks: int,
                                    argnums=(0, 1)):
        """The minibatch streamed step: ``batch_chunks`` of the stream's
        chunks a step, the SAME chunk indices on every rank (a generator in
        the same state on every rank, or explicit indices), one pass over
        them, their rows concatenated and folded exactly, every field
        scaled by ``n_chunks / batch_chunks``: an unbiased (value, grad) of
        the NEGATIVE bound at O(batch_chunks * chunk) rows a step.  With
        ``batch_chunks >= n_chunks`` it is the exact step.  ``failure_mode=
        "rescale"`` is refused: its deterministic live count would need a
        full pass.

        Returns ``step(hyp, z, stream, draw, fmask=None, n_full=None) ->
        (value, grads)``, ``draw`` a ``torch.Generator`` or the chunk
        indices.
        """
        single, argnums = self._argnums(argnums, (0, 1))
        if batch_chunks < 1:
            raise ValueError(f"batch_chunks must be >= 1, got {batch_chunks}")
        if self.failure_mode == "rescale":
            raise NotImplementedError(
                "streamed SVI supports failure_mode='drop' only: rescale "
                "needs the deterministic live count, a full data pass")

        def step(hyp, z, stream, draw, fmask=None, n_full=None):
            stream, fmask, n_full = self._stream_args(stream, fmask, n_full)
            nc = stream.n_chunks
            if isinstance(draw, torch.Generator):
                b = min(batch_chunks, nc)
                idx = (sample_block_indices(draw, nc, b).tolist() if b < nc
                       else list(range(nc)))
            else:
                idx = [int(c) for c in np.asarray(draw).reshape(-1)]
            chunks = list(self._read(stream, idx))
            stager = stage_to_device(self.device, depth=1)
            arrs, w = stager.ready(stager((
                {k: np.concatenate([c[0][k] for c in chunks])
                 for k in stream.fields},
                np.concatenate([c[1] for c in chunks]))))
            wm, scale = self._masked(w, fmask), nc / len(idx)

            def local(h, zz, mu, s):
                st = self._local_stats(h, zz, arrs["y"], mu, s, wm,
                                       exact=True)
                st = st.scale(scale) if scale != 1.0 else st
                return (st, *self._reduce(st))   # the serial reduce

            neg, out = self._value_and_grad(d, argnums, hyp, z, arrs["mu"],
                                            arrs.get("s"), n_full, local)
            return neg, (out[0] if single else out)

        return step

    def streamed_predictive_state(self, hyp, z, stream, fmask=None,
                                  jitter: float = DEFAULT_JITTER,
                                  prefetch_depth: int = 2):
        """One streamed exact map-reduce -> the frozen
        ``serve.PredictiveState``: bitwise :meth:`predictive_state` over the
        same rows in memory."""
        from ..serve import extract_state

        st = self.streamed_stats(hyp, z, stream, fmask, prefetch_depth)
        return extract_state(hyp, z, st, jitter=jitter, kernel=self.kernel,
                             device=self.device)

    # -- serving ----------------------------------------------------------------
    def predictive_state(self, hyp, z, y, mu, s, w, fmask=None,
                         jitter: float = DEFAULT_JITTER):
        """One exact map-reduce over the shards -> the frozen
        ``serve.PredictiveState`` on the engine's device, the same on every
        rank: the training-to-serving handoff."""
        from ..serve import extract_state

        if fmask is None:
            fmask = np.ones((self.n_shards,))
        st = self._reduced(hyp, z, y, mu, s, w, fmask)
        return extract_state(hyp, z, st, jitter=jitter, kernel=self.kernel,
                             device=self.device)

    def predict_engine(self, state, block_size: int = 256,
                       donate: bool = False):
        """A ``serve.PredictEngine`` over ``state`` (the same on every rank)
        on this engine's device, sharding each query batch's rows over the
        engine's group: rank r computes its W-th, one all_gather gives every
        rank all rows.  ``donate`` changes nothing (torch donates no
        buffers); a caller's queries are never consumed."""
        from ..serve import PredictEngine

        return PredictEngine(state, block_size=block_size, device=self.device,
                             group=self.group, donate=donate)

    def multi_predict_engine(self, states, block_size: int = 256,
                             donate: bool = False, compute_dtype=None):
        """A ``serve.MultiPredictEngine`` serving N stacked states (an
        ensemble or an A/B fleet, the same on every rank) on this engine's
        device, sharding each batch's rows over the engine's group as
        :meth:`predict_engine` does."""
        from ..serve import MultiPredictEngine

        return MultiPredictEngine(states, block_size=block_size,
                                  compute_dtype=compute_dtype,
                                  device=self.device, group=self.group,
                                  donate=donate)

    # -- online updates -----------------------------------------------------------
    def update_stats_fn(self, d: int):
        """The distributed fold of a new sharded block into reduced Stats:
        ``fold(base, hyp, z, y_new, mu_new, s_new, w_new, fmask) -> Stats``,
        with ``y_new``, ``mu_new``, ``s_new``, ``w_new`` this rank's slice
        from :meth:`put_data` and ``base`` the same on every rank.  Each
        rank maps its slice with the exact fold (fold and downdate hold for
        unscaled Stats only, whatever ``batch_blocks`` is), one all_reduce
        sums them, and ``base`` is added (``stats.fold_stats``): O(k / W ·
        m²) map and O(m² + md) reduce, whatever ``base`` summarises.  To
        forget a block, subtract its :meth:`reduced_stats`
        (``stats.downdate_stats``)."""
        del d

        def fold(base, hyp, z, y, mu, s, w, fmask):
            with torch.no_grad():
                local = self._local_stats(hyp, z, y, mu, s,
                                          self._masked(w, fmask), exact=True)
                return fold_stats(base, self._reduce(local)[0])
        return fold

    def update_predictive_state(self, state, x_new, y_new, weights=None):
        """Absorb a block of k events, the same on every rank, into a
        served state by the rank-k refresh of ``serve.online`` on this
        rank's device, with no collective: the serving tier ingests events,
        not training shards.  Returns ``online.RefreshResult``; the
        training-side Stats are :meth:`update_stats_fn`'s."""
        from ..serve import online

        return online.update_state(state, x_new, y_new, weights)

    def downdate_predictive_state(self, state, x_old, y_old, weights=None):
        """Forget a block (the same on every rank) from a served state: the
        rank-k downdate with the guarded refactorisation fallback, no
        collective, as :meth:`update_predictive_state`."""
        from ..serve import online

        return online.downdate_state(state, x_old, y_old, weights)
