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

Ported: the default configuration of the JAX engine (serial reduce,
in-memory data, the exact bound, SE-ARD, ``chunk_size`` None or an
integer), regression and latent.  Each option not ported yet raises
``NotImplementedError`` naming its ROADMAP Queue 1 item.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from .._device import as_f64, rank_device
from ..data.stream import padded_rows
from . import covariance as cov
from .bound import DEFAULT_JITTER, collapsed_bound
from .stats import Stats, pack_stats, partial_stats_chunked, unpack_stats


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


def _not_ported(name: str, item: int):
    def method(self, *args, **kwargs):
        raise NotImplementedError(f"DistributedGP.{name} is not ported yet "
                                  f"(ROADMAP Queue 1 item {item})")
    method.__name__ = name
    return method


def _leaf(t, need: bool):
    """A fresh autograd leaf of ``t`` (each leaf of a dict), or ``t``."""
    if t is None or not need:
        return t
    if isinstance(t, dict):
        return {k: v.detach().requires_grad_() for k, v in t.items()}
    return t.detach().requires_grad_()


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
    """Distributed bound, gradient and serving handoff for SGPR
    (``latent=False``) and the Bayesian GPLVM (``latent=True``).

    ``group``: the process group whose ranks are the data shards (default:
    the process's default group if it joined one, else a world of one with
    no communication).  ``device``: this rank's device (default the card,
    ``cuda:{LOCAL_RANK}``; raises without CUDA; ``"cpu"`` runs the plain
    versions).  Over gloo, CUDA buffers are reduced through host copies.

    ``chunk_size``: each rank's map folds its rows in blocks of this many
    (``stats.partial_stats_chunked``); ``put_data`` then pads n to a
    multiple of ``n_shards * chunk_size``.  Not ported: ``batch_blocks``
    (ROADMAP Queue 1 item 3), ``reduce_mode`` other than ``"serial"`` (item
    11), the ``psi2_fn``/``reg_stats_fn`` hooks (items 5 and 6), and
    kernels other than SE-ARD (item 6, raised by ``covariance``).
    """

    def __init__(self, group=None, latent: bool = False,
                 failure_mode: str = "drop", chunk_size: int | None = None,
                 kernel=None, device=None, *, batch_blocks=None,
                 reduce_mode: str = "serial", psi2_fn=None,
                 reg_stats_fn=None):
        if chunk_size is not None and chunk_size < 1:
            raise ValueError(f"chunk_size must be >= 1, got {chunk_size}")
        if failure_mode not in ("drop", "rescale"):
            raise ValueError("failure_mode must be 'drop' or 'rescale', got "
                             f"{failure_mode!r}")
        if batch_blocks is not None:
            raise NotImplementedError("DistributedGP(batch_blocks=...), the "
                                      "SVI bound, is not ported yet (ROADMAP "
                                      "Queue 1 item 3)")
        if reduce_mode != "serial":
            raise NotImplementedError(f"reduce_mode={reduce_mode!r} is not "
                                      "ported yet (ROADMAP Queue 1 item 11)")
        if psi2_fn is not None or reg_stats_fn is not None:
            raise NotImplementedError("the psi2_fn/reg_stats_fn hooks are not "
                                      "ported yet (ROADMAP Queue 1 items 5 "
                                      "and 6); CUDA tensors always take the "
                                      "hand-written kernels")
        self.kernel = cov.as_kernel(kernel)
        self.device = rank_device(device)
        if group is None and dist.is_available() and dist.is_initialized():
            group = dist.group.WORLD
        self.group = group
        self.rank = 0 if group is None else dist.get_rank(group)
        self.n_shards = num_shards(group)
        self.latent = latent
        self.failure_mode = failure_mode
        self.chunk_size = chunk_size
        self._via_host = (group is not None and self.device.type == "cuda"
                          and dist.get_backend(group) == "gloo")

    # -- data -----------------------------------------------------------------
    def put_data(self, stream=None, **arrs):
        """Pad the full host arrays (``y=``, ``mu=``, ``s=``) as the JAX
        engine does and keep this rank's contiguous block of n_pad / W rows,
        and its weights, in f64 on the engine's device: ``(dict, w)``."""
        if stream is not None:
            raise NotImplementedError("put_data(stream=...) is not ported yet "
                                      "(ROADMAP Queue 1 item 9)")
        padded, w = pad_and_shard(arrs, self.n_shards, block=self.chunk_size)
        rows = w.shape[0] // self.n_shards
        mine = slice(self.rank * rows, (self.rank + 1) * rows)
        return ({k: as_f64(v[mine], self.device) for k, v in padded.items()},
                as_f64(w[mine], self.device))

    # -- the map, the reduce, the global step -----------------------------------
    def _local_stats(self, hyp, z, y, mu, s, w) -> Stats:
        return partial_stats_chunked(hyp, z, y, mu, s, weights=w,
                                     latent=self.latent,
                                     block_size=self.chunk_size,
                                     kernel=self.kernel, force_scan=True)

    def _all_reduce(self, buf: torch.Tensor) -> torch.Tensor:
        """The constant-size sum over ranks (the paper's reduce)."""
        if self.group is None:
            return buf
        host = buf.cpu() if self._via_host else buf
        dist.all_reduce(host, op=dist.ReduceOp.SUM, group=self.group)
        return host.to(buf.device) if self._via_host else host

    def _masked(self, w, fmask):
        """This rank's weights with its entry of the failure mask."""
        return w * torch.as_tensor(fmask, dtype=w.dtype,
                                   device=w.device)[self.rank]

    def _reduced(self, hyp, z, y, mu, s, w, fmask) -> Stats:
        with torch.no_grad():
            st = self._local_stats(hyp, z, y, mu, s, self._masked(w, fmask))
            return unpack_stats(self._all_reduce(pack_stats(st)),
                                z.shape[0], y.shape[1])

    def _bound(self, hyp, z, st: Stats, d: int, n_full):
        """The failure mode's n handling, then the collapsed bound."""
        n_full = torch.as_tensor(n_full, dtype=st.n.dtype, device=st.n.device)
        if self.failure_mode == "rescale":
            live = st.n / n_full
            st = Stats(A=st.A / live, B=st.B / live, C=st.C / live,
                       D=st.D / live, KL=st.KL / live, n=n_full)
        else:
            st = st._replace(n=n_full)
        return collapsed_bound(hyp, z, st, d, kernel=self.kernel)

    def bound_fn(self, d: int):
        """The bound, the same on every rank: ``(hyp, z, y, mu, s, w,
        fmask, n_full) -> ()``; NaN where the global step's Cholesky fails.
        Value only: the gradient is :meth:`make_value_and_grad`'s."""
        def bound(hyp, z, y, mu, s, w, fmask, n_full):
            st = self._reduced(hyp, z, y, mu, s, w, fmask)
            with torch.no_grad():
                try:
                    return self._bound(hyp, z, st, d, n_full)
                except torch.linalg.LinAlgError:
                    return torch.full((), float("nan"), dtype=st.n.dtype,
                                      device=st.n.device)
        return bound

    def make_value_and_grad(self, d: int, argnums=(0, 1)):
        """(value, grad) of the NEGATIVE bound with respect to the chosen
        arguments: ``step(hyp, z, mu, s, y, w, fmask, n_full)``.

        ``argnums`` indexes (hyp, z, mu, s): (0, 1) for the SGPR, add 2 and
        3 for the GPLVM (gradients with respect to the variances s).  The
        gradients come back in that order (one, not a tuple, for an int);
        hyp's as a dict.  hyp and z gradients are the same on every rank;
        mu and s gradients are this rank's rows.
        """
        single = isinstance(argnums, int)
        argnums = (argnums,) if single else tuple(argnums)
        if not set(argnums) <= {0, 1, 2, 3}:
            raise ValueError(f"argnums must index (hyp, z, mu, s), got "
                             f"{argnums}")

        def step(hyp, z, mu, s, y, w, fmask, n_full):
            if 3 in argnums and s is None:
                raise ValueError("argnums holds 3 (s), but s is None")
            hyp, z, mu, s = (_leaf(p, i in argnums)
                             for i, p in enumerate((hyp, z, mu, s)))
            keys = sorted(hyp)
            theta = [hyp[k] for k in keys] + [z]          # global params
            rows = [mu] + ([] if s is None else [s])      # this rank's
            # 1. the map on this rank's rows, its graph kept for step 3
            with torch.enable_grad():
                local = self._local_stats(hyp, z, y, mu, s,
                                          self._masked(w, fmask))
            # 2. the reduce; the bound of the reduced Stats as leaves gives
            #    dF/dS and the direct dF/dtheta, the same on every rank
            st = unpack_stats(self._all_reduce(pack_stats(local).detach()),
                              z.shape[0], y.shape[1])
            st = Stats(*(t.detach().requires_grad_() for t in st))
            try:
                with torch.enable_grad():
                    neg = -self._bound(hyp, z, st, d, n_full)
                    direct = _grads([neg], theta + list(st))
            except torch.linalg.LinAlgError:
                neg = torch.full((), float("nan"), dtype=st.n.dtype,
                                 device=st.n.device)
                direct = [torch.full_like(t, float("nan"))
                          for t in theta + list(st)]
            g_theta, g_st = direct[:len(theta)], direct[len(theta):]
            # 3. dF/dS pulled back through this rank's map
            outs = [(o, g) for o, g in zip(local, g_st) if o.requires_grad]
            pulled = _grads([o for o, _ in outs], theta + rows,
                            [g for _, g in outs])
            grads = {i: g for i, g in zip((2, 3), pulled[len(theta):])}
            # 4. one all_reduce of the ranks' (hyp, z) parts; 5. the direct
            #    part added once
            if {0, 1} & set(argnums):
                parts = self._all_reduce(torch.cat(
                    [g.reshape(-1) for g in pulled[:len(theta)]]))
                summed = [g + p.reshape(g.shape) for g, p in zip(
                    g_theta, parts.split([t.numel() for t in theta]))]
                grads[0] = dict(zip(keys, summed[:-1]))
                grads[1] = summed[-1]
            out = tuple(grads[i] for i in argnums)
            return neg.detach(), (out[0] if single else out)

        return step

    def reduced_stats(self, d: int):
        """The reduced Stats, the same on every rank: ``(hyp, z, y, mu, s,
        w, fmask) -> Stats`` (the failure mask applied, n the live count)."""
        del d
        return self._reduced

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

    # -- not ported yet ---------------------------------------------------------
    predict_engine = _not_ported("predict_engine", 4)
    multi_predict_engine = _not_ported("multi_predict_engine", 8)
    update_stats_fn = _not_ported("update_stats_fn", 7)
    update_predictive_state = _not_ported("update_predictive_state", 7)
    downdate_predictive_state = _not_ported("downdate_predictive_state", 7)
    open_stream = _not_ported("open_stream", 9)
    streamed_stats = _not_ported("streamed_stats", 9)
    streamed_bound = _not_ported("streamed_bound", 9)
    streamed_value_and_grad = _not_ported("streamed_value_and_grad", 9)
    streamed_svi_value_and_grad = _not_ported("streamed_svi_value_and_grad", 9)
    streamed_predictive_state = _not_ported("streamed_predictive_state", 9)
