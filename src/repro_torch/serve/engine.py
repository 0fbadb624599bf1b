"""Batched predict engine over a frozen ``PredictiveState``.

Counterpart of ``repro.serve.engine.PredictEngine`` (the predict path, on
one device or sharded over a process group, and the online ``ingest`` /
``forget`` / ``swap_state``).  No output row depends on the batch it
arrives in.

* On the CPU the JAX package's ``lax.scan`` over blocks becomes a Python
  loop of the plain version, one block at a time, so one block's (block, m)
  slab is live at a time.  Queries are padded with zero rows up to a
  multiple of ``block_size``; pad rows are computed and sliced off.
* On CUDA one launch of the fused predict kernel covers the whole batch,
  unpadded: the kernel masks its ragged last row tile itself.  It keeps
  each 32-row slab in shared memory and never stores a (t, m) slab, so
  serving memory stays O(t·d + m² + m·d).  A state of any other kernel
  expression takes the plain serving math (``kernels.predict.
  predict_fn_for_engine``) block by block, as on the CPU, unpadded.

A low-precision state is cast once, at engine build, to ``compute_dtype``
(f32 for sub-f32 states), so the only loss is the storage rounding.

Sharding (``group=``, the counterpart of ``mesh=``/``data_axes=``): every
rank of a ``torch.distributed`` group holds the same state and is given
the same batch.  The batch is padded to a multiple of the group's W ranks
(W · ``block_size`` on the CPU), rank r computes only its contiguous W-th
of the rows, as ``shard_map`` over ``P(data)`` gives device r, and one
``all_gather`` of the packed ``(mean, var)`` hands every rank all the rows:
what ``np.asarray`` of the JAX engine's global array holds.  Over gloo,
CUDA buffers go through host copies.  The gather is the only collective.

``predict_stream`` serves an iterator of query batches, staging batch
``i+1`` in a background thread while batch ``i`` computes;
``sample_stream`` waits for the sampling of ROADMAP Queue 1 item 8.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from .._device import rank_device, resolve_device
from ..core.covariance import is_fused_se
from ..launch.mesh import via_host
from . import posterior


def _resolve_compute_dtype(state_dtype, compute_dtype) -> torch.dtype:
    """Engine compute width: explicit > state's own (f32/f64) > f32 floor."""
    if compute_dtype is not None:
        return compute_dtype
    return (state_dtype if torch.finfo(state_dtype).bits >= 32
            else torch.float32)


class PredictEngine:
    """Block predict engine.

    Args:
      state: a :class:`~repro_torch.serve.posterior.PredictiveState`.
      block_size: rows per block of the CPU loop; there queries are padded
        to a multiple of it.  The CUDA kernel takes any batch in one launch.
      compute_dtype: dtype every contraction runs in.  ``None`` keeps
        f32/f64 states as they are and lifts bf16/f16 states to f32.
      device: where the engine serves (default CUDA; ``"cpu"`` runs the
        plain versions).
      group: a ``torch.distributed`` process group whose ranks shard each
        batch's rows (module docstring); None serves alone.  Every rank
        must make the same calls with the same batches.
      donate: accepted for the JAX engine's signature, and changes nothing:
        torch has no buffer donation to a compiled program.  As in the JAX
        engine, a caller's own query buffer is never consumed or changed.
    """

    def __init__(self, state: posterior.PredictiveState, block_size: int = 256,
                 compute_dtype=None, device=None, group=None,
                 donate: bool = False):
        if block_size < 1:
            raise ValueError(f"block_size must be >= 1, got {block_size}")
        self.device = resolve_device(device)
        self.block_size = block_size
        self.donate = donate
        self.group = group
        self.n_shards = 1 if group is None else dist.get_world_size(group)
        self.rank = 0 if group is None else dist.get_rank(group)
        self._via_host = via_host(group, self.device)
        self.compute_dtype = _resolve_compute_dtype(state.dtype, compute_dtype)
        # The stored artifact stays as given (``.state``); every query runs
        # on the compute-width copy on the engine's device, made once here.
        self.state = state
        self._cstate = state._to(device=self.device, dtype=self.compute_dtype)

    def pad_queries(self, xstar) -> tuple[torch.Tensor, int]:
        """(t, q) queries on the engine's device in ``compute_dtype``,
        padded with zero rows up to a multiple of ``n_shards`` (times
        ``block_size`` on the CPU); returns (buffer, t)."""
        xq = torch.as_tensor(xstar).to(device=self.device,
                                       dtype=self.compute_dtype)
        t = xq.shape[0]
        mult = self.n_shards * (self.block_size if xq.device.type == "cpu"
                                else 1)
        pad = (-t) % mult
        if pad:
            xq = torch.cat([xq, xq.new_zeros((pad, xq.shape[1]))])
        return xq, t

    @property
    def compute_state(self) -> posterior.PredictiveState:
        """The compute-width, device-placed state the queries run on."""
        return self._cstate

    def run_blocks(self, xq: torch.Tensor, cstate=None):
        """(mean, var) of a buffer from :meth:`pad_queries`, pad rows
        included; ``cstate`` pins a :attr:`compute_state`.  Under a group
        this rank computes its W-th of the rows and every rank gets all."""
        st = self._cstate if cstate is None else cstate
        rows = xq.shape[0] // self.n_shards
        mine = xq[self.rank * rows:(self.rank + 1) * rows]
        if mine.device.type == "cuda" and is_fused_se(st.kernel):
            mean, var = posterior.predict_mean_var(st, mine)
        else:
            outs = [posterior.predict_mean_var(st, mine[i:i + self.block_size])
                    for i in range(0, rows, self.block_size)]
            mean = torch.cat([o[0] for o in outs])
            var = torch.cat([o[1] for o in outs])
        return self._gather(mean, var)

    # -- online updates (ingest-update-serve) -------------------------------
    def swap_state(self, state: posterior.PredictiveState) -> None:
        """Replace the served state with one of the same kernel expression
        and leaf shapes (``ValueError`` otherwise), rebuilding the
        compute-width copy on the engine's device; an engine built with
        ``group=`` keeps sharding its queries over that group.  The serving
        half of an online update: refresh the factors (``serve.online``) or
        re-extract after a fit, then swap."""
        if state.kernel != self.state.kernel:
            raise ValueError(
                "swap_state needs the same kernel expression "
                f"({self.state.kernel} vs {state.kernel}); build a new "
                "engine for a different covariance")
        for a, b in zip(self.state._leaves(), state._leaves()):
            if a.shape != b.shape:
                raise ValueError(
                    "swap_state needs identical leaf shapes (same m, q, d), "
                    f"got {tuple(a.shape)} vs {tuple(b.shape)}; build a new "
                    "engine for a reshaped state")
        self._cstate = state._to(device=self.device, dtype=self.compute_dtype)
        self.state = state

    def ingest(self, x_new, y_new, weights=None):
        """Absorb a block of k observations into the served posterior in
        O(m²k) (``serve.online.update_state``, then :meth:`swap_state`);
        the hyper-parameters stay.  Returns the ``online.RefreshResult``."""
        from . import online
        res = online.update_state(self.state, x_new, y_new, weights)
        self.swap_state(res.state)
        return res

    def forget(self, x_old, y_old, weights=None):
        """Remove a block ingested before (``serve.online.downdate_state``,
        with its guarded refactorisation fallback, then
        :meth:`swap_state`).  Returns the ``online.RefreshResult``; read
        ``.fallback`` for telemetry."""
        from . import online
        res = online.downdate_state(self.state, x_old, y_old, weights)
        self.swap_state(res.state)
        return res

    def _gather(self, mean, var):
        """Every rank's rows of (mean, var), in rank order, on every rank:
        one ``all_gather`` of the packed (rows, d + 1) buffer."""
        if self.group is None:
            return mean, var
        packed = torch.cat([mean, var[:, None]], 1)
        if self._via_host:
            packed = packed.cpu()
        parts = [torch.empty_like(packed) for _ in range(self.n_shards)]
        dist.all_gather(parts, packed, group=self.group)
        full = torch.cat(parts).to(mean.device)
        return full[:, :-1], full[:, -1]

    def _noise_var(self) -> torch.Tensor:
        return torch.exp(-self._cstate.hyp["log_beta"])

    @torch.no_grad()
    def _answer(self, xq, t: int, include_noise: bool):
        """(mean, var) of the first ``t`` rows of a padded buffer."""
        if t == 0:
            # An empty batch is a no-op, never a shape error.
            return (xq.new_zeros((0, self.state.d)), xq.new_zeros((0,)))
        mean, var = self.run_blocks(xq)
        mean, var = mean[:t], var[:t]
        if include_noise:
            var = var + self._noise_var()
        return mean, var

    def predict(self, xstar, include_noise: bool = False):
        """Batched diag-variance prediction: ``(mean (t, d), var (t,))``."""
        return self._answer(*self.pad_queries(xstar), include_noise)

    @torch.no_grad()
    def predict_full_cov(self, xstar, include_noise: bool = False):
        """Full-covariance mode: ``(mean (t, d), cov (t, t))``, in one piece
        (cross-covariances couple all query pairs): the small-t mode."""
        xq = torch.as_tensor(xstar).to(device=self.device,
                                       dtype=self.compute_dtype)
        mean, cov = posterior.predict_full_cov(self._cstate, xq)
        if include_noise:
            cov = cov + self._noise_var() * torch.eye(
                xq.shape[0], dtype=cov.dtype, device=cov.device)
        return mean, cov

    def __call__(self, xstar, include_noise: bool = False,
                 full_cov: bool = False):
        if full_cov:
            return self.predict_full_cov(xstar, include_noise=include_noise)
        return self.predict(xstar, include_noise=include_noise)

    def predict_stream(self, queries, include_noise: bool = False,
                       prefetch_depth: int = 2):
        """Serve an iterator of query batches: yields one ``(mean, var)``
        per batch, in order, each bitwise what :meth:`predict` returns for
        it; only ``prefetch_depth`` + 1 batches are on the device at once.
        :meth:`pad_queries` runs in a ``data.stream.prefetch`` worker, bound
        to the engine's device, while the caller's batch computes; a
        failure there raises here."""
        from ..data.stream import prefetch

        dev = rank_device(self.device)   # with its index, for the worker

        def stage(xstar):
            if dev.type != "cuda":
                return self.pad_queries(xstar)
            with torch.cuda.device(dev):   # the current device is per thread
                return self.pad_queries(xstar)

        for xq, t in prefetch(iter(queries), stage, depth=prefetch_depth):
            yield self._answer(xq, t, include_noise)

    def predict_np(self, xstar, include_noise: bool = False):
        """predict, then copied to host numpy arrays."""
        mean, var = self.predict(xstar, include_noise=include_noise)
        return mean.cpu().numpy(), var.cpu().numpy()
