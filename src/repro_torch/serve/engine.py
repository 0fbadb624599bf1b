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
``i+1`` in a background thread while batch ``i`` computes.

``sample`` draws posterior functions jointly within each ``block_size``
block of queries and independently across blocks.  It has no kernel in
either package: each block's moments, its (block, block) Cholesky and the
draws are ``torch.linalg`` and matmuls in f64, block by block (one block's
factor never depends on how many blocks a call holds).  Block i's normals
come from a generator seeded from ``(seed, i)`` alone, i the global block
index, so a one-shot call, ``sample_stream`` over batches that are
multiples of ``block_size`` and a sharded engine (each rank draws its own
contiguous blocks, one ``all_gather`` joins them) give the same bits.

:class:`MultiPredictEngine` serves N same-shape states (an ensemble or an
A/B fleet) stacked into one state with a leading model axis
(:func:`stack_states`).  Where the JAX engine ``vmap``s its block scan
over the models, the port answers model by model: on CUDA one launch of
the fused predict kernel per model covers the batch, so every model's rows
are bitwise its own :class:`PredictEngine`'s and no (N, t, m) slab exists.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from .._device import rank_device, resolve_device
from ..core.bound import DEFAULT_JITTER
from ..core.covariance import is_fused_se
from ..core.flat import tree_map
from ..launch.mesh import via_host
from . import posterior

_MASK64 = (1 << 64) - 1


def _resolve_compute_dtype(state_dtype, compute_dtype) -> torch.dtype:
    """Engine compute width: explicit > state's own (f32/f64) > f32 floor."""
    if compute_dtype is not None:
        return compute_dtype
    return (state_dtype if torch.finfo(state_dtype).bits >= 32
            else torch.float32)


def _mix64(x: int) -> int:
    """splitmix64's finaliser: a bijection of 64-bit integers that spreads
    neighbouring inputs apart."""
    x = (x + 0x9E3779B97F4A7C15) & _MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
    return x ^ (x >> 31)


def _block_seed(seed: int, block: int) -> int:
    """The seed of global block ``block``'s normals: a function of
    ``(seed, block)`` alone, the counterpart of ``fold_in(key, block)``."""
    return _mix64(_mix64(seed & _MASK64) ^ block)


def _base_seed(key) -> int:
    """An integer seed as given, or one draw from a ``torch.Generator``."""
    if isinstance(key, torch.Generator):
        return int(torch.randint(0, 1 << 62, (), generator=key,
                                 device=key.device))
    return int(key)


def _rows(st, x, block_size: int):
    """Noise-free ``(mean, var)`` of the query rows ``x`` under one state:
    one launch of the fused kernel on CUDA for the full-width SE-ARD, else
    the state's serving math block by block."""
    if x.device.type == "cuda" and is_fused_se(st.kernel):
        return posterior.predict_mean_var(st, x)
    outs = [posterior.predict_mean_var(st, x[i:i + block_size])
            for i in range(0, x.shape[0], block_size)]
    return torch.cat([o[0] for o in outs]), torch.cat([o[1] for o in outs])


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
      sample_jitter: diagonal jitter (scaled by the signal variance, the
        ``_chol_kmm`` convention) added to each block's covariance before
        its Cholesky in :meth:`sample`.
    """

    def __init__(self, state: posterior.PredictiveState, block_size: int = 256,
                 compute_dtype=None, device=None, group=None,
                 donate: bool = False, sample_jitter: float = DEFAULT_JITTER):
        if block_size < 1:
            raise ValueError(f"block_size must be >= 1, got {block_size}")
        self.device = resolve_device(device)
        self.block_size = block_size
        self.donate = donate
        self.sample_jitter = sample_jitter
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
        return self._pad(xstar, self.n_shards * (
            self.block_size if self.device.type == "cpu" else 1))

    def _pad(self, xstar, mult: int) -> tuple[torch.Tensor, int]:
        """(t, q) queries on the engine's device in ``compute_dtype``,
        padded with zero rows up to a multiple of ``mult``."""
        xq = torch.as_tensor(xstar).to(device=self.device,
                                       dtype=self.compute_dtype)
        t = xq.shape[0]
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
        return self._gather(*_rows(st, self._my_rows(xq), self.block_size))

    def _my_rows(self, xq: torch.Tensor) -> torch.Tensor:
        """This rank's contiguous W-th of a padded buffer's rows."""
        rows = xq.shape[0] // self.n_shards
        return xq[self.rank * rows:(self.rank + 1) * rows]

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
        one ``all_gather`` of the packed (..., rows, d + 1) buffer."""
        if self.group is None:
            return mean, var
        full = self._gather_rows(torch.cat([mean, var[..., None]], -1), -2)
        return full[..., :-1], full[..., -1]

    def _gather_rows(self, local: torch.Tensor, dim: int) -> torch.Tensor:
        """Every rank's ``local`` joined along its row axis ``dim``, in rank
        order, on every rank: one ``all_gather`` (through the host over
        gloo for CUDA buffers)."""
        if self.group is None:
            return local
        send = local.cpu() if self._via_host else local.contiguous()
        parts = [torch.empty_like(send) for _ in range(self.n_shards)]
        dist.all_gather(parts, send, group=self.group)
        return torch.cat(parts, dim).to(local.device)

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
        for xq, t in self._staged(queries, self.pad_queries, prefetch_depth):
            yield self._answer(xq, t, include_noise)

    def _staged(self, queries, pad, depth: int):
        """``pad`` over an iterator of batches in a ``data.stream.prefetch``
        worker bound to the engine's card, ``depth`` batches ahead."""
        from ..data.stream import prefetch

        dev = rank_device(self.device)   # with its index, for the worker

        def stage(xstar):
            if dev.type != "cuda":
                return pad(xstar)
            with torch.cuda.device(dev):   # the current device is per thread
                return pad(xstar)

        return prefetch(iter(queries), stage, depth=depth)

    # -- posterior sampling -------------------------------------------------
    def _check_sampling(self, num_samples: int, what: str) -> None:
        if num_samples < 1:
            raise ValueError(f"num_samples must be >= 1, got {num_samples}")
        if torch.finfo(self.compute_dtype).bits < 32:
            raise ValueError(
                f"{what} needs a Cholesky per block; build the engine with "
                f"compute_dtype=f32/f64, not {self.compute_dtype}")
        if torch.finfo(self.state.dtype).bits < 32:
            raise ValueError(
                f"{what} re-factorises each block's predictive covariance, "
                "and sub-f32 storage rounding (bf16/f16 quantization of g) "
                "can make it indefinite beyond any reasonable jitter; ship "
                "an f32/f64 PredictiveState for sampling (quantized states "
                "serve mean/var only)")

    def _pad_blocks(self, xstar) -> tuple[torch.Tensor, int]:
        """Queries padded to whole blocks on every rank, on any device."""
        return self._pad(xstar, self.n_shards * self.block_size)

    @torch.no_grad()
    def _sample_padded(self, xq, t: int, seed: int, offset: int,
                       num_samples: int, include_noise: bool):
        """Draws (num_samples, t, d) of a buffer from :meth:`_pad_blocks`
        whose first block is global block ``offset``: this rank draws its
        contiguous blocks, each from its own ``(seed, block)`` generator,
        one block at a time; one ``all_gather`` joins the ranks' rows."""
        bs, st = self.block_size, self._cstate
        mine = self._my_rows(xq)
        first = offset + self.rank * (mine.shape[0] // bs)
        outs = [posterior.sample_block(
            st, mine[i:i + bs],
            torch.Generator(device=xq.device).manual_seed(
                _block_seed(seed, first + i // bs)),
            num_samples, jitter=self.sample_jitter,
            include_noise=include_noise)
            for i in range(0, mine.shape[0], bs)]
        local = (torch.cat(outs, 1) if outs else
                 xq.new_zeros((num_samples, 0, self.state.d)))
        return self._gather_rows(local, 1)[:, :t]

    def sample(self, xstar, num_samples: int, key,
               include_noise: bool = False) -> torch.Tensor:
        """Posterior function draws: ``(num_samples, t, d)``, in
        ``compute_dtype``.

        Draws are joint within each ``block_size`` block of queries (the
        block's full predictive covariance, a jittered Cholesky) and
        independent across blocks: ``block_size`` is the correlation
        length; for exact joint draws over every query keep ``t <=
        block_size`` or use ``serve.posterior.sample_joint``.  ``key`` is
        an integer seed or a ``torch.Generator`` (one integer is drawn from
        it).  Block i's normals depend on ``(key, i)`` alone, i the global
        block index, so a sharded engine draws the same bits as a single
        one; the same key and queries give the same samples on one device
        type (CPU and CUDA generators differ)."""
        self._check_sampling(num_samples, "sample")
        xq, t = self._pad_blocks(xstar)
        return self._sample_padded(xq, t, _base_seed(key), 0, num_samples,
                                   include_noise)

    def sample_stream(self, queries, num_samples: int, key,
                      include_noise: bool = False, prefetch_depth: int = 2):
        """Streaming :meth:`sample`: yields ``(num_samples, t_i, d)`` draws
        per query batch, staged as :meth:`predict_stream` stages.  Block
        seeds run over the concatenated stream (each batch advances the
        offset by its padded block count), so batches whose row counts are
        multiples of ``n_shards * block_size`` give bitwise
        ``sample(concat(batches))``; ragged batches still draw valid
        independent blocks, under another assignment."""
        self._check_sampling(num_samples, "sample_stream")
        seed, offset = _base_seed(key), 0
        for xq, t in self._staged(queries, self._pad_blocks, prefetch_depth):
            yield self._sample_padded(xq, t, seed, offset, num_samples,
                                      include_noise)
            offset += xq.shape[0] // self.block_size

    def predict_np(self, xstar, include_noise: bool = False):
        """predict, then copied to host numpy arrays."""
        mean, var = self.predict(xstar, include_noise=include_noise)
        return mean.cpu().numpy(), var.cpu().numpy()


# -- multi-model serving ----------------------------------------------------

def stack_states(states) -> posterior.PredictiveState:
    """N same-shape PredictiveStates stacked into one: every leaf gains a
    leading model axis of size N (what :class:`MultiPredictEngine` serves).
    The states must share one kernel expression and every leaf's shape and
    dtype (``astype`` first if the fleet is of mixed precision)."""
    states = list(states)
    if not states:
        raise ValueError("stack_states needs at least one PredictiveState")
    ref = states[0]
    for s in states[1:]:
        if s.kernel != ref.kernel:
            raise ValueError(
                "all PredictiveStates must share one kernel expression to "
                f"stack: {ref.kernel} vs {s.kernel}")
        for a, b in zip(ref._leaves(), s._leaves()):
            if a.shape != b.shape or a.dtype != b.dtype:
                raise ValueError(
                    "all PredictiveStates must share leaf shapes/dtypes to "
                    f"stack: {tuple(a.shape)}/{a.dtype} vs "
                    f"{tuple(b.shape)}/{b.dtype}")
    fields = posterior._ARRAY_FIELDS
    return posterior.PredictiveState(
        hyp=tree_map(lambda *ls: torch.stack(ls), *(s.hyp for s in states)),
        kernel=ref.kernel,
        **{f: torch.stack([getattr(s, f) for s in states]) for f in fields})


def mixture_moments(mean: torch.Tensor, var: torch.Tensor):
    """Equal-weight mixture moments from per-model predictions: ``mean``
    (N, t, d), ``var`` (N, t) -> (mean (t, d), var (t, d)), the mean
    within-model variance plus the spread of the models' means (per output
    dim).  Within-model variances are clamped at 0 first: a quantized state
    can round a near-zero ``k** - quad`` slightly negative."""
    return (mean.mean(0),
            var.clamp(min=0).mean(0)[:, None] + mean.var(0, correction=0))


def _slot(st: posterior.PredictiveState, k: int) -> posterior.PredictiveState:
    """Model ``k`` of a stacked state (views of its leaves)."""
    return st._map(lambda v: v[k])


class MultiPredictEngine:
    """Serve N same-shape PredictiveStates (an ensemble or an A/B fleet).

    The states are stacked into one state with a leading model axis
    (:func:`stack_states`), held once at compute width on the engine's
    device.  Every model answers each batch: :meth:`predict` returns
    ``(mean (N, t, d), var (N, t))``, model k's rows bitwise what its own
    :class:`PredictEngine` returns (on CUDA one fused predict launch per
    model covers the batch; elsewhere, and for any other kernel
    expression, the plain serving math block by block).

    Args:
      states: a sequence of PredictiveStates (stacked here), or a state
        already stacked (:func:`stack_states`, or another engine's
        ``.state``).
      block_size / compute_dtype / device / group / donate: as
        :class:`PredictEngine`: under ``group`` each rank computes its
        W-th of the rows for every model, one ``all_gather`` joins them.
    """

    def __init__(self, states, block_size: int = 256, compute_dtype=None,
                 device=None, group=None, donate: bool = False):
        if block_size < 1:
            raise ValueError(f"block_size must be >= 1, got {block_size}")
        stacked = (states if isinstance(states, posterior.PredictiveState)
                   else stack_states(states))
        if stacked.z.ndim != 3:
            raise ValueError(
                "expected a stacked state with a leading model axis, got z "
                f"of shape {tuple(stacked.z.shape)}")
        self.n_models = stacked.z.shape[0]
        self.device = resolve_device(device)
        self.block_size = block_size
        self.donate = donate
        self.group = group
        self.n_shards = 1 if group is None else dist.get_world_size(group)
        self.rank = 0 if group is None else dist.get_rank(group)
        self._via_host = via_host(group, self.device)
        self.compute_dtype = _resolve_compute_dtype(stacked.dtype,
                                                    compute_dtype)
        self.state = stacked
        self._cstate = stacked._to(device=self.device,
                                   dtype=self.compute_dtype)

    # The padding, the compute state and the gather are the single-model
    # engine's (the state is simply the stacked one).
    pad_queries = PredictEngine.pad_queries
    _pad = PredictEngine._pad
    _my_rows = PredictEngine._my_rows
    _gather = PredictEngine._gather
    _gather_rows = PredictEngine._gather_rows
    compute_state = PredictEngine.compute_state

    def run_blocks(self, xq: torch.Tensor, cstate=None):
        """(mean (N, rows, d), var (N, rows)) of a buffer from
        :meth:`pad_queries`, pad rows included, model by model; ``cstate``
        pins a :attr:`compute_state`."""
        st = self._cstate if cstate is None else cstate
        mine = self._my_rows(xq)
        outs = [_rows(_slot(st, k), mine, self.block_size)
                for k in range(st.z.shape[0])]
        return self._gather(torch.stack([o[0] for o in outs]),
                            torch.stack([o[1] for o in outs]))

    # -- hot swap -----------------------------------------------------------
    def swap_state(self, states) -> None:
        """Replace the whole fleet with same-shape states (a stacked state
        or a sequence of N), rebuilding the compute-width copy."""
        stacked = (states if isinstance(states, posterior.PredictiveState)
                   else stack_states(states))
        if stacked.kernel != self.state.kernel:
            raise ValueError(
                "swap_state needs the same kernel expression "
                f"({self.state.kernel} vs {stacked.kernel}); build a new "
                "engine for a different covariance")
        for a, b in zip(self.state._leaves(), stacked._leaves()):
            if a.shape != b.shape:
                raise ValueError(
                    "swap_state needs identical leaf shapes (same N, m, q, d)"
                    f", got {tuple(a.shape)} vs {tuple(b.shape)}; build a new "
                    "engine for a reshaped fleet")
        self._cstate = stacked._to(device=self.device,
                                   dtype=self.compute_dtype)
        self.state = stacked

    def swap_slot(self, index: int, state: posterior.PredictiveState) -> None:
        """Replace ONE model of the fleet (an A/B rollout: a new state into
        slot ``index`` while the other N-1 keep serving), as
        :meth:`swap_state` does for the whole fleet."""
        if not 0 <= index < self.n_models:
            raise ValueError(
                f"slot {index} out of range for a fleet of {self.n_models}")
        if state.kernel != self.state.kernel:
            raise ValueError(
                "swap_slot needs the same kernel expression "
                f"({self.state.kernel} vs {state.kernel})")
        for a, b in zip(self.state._leaves(), state._leaves()):
            if a.shape[1:] != b.shape:
                raise ValueError(
                    "swap_slot needs a state matching the fleet's per-model "
                    f"leaf shapes, got {tuple(b.shape)} for a slot of "
                    f"{tuple(a.shape[1:])}")

        def put(big, one):
            new = big.clone()
            new[index] = posterior._cast(one, big.dtype).to(big.device)
            return new

        self.swap_state(posterior.PredictiveState(
            hyp=tree_map(put, self.state.hyp, state.hyp),
            kernel=self.state.kernel,
            **{f: put(getattr(self.state, f), getattr(state, f))
               for f in posterior._ARRAY_FIELDS}))

    @torch.no_grad()
    def predict(self, xstar, include_noise: bool = False):
        """All models answer the batch: ``(mean (N, t, d), var (N, t))``."""
        xq, t = self.pad_queries(xstar)
        if t == 0:
            return (xq.new_zeros((self.n_models, 0, self.state.d)),
                    xq.new_zeros((self.n_models, 0)))
        mean, var = self.run_blocks(xq)
        mean, var = mean[:, :t], var[:, :t]
        if include_noise:
            var = var + torch.exp(-self._cstate.hyp["log_beta"])[:, None]
        return mean, var

    def __call__(self, xstar, include_noise: bool = False):
        return self.predict(xstar, include_noise=include_noise)

    def predict_mixture(self, xstar, include_noise: bool = False):
        """Equal-weight ensemble moments: ``(mean (t, d), var (t, d))``."""
        return mixture_moments(*self.predict(xstar,
                                             include_noise=include_noise))
