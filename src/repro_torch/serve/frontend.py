"""Async micro-batching serving front-end: requests in, engine batches out.

Counterpart of ``repro.serve.frontend``.  The engines (:mod:`serve.engine`)
answer one batch per call; a deployment faces many concurrent requests of
any size.  :class:`Frontend` is the layer between:

  * **Continuous micro-batching.** One dispatch loop pulls requests off a
    bounded queue and coalesces them until the batch is full
    (``max_batch_rows``, rounded up to ``n_shards * block_size``) or the
    oldest request has waited ``max_wait_ms``, then flushes.  Requests are
    concatenated raw and padded once; predictions are row-local, so each
    response is bitwise what a direct ``engine.predict`` returns for it.
  * **Admission control and deadlines.** A full queue rejects at submit
    with :class:`QueueFull`; a request whose deadline passes before
    dispatch fails fast with :class:`SLOExceeded` and takes no engine time.
    A request dispatched in time but finished late is answered and counted
    ``late``.
  * **SLO accounting.** Every request feeds the constant-memory
    :class:`~repro_torch.serve.slo.SLOMetrics`; each flush's engine wall
    time also feeds a :class:`~repro_torch.distributed.fault.StepTimer`
    (the training loop's min/mean/max load summary).
  * **Hot swap.** :meth:`Frontend.swap_state` replaces the engine's state
    (or one slot of a :class:`~repro_torch.serve.engine.MultiPredictEngine`
    fleet) while requests are in flight.  The fence is one
    ``(generation, compute_state, noise)`` tuple, assigned at once and read
    once per flush: a flush in flight keeps its snapshot (whose references
    keep its tensors alive), every response carries the generation it was
    served under, and no request is dropped by a swap.

The engine call runs in a worker thread (``run_in_executor``) so the event
loop keeps accepting requests while the card computes.  The worker binds
the engine's card (the CUDA current device is per thread; the kernels
launch on its current stream) and does three steps: pad in numpy, one
host-to-device copy, ``run_blocks`` and one device-to-host copy.  There is
no compile to pay: :meth:`Frontend.warmup` runs every padded batch shape
once, so the kernel's library is built or loaded and the allocator holds
its blocks before the first flush.

An engine sharded over a process group (``PredictEngine(group=)``,
``MultiPredictEngine(group=)``) needs every rank to make the same calls
with the same batches, where the JAX package's front-end drives a mesh
from one process.  So rank 0 runs the :class:`Frontend`, and each other
rank runs :func:`serve_follower` on its engine.  Every flush broadcasts
a small header (operation, rows, generation) and the padded batch, then
every rank calls ``run_blocks`` on it, whose ``all_gather`` hands rank 0
every row; a ``swap_state`` broadcasts the new compute state's leaves;
:meth:`Frontend.close` sends the message that ends the followers' loop.
Over gloo the broadcasts go through the host, over NCCL on the card.  A
world of one serves as without a group.  All request-path methods
(``submit``, ``start``, ``stop``, ``close``) belong to one event loop;
``swap_state`` may be called from any thread.
"""
from __future__ import annotations

import asyncio
import contextlib
import dataclasses
import pathlib
import threading
import time
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from .._device import rank_device
from ..core.flat import tree_items, tree_unflatten
from ..distributed.fault import StepTimer
from .engine import MultiPredictEngine, PredictEngine
from .posterior import _ARRAY_FIELDS, load_state
from .slo import SLOMetrics

_NUMPY_DTYPES = {torch.float64: np.float64, torch.float32: np.float32,
                 torch.float16: np.float16}


class FrontendError(RuntimeError):
    """Base class for front-end request failures."""


class QueueFull(FrontendError):
    """Admission control: the bounded request queue cannot take this
    request now; retry with backoff or shed load upstream."""


class SLOExceeded(FrontendError):
    """The request's deadline expired before it could be dispatched; it
    was failed fast (no engine time spent), never silently dropped."""


class ServeResult(NamedTuple):
    """One answered request.  ``mean``/``var`` are numpy, shaped as
    ``engine.predict`` returns this request's rows ((t, d)/(t,) for one
    model; (N, t, d)/(N, t) for a fleet).  ``generation`` is the hot-swap
    fence value of the state that served it."""

    mean: np.ndarray
    var: np.ndarray
    generation: int


@dataclass
class _Request:
    x: np.ndarray
    include_noise: bool
    enqueue: float            # monotonic seconds
    deadline: float | None    # monotonic seconds, absolute
    future: asyncio.Future


_CLOSE = object()   # queue sentinel: drain and stop

# The operations rank 0 broadcasts to the followers of a sharded engine.
_OP_RUN, _OP_SWAP, _OP_STOP = 1, 2, 3


def _buffer(engine, shape, dtype) -> torch.Tensor:
    """A buffer to receive a broadcast in: on the host over gloo, on the
    engine's device over NCCL."""
    on_host = engine._via_host or engine.device.type == "cpu"
    return torch.empty(shape, dtype=dtype,
                       device="cpu" if on_host else engine.device)


def _broadcast(engine, t: torch.Tensor) -> torch.Tensor:
    """``t`` from rank 0 to every rank of the engine's group (a follower
    passes a :func:`_buffer` to receive into); returns it on the engine's
    device.  NCCL takes contiguous tensors only, and a state's factors on
    the card may be column-major (the Cholesky's layout)."""
    on_host = engine._via_host or engine.device.type == "cpu"
    buf = (t.cpu() if on_host else t.to(engine.device)).contiguous()
    dist.broadcast(buf, src=dist.get_global_rank(engine.group, 0),
                   group=engine.group)
    return buf.to(engine.device)


def _send_header(engine, op: int, rows: int = 0, generation: int = 0):
    _broadcast(engine, torch.tensor([op, rows, generation],
                                    dtype=torch.int64))


def _from_leaves(template, leaves):
    """A state of ``template``'s layout holding ``leaves`` (its
    ``_leaves()`` order)."""
    paths = [p for p, _ in tree_items(template.hyp)]
    k = len(paths)
    return dataclasses.replace(template,
                               hyp=tree_unflatten(paths, leaves[:k]),
                               **dict(zip(_ARRAY_FIELDS, leaves[k:])))


def _bound_device(device):
    """The engine's card as the current device of this thread (it is per
    thread), or nothing on the CPU."""
    return (torch.cuda.device(device) if device.type == "cuda"
            else contextlib.nullcontext())


def serve_follower(engine: PredictEngine | MultiPredictEngine) -> int:
    """The loop of a follower rank (rank > 0) of an engine sharded over a
    process group, in lockstep with rank 0's :class:`Frontend` over the
    same engine: each flush's padded batch goes through ``run_blocks``
    under the state of the flush's generation (its ``all_gather`` hands
    rank 0 every row), each ``swap_state`` replaces the state, and rank
    0's :meth:`Frontend.close` ends the loop.  The engine must start from
    the state rank 0's engine holds when its front-end is built.  Returns
    the number of batches served."""
    if engine.n_shards == 1 or engine.rank == 0:
        raise ValueError(
            "serve_follower runs on the ranks > 0 of an engine sharded "
            "over a process group; rank 0 runs the Frontend")
    # Generation -> compute state: a flush dispatched before a swap may
    # reach the followers after it, under its own generation.
    states = {0: engine.compute_state}
    served = 0
    with _bound_device(rank_device(engine.device)), torch.no_grad():
        while True:
            op, rows, gen = _broadcast(
                engine, _buffer(engine, (3,), torch.int64)).tolist()
            if op == _OP_STOP:
                return served
            if op == _OP_SWAP:
                leaves = [_broadcast(engine, _buffer(engine, t.shape,
                                                     t.dtype))
                          for t in engine.compute_state._leaves()]
                engine.swap_state(_from_leaves(engine.compute_state, leaves))
                states[gen] = engine.compute_state
                continue
            x = _broadcast(engine, _buffer(engine, (rows, engine.state.q),
                                           engine.compute_dtype))
            for g in [g for g in states if g < gen]:
                del states[g]    # flushes come in generation order
            engine.run_blocks(x, states[gen])
            served += 1


class Frontend:
    """Continuous micro-batching front-end over a predict engine.

    Args:
      engine: a :class:`PredictEngine` or :class:`MultiPredictEngine`,
        alone or sharded over a process group; a sharded engine's
        front-end runs on rank 0 and the other ranks run
        :func:`serve_follower` (module docstring).
      max_batch_rows: flush as soon as a batch holds this many rows
        (rounded up to the engine's ``n_shards * block_size``, so a full
        flush needs no pad rows).  A hard cap: a request that would push
        past it heads the next batch; only a single request larger than
        the cap exceeds it, flushing alone on a shape :meth:`warmup` did
        not run.  Default: one padding multiple.
      max_wait_ms: flush no later than this after the oldest queued
        request arrived (0 dispatches every request at once).
      max_queue_rows: admission bound on rows accepted but not yet
        dispatched; beyond it ``submit`` raises :class:`QueueFull`.
      max_batch_requests: optional cap on requests per flush (1 = one
        request a flush, the naive baseline).
      default_deadline_ms: deadline of a ``submit`` that passes none
        (``None``: no deadline).
      metrics / timer: an :class:`SLOMetrics` / :class:`StepTimer` to feed
        (e.g. shared across front-ends); fresh ones by default.
    """

    def __init__(self, engine: PredictEngine | MultiPredictEngine, *,
                 max_batch_rows: int | None = None, max_wait_ms: float = 2.0,
                 max_queue_rows: int = 65536,
                 max_batch_requests: int | None = None,
                 default_deadline_ms: float | None = None,
                 metrics: SLOMetrics | None = None,
                 timer: StepTimer | None = None):
        if engine.n_shards > 1 and engine.rank != 0:
            raise ValueError(
                "the Frontend of an engine sharded over a process group runs "
                f"on rank 0; run serve_follower(engine) on rank {engine.rank}")
        if max_wait_ms < 0:
            raise ValueError(f"max_wait_ms must be >= 0, got {max_wait_ms}")
        if max_queue_rows < 1:
            raise ValueError(
                f"max_queue_rows must be >= 1, got {max_queue_rows}")
        if max_batch_requests is not None and max_batch_requests < 1:
            raise ValueError(
                f"max_batch_requests must be >= 1, got {max_batch_requests}")
        if engine.compute_dtype not in _NUMPY_DTYPES:
            raise ValueError(
                "the front-end answers in numpy, which has no "
                f"{engine.compute_dtype}; build the engine with an f16, f32 "
                "or f64 compute_dtype")
        self.engine = engine
        self._multi = isinstance(engine, MultiPredictEngine)
        self._row_mult = engine.block_size * engine.n_shards
        if max_batch_rows is None:
            max_batch_rows = self._row_mult
        if max_batch_rows < 1:
            raise ValueError(
                f"max_batch_rows must be >= 1, got {max_batch_rows}")
        # Round up to the padding multiple: a "full" batch never pads.
        self.max_batch_rows = (-(-max_batch_rows // self._row_mult)
                               * self._row_mult)
        self.max_wait = max_wait_ms / 1e3
        self.max_queue_rows = max_queue_rows
        self.max_batch_requests = max_batch_requests
        self.default_deadline = (None if default_deadline_ms is None
                                 else default_deadline_ms / 1e3)
        self.metrics = metrics if metrics is not None else SLOMetrics()
        self.timer = timer if timer is not None else StepTimer()
        self._np_dtype = np.dtype(_NUMPY_DTYPES[engine.compute_dtype])
        self._device = rank_device(engine.device)   # with its index
        self._q = engine.state.q
        self._d = engine.state.d
        self._queue: asyncio.Queue = asyncio.Queue()
        self._queued_rows = 0
        self._generation = 0
        # The hot-swap fence: replaced as ONE tuple so a flush that reads it
        # once never pairs an old generation with a new state (or the wrong
        # generation's noise term).
        self._current = (0, engine.compute_state,
                         self._noise_of(engine.compute_state))
        self._task: asyncio.Task | None = None
        self._closed = False
        # A sharded engine: rank 0's messages to the followers, one at a
        # time (a flush and a swap from another thread must not interleave
        # their collectives).
        self._sharded = engine.n_shards > 1
        self._send_lock = threading.Lock()
        self._shut = False

    # -- lifecycle ----------------------------------------------------------
    def start(self) -> "Frontend":
        """Start the dispatch loop on the running event loop (idempotent)."""
        if self._shut:
            raise FrontendError("Frontend is closed")
        if self._task is None:
            self._closed = False
            self._task = asyncio.get_running_loop().create_task(
                self._dispatch_loop(), name="serve-frontend-dispatch")
        return self

    async def stop(self) -> None:
        """Drain (every accepted request is flushed and answered), then stop
        the dispatch loop.  ``start`` may be called again after."""
        if self._task is None:
            return
        self._closed = True          # reject new submits while draining
        self._queue.put_nowait(_CLOSE)
        await self._task
        self._task = None

    def close(self) -> None:
        """Send the followers of a sharded engine the message that ends
        their :func:`serve_follower` loop; call it after :meth:`stop`, once
        serving is over.  Idempotent; nothing to do in a world of one."""
        if self._task is not None:
            raise FrontendError("stop() the Frontend before close()")
        if self._sharded and not self._shut:
            with self._send_lock:
                _send_header(self.engine, _OP_STOP)
        self._shut = True

    async def __aenter__(self) -> "Frontend":
        return self.start()

    async def __aexit__(self, *exc) -> None:
        await self.stop()

    def warmup(self) -> int:
        """Run every padded batch shape the dispatch loop can produce (each
        multiple of the padding multiple up to ``max_batch_rows``) once, so
        no flush pays the kernel library's build or load, or the
        allocator's first blocks of its shape.  Blocking; call before
        taking load.  A sharded engine's followers run every shape too.
        Returns the number of shapes run."""
        gen, cstate, _ = self._current
        n = 0
        for rows in range(self._row_mult, self.max_batch_rows + 1,
                          self._row_mult):
            self._run_batch(gen, cstate,
                            np.zeros((rows, self._q), self._np_dtype))
            n += 1
        return n

    # -- the request path ---------------------------------------------------
    @property
    def generation(self) -> int:
        """The hot-swap fence: bumped by every :meth:`swap_state`."""
        return self._generation

    @property
    def queued_rows(self) -> int:
        """Rows accepted but not yet dispatched (the admission meter)."""
        return self._queued_rows

    def load_summary(self) -> dict:
        """Per-flush engine-time min/mean/max and straggler overhead: the
        ``StepTimer`` summary the training loop reports."""
        return self.timer.summary()

    async def submit(self, x, *, include_noise: bool = False,
                     deadline_ms: float | None = None) -> ServeResult:
        """Enqueue one request of ``(t, q)`` queries (a 1-d ``(q,)`` array
        is one row) and await its :class:`ServeResult`.

        Raises :class:`QueueFull` at once when admission fails and
        :class:`SLOExceeded` when the deadline passes before dispatch.
        """
        if self._task is None or self._closed:
            raise FrontendError(
                "Frontend is not running: use `async with Frontend(...)` "
                "or call start() first" if self._task is None
                else "Frontend is draining: no new requests")
        x = np.asarray(x, self._np_dtype)
        if x.ndim == 1:
            x = x[None, :]
        if x.ndim != 2 or x.shape[1] != self._q:
            raise ValueError(
                f"expected queries of shape (t, {self._q}), got {x.shape}")
        t = x.shape[0]
        if t == 0:
            # An empty request is answered inline: nothing to batch.
            lead = (self.engine.n_models,) if self._multi else ()
            return ServeResult(np.zeros((*lead, 0, self._d), self._np_dtype),
                               np.zeros((*lead, 0), self._np_dtype),
                               self._current[0])
        if self._queued_rows + t > self.max_queue_rows:
            self.metrics.observe_reject_queue_full()
            raise QueueFull(
                f"request of {t} rows rejected: {self._queued_rows} of "
                f"{self.max_queue_rows} queue rows already in use")
        now = time.monotonic()
        dl = (deadline_ms / 1e3 if deadline_ms is not None
              else self.default_deadline)
        req = _Request(x=x, include_noise=include_noise, enqueue=now,
                       deadline=None if dl is None else now + dl,
                       future=asyncio.get_running_loop().create_future())
        self._queued_rows += t
        self.metrics.observe_admit()
        self._queue.put_nowait(req)
        return await req.future

    # -- hot swap -----------------------------------------------------------
    def swap_state(self, state_or_path, slot: int | None = None) -> int:
        """Replace the served state while requests are in flight; returns
        the new generation (the fence value later responses carry).

        ``state_or_path`` is a ``PredictiveState`` or a checkpoint path
        (restored onto the engine's device from its sidecar by
        ``serve.load_state``: a rollout host needs no model code).  ``slot``
        selects one model of a :class:`MultiPredictEngine` fleet
        (``swap_slot``); ``None`` replaces the whole state.  A flush in
        flight completes against the state it was dispatched with.  A
        sharded engine's followers are sent the new compute state's leaves.
        """
        state = state_or_path
        if isinstance(state, (str, pathlib.Path)):
            state, _ = load_state(state, device=self.engine.device)
        if slot is not None and not self._multi:
            raise ValueError(
                "slot= is only meaningful for a MultiPredictEngine fleet")
        if self._shut:
            raise FrontendError("Frontend is closed")
        with self._send_lock:
            if slot is None:
                self.engine.swap_state(state)
            else:
                self.engine.swap_slot(slot, state)
            self._generation += 1
            cstate = self.engine.compute_state
            if self._sharded:
                with _bound_device(self._device):
                    _send_header(self.engine, _OP_SWAP,
                                 generation=self._generation)
                    for leaf in cstate._leaves():
                        _broadcast(self.engine, leaf)
            self._current = (self._generation, cstate,
                             self._noise_of(cstate))
        return self._generation

    # -- the dispatch loop --------------------------------------------------
    async def _dispatch_loop(self) -> None:
        q = self._queue
        draining = False
        held: _Request | None = None     # dequeued but didn't fit last batch
        while True:
            if held is not None:
                req, held = held, None
            elif draining:
                if q.empty():
                    break
                req = q.get_nowait()
            else:
                req = await q.get()
            if req is _CLOSE:
                draining = True
                continue
            batch = [req]
            rows = req.x.shape[0]
            flush_by = req.enqueue + self.max_wait
            while rows < self.max_batch_rows and (
                    self.max_batch_requests is None
                    or len(batch) < self.max_batch_requests):
                if not q.empty():
                    # Greedy drain: whatever is queued already joins this
                    # batch at no extra latency; under backlog the batcher
                    # must not flush singletons because the oldest
                    # request's wait budget is spent.
                    nxt = q.get_nowait()
                elif draining:
                    break
                else:
                    delay = flush_by - time.monotonic()
                    if delay <= 0:
                        break
                    try:
                        nxt = await asyncio.wait_for(q.get(), timeout=delay)
                    except asyncio.TimeoutError:
                        break
                if nxt is _CLOSE:
                    draining = True
                    continue
                if rows + nxt.x.shape[0] > self.max_batch_rows:
                    # It would overshoot the batch bound (a shape warmup
                    # never ran): it heads the next batch instead.
                    held = nxt
                    break
                batch.append(nxt)
                rows += nxt.x.shape[0]
            await self._flush(batch)

    async def _flush(self, batch: list[_Request]) -> None:
        now = time.monotonic()
        live = []
        for r in batch:
            self._queued_rows -= r.x.shape[0]
            if r.future.cancelled():
                self.metrics.observe_cancelled()
                continue
            if r.deadline is not None and now > r.deadline:
                self.metrics.observe_expired()
                r.future.set_exception(SLOExceeded(
                    f"deadline expired {1e3 * (now - r.deadline):.2f} ms "
                    f"before dispatch (waited "
                    f"{1e3 * (now - r.enqueue):.2f} ms in queue)"))
                continue
            live.append(r)
        if not live:
            return                       # a zero-row flush is a no-op
        gen, cstate, noise = self._current   # the hot-swap fence, read ONCE
        for r in live:
            self.metrics.observe_wait(now - r.enqueue)
        xcat = np.concatenate([r.x for r in live], axis=0)
        rows = xcat.shape[0]
        pad_rows = (-rows) % self._row_mult
        t0 = time.perf_counter()
        mean, var = await asyncio.get_running_loop().run_in_executor(
            None, self._run_batch, gen, cstate, xcat)
        engine_s = time.perf_counter() - t0
        self.timer.record([engine_s])
        self.metrics.observe_flush(len(live), rows, pad_rows, engine_s)
        done = time.monotonic()
        lo = 0
        for r in live:
            hi = lo + r.x.shape[0]
            m_i, v_i = mean[..., lo:hi, :], var[..., lo:hi]
            lo = hi
            if r.include_noise:
                v_i = v_i + noise
            if not r.future.cancelled():
                r.future.set_result(ServeResult(m_i, v_i, gen))
            late = r.deadline is not None and done > r.deadline
            self.metrics.observe_complete(done - r.enqueue, late=late)

    def _run_batch(self, gen: int, cstate, xcat: np.ndarray):
        """Worker-thread body against the fenced state snapshot of
        generation ``gen``: pad in numpy, one host-to-device copy,
        ``run_blocks``, one device-to-host copy of the packed (mean, var),
        pad rows sliced off; a sharded engine's followers are sent the
        header and the padded batch first.  Every torch op here hands the
        GIL to the event loop and back, so the op count of this thread is
        latency under load."""
        t = xcat.shape[0]
        pad = (-t) % self._row_mult
        if pad:
            xq = np.zeros((t + pad, xcat.shape[1]), xcat.dtype)
            xq[:t] = xcat
        else:
            xq = xcat
        with _bound_device(self._device), torch.no_grad():
            if self._sharded:
                with self._send_lock:
                    if self._shut:
                        raise FrontendError("Frontend is closed")
                    _send_header(self.engine, _OP_RUN, xq.shape[0], gen)
                    mean, var = self.engine.run_blocks(
                        _broadcast(self.engine, torch.from_numpy(xq)), cstate)
            else:
                mean, var = self.engine.run_blocks(
                    torch.from_numpy(xq).to(self._device), cstate)
            out = torch.cat([mean, var[..., None]], -1).cpu().numpy()
        return out[..., :t, :-1], out[..., :t, -1]

    def _noise_of(self, cstate) -> np.ndarray:
        """1/beta of a state snapshot, computed on the engine's device in
        its compute dtype as the engine's ``include_noise`` computes it, so
        noisy responses stay bitwise too.  Once per generation."""
        nv = torch.exp(-cstate.hyp["log_beta"]).cpu().numpy()
        return nv[..., None] if self._multi else nv
