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

An engine sharded over a process group of more than one rank cannot be
driven by one front-end (every rank must make the same calls with the same
batches): ROADMAP Queue 1 item 15.  All request-path methods (``submit``,
``start``, ``stop``) belong to one event loop; ``swap_state`` may be called
from any thread.
"""
from __future__ import annotations

import asyncio
import contextlib
import pathlib
import time
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from .._device import rank_device
from ..distributed.fault import StepTimer
from .engine import MultiPredictEngine, PredictEngine
from .posterior import load_state
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


class Frontend:
    """Continuous micro-batching front-end over a predict engine.

    Args:
      engine: a :class:`PredictEngine` or :class:`MultiPredictEngine`
        (alone, or in a process group of one rank).
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
        if engine.n_shards > 1:
            raise NotImplementedError(
                "a Frontend over an engine sharded across "
                f"{engine.n_shards} ranks is not ported yet (ROADMAP Queue 1 "
                "item 15): every rank must make the same calls with the "
                "same batches, so rank 0's front-end would have to "
                "broadcast each flush to the others")
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

    # -- lifecycle ----------------------------------------------------------
    def start(self) -> "Frontend":
        """Start the dispatch loop on the running event loop (idempotent)."""
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

    async def __aenter__(self) -> "Frontend":
        return self.start()

    async def __aexit__(self, *exc) -> None:
        await self.stop()

    def warmup(self) -> int:
        """Run every padded batch shape the dispatch loop can produce (each
        multiple of the padding multiple up to ``max_batch_rows``) once, so
        no flush pays the kernel library's build or load, or the
        allocator's first blocks of its shape.  Blocking; call before
        taking load.  Returns the number of shapes run."""
        cstate = self._current[1]
        n = 0
        for rows in range(self._row_mult, self.max_batch_rows + 1,
                          self._row_mult):
            self._run_batch(cstate, np.zeros((rows, self._q), self._np_dtype))
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
        flight completes against the state it was dispatched with.
        """
        state = state_or_path
        if isinstance(state, (str, pathlib.Path)):
            state, _ = load_state(state, device=self.engine.device)
        if slot is None:
            self.engine.swap_state(state)
        else:
            if not self._multi:
                raise ValueError(
                    "slot= is only meaningful for a MultiPredictEngine fleet")
            self.engine.swap_slot(slot, state)
        self._generation += 1
        cstate = self.engine.compute_state
        self._current = (self._generation, cstate, self._noise_of(cstate))
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
            None, self._run_batch, cstate, xcat)
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

    def _run_batch(self, cstate, xcat: np.ndarray):
        """Worker-thread body against the fenced state snapshot: pad in
        numpy, one host-to-device copy, ``run_blocks``, one device-to-host
        copy of the packed (mean, var), pad rows sliced off.  Every torch
        op here hands the GIL to the event loop and back, so the op count
        of this thread is latency under load."""
        t = xcat.shape[0]
        pad = (-t) % self._row_mult
        if pad:
            xq = np.zeros((t + pad, xcat.shape[1]), xcat.dtype)
            xq[:t] = xcat
        else:
            xq = xcat
        with (torch.cuda.device(self._device)
              if self._device.type == "cuda" else contextlib.nullcontext()):
            with torch.no_grad():
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
