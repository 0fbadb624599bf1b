"""Host streaming: block sources, shard-major chunking, prefetch and
staging onto the card.  Port of ``repro.data.stream`` (numpy, plus
:func:`stage_to_device` for torch).

* **Block sources**: a random-access protocol (``n``, ``fields``,
  ``read(start, stop)``) over host data that never has to be resident at
  once: in-memory arrays (:class:`ArraySource`), memory-mapped ``.npy`` and
  uncompressed ``.npz`` files (:class:`MemmapSource`, the npz members mapped
  in place through their zip offsets), and deterministic chunk-addressable
  generators (:class:`SyntheticSource`, e.g. ``data.synthetic.flight_like``).
* **Shard-major chunking** (:class:`BlockStream`): fixed-shape padded
  ``(arrays, weights)`` chunks; chunk ``c`` carries scan blocks
  ``[c·bpc, (c+1)·bpc)`` of EVERY shard's contiguous row range, so each
  shard sees its rows in the block partition and order that
  ``core.distributed.pad_and_shard`` and the in-memory fold give it.  That
  is what makes streamed Stats bitwise the in-memory ones.  A rank of a
  process group reads only its own window of a chunk
  (:meth:`BlockStream.shard_chunk`).
* **Prefetch** (:func:`prefetch`): a bounded background thread that
  assembles and stages chunk ``i+1`` while the caller computes on chunk
  ``i``; errors re-raise at the consumer.
* **Staging** (:func:`stage_to_device`): the chunk goes into pinned host
  memory and onto the card by a ``non_blocking`` copy on a side CUDA
  stream; the consumer's stream waits on the copy's event.
"""
from __future__ import annotations

import pathlib
import queue
import threading
import zipfile
from typing import Callable, Iterable, Iterator, NamedTuple

import numpy as np
import torch

from .._device import rank_device

__all__ = [
    "ArraySource", "MemmapSource", "SyntheticSource", "as_source",
    "BlockStream", "prefetch", "stage_to_device", "padded_rows",
    "open_npz_memmaps",
]


# -- block sources -----------------------------------------------------------
#
# A source is anything with:
#   n: int                              total real rows
#   fields: dict[str, tuple]            field name -> trailing shape
#   read(start, stop) -> dict[str, np.ndarray]   rows [start, stop), 0<=start
#                                       <=stop<=n, each (stop-start,)+trailing
#
# ``read`` must be cheap for any window (random access): the SVI chunk
# sampler and the two-pass streamed gradient both re-read arbitrary chunks.


class ArraySource:
    """In-memory dict-of-arrays source — the parity/testing reference, and
    what ``as_source`` wraps a plain dict into."""

    def __init__(self, arrs: dict):
        if not arrs:
            raise ValueError("ArraySource needs at least one field")
        self._arrs = {k: np.asarray(v) for k, v in arrs.items()}
        ns = {a.shape[0] for a in self._arrs.values()}
        if len(ns) != 1:
            raise ValueError(f"fields disagree on leading dim: {ns}")
        self.n = ns.pop()
        self.fields = {k: a.shape[1:] for k, a in self._arrs.items()}

    def read(self, start: int, stop: int) -> dict:
        return {k: a[start:stop] for k, a in self._arrs.items()}


def open_npz_memmaps(path) -> dict:
    """Memory-map every member of an *uncompressed* ``.npz`` in place.

    ``np.savez`` stores members ZIP_STORED (no deflate), so each embedded
    ``.npy`` is a contiguous byte range of the archive: seek past the zip
    local header, parse the npy header, and ``np.memmap`` the payload at
    its absolute offset.  Compressed members (``np.savez_compressed``)
    cannot be mapped — they fall back to a full in-memory load, which
    keeps small files working but forfeits the O(chunk) residency.
    """
    path = pathlib.Path(path)
    out = {}
    with zipfile.ZipFile(path) as zf:
        infos = {i.filename: i for i in zf.infolist()}
        for name, info in infos.items():
            key = name[:-4] if name.endswith(".npy") else name
            if info.compress_type != zipfile.ZIP_STORED:
                out[key] = np.load(path)[key]     # compressed: load fallback
                continue
            with open(path, "rb") as f:
                # Local file header: 30 fixed bytes + name + extra field
                # (the extra field can differ from the central directory's,
                # so it must be read from the local header itself).
                f.seek(info.header_offset + 26)
                name_len = int.from_bytes(f.read(2), "little")
                extra_len = int.from_bytes(f.read(2), "little")
                data_off = info.header_offset + 30 + name_len + extra_len
                f.seek(data_off)
                version = np.lib.format.read_magic(f)
                shape, fortran, dtype = np.lib.format._read_array_header(
                    f, version)
                payload_off = f.tell()
            out[key] = np.memmap(path, dtype=dtype, mode="r", shape=shape,
                                 offset=payload_off,
                                 order="F" if fortran else "C")
    return out


class MemmapSource:
    """Memory-mapped file-backed source: rows live in the page cache, not
    the process heap — reading a window touches O(window) bytes.

    Construct from per-field ``.npy`` paths (``MemmapSource({"y": "y.npy",
    "mu": "x.npy"})``) or a single ``.npz`` via :meth:`from_npz`.
    """

    def __init__(self, paths_or_arrays: dict):
        arrs = {}
        for k, v in paths_or_arrays.items():
            if isinstance(v, (str, pathlib.Path)):
                arrs[k] = np.load(v, mmap_mode="r")
            else:
                arrs[k] = v                     # already array-like / memmap
        self._src = ArraySource(arrs)
        self.n = self._src.n
        self.fields = self._src.fields

    @classmethod
    def from_npz(cls, path) -> "MemmapSource":
        return cls(open_npz_memmaps(path))

    def read(self, start: int, stop: int) -> dict:
        # np.asarray materialises just the window (memmap slices are lazy).
        return {k: np.asarray(v) for k, v in self._src.read(start, stop).items()}


class SyntheticSource:
    """Chunk-addressable generator source: rows are *computed* on demand by
    ``make_chunk(start, stop) -> dict``, deterministically per window, so a
    2M-row dataset occupies O(chunk) host memory (examples/flight_scale.py).

    ``make_chunk`` must be pure in (start, stop): the same window always
    yields the same rows (the SVI sampler and the streamed gradient's
    second pass re-read windows).  ``fields`` is probed with an empty-able
    1-row window unless given explicitly.
    """

    def __init__(self, n: int, make_chunk: Callable[[int, int], dict],
                 fields: dict | None = None):
        if n < 0:
            raise ValueError(f"n must be >= 0, got {n}")
        self.n = n
        self._make = make_chunk
        if fields is None:
            probe = make_chunk(0, min(1, n)) if n else {}
            fields = {k: np.asarray(v).shape[1:] for k, v in probe.items()}
        self.fields = dict(fields)

    def read(self, start: int, stop: int) -> dict:
        out = {k: np.asarray(v) for k, v in self._make(start, stop).items()}
        for k, v in out.items():
            if v.shape[0] != stop - start:
                raise ValueError(
                    f"make_chunk returned {v.shape[0]} rows for field {k!r}, "
                    f"expected {stop - start}")
        return out


def as_source(obj):
    """Coerce to a block source: dict of arrays -> ArraySource; an existing
    source (or BlockStream, unwrapped) passes through."""
    if isinstance(obj, BlockStream):
        return obj.source
    if isinstance(obj, dict):
        return ArraySource(obj)
    if hasattr(obj, "read") and hasattr(obj, "n") and hasattr(obj, "fields"):
        return obj
    raise TypeError(
        f"cannot stream from {type(obj).__name__}: expected a dict of "
        "arrays or an object with (n, fields, read)")


# -- shard-major fixed-shape chunking ---------------------------------------

def padded_rows(n: int, mult: int) -> int:
    """Padded leading dim: the next multiple of ``mult`` >= max(n, 1), the
    single source of the padded n that ``core.distributed.pad_and_shard``
    builds, so a stream's padded layout matches the in-memory one row for
    row.  n = 0 still yields one full multiple (an all-padding block)
    rather than empty arrays."""
    return max(n + (-n) % mult, mult)


class BlockStream:
    """Fixed-shape padded chunks of a source, in shard-major layout.

    The padded row space is the one ``core.distributed.pad_and_shard``
    builds: ``n_pad = padded_rows(n, n_shards·block_size)`` rows, shard k
    owning the contiguous range ``[k·rps, (k+1)·rps)`` (``rps = n_pad /
    n_shards``), real rows first, zero-weight padding at the global tail.
    Chunk ``c`` carries, for EVERY shard, its local blocks ``[c·bpc,
    (c+1)·bpc)``, concatenated shard by shard into one
    ``(n_shards·bpc·block_size, ...)`` host array (:meth:`chunk`); shard
    k's window of it, ``bpc·block_size`` rows from ``k·rps + c·bpc·
    block_size``, is :meth:`shard_chunk`, what a rank reads.

    Each shard sees its in-memory rows in its in-memory block partition and
    order, so folding its windows through ``partial_stats_chunked(init=
    carry)`` reproduces the in-memory fold bitwise: the layout is the parity
    contract.  Assembly is host-side numpy over ``source.read`` windows,
    O(chunk) resident whatever n is.

    Args:
      source: a block source (``as_source`` coercible).
      n_shards: data shards (``DistributedGP.n_shards``).
      block_size: rows per fold block (the engine's ``chunk_size``).
      blocks_per_chunk: blocks per shard per chunk, the host-to-card
        transfer unit; an oversized value clamps to the whole shard.
    """

    def __init__(self, source, n_shards: int = 1, block_size: int = 1024,
                 blocks_per_chunk: int = 1):
        if n_shards < 1 or block_size < 1 or blocks_per_chunk < 1:
            raise ValueError(
                "n_shards, block_size and blocks_per_chunk must be >= 1, "
                f"got {n_shards}, {block_size}, {blocks_per_chunk}")
        self.source = as_source(source)
        self.n_shards = n_shards
        self.block_size = block_size
        self.n = self.source.n
        self.fields = dict(self.source.fields)
        self.n_pad = padded_rows(self.n, n_shards * block_size)
        self.rows_per_shard = self.n_pad // n_shards
        self.blocks_per_shard = self.rows_per_shard // block_size
        # A chunk never overshoots a shard's row range, so every chunk's
        # per-shard blocks are a run of the in-memory fold's.
        blocks_per_chunk = min(blocks_per_chunk, self.blocks_per_shard)
        self.blocks_per_chunk = blocks_per_chunk
        self.n_chunks = -(-self.blocks_per_shard // blocks_per_chunk)
        # Rows per shard per chunk, and per chunk (the tail chunk tops up
        # with zero-weight blocks).
        self.shard_chunk_rows = blocks_per_chunk * block_size
        self.chunk_rows = n_shards * self.shard_chunk_rows
        self._dtypes = None

    def field_dtype(self, k):
        """Host dtype of field ``k`` (probed once from a 0/1-row read)."""
        if self._dtypes is None:
            win = self.source.read(0, 0 if self.n == 0 else 1)
            self._dtypes = {f: np.asarray(win[f]).dtype for f in self.fields}
        return self._dtypes[k]

    def _check(self, c: int):
        if not 0 <= c < max(self.n_chunks, 1):
            raise IndexError(f"chunk {c} out of range ({self.n_chunks})")

    def shard_chunk(self, c: int, shard: int):
        """Shard ``shard``'s window of chunk ``c``: ``(dict of
        (shard_chunk_rows, ...) arrays, weights (shard_chunk_rows,))``,
        weights 1.0 exactly on real rows.  Reads only that window's real
        rows from the source."""
        self._check(c)
        if not 0 <= shard < self.n_shards:
            raise IndexError(f"shard {shard} out of range ({self.n_shards})")
        rows = self.shard_chunk_rows
        lo = shard * self.rows_per_shard + c * rows
        hi = min(lo + rows, (shard + 1) * self.rows_per_shard)
        real = max(0, min(hi, self.n) - lo)   # padding: global tail rows
        w = np.zeros((rows,), np.float64)
        w[:real] = 1.0
        # q(X) variances pad with 1s (log-safe), everything else with 0s:
        # the pad_and_shard convention.
        out = {k: np.full((rows,) + tuple(trail),
                          1.0 if k in ("s", "S") else 0.0,
                          dtype=self.field_dtype(k))
               for k, trail in self.fields.items()}
        if real:
            data = self.source.read(lo, lo + real)
            for k in self.fields:
                out[k][:real] = data[k]
        return out, w

    def chunk(self, c: int):
        """Assemble chunk ``c`` -> ``(dict of (chunk_rows, ...) arrays,
        weights (chunk_rows,))``: every shard's window, shard-major."""
        self._check(c)
        parts = [self.shard_chunk(c, k) for k in range(self.n_shards)]
        return ({k: np.concatenate([p[0][k] for p in parts])
                 for k in self.fields},
                np.concatenate([p[1] for p in parts]))

    def __len__(self) -> int:
        return self.n_chunks

    def __iter__(self) -> Iterator:
        return (self.chunk(c) for c in range(self.n_chunks))

    def chunks(self, indices: Iterable[int] | None = None) -> Iterator:
        """Iterate chunks: all of them, or an explicit index subset (the
        SVI sampler's)."""
        idx = range(self.n_chunks) if indices is None else indices
        return (self.chunk(int(c)) for c in idx)


# -- prefetch and staging ----------------------------------------------------

class _PrefetchDone:
    pass


class _PrefetchError:
    def __init__(self, exc):
        self.exc = exc


def prefetch(it: Iterable, fn: Callable | None = None, depth: int = 2):
    """Map ``fn`` over ``it`` in a background thread, ``depth`` items ahead.

    The returned generator yields ``fn(item)`` in order.  With ``fn`` doing
    host assembly and staging (:func:`stage_to_device`), item ``i+1``'s
    read, pad and copy overlap the caller's work on item ``i``: CUDA
    launches return at once and torch's CPU ops release the GIL.  ``depth``
    bounds how many staged items exist at once (2: double buffering).  An
    exception in the worker re-raises at the consumer's next pull;
    closing the generator (``close``, or garbage collection) stops the
    worker.
    """
    if depth < 1:
        raise ValueError(f"depth must be >= 1, got {depth}")
    q: queue.Queue = queue.Queue(maxsize=depth)
    stop = threading.Event()

    def _put(item) -> bool:
        """Queue ``item`` unless the consumer has gone; False if it has."""
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _worker():
        try:
            for item in it:
                if not _put(item if fn is None else fn(item)):
                    return
            _put(_PrefetchDone())
        except BaseException as e:  # noqa: BLE001 -- relayed to the consumer
            _put(_PrefetchError(e))

    t = threading.Thread(target=_worker, daemon=True,
                         name="repro-torch-stream-prefetch")
    t.start()

    def _gen():
        try:
            while True:
                item = q.get()
                if isinstance(item, _PrefetchDone):
                    return
                if isinstance(item, _PrefetchError):
                    raise item.exc
                yield item
        finally:
            stop.set()

    return _gen()


class Staged(NamedTuple):
    """A chunk staged by :func:`stage_to_device`: its tensors on the
    device, and the event of their copy (None on the CPU)."""

    arrs: dict
    w: torch.Tensor
    event: object


class _Stager:
    """The ``prefetch`` fn of :func:`stage_to_device` (worker side) and its
    :meth:`ready` (consumer side)."""

    def __init__(self, device, buffers: int):
        self.device = rank_device(device)   # with its index, for the worker
        if self.device.type == "cuda":
            self._copies = torch.cuda.Stream(self.device)
        # pinned host buffers, each with the event of its last copy
        self._ring = [None] * buffers
        self._slot = 0

    def __call__(self, chunk) -> Staged:
        arrs, w = chunk
        names = list(arrs)
        host = [np.asarray(arrs[k]) for k in names] + [np.asarray(w)]
        if self.device.type != "cuda":
            event = None
            t = [torch.as_tensor(v).to(self.device, torch.float64)
                 for v in host]
        else:
            # The current device is per thread: bind the engine's, or a
            # rank on cuda:1 would copy to cuda:0.
            with torch.cuda.device(self.device):
                t, event = self._copy(host)
        return Staged(dict(zip(names, t[:-1])), t[-1], event)

    def _copy(self, host: list):
        slot = self._ring[self._slot]
        pinned = None
        if slot is not None:
            slot[1].synchronize()   # its last copy has left the buffer
            if [p.shape for p in slot[0]] == [v.shape for v in host]:
                pinned = slot[0]
        if pinned is None:
            pinned = [torch.empty(v.shape, dtype=torch.float64,
                                  pin_memory=True) for v in host]
        for p, v in zip(pinned, host):
            p.copy_(torch.as_tensor(v))
        with torch.cuda.stream(self._copies):
            out = [p.to(self.device, non_blocking=True) for p in pinned]
            event = torch.cuda.Event()
            event.record(self._copies)
        self._ring[self._slot] = (pinned, event)
        self._slot = (self._slot + 1) % len(self._ring)
        return out, event

    def ready(self, staged: Staged):
        """``(arrays, weights)`` of a staged chunk, usable on the caller's
        current stream: that stream waits on the copy's event, and the
        tensors are recorded on it so the caching allocator does not hand
        their memory out before its work on them is done."""
        if staged.event is not None:
            cur = torch.cuda.current_stream(self.device)
            cur.wait_event(staged.event)
            for t in (*staged.arrs.values(), staged.w):
                t.record_stream(cur)
        return staged.arrs, staged.w


def stage_to_device(device, depth: int = 2) -> _Stager:
    """A ``prefetch`` fn staging ``(arrays, weights)`` chunks on ``device``
    in f64 (the GP math's width); its ``ready(staged)`` gives the consumer
    the tensors.

    On CUDA the worker copies the chunk into pinned host memory and onto
    the card with a ``non_blocking`` copy on a side stream, recording an
    event; ``ready`` makes the consumer's current stream wait on it.
    ``depth + 2`` pinned buffers (the queue's, the consumer's and the
    worker's) rotate, and none is refilled before its copy's event has
    completed.  A failed copy raises at the consumer (through
    :func:`prefetch`): nothing falls back to a synchronous copy or the CPU.
    """
    return _Stager(device, depth + 2)
