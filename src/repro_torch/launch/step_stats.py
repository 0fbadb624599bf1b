"""One step's per-rank FLOPs, bytes, collectives and memory, counted on
fake tensors: the port's counterpart of ``repro.launch.hlo_stats`` and
``repro.launch.hlo_analyzer``.

The reference lowers and compiles a step at the production mesh and reads
XLA's cost and memory analyses and the collectives of the optimised HLO;
a ``lax.scan`` is one HLO while body there, which the analyzer weights by
its trip count.  The port has no compiler to ask.  It runs the step
itself, eagerly, on fake tensors (``FakeTensorMode``: shapes and dtypes,
no data) as rank 0 of a fake world (``launch.mesh.make_fake_mesh``), and
counts what it dispatches:

* FLOPs: ``torch.utils.flop_counter.FlopCounterMode`` (the products, the
  flash operator through its formula);
* bytes: each dispatched op's tensor inputs read once and its outputs
  written once, views, allocations and collectives left out.  The ops run
  unfused, so this bounds from above what fused kernels would move;
* collectives by kind, calls and bytes:
  ``distributed.tensor_parallel.COUNTS``;
* argument bytes: the rank's blocks of the state and its batch;
* the peak of everything else: ``MemTracker``'s peak less the arguments.

Python loops (over layers, query chunks, experts) run for real, so every
trip is counted: the trip-count weighting that the HLO analyzer needed
does not arise.  A step of a few thousand dispatched ops takes seconds.
"""
from __future__ import annotations

import time

import torch
from torch.distributed._tools.mem_tracker import MemTracker
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import FlopCounterMode

from ..distributed import tensor_parallel as tp

_SKIP_NAMESPACES = {"c10d", "_c10d_functional"}


def nbytes(tree) -> int:
    """Bytes of every tensor in a nested structure."""
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree)
               if isinstance(t, torch.Tensor))


def _moves_data(func) -> bool:
    """Not a view (a return aliasing an input without writing it), an
    allocation, or a collective (counted on its own)."""
    if func.namespace in _SKIP_NAMESPACES:
        return False
    if func.__name__.split(".")[0] in ("empty", "empty_like", "new_empty",
                                       "empty_strided", "new_empty_strided"):
        return False
    return not any(r.alias_info is not None and not r.alias_info.is_write
                   for r in func._schema.returns)


class ByteCounter(TorchDispatchMode):
    """Bytes read and written by the ops dispatched under it."""

    def __init__(self):
        super().__init__()
        self.read = self.written = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if _moves_data(func):
            self.read += nbytes((args, kwargs))
            self.written += nbytes(out)
        return out


def step_stats(fn, arguments) -> dict:
    """Run ``fn()`` once and count it (module doc).  ``arguments``: the
    tensors it reads that exist before it runs (state and batch), as a
    dict of named trees."""
    args = tree_leaves(arguments)
    tp.reset_counts()
    flops, moved, mem = FlopCounterMode(display=False), ByteCounter(), \
        MemTracker()
    mem.track_external(*[a for a in args if isinstance(a, torch.Tensor)])
    t0 = time.perf_counter()
    with mem, flops, moved:
        fn()
    took = time.perf_counter() - t0
    arg_bytes = {k: nbytes(v) for k, v in arguments.items()}
    total_arg = sum(arg_bytes.values())
    peak = sum(d["Total"] for d in mem.get_tracker_snapshot("peak").values())
    return {"trace_s": took, "flops": float(flops.get_total_flops()),
            "bytes": {"read": moved.read, "written": moved.written,
                      "total": moved.read + moved.written},
            "collectives": tp.counts(),
            "memory": {**{f"{k}_bytes": v for k, v in arg_bytes.items()},
                       "argument_bytes": total_arg, "peak_bytes": peak,
                       "temp_bytes": max(peak - total_arg, 0)}}
