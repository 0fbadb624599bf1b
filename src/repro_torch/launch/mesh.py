"""The data-parallel process group: the port's counterpart of
``repro.launch.mesh.make_compat_mesh`` for the distributed engine.

JAX runs one SPMD program over a mesh of devices; the port runs one process
per data shard, joined in a ``torch.distributed`` process group whose ranks
are the shards (``core.distributed.DistributedGP``).  ``launch/train.py``
and the roofline's analytic half are ported beside it; the HLO tools and
the roofline over their artifacts are queued in ROADMAP Queue 1 item 13.
"""
from __future__ import annotations

import datetime
import os

import torch
import torch.distributed as dist

from .._device import rank_device

DEFAULT_TIMEOUT = datetime.timedelta(minutes=5)


def make_data_group(device=None, *, backend: str | None = None, store=None,
                    rank: int | None = None, world_size: int | None = None,
                    timeout: datetime.timedelta = DEFAULT_TIMEOUT):
    """Join the process group whose ranks are the data shards; returns it.

    The group is described by the caller (``store=``, ``rank=``,
    ``world_size=``: e.g. a ``dist.FileStore``), else by a launcher's
    environment (``torchrun``: ``MASTER_ADDR``, ``RANK``, ``WORLD_SIZE``),
    else it is a world of one.  A process that already joined gets the
    group it is in.

    ``device``: this rank's device, resolved as the engine resolves it
    (``None`` = the card, ``cuda:{LOCAL_RANK}``; raises without CUDA).  It
    picks the backend unless ``backend=`` is given: NCCL for CUDA, gloo
    for the CPU.  NCCL refuses two ranks on one card; several ranks on one
    card take ``backend="gloo"``.

    ``timeout``: how long a collective waits for a missing rank before it
    fails the run (the backends' own default is 10 to 30 minutes).
    """
    dev = rank_device(device)
    if dist.is_initialized():
        return dist.group.WORLD
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if store is not None:
        if rank is None or world_size is None:
            raise ValueError("make_data_group: store= needs rank= and "
                             "world_size=")
        dist.init_process_group(backend, store=store, rank=rank,
                                world_size=world_size, timeout=timeout)
    elif "MASTER_ADDR" in os.environ and "WORLD_SIZE" in os.environ:
        dist.init_process_group(backend, init_method="env://",
                                timeout=timeout)
    elif (rank or 0) != 0 or (world_size or 1) != 1:
        raise ValueError("make_data_group: a world of more than one rank "
                         "needs store= or a launcher's environment")
    else:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1, timeout=timeout)
    return dist.group.WORLD


def via_host(group, device) -> bool:
    """Whether a collective over ``group`` must move ``device``'s buffers
    through host copies: gloo cannot reduce or gather CUDA tensors."""
    return (group is not None and torch.device(device).type == "cuda"
            and dist.get_backend(group) == "gloo")
