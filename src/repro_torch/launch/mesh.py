"""Process groups and device meshes: the port's counterpart of
``repro.launch.mesh``.

JAX runs one SPMD program over a mesh of devices; the port runs one process
a rank, joined in a ``torch.distributed`` process group.  The distributed
GP engine (``core.distributed.DistributedGP``) takes the flat group of data
shards (``make_data_group``).  The LM substrate takes a named
``DeviceMesh`` over the same world (``make_compat_mesh``), whose ``model``
axis carries the tensor-parallel layers and the expert-parallel MoE
(``distributed.tensor_parallel``, ``models.moe.moe_sharded``) and whose
axes the logical-axis rules read (``distributed.sharding``).
``make_production_mesh`` / ``make_gp_mesh`` / ``gp_data_axes`` mirror the
reference's 256- and 512-chip layouts; they are built under a launcher
with that world, or in one process on a fake world (``make_fake_mesh``),
where the dry run (``launch.dryrun``) acts as rank 0 of 256 or 512.
"""
from __future__ import annotations

import datetime
import math
import os
from typing import Sequence

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


def make_compat_mesh(shape: Sequence[int], axis_names: Sequence[str],
                     device=None, **group_kw):
    """A ``DeviceMesh`` of ``shape`` with dimensions named ``axis_names``
    over the world of ``make_data_group(device, **group_kw)`` (the same
    ``backend=``, ``store=``, ``rank=``, ``world_size=`` and ``timeout=``),
    rank r at the row-major position r, the last axis fastest.  Raises
    ``ValueError`` unless prod(shape) is the world size."""
    from torch.distributed.device_mesh import init_device_mesh

    shape, axis_names = tuple(shape), tuple(axis_names)
    if len(shape) != len(axis_names):
        raise ValueError(f"make_compat_mesh: shape {shape} and axis names "
                         f"{axis_names} differ in length")
    dev = rank_device(device)
    group = make_data_group(dev, **group_kw)
    world = dist.get_world_size(group)
    if math.prod(shape) != world:
        raise ValueError(f"make_compat_mesh: a mesh of shape {shape} needs "
                         f"{math.prod(shape)} ranks, the world has {world}")
    return init_device_mesh(dev.type, shape, mesh_dim_names=axis_names)


PRODUCTION = {False: ((16, 16), ("data", "model")),
              True: ((2, 16, 16), ("pod", "data", "model"))}


def make_production_mesh(*, multi_pod: bool = False, device=None,
                         **group_kw):
    shape, axes = PRODUCTION[multi_pod]
    return make_compat_mesh(shape, axes, device, **group_kw)


def make_fake_mesh(shape: Sequence[int], axis_names: Sequence[str],
                   device_type: str = "cpu"):
    """A ``DeviceMesh`` of ``shape`` over a fake world of prod(shape)
    ranks in which this process is rank 0: ``torch.distributed``'s
    ``"fake"`` backend, whose collectives return at once and move nothing
    (with fake tensors they give the right shapes).  A process group
    already joined is left first (``dist.destroy_process_group``), so one
    process can build the meshes one after another.  For shapes, FLOPs,
    bytes and collectives, never for values."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=math.prod(shape))
    return init_device_mesh(device_type, tuple(shape),
                            mesh_dim_names=tuple(axis_names))


def make_gp_mesh(*, multi_pod: bool = False, device=None, **group_kw):
    """The GP map-reduce uses every rank as a data shard (the paper's 1-D
    decomposition); same fleet, flat data axis factored per pod."""
    return make_production_mesh(multi_pod=multi_pod, device=device,
                                **group_kw)


def gp_data_axes(mesh) -> tuple[str, ...]:
    """GP shards n over ALL mesh axes (512-way at multi-pod)."""
    return tuple(mesh.mesh_dim_names)
