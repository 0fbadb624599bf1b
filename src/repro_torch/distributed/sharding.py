"""Logical-axis sharding: MaxText-style rules with divisibility fallback.

Port of ``repro.distributed.sharding``.  Every parameter is described with
a tuple of *logical* axis names (``models.common.Leaf.logical``).  The
rules below resolve logical names to the axes of a mesh; an assignment
whose dimension is not divisible by the mesh axis's size falls back to
replication (e.g. kv_heads=2 under model=16).

The mesh is a ``torch.distributed.device_mesh.DeviceMesh`` with named
dimensions (``launch.mesh.make_compat_mesh``), or any object whose
``.shape`` is a dict of axis sizes (what the rules read).  A resolved spec
is the reference's ``PartitionSpec`` as a plain tuple: one entry a tensor
dimension, ``None`` (replicated), an axis name, or a tuple of names (the
first-named axis major), trailing ``None``s trimmed.

Where the port cuts a leaf otherwise than the reference's spec (the
reference leaves the reshuffle to XLA's partitioner; the port says each
collective itself), the leaf's logical axes are a :class:`PortAxes`: its
``port`` axes, an entry of which may be a :class:`Packed` dimension (the
SSD's ``z | x | B | C | dt`` columns, cut head by head), are the only
layout any function here resolves (``spec_for``, ``local_shape``,
``local_shard``, ``shard_ranges``, ``shard_slices``, ``block_axes``,
``param_layout``, ``tree_shardings``).  Its value as a tuple is the
reference's logical axes, so that the spec tree compares equal to the JAX
package's; nothing resolves that tuple into a block.

``set_mesh`` / ``use_mesh`` set the module's mesh context, which the
model code reads: ``distributed.tensor_parallel``'s collectives over its
axes, and each layer's split, taken from the resolved spec of its leaves
(``param_layout``: every leaf's spec and local shape).  ``constrain`` is
the identity: the reference's is a layout hint to XLA's SPMD partitioner
(``with_sharding_constraint``) that changes no value, and the port has no
partitioner: it partitions with explicit collectives.  Its call sites
stay where the reference has them.
"""
from __future__ import annotations

import contextlib
from typing import Any, NamedTuple, Sequence

import torch

# logical axis -> preferred mesh axis (order tried first-to-last)
DEFAULT_RULES: dict[str, tuple[str, ...]] = {
    # tensor-parallel dims
    "vocab": ("model",),
    "mlp": ("model",),
    "heads": ("model",),
    "kv_heads": ("model",),
    "heads_group": ("model",),   # the H/Hkv group dim of unfused GQA scores
    "experts": ("model",),
    "lru": ("model",),
    "inner": ("model",),       # ssm d_inner / conv channels
    # fsdp dims (weight shards over the data axis)
    "embed": ("data",),
    "moe_mlp": ("data",),
    "qk": (), "v": (), "rank": (),   # MLA small dims: replicate
    # never sharded
    "layers": (), "state": (), "conv": (), "pos": (), "frames": (),
    # activations
    "batch": ("pod", "data"),
    "seq": (),
    "seq_model": ("model",),   # Megatron-style sequence parallelism between blocks
    # KV-cache sequence dim: prefer model (batch usually owns data); decode
    # softmax over the sharded S axis costs two small per-layer all-reduces
    # and cuts per-device cache by the TP degree.
    "seq_shard": ("model", "data"),
}

_CTX: dict[str, Any] = {"mesh": None, "rules": dict(DEFAULT_RULES)}


def set_mesh(mesh, rules: dict | None = None):
    _CTX["mesh"] = mesh
    _CTX["rules"] = dict(DEFAULT_RULES) if rules is None else dict(rules)


@contextlib.contextmanager
def use_mesh(mesh, rules: dict | None = None):
    old = dict(_CTX)
    set_mesh(mesh, rules)
    try:
        yield
    finally:
        _CTX.update(old)


def mesh_sizes(mesh) -> dict[str, int]:
    """Axis name -> size: a ``DeviceMesh``'s ``shape`` is a tuple in the
    order of ``mesh_dim_names``; a duck-typed mesh's ``shape`` is the dict."""
    if isinstance(mesh.shape, dict):
        return dict(mesh.shape)
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def _axes_for(logical: str | None, dim_size: int, sizes: dict[str, int],
              rules: dict, used: set[str]) -> tuple[str, ...] | None:
    if logical is None:
        return None
    # "name:quantum" — the dim may only be split in units of ``quantum``
    # (e.g. "heads:128" keeps whole attention heads on one shard).
    name, _, quantum_s = logical.partition(":")
    quantum = int(quantum_s) if quantum_s else 1
    units = dim_size // max(quantum, 1)
    picked = []
    size = 1
    for ax in rules.get(name, ()):
        if ax in used or ax not in sizes:
            continue
        if units % (size * sizes[ax]) == 0:
            picked.append(ax)
            size *= sizes[ax]
    return tuple(picked) or None


def spec_for(logical_axes: Sequence[str | None], shape: Sequence[int],
             mesh=None, rules: dict | None = None) -> tuple:
    """Resolve a logical-axis tuple (a :class:`PortAxes`: its port axes)
    into the entries of a PartitionSpec for ``mesh`` (the context mesh if
    None; ``()`` with no mesh).  A :class:`Packed` dimension's entry names
    the axes its segments are cut over."""
    mesh = _CTX["mesh"] if mesh is None else mesh
    if mesh is None:
        return ()
    entries = [None if not axes else axes if len(axes) > 1 else axes[0]
               for axes in _dim_axes(logical_axes, shape, mesh, rules)]
    while entries and entries[-1] is None:
        entries.pop()
    return tuple(entries)


def axis_divides(logical: str, size: int) -> bool:
    """True iff ``size`` is divisible by the mesh extent mapped to
    ``logical`` (False when no mesh/axis)."""
    mesh = _CTX["mesh"]
    if mesh is None:
        return False
    sizes = mesh_sizes(mesh)
    ext = 1
    for ax in _CTX["rules"].get(logical, ()):
        if ax in sizes:
            ext *= sizes[ax]
    return ext > 1 and size % ext == 0


def constrain(x, logical_axes: Sequence[str | None]):
    """The identity, with or without a mesh.  The reference pins ``x``'s
    layout for XLA's SPMD partitioner (``with_sharding_constraint``), which
    changes no value; the port has no partitioner, and its layers split
    with explicit collectives (``distributed.tensor_parallel``)."""
    del logical_axes
    return x


def _entry_axes(entry) -> tuple[str, ...]:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def spec_axes(spec: tuple) -> set[str]:
    """Every mesh axis a resolved spec names."""
    return {ax for e in spec for ax in _entry_axes(e)}


class Packed(NamedTuple):
    """A dimension of segments side by side, each ``(size, units)``: cut
    over the axes of rule ``name`` into equal parts of every segment with
    ``units`` > 0 (whole heads: ``units`` its heads), a segment of 0 units
    whole on every rank.  Cut only where the axes divide every such
    segment's units; else whole on every rank (the rules' fallback)."""
    name: str
    segments: tuple


class PortAxes(tuple):
    """A leaf's axes where the port cuts it otherwise than the reference:
    ``port``, one entry a dimension (a logical name, None or a
    :class:`Packed`), is what every function here resolves; the tuple's
    value is the reference's logical axes, for comparison with the JAX
    package's spec tree only."""

    def __new__(cls, logical, port):
        self = super().__new__(cls, logical)
        self.port = tuple(port)
        return self

    def __reduce__(self):
        return PortAxes, (tuple(self), self.port)

    def stacked(self) -> "PortAxes":
        """The same axes behind a leading ``layers`` axis."""
        return PortAxes(("layers", *self), ("layers", *self.port))


def _dim_axes(logical, shape, mesh, rules) -> list[tuple[str, ...]]:
    """The mesh axes that cut each dimension of the port's block."""
    sizes = mesh_sizes(mesh)
    rules = _CTX["rules"] if rules is None else rules
    used: set[str] = set()
    out = []
    for entry, dim in zip(getattr(logical, "port", logical), shape):
        if isinstance(entry, Packed):
            units = [u for _, u in entry.segments if u]
            picked, size = [], 1
            for ax in rules.get(entry.name, ()):
                if ax in used or ax not in sizes:
                    continue
                if all(u % (size * sizes[ax]) == 0 for u in units):
                    picked.append(ax)
                    size *= sizes[ax]
            axes = tuple(picked)
        else:
            axes = _axes_for(entry, dim, sizes, rules, used) or ()
        used.update(axes)
        out.append(axes)
    out += [()] * (len(shape) - len(out))
    return out


def shard_ranges(logical, shape: Sequence[int], mesh, coord: dict[str, int],
                 rules: dict | None = None) -> list[list[tuple[int, int]]]:
    """The ``[start, stop)`` ranges of each dimension of a whole tensor of
    ``shape`` that mesh position ``coord`` holds: one range a dimension,
    or one a segment of a :class:`Packed` one."""
    sizes = mesh_sizes(mesh)
    port = getattr(logical, "port", ())
    out = []
    for d, (axes, dim) in enumerate(zip(_dim_axes(logical, shape, mesh,
                                                  rules), shape)):
        parts, idx = 1, 0
        for ax in axes:
            idx = idx * sizes[ax] + coord[ax]
            parts *= sizes[ax]
        entry = port[d] if d < len(port) else None
        if not isinstance(entry, Packed):
            step = dim // parts
            out.append([(idx * step, (idx + 1) * step)])
            continue
        ranges, off = [], 0
        for size, units in entry.segments:
            if units and parts > 1:
                step = size // parts
                ranges.append((off + idx * step, off + (idx + 1) * step))
            else:
                ranges.append((off, off + size))
            off += size
        out.append(ranges)
    return out


def block_axes(logical, shape: Sequence[int], mesh=None,
               rules: dict | None = None) -> set[str]:
    """The mesh axes that cut a leaf's block."""
    mesh = _CTX["mesh"] if mesh is None else mesh
    if mesh is None:
        return set()
    return {ax for axes in _dim_axes(logical, shape, mesh, rules)
            for ax in axes}


def local_shape(logical: Sequence[str | None], shape: Sequence[int],
                mesh=None, rules: dict | None = None) -> tuple[int, ...]:
    """The shape of one rank's block of a whole tensor of ``shape``."""
    mesh = _CTX["mesh"] if mesh is None else mesh
    if mesh is None:
        return tuple(shape)
    coord = {ax: 0 for ax in mesh_sizes(mesh)}
    return tuple(sum(b - a for a, b in rs)
                 for rs in shard_ranges(logical, shape, mesh, coord, rules))


class LeafLayout(NamedTuple):
    spec: tuple                 # the resolved spec of the rank's block
    shape: tuple[int, ...]      # the whole leaf
    local: tuple[int, ...]      # one rank's block
    axes: frozenset             # the mesh axes the block is cut over


def param_layout(cfg, mesh=None, rules: dict | None = None) -> dict:
    """``cfg``'s parameter tree on ``mesh`` (the context mesh if None),
    each leaf its :class:`LeafLayout`."""
    from ..models.common import tree_map
    from ..models.transformer import param_spec

    mesh = _CTX["mesh"] if mesh is None else mesh

    def one(leaf):
        spec = spec_for(leaf.logical, leaf.shape, mesh, rules)
        return LeafLayout(spec, leaf.shape,
                          local_shape(leaf.logical, leaf.shape, mesh, rules),
                          frozenset(spec_axes(spec)))
    return tree_map(one, param_spec(cfg))


def shard_slices(logical: Sequence[str | None], shape: Sequence[int], mesh,
                 coord: dict[str, int], rules: dict | None = None) -> tuple:
    """The slice of each dimension of a whole tensor of ``shape`` that the
    mesh position ``coord`` (axis name -> index) holds under ``logical``:
    the blocks of ``NamedSharding(mesh, spec).devices_indices_map``, the
    first-named axis of a dimension major.  A cut :class:`Packed`
    dimension is no slice (``shard_ranges`` gives its ranges)."""
    out = []
    for d, rs in enumerate(shard_ranges(logical, shape, mesh, coord, rules)):
        if len(rs) > 1:
            raise ValueError(f"dimension {d} of {logical!r} is packed: its "
                             "block is one range a segment (shard_ranges)")
        out.append(slice(*rs[0]))
    return tuple(out)


def mesh_coordinate(mesh) -> dict[str, int]:
    """This process's index along each named axis of ``mesh``."""
    names = getattr(mesh, "mesh_dim_names", None) or tuple(mesh_sizes(mesh))
    return dict(zip(names, mesh.get_coordinate()))


def local_shard(t: torch.Tensor, logical: Sequence[str | None], mesh,
                rules: dict | None = None) -> torch.Tensor:
    """This rank's block of the whole tensor ``t`` under ``logical`` (a
    contiguous copy; ``t`` itself where nothing is sharded): the port's
    ``jax.device_put(t, NamedSharding(mesh, spec))``, a :class:`Packed`
    dimension's segments each cut alike."""
    ranges = shard_ranges(logical, t.shape, mesh, mesh_coordinate(mesh),
                          rules)
    if all(rs == [(0, n)] for rs, n in zip(ranges, t.shape)):
        return t
    for d, rs in enumerate(ranges):
        pieces = [t.narrow(d, a, b - a) for a, b in rs]
        t = pieces[0] if len(pieces) == 1 else torch.cat(pieces, d)
    return t.contiguous()


def _is_spec(x) -> bool:
    return isinstance(x, tuple) and all(isinstance(e, (str, type(None)))
                                        for e in x)


def _tree_map2(fn, spec_tree, shape_tree):
    if _is_spec(spec_tree):
        return fn(spec_tree, shape_tree)
    if isinstance(spec_tree, dict):
        return {k: _tree_map2(fn, v, shape_tree[k])
                for k, v in spec_tree.items()}
    if isinstance(spec_tree, list):
        return [_tree_map2(fn, v, s) for v, s in zip(spec_tree, shape_tree)]
    raise TypeError(f"not a logical-axes tree node: {spec_tree!r}")


def tree_shardings(spec_tree, shape_tree, mesh, rules: dict | None = None):
    """Map a logical-axes tree and a matching tree of tensors (or of
    shapes) to each leaf's DTensor placements on ``mesh``: a list, one
    ``Shard(dim)`` or ``Replicate()`` a mesh dimension.  Where one tensor
    dimension takes two mesh axes, DTensor lays the shards out in the
    mesh's dimension order, JAX in the spec's (first-named major); the
    two agree when the spec names them in mesh order.  ``local_shard``
    follows JAX's.  A cut :class:`Packed` dimension of more than one
    segment has no placement."""
    from torch.distributed.tensor import Replicate, Shard

    names = tuple(mesh_sizes(mesh))

    def one(logical, leaf):
        shape = leaf.shape if hasattr(leaf, "shape") else tuple(leaf)
        spec = spec_for(logical, shape, mesh, rules)
        port = getattr(logical, "port", logical)
        if any(e is not None and isinstance(port[d], Packed)
               and len(port[d].segments) > 1 for d, e in enumerate(spec)):
            raise ValueError(f"{logical!r} has a packed dimension: no "
                             "DTensor placement holds its block")
        dim_of = {ax: d for d, e in enumerate(spec) for ax in _entry_axes(e)}
        return [Shard(dim_of[n]) if n in dim_of else Replicate()
                for n in names]

    return _tree_map2(one, spec_tree, shape_tree)

