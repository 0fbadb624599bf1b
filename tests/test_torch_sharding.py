"""The logical-axis sharding rules (``distributed.sharding``), the mesh
constructors (``launch.mesh``) and the spec trees (``models.transformer.
param_logical_axes``, ``train.steps``) against the JAX package's.

``spec_for`` is held against the reference's on every case of
``tests/test_sharding_rules.py`` and a few more, on the same duck-typed
meshes; the parameter, state, cache and batch spec trees against the
reference's for each of the ten configs, full and reduced (shapes only:
the reference's spec tree comes out of an abstract ``init_params``, its
batches out of ``input_specs``); ``local_shard``'s blocks against
``NamedSharding(mesh, spec).devices_indices_map`` on a (2, 4) and a
(2, 2, 2) mesh of 8 placeholder devices, in one subprocess, among them a
dimension split over ("model", "data") (the first-named axis major, where
DTensor would order them by mesh dimension).
"""
import os
import pathlib
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.configs import SHAPES, all_configs
from repro.distributed import sharding as j_sh
from repro.models import transformer as j_tf
from repro.train import steps as j_steps
from repro_torch.configs import get_config
from repro_torch.distributed import sharding as sh
from repro_torch.models import transformer as tf
from repro_torch.train import steps

ROOT = pathlib.Path(__file__).resolve().parents[1]
NAMES = sorted(all_configs())


class FakeMesh:
    """Duck-typed mesh: the rules only read .shape (a dict)."""

    def __init__(self, **shape):
        self.shape = shape


MESH = FakeMesh(data=16, model=16)
POD = FakeMesh(pod=2, data=16, model=16)
SMALL = FakeMesh(data=2, model=4)

# (logical, shape, mesh, the entries tests/test_sharding_rules.py expects
# or None where that file has no such case)
RULE_CASES = [
    (("embed", "mlp"), (1536, 8960), MESH, ("data", "model")),
    (("embed", "heads:128"), (1536, 1536), MESH, ("data",)),
    (("embed", "heads:128"), (4096, 4096), MESH, ("data", "model")),
    (("batch", None), (256, 4096), POD, (("pod", "data"),)),
    (("batch", None), (1, 4096), POD, ()),
    (("mlp", "heads:64"), (1536 * 16, 64 * 16), MESH, ("model",)),
    (("batch", "seq_shard", "kv_heads", None), (128, 32768, 2, 128), MESH,
     ("data", "model")),
    (("batch", "seq_shard", "kv_heads", None), (1, 2048, 1, 256), MESH,
     (None, ("model", "data"))),
    (("kv_heads:128",), (4096,), MESH, ("model",)),
    (("kv_heads:128",), (256,), MESH, ()),
    (("layers", "experts", "moe_mlp", None), (4, 128, 4096, 1536), MESH,
     None),
    (("vocab", "embed"), (151936, 4096), SMALL, None),
    (("batch", "seq_model", None), (8, 2048, 4096), SMALL, None),
    (("unknown", None, "lru"), (3, 5, 7), POD, None),
]


@pytest.mark.parametrize("case", range(len(RULE_CASES)))
def test_spec_for_matches_the_reference(case):
    logical, shape, mesh, expect = RULE_CASES[case]
    want = tuple(j_sh.spec_for(logical, shape, mesh, j_sh.DEFAULT_RULES))
    got = sh.spec_for(logical, shape, mesh, sh.DEFAULT_RULES)
    assert got == want
    if expect is not None:
        assert got == expect


def test_rules_and_context_mirror_the_reference():
    assert sh.DEFAULT_RULES == j_sh.DEFAULT_RULES
    assert sh.spec_for(("embed",), (4096,)) == ()   # no mesh: replicated
    with sh.use_mesh(SMALL):
        assert sh.spec_for(("embed", "mlp"), (64, 128)) == ("data", "model")
        assert sh.axis_divides("heads", 8) and not sh.axis_divides("heads", 6)
        assert not sh.axis_divides("layers", 8)
        with sh.use_mesh(MESH, rules={"embed": ("model",)}):
            assert sh.spec_for(("embed", "mlp"), (64, 128)) == ("model",)
        assert sh._CTX["mesh"] is SMALL
    assert sh._CTX["mesh"] is None and not sh.axis_divides("heads", 8)


def test_constrain_is_the_identity():
    x = torch.ones((4, 4))
    sh.set_mesh(None)
    assert sh.constrain(x, ("batch", None)) is x
    with sh.use_mesh(SMALL):
        assert sh.constrain(x, ("batch", None)) is x


def _norm(tree):
    """A JAX spec tree with tuples of entries at the leaves."""
    if isinstance(tree, dict):
        return {k: _norm(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_norm(v) for v in tree]
    return tuple(tree)


def _j_param_specs(cfg):
    """The reference's spec tree, from an abstract ``init_params`` (its
    ``steps._specs_only`` caches by config name, which reduced configs
    share)."""
    holder = {}

    def init():
        params, holder["specs"] = j_tf.init_params(cfg, jax.random.PRNGKey(0))
        return params
    jax.eval_shape(init)
    return _norm(holder["specs"])


@pytest.mark.parametrize("reduced", [False, True], ids=["full", "reduced"])
@pytest.mark.parametrize("name", NAMES)
def test_param_and_state_specs_match_the_reference(name, reduced):
    jc, pc = all_configs()[name], get_config(name)
    if reduced:
        jc, pc = jc.reduced(), pc.reduced()
    want = _j_param_specs(jc)
    assert tf.param_logical_axes(pc) == want
    state, specs = steps.abstract_state(pc)
    assert specs == {"params": want, "opt": {"m": want, "v": want,
                                             "step": ()}}
    # every leaf's logical tuple is rank-matched to its (meta) tensor
    flat = [(t.shape, s) for t, s in zip(
        _leaves(state["params"]), _leaves(specs["params"], spec=True))]
    assert all(len(shape) == len(s) for shape, s in flat)
    assert all(t.device.type == "meta" for t in _leaves(state))


def _leaves(tree, spec=False):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v, spec)]
    if isinstance(tree, list):
        return [x for v in tree for x in _leaves(v, spec)]
    return [tree]


@pytest.mark.parametrize("name", NAMES)
def test_batch_and_cache_specs_match_the_reference(name):
    for reduced in (False, True):
        jc, pc = all_configs()[name], get_config(name)
        if reduced:
            jc, pc = jc.reduced(), pc.reduced()
        for shape in SHAPES.values():
            j_in = j_steps.input_specs(jc, shape)
            p_in = steps.input_specs(pc, shape)
            assert _norm(j_steps.batch_specs(jc, j_in)) == \
                steps.batch_specs(pc, p_in)
            assert jax.tree.map(lambda a: (tuple(a.shape), str(a.dtype)),
                                j_in) == _shapes(p_in)
            if shape.kind == "decode":
                assert _norm(j_steps.cache_specs(jc, j_in["caches"])) == \
                    steps.cache_specs(pc, p_in["caches"])


def _shapes(tree):
    if isinstance(tree, dict):
        return {k: _shapes(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_shapes(v) for v in tree]
    return (tuple(tree.shape), str(tree.dtype).removeprefix("torch."))


# -- local_shard against devices_indices_map --------------------------------------

SHARD_MESHES = {"2x4": ((2, 4), ("data", "model")),
                "2x2x2": ((2, 2, 2), ("pod", "data", "model"))}
SHARD_CASES = [
    (("batch", "seq_shard", "kv_heads", None), (1, 2048, 1, 256)),
    (("batch", "seq_shard", "kv_heads", None), (8, 2048, 4, 16)),
    (("batch", None), (16, 8)),
    (("embed", "mlp"), (64, 128)),
    (("layers", "experts", "moe_mlp", None), (2, 8, 16, 4)),
    (("vocab", "embed"), (512, 64)),
    (("embed", "heads:16"), (64, 48)),
]

_JAX_WORKER = """
import sys
import numpy as np
sys.path.insert(0, {tests!r})
import test_torch_sharding as t
from jax.sharding import NamedSharding
from repro.distributed import sharding as j_sh
from repro.launch.mesh import make_compat_mesh

out = {{}}
for tag, (shape, names) in t.SHARD_MESHES.items():
    mesh = make_compat_mesh(shape, names)
    pos = {{d: idx for idx, d in np.ndenumerate(mesh.devices)}}
    for c, (logical, dims) in enumerate(t.SHARD_CASES):
        spec = j_sh.spec_for(logical, dims, mesh, j_sh.DEFAULT_RULES)
        for dev, index in NamedSharding(mesh, spec).devices_indices_map(
                dims).items():
            key = tag + "/" + str(c) + "/" + ",".join(map(str, pos[dev]))
            out[key] = np.asarray([s.indices(n)[:2]
                                   for s, n in zip(index, dims)])
np.savez({out!r}, **out)
print("JAX-REF-OK")
"""


@pytest.fixture(scope="module")
def jax_blocks(tmp_path_factory):
    out = tmp_path_factory.mktemp("jax_blocks") / "blocks.npz"
    env = {**os.environ,
           "XLA_FLAGS": "--xla_force_host_platform_device_count=8",
           "PYTHONPATH": os.pathsep.join([str(ROOT / "src"),
                                          os.environ.get("PYTHONPATH", "")])}
    code = _JAX_WORKER.format(tests=str(ROOT / "tests"), out=str(out))
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0 and "JAX-REF-OK" in res.stdout, \
        res.stdout + res.stderr
    return dict(np.load(out))


class _PositionedMesh(FakeMesh):
    """A duck-typed mesh seen from one position (``get_coordinate``)."""

    def __init__(self, coord, **shape):
        super().__init__(**shape)
        self._coord = coord

    def get_coordinate(self):
        return self._coord


@pytest.mark.parametrize("mesh_tag", SHARD_MESHES)
@pytest.mark.parametrize("case", range(len(SHARD_CASES)))
def test_local_shard_is_the_named_shardings_block(jax_blocks, mesh_tag, case):
    shape, names = SHARD_MESHES[mesh_tag]
    logical, dims = SHARD_CASES[case]
    t = torch.arange(int(np.prod(dims))).reshape(dims)
    for coord in np.ndindex(*shape):
        mesh = _PositionedMesh(coord, **dict(zip(names, shape)))
        want = jax_blocks[f"{mesh_tag}/{case}/{','.join(map(str, coord))}"]
        sl = sh.shard_slices(logical, dims, mesh, dict(zip(names, coord)))
        assert [[s.start, s.stop] for s in sl] == want.tolist()
        block = sh.local_shard(t, logical, mesh)
        assert torch.equal(block, t[tuple(slice(a, b) for a, b in want)])


def test_a_dimension_over_model_then_data_is_model_major():
    """P(None, ("model", "data")): JAX's block index is model * data_size +
    data, DTensor's placements name the dimension on both mesh axes."""
    from torch.distributed.tensor import Replicate, Shard

    logical, dims = SHARD_CASES[0]
    mesh = _PositionedMesh((1, 2), data=2, model=4)
    sl = sh.shard_slices(logical, dims, mesh, {"data": 1, "model": 2})
    assert sl[1] == slice((2 * 2 + 1) * 256, (2 * 2 + 2) * 256)
    specs = {"k": logical, "e": ("experts", None), "n": (None,)}
    tensors = {"k": torch.empty(dims, device="meta"),
               "e": torch.empty((8, 3), device="meta"), "n": (5,)}
    assert sh.tree_shardings(specs, tensors, mesh) == {
        "k": [Shard(1), Shard(1)], "e": [Replicate(), Shard(0)],
        "n": [Replicate(), Replicate()]}


def test_make_compat_mesh_in_a_world_of_one():
    from repro_torch.launch import mesh as mesh_mod

    assert not dist.is_initialized()
    try:
        mesh = mesh_mod.make_compat_mesh((1, 1), ("data", "model"), "cpu")
        assert sh.mesh_sizes(mesh) == {"data": 1, "model": 1}
        assert sh.mesh_coordinate(mesh) == {"data": 0, "model": 0}
        assert mesh_mod.gp_data_axes(mesh) == ("data", "model")
        with pytest.raises(ValueError, match="needs 4 ranks"):
            mesh_mod.make_compat_mesh((2, 2), ("data", "model"), "cpu")
        with pytest.raises(ValueError, match="differ in length"):
            mesh_mod.make_compat_mesh((1,), ("data", "model"), "cpu")
        with pytest.raises(ValueError, match="needs 256 ranks"):
            mesh_mod.make_production_mesh(device="cpu")
    finally:
        dist.destroy_process_group()
