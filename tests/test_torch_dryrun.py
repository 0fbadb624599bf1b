"""The dry run (``launch.dryrun``, ``launch.step_stats``) and its roofline
(``launch.roofline``, ``launch.report``), on the CPU with no card.

Three small cells of ``reduced()`` llama3.2-1b (8 heads, kv 4: every
layer split) run twice on the mesh (2, 2) of ("data", "model"): for real
on 4 gloo ranks spawned once, and counted by ``dryrun.run_cell`` on fake
tensors as rank 0 of a fake world of 4 (``make_fake_mesh``) in one
spawned process.  The dry run's collectives (calls and bytes of each
kind) equal those ``tensor_parallel.COUNTS`` recorded on the real ranks,
its argument bytes the real ranks' blocks of the state and batch (their
``local_shard`` sizes), and its FLOPs lie within [0.9, 1.3] of
``roofline.model_flops`` (for the prefill, less the unembedding of the
positions before the last, which prefill does not compute and the model
count includes).  In the same process the production cell llama3.2-1b
``decode_32k`` runs on the fake (16, 16) mesh through the command line,
writes its JSON, and the roofline renders it.

The GP cells (``dryrun.gp_cell``) likewise: an sgpr-synth-1m-shaped and
a gplvm-usps-shaped config (their d and q, n and m cut so the real ranks
run the plain versions in seconds), one value and gradient of the
negative bound in f32 on the same 4 real ranks (``DistributedGP`` over
the world, ``torch.distributed.all_reduce`` counted) and on the fake
world of 4 (every axis a data shard; the engine's own all_reduce, which
records in ``COUNTS``): the collectives equal to the byte,
the argument bytes the ranks' shards, the FLOPs (the kernels' operators,
forward and backward, by their formulas; plain versions as they run) within
``GP_FLOP_BAND`` of ``roofline.gp_model_flops``.  The production cell
gplvm-oilflow ``naive`` runs on the fake (16, 16) mesh through ``--gp``,
and ``report`` reads its record.
"""
import dataclasses
import datetime
import json
import pathlib

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.configs import ShapeSpec, get_config
from repro_torch.launch import report, roofline
from test_torch_spawn import spawn_ranks

W = 4
MESH = (2, 2)
SHAPES = {"train": ShapeSpec("tiny_train", 16, 4, "train"),
          "prefill": ShapeSpec("tiny_prefill", 16, 4, "prefill"),
          "decode": ShapeSpec("tiny_decode", 16, 4, "decode")}
FLOP_RANGE = (0.9, 1.3)
# GP cells: the counted FLOPs over the paper's 3 n m^2 (2q + 4) per rank,
# within 30 % of each cell's ratio on the CPU's fake world of 4 (0.09349 and
# 2.260).  The regression's kernels count by their operators' formulas:
# K^T W K's upper half (n m^2) and the backward kernel's K S (2 n m^2),
# 3 n m^2, are 1 / (2q + 4) = 0.05 of the paper's count at q 8 (the
# kernels' exponents and the bound's m^3 terms the rest at m 64); the
# GPLVM's ``mxu`` psi2 forms each row's (m, m, q) product in full, forward
# and backward.
GP_FLOP_BAND = {"sgpr-synth-1m": (0.06545, 0.1215),
                "gplvm-usps": (1.582, 2.938)}
GP_CELLS = {"sgpr-synth-1m": dict(n=4096, m=64),
            "gplvm-usps": dict(n=1000, m=32)}
GP_VARIANT = {"sgpr-synth-1m": "naive", "gplvm-usps": "mxu"}


def cfg():
    return dataclasses.replace(get_config("llama3.2-1b").reduced(),
                               num_heads=8, num_kv_heads=4)


def gp_cfg(name):
    from repro_torch.configs import GP_CONFIGS
    return dataclasses.replace(GP_CONFIGS[name], **GP_CELLS[name])


def _gp_real(rank, world, out):
    """Each GP cell's value and gradient on this rank's rows (f32, the
    plain versions), its all_reduces counted."""
    from repro_torch.launch import dryrun

    calls = []
    real = dist.all_reduce

    def counting(t, *a, **kw):
        calls.append(t.numel() * t.element_size())
        return real(t, *a, **kw)
    dist.all_reduce = counting
    try:
        for name in GP_CELLS:
            gp = gp_cfg(name)
            n_loc = -(-gp.n // world)
            rng = np.random.default_rng(rank)
            f32 = torch.float32

            def rows(*shape):
                return torch.from_numpy(rng.standard_normal(shape)).to(f32)
            hyp = {"log_sf2": torch.zeros((), dtype=f32),
                   "log_ell": torch.zeros((gp.q,), dtype=f32),
                   "log_beta": torch.zeros((), dtype=f32)}
            z = torch.from_numpy(np.random.default_rng(9).standard_normal(
                (gp.m, gp.q))).to(f32)
            mu, y = rows(n_loc, gp.q), rows(n_loc, gp.d)
            s = 0.1 + rows(n_loc, gp.q).abs() if gp.latent else None
            w = torch.ones((n_loc,), dtype=f32)
            eng = dryrun.DistributedGP(group=dist.group.WORLD,
                                       latent=gp.latent, device="cpu",
                                       psi2_fn=dryrun.gp_psi2_fn(
                                           GP_VARIANT[name]))
            step = eng.make_value_and_grad(
                gp.d, argnums=(0, 1, 2, 3) if gp.latent else (0, 1))
            calls.clear()
            value, _ = step(hyp, z, mu, s, y, w,
                            np.ones((world,), np.float32), float(gp.n))
            out[f"gp/{name}/all_reduce"] = np.asarray(calls)
            out[f"gp/{name}/finite"] = np.asarray(bool(torch.isfinite(value)))
            out[f"gp/{name}/argument_bytes"] = _bytes(
                [hyp, z, mu, y, w] + ([s] if gp.latent else [])) \
                + 4 * world
    finally:
        dist.all_reduce = real


def _bytes(tree) -> int:
    from torch.utils._pytree import tree_leaves
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree))


def _real_rank(rank, world, store_path, out_dir):
    """One cell of each kind on the rank's blocks, its collectives
    counted."""
    torch.set_num_threads(1)
    from repro_torch.distributed import sharding
    from repro_torch.distributed import tensor_parallel as tp
    from repro_torch.launch import make_compat_mesh
    from repro_torch.models import transformer as tf
    from repro_torch.optim import adam
    from repro_torch.train import steps

    mesh = make_compat_mesh(MESH, ("data", "model"), "cpu",
                            store=dist.FileStore(store_path, world),
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=60))
    c = cfg()
    params = steps.init_params_sharded(c, torch.Generator().manual_seed(0),
                                       mesh, device="cpu")
    rng = np.random.default_rng(0)
    out = {}
    with sharding.use_mesh(mesh):
        for kind, shape in SHAPES.items():
            b, t = shape.global_batch, shape.seq_len
            batch = steps.local_batch({
                "tokens": torch.from_numpy(rng.integers(
                    0, c.vocab_size, (b, t), dtype=np.int32)),
                "labels": torch.from_numpy(rng.integers(
                    0, c.vocab_size, (b, t), dtype=np.int32))})
            if kind == "train":
                state = {"params": params, "opt": adam.init_opt_state(params)}
                args = {"state": state, "batch": batch}
                step = steps.make_train_step(c)
                fn = lambda: step(state, batch)   # noqa: E731
            elif kind == "prefill":
                del batch["labels"]
                args = {"state": params, "batch": batch}
                step = steps.make_prefill_step(c)
                fn = lambda: step(params, batch)   # noqa: E731
            else:
                bl = batch["tokens"].shape[0]
                dec = {"tokens_t": batch["tokens"][:, :1].contiguous(),
                       "pos": torch.full((bl,), t - 1, dtype=torch.int32),
                       "caches": tf.init_decode_cache(c, bl, t,
                                                      device="cpu")}
                args = {"state": params, "batch": dec}
                step = steps.make_serve_step(c)
                fn = lambda: step(params, dec["caches"],   # noqa: E731
                                  dec["tokens_t"], dec["pos"])
            out[f"{kind}/argument_bytes"] = sum(_bytes(v)
                                                for v in args.values())
            tp.reset_counts()
            fn()
            out[f"{kind}/collectives"] = json.dumps(tp.counts())
    _gp_real(rank, world, out)
    np.savez(pathlib.Path(out_dir) / f"rank{rank}.npz", **out)
    dist.destroy_process_group()


def _fake_world(rank, world, store_path, out_dir):
    """The same cells counted on a fake world of 4, then the production
    cell through the command line."""
    torch.set_num_threads(1)
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_fake_mesh

    mesh = make_fake_mesh(MESH, ("data", "model"))
    res = {kind: dryrun.run_cell(cfg(), shape, mesh)
           for kind, shape in SHAPES.items()}
    res.update({f"gp/{name}": dryrun.gp_cell(gp_cfg(name), mesh,
                                             GP_VARIANT[name])
                for name in GP_CELLS})
    (pathlib.Path(out_dir) / "cells.json").write_text(json.dumps(res))
    rc = dryrun.main(["--mesh", "single", "--archs", "llama3.2-1b",
                      "--shapes", "decode_32k", "--out",
                      str(pathlib.Path(out_dir) / "art")])
    rc_gp = dryrun.main(["--mesh", "single", "--gp", "--gp-names",
                         "gplvm-oilflow", "--variant", "naive", "--out",
                         str(pathlib.Path(out_dir) / "art")])
    (pathlib.Path(out_dir) / "rc").write_text(f"{rc} {rc_gp}")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    real, fake = (tmp_path_factory.mktemp(n) for n in ("real", "fake"))
    codes, _ = spawn_ranks(_real_rank, W, real)
    assert codes == [0] * W, f"rank exit codes {codes}"
    codes, _ = spawn_ranks(_fake_world, 1, fake)
    assert codes == [0], f"fake world exit code {codes}"
    ranks = [dict(np.load(real / f"rank{r}.npz")) for r in range(W)]
    return ranks, json.loads((fake / "cells.json").read_text()), fake


@pytest.mark.parametrize("kind", SHAPES)
def test_collectives_equal_the_real_ranks(runs, kind):
    ranks, cells, _ = runs
    got = cells[kind]["collectives"]
    for r in ranks:
        assert json.loads(str(r[f"{kind}/collectives"])) == got
    assert got["all_reduce"]["calls"] > 0 and got["all_gather"]["calls"] > 0


@pytest.mark.parametrize("kind", SHAPES)
def test_argument_bytes_are_the_blocks_of_the_state_and_batch(runs, kind):
    ranks, cells, _ = runs
    mem = cells[kind]["memory"]
    assert mem["argument_bytes"] == mem["state_bytes"] + mem["batch_bytes"]
    for r in ranks:
        assert int(r[f"{kind}/argument_bytes"]) == mem["argument_bytes"]
    assert mem["peak_bytes"] >= mem["argument_bytes"]


@pytest.mark.parametrize("kind", SHAPES)
def test_flops_are_the_model_flops(runs, kind):
    _, cells, _ = runs
    cell = cells[kind]
    c, shape = cfg(), SHAPES[kind]
    want = roofline.model_flops(c, shape, W)
    if kind == "prefill":   # logits of the last position only
        want -= (2.0 * c.vocab_size * c.d_model * shape.global_batch
                 * (shape.seq_len - 1) / W)
    lo, hi = FLOP_RANGE
    assert lo * want <= cell["flops"] <= hi * want, cell["flops"] / want
    assert cell["model_flops"] == roofline.model_flops(c, shape, W)
    assert cell["bytes"]["total"] > 0


def test_the_production_cell_writes_its_record(runs):
    _, _, fake = runs
    assert (fake / "rc").read_text() == "0 0"
    fp = fake / "art" / "single" / "llama3.2-1b__decode_32k.json"
    cell = json.loads(fp.read_text())
    assert cell["mesh"] == {"data": 16, "model": 16}
    assert cell["n_devices"] == 256 and cell["kind"] == "decode"
    assert cell["collectives"]["total"] > 0 and cell["flops"] > 0
    row = roofline.roofline_row(cell)
    assert row["dominant"] in ("compute", "memory", "collective")
    md = roofline.render_md([row])
    assert "| llama3.2-1b | decode_32k | baseline |" in md
    table = report.roofline_table("single", fake / "art")
    assert "llama3.2-1b | decode_32k" in table
    assert "decode_32k" in report.perf_compare(fake / "art", fake / "art")


def test_the_default_archs_are_the_ones_tensor_parallelism_covers():
    """All ten configs: every mixer splits over ``model``."""
    from repro_torch.configs import all_configs
    from repro_torch.launch import dryrun

    assert sorted(dryrun.TP_ARCHS) == sorted(all_configs())
    assert len(dryrun.TP_ARCHS) == 10


@pytest.mark.parametrize("name", GP_CELLS)
def test_gp_cell_collectives_equal_the_real_ranks(runs, name):
    """The engine's two all_reduces a step (the packed Stats, the pulled
    (hyp, z) gradient parts), calls and bytes, on every real rank."""
    ranks, cells, _ = runs
    got = cells[f"gp/{name}"]["collectives"]
    for r in ranks:
        sizes = r[f"gp/{name}/all_reduce"]
        assert got["all_reduce"] == {"calls": len(sizes),
                                     "bytes": int(sizes.sum())}
        assert bool(r[f"gp/{name}/finite"])
    assert got["all_reduce"]["calls"] == 2
    assert got["total"] == got["all_reduce"]["bytes"]


@pytest.mark.parametrize("name", GP_CELLS)
def test_gp_cell_argument_bytes_are_the_shards(runs, name):
    ranks, cells, _ = runs
    mem = cells[f"gp/{name}"]["memory"]
    for r in ranks:
        assert int(r[f"gp/{name}/argument_bytes"]) == mem["argument_bytes"]


@pytest.mark.parametrize("name", GP_CELLS)
def test_gp_cell_flops_are_in_the_band_of_the_model_flops(runs, name):
    _, cells, _ = runs
    cell = cells[f"gp/{name}"]
    want = roofline.gp_model_flops(gp_cfg(name), W)
    assert cell["model_flops"] == want and cell["n_devices"] == W
    lo, hi = GP_FLOP_BAND[name]
    assert lo * want <= cell["flops"] <= hi * want, cell["flops"] / want


def test_the_production_gp_cell_writes_its_record(runs):
    _, _, fake = runs
    fp = fake / "art" / "single" / "gp_gplvm-oilflow__naive.json"
    cell = json.loads(fp.read_text())
    assert cell["arch"] == "gp:gplvm-oilflow" and cell["kind"] == "gp_step"
    assert cell["n_devices"] == 256 and cell["variant"] == "naive"
    table = report.roofline_table("single", fake / "art")
    lines = table.splitlines()
    gp_line = next(i for i, ln in enumerate(lines) if "gp:gplvm-oilflow" in ln)
    lm_line = next(i for i, ln in enumerate(lines) if "llama3.2-1b" in ln)
    assert lm_line < gp_line   # the GP rows after the LM rows
