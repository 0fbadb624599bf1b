"""Dry run: one step of every (architecture x input shape) cell at the
production meshes, counted on fake tensors in one process that acts as
rank 0 of the fake world (the port's counterpart of ``repro.launch.dryrun``).

  PYTHONPATH=src python -m repro_torch.launch.dryrun --mesh single \
      --archs llama3.2-1b
  PYTHONPATH=src python -m repro_torch.launch.dryrun --mesh multi   # all

The meshes are the reference's: (16, 16) ``("data", "model")`` = 256
ranks (``single``) and (2, 16, 16) ``("pod", "data", "model")`` = 512
(``multi``), built over ``torch.distributed``'s fake backend
(``launch.mesh.make_fake_mesh``); no card and no network is needed.  Each
cell runs the step the reference lowers (``train_4k``: ``make_train_step``
on the rank's blocks of the state; ``prefill_32k``: ``make_prefill_step``;
``decode_32k``: ``make_serve_step`` against a full cache) on the rank's
local shapes (``train.steps.abstract_state`` / ``input_specs`` with the
mesh), and records per rank what ``launch.step_stats`` counts: FLOPs,
bytes, collectives by kind, argument and peak bytes.  One JSON per cell
goes to ``artifacts/dryrun_torch/<mesh>/<arch>__<shape>[__<variant>].json``
(a cell already there is skipped); ``launch.roofline`` and
``launch.report`` read them at the H100's data-sheet peaks (analytic: no
time here is measured).  A failure is a bug of the port: the run lists
them and exits 1.

The default architectures are all ten, ``long_500k`` included for
mamba2-370m and recurrentgemma-9b.

``--gp`` (``lower_gp_cell``) runs the GP cells instead: one value and
gradient of ``DistributedGP``'s bound at each GP config (``--gp-names``,
default all five), in f32 as the reference lowers it, with every rank of
the fake world a data shard (``launch.mesh.gp_data_axes``): 256 ranks
(``single``) or 512 (``multi``), each its n / ranks rows.  Variants (the
reference's): ``naive`` the port's kernels (``reg_stats``, psi1, psi2),
``mxu`` psi2 by ``core.gp_kernels.psi2_mxu`` (chunk 512), ``sym`` by
``psi2_mxu_sym`` (chunk 512, tile 64); ``--variant`` picks one, by default
all three.  On fake tensors the kernels' wrappers call their operators,
whose FLOP formulas count the kernels' work; their backward is the plain
chunked recompute, counted as it runs.  The engine's own all_reduces
record in ``tensor_parallel.COUNTS``, as the model's collectives do.  One
JSON per cell,
``gp_<name>__<variant>.json``.

Not ported: ``repro.launch.reanalyze``, which re-reads saved HLO: no HLO
is saved here, and a cell is re-counted by running it again.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import pathlib
import traceback

import numpy as np
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from ..configs import GP_CONFIGS, SHAPES, all_configs, cells
from ..core.distributed import DistributedGP
from ..distributed import sharding as shlib
from ..models.common import tree_map
from ..train import steps
from . import roofline
from .mesh import PRODUCTION, gp_data_axes, make_fake_mesh
from .step_stats import step_stats

ART = pathlib.Path(__file__).resolve().parents[3] / "artifacts" / \
    "dryrun_torch"
TP_ARCHS = tuple(sorted(all_configs()))   # every config splits its layers
GP_VARIANTS = ("naive", "mxu", "sym")
# The fake tensors live on the CPU device: a CPU build of torch cannot
# dispatch indexing ops on fake CUDA tensors, and no count here depends on
# the device.
DEVICE = "cpu"


def variant_config(cfg, variant: str):
    """The reference's perf-variant knobs, joined by ``+``."""
    for v in variant.split("+"):
        if v == "flash":
            cfg = dataclasses.replace(cfg, use_flash=True)
        elif v == "a2a_int8":
            cfg = dataclasses.replace(cfg, moe_dispatch_dtype="int8")
        elif v == "cap10":
            cfg = dataclasses.replace(cfg, capacity_factor=1.0)
        elif v == "noremat":
            cfg = dataclasses.replace(cfg, remat=False)
        elif v == "remat_dots":
            cfg = dataclasses.replace(cfg, remat_policy="dots")
        elif v != "baseline":
            raise ValueError(f"unknown variant {v!r}")
    return cfg


def _fake(meta_tree):
    """Fake tensors (under the active ``FakeTensorMode``) of a tree of
    ``meta`` tensors' shapes and dtypes."""
    return tree_map(lambda m: torch.zeros(m.shape, dtype=m.dtype,
                                          device=DEVICE), meta_tree)


def run_cell(cfg, shape, mesh) -> dict:
    """One step of ``cfg`` at ``shape`` (a ``ShapeSpec``) as this rank of
    ``mesh``, counted (``step_stats``)."""
    with FakeTensorMode(), shlib.use_mesh(mesh):
        state_meta, _ = steps.abstract_state(cfg, mesh)
        batch = _fake(steps.input_specs(cfg, shape, mesh))
        if shape.kind == "train":
            state = _fake(state_meta)
            step = steps.make_train_step(cfg)
            stats = step_stats(lambda: step(state, batch),
                               {"state": state, "batch": batch})
        elif shape.kind == "prefill":
            params = _fake(state_meta["params"])
            step = steps.make_prefill_step(cfg)
            stats = step_stats(lambda: step(params, batch),
                               {"state": params, "batch": batch})
        else:
            params = _fake(state_meta["params"])
            step = steps.make_serve_step(cfg)
            stats = step_stats(
                lambda: step(params, batch["caches"], batch["tokens_t"],
                             batch["pos"]),
                {"state": params, "batch": batch})
    sizes = shlib.mesh_sizes(mesh)
    n_dev = math.prod(sizes.values())
    return {"kind": shape.kind, "mesh": sizes, "n_devices": n_dev,
            "model_flops": roofline.model_flops(cfg, shape, n_dev),
            "peaks": roofline.PEAKS_NOTE, **stats}


def lower_cell(arch: str, shape_name: str, mesh,
               variant: str = "baseline") -> dict:
    """The reference's ``lower_cell``: one cell's record."""
    cfg = variant_config(all_configs()[arch], variant)
    stats = run_cell(cfg, SHAPES[shape_name], mesh)
    _print(stats)
    return {"arch": arch, "shape": shape_name, "variant": variant, **stats}


def gp_psi2_fn(variant: str):
    """The reference's psi2 of each GP variant (None: the engine's kernel
    route)."""
    from ..core import gp_kernels as gpk

    if variant == "naive":
        return None
    if variant == "mxu":
        return lambda hyp, z, mu, s, w: gpk.psi2_mxu(hyp, z, mu, s, w,
                                                     chunk=512)
    if variant == "sym":
        return lambda hyp, z, mu, s, w: gpk.psi2_mxu_sym(hyp, z, mu, s, w,
                                                         chunk=512, tile=64)
    raise ValueError(f"unknown GP variant {variant!r}")


def gp_cell(gp, mesh, variant: str = "naive") -> dict:
    """One value and gradient of the negative bound of ``gp`` (a
    ``GPConfig``) as rank 0 of ``mesh`` (every axis a data shard),
    counted (``step_stats``)."""
    sizes = shlib.mesh_sizes(mesh)
    ranks = math.prod(sizes[a] for a in gp_data_axes(mesh))
    n_loc = -(-gp.n // ranks)
    f32 = torch.float32
    with FakeTensorMode():
        eng = DistributedGP(group=torch.distributed.group.WORLD,
                            latent=gp.latent, device=DEVICE,
                            psi2_fn=gp_psi2_fn(variant))
        hyp = {"log_sf2": torch.zeros((), dtype=f32, device=DEVICE),
               "log_ell": torch.zeros((gp.q,), dtype=f32, device=DEVICE),
               "log_beta": torch.zeros((), dtype=f32, device=DEVICE)}
        z = torch.zeros((gp.m, gp.q), dtype=f32, device=DEVICE)
        mu = torch.zeros((n_loc, gp.q), dtype=f32, device=DEVICE)
        s = (torch.zeros((n_loc, gp.q), dtype=f32, device=DEVICE)
             if gp.latent else None)
        y = torch.zeros((n_loc, gp.d), dtype=f32, device=DEVICE)
        w = torch.zeros((n_loc,), dtype=f32, device=DEVICE)
        # the failure mask on the host, as a streamed step takes it: the
        # engine reads this rank's entry as a number
        mask = np.ones((ranks,), dtype=np.float32)
        fmask = torch.zeros((ranks,), dtype=f32, device=DEVICE)
        argnums = (0, 1, 2, 3) if gp.latent else (0, 1)
        step = eng.make_value_and_grad(gp.d, argnums=argnums)
        stats = step_stats(
            lambda: step(hyp, z, mu, s, y, w, mask, float(gp.n)),
            {"state": {"hyp": hyp, "z": z},
             "batch": {"mu": mu, "s": s, "y": y, "w": w, "fmask": fmask}})
    return {"kind": "gp_step", "mesh": sizes, "n_devices": ranks,
            "model_flops": roofline.gp_model_flops(gp, ranks),
            "peaks": roofline.PEAKS_NOTE, **stats}


def lower_gp_cell(name: str, mesh, variant: str = "naive") -> dict:
    """The reference's ``lower_gp_cell``: one GP cell's record."""
    gp = GP_CONFIGS[name]
    stats = gp_cell(gp, mesh, variant)
    _print(stats)
    return {"arch": f"gp:{name}", "shape": f"n{gp.n}_m{gp.m}",
            "variant": variant, **stats}


def _print(stats):
    print(f"  flops {stats['flops']:.3e}  bytes "
          f"{stats['bytes']['total']:.3e}  collectives "
          f"{stats['collectives']['total']:.3e}  args "
          f"{stats['memory']['argument_bytes'] / 1e9:.2f} GB  peak "
          f"{stats['memory']['peak_bytes'] / 1e9:.2f} GB  "
          f"({stats['trace_s']:.1f} s)", flush=True)


def _run_one(fp, label, fn, failures):
    """Write ``fn()``'s record to ``fp`` unless it is there; a failure is
    listed, not raised."""
    if fp.exists():
        print(f"{label} (cached)")
        return
    print(label, flush=True)
    try:
        fp.write_text(json.dumps(fn()))
    except Exception as e:  # noqa: BLE001
        traceback.print_exc()
        failures.append((label, repr(e)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--mesh", choices=["single", "multi", "both"],
                    default="both")
    ap.add_argument("--archs", nargs="*", default=None)
    ap.add_argument("--shapes", nargs="*", default=None)
    ap.add_argument("--gp", action="store_true", help="GP cells only")
    ap.add_argument("--gp-names", nargs="*", default=None)
    ap.add_argument("--variant", default="baseline")
    ap.add_argument("--out", default=str(ART))
    args = ap.parse_args(argv)

    out_root = pathlib.Path(args.out)
    meshes = {"single": [False], "multi": [True], "both": [False, True]}
    cfgs = all_configs()
    failures = []
    for multi in meshes[args.mesh]:
        mesh_name = "multi" if multi else "single"
        out_dir = out_root / mesh_name
        out_dir.mkdir(parents=True, exist_ok=True)
        mesh = make_fake_mesh(*PRODUCTION[multi])
        if args.gp:
            variants = (GP_VARIANTS if args.variant == "baseline"
                        else (args.variant,))
            for name in args.gp_names or GP_CONFIGS:
                for variant in variants:
                    tag = f"gp_{name}__{variant}"
                    _run_one(out_dir / f"{tag}.json", f"[{mesh_name}] {tag}",
                             lambda: lower_gp_cell(name, mesh, variant),
                             failures)
        else:
            for arch in args.archs or TP_ARCHS:
                for shape_name in cells(cfgs[arch]):
                    if args.shapes and shape_name not in args.shapes:
                        continue
                    tag = f"{arch}__{shape_name}"
                    if args.variant != "baseline":
                        tag += f"__{args.variant}"
                    _run_one(out_dir / f"{tag}.json", f"[{mesh_name}] {tag}",
                             lambda: lower_cell(arch, shape_name, mesh,
                                                args.variant), failures)
        torch.distributed.destroy_process_group()
    if failures:
        print("\nFAILURES:")
        for f in failures:
            print(" ", f)
        return 1
    print("\nDRY-RUN COMPLETE")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
