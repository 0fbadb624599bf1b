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

The default architectures are the six that tensor parallelism covers (the
five dense configs and qwen3-moe); the other four raise under a
``model`` axis (ROADMAP Queue 1 item 13) and fail if named.  Not ported:
the GP cells (``--gp``, ``lower_gp_cell``; ROADMAP Queue 1 item 13), and
``repro.launch.reanalyze``, which re-reads saved HLO: no HLO is saved
here, and a cell is re-counted by running it again.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import pathlib
import traceback

import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from ..configs import SHAPES, all_configs, cells
from ..distributed import sharding as shlib
from ..models.common import tree_map
from ..train import steps
from . import roofline
from .mesh import PRODUCTION, make_fake_mesh
from .step_stats import step_stats

ART = pathlib.Path(__file__).resolve().parents[3] / "artifacts" / \
    "dryrun_torch"
TP_ARCHS = ("qwen2-1.5b", "llama3.2-1b", "starcoder2-3b", "codeqwen1.5-7b",
            "chameleon-34b", "qwen3-moe-235b-a22b")
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
    print(f"  flops {stats['flops']:.3e}  bytes "
          f"{stats['bytes']['total']:.3e}  collectives "
          f"{stats['collectives']['total']:.3e}  args "
          f"{stats['memory']['argument_bytes'] / 1e9:.2f} GB  peak "
          f"{stats['memory']['peak_bytes'] / 1e9:.2f} GB  "
          f"({stats['trace_s']:.1f} s)", flush=True)
    return {"arch": arch, "shape": shape_name, "variant": variant, **stats}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--mesh", choices=["single", "multi", "both"],
                    default="both")
    ap.add_argument("--archs", nargs="*", default=None)
    ap.add_argument("--shapes", nargs="*", default=None)
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
        for arch in args.archs or TP_ARCHS:
            for shape_name in cells(cfgs[arch]):
                if args.shapes and shape_name not in args.shapes:
                    continue
                tag = f"{arch}__{shape_name}"
                if args.variant != "baseline":
                    tag += f"__{args.variant}"
                fp = out_dir / f"{tag}.json"
                if fp.exists():
                    print(f"[{mesh_name}] {tag} (cached)")
                    continue
                print(f"[{mesh_name}] {tag}", flush=True)
                try:
                    st = lower_cell(arch, shape_name, mesh, args.variant)
                    fp.write_text(json.dumps(st))
                except Exception as e:  # noqa: BLE001
                    traceback.print_exc()
                    failures.append((mesh_name, tag, repr(e)))
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
