"""End-to-end LM pre-training with checkpoint/restart (port of
``examples/lm_pretrain.py``): trains a reduced llama3.2-style model on the
synthetic token stream, checkpointing every 50 steps, then "crashes" and
resumes from the latest checkpoint to show fault-tolerant restart.

  PYTHONPATH=src python -m repro_torch.examples.lm_pretrain [--steps 200] \\
      [--device cpu] [--ckpt-dir DIR]

``--ckpt-dir`` (default: ``repro_torch_lm_pretrain_ckpt`` in the temporary
directory) is emptied first.
"""
import argparse
import pathlib
import shutil
import tempfile

from ..launch.train import main as train_main


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--arch", default="llama3.2-1b")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--ckpt-dir", default=str(
        pathlib.Path(tempfile.gettempdir()) / "repro_torch_lm_pretrain_ckpt"))
    args = ap.parse_args(argv)

    ckdir = pathlib.Path(args.ckpt_dir)
    shutil.rmtree(ckdir, ignore_errors=True)
    common = ["--arch", args.arch, "--reduced", "--batch", "8", "--seq",
              "128", "--ckpt-dir", str(ckdir), "--ckpt-every", "50"]
    if args.device:
        common += ["--device", args.device]

    half = args.steps // 2
    print(f"=== phase 1: train to step {half}, checkpoint every 50 ===")
    train_main(common + ["--steps", str(half)])

    print("\n=== simulated crash; phase 2: resume from latest checkpoint ===")
    losses = train_main(common + ["--steps", str(args.steps)])
    print(f"\ntrained {args.steps} steps total across a restart; "
          f"final loss {losses[-1]:.4f}")
    return losses


if __name__ == "__main__":
    main()
