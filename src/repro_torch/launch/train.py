"""End-to-end LM trainer with checkpoint/restart (port of
``repro.launch.train``).

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-1.5b \\
      --reduced --steps 200 --batch 8 --seq 128 --ckpt-dir /tmp/run1

Runs on the card unless ``--device cpu``.  Restart-safe: the data stream is
(seed, step)-addressed, so resuming from step k replays the exact token
stream; checkpoints rotate atomically and are the JAX package's format, so
a run resumes from a train state the JAX package's trainer wrote (and the
other way round).  The error-feedback state of ``--compress-grads`` is not
checkpointed, as in the JAX package.
"""
import argparse
import pathlib
import time

import torch

from .._device import resolve_device
from ..checkpoint import checkpoint as ckpt
from ..configs import all_configs
from ..data.tokens import TokenStream
from ..optim import compression as comp
from ..optim.adam import AdamConfig
from ..train import steps


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-1.5b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = all_configs()[args.arch]
    if args.reduced:
        cfg = cfg.reduced()
    stream = TokenStream(cfg.vocab_size, args.seq, args.batch, seed=0,
                         device=dev)

    gen = torch.Generator(device=dev).manual_seed(0)
    state = steps.init_train_state(cfg, gen, device=dev)
    start_step = 0

    ckdir = pathlib.Path(args.ckpt_dir) if args.ckpt_dir else None
    if ckdir and (last := ckpt.latest(ckdir)) is not None:
        state, meta = ckpt.restore(last, state, dev)
        start_step = int(meta["step"])
        print(f"resumed from {last} at step {start_step}")

    adam_cfg = AdamConfig(lr=args.lr, warmup_steps=max(args.steps // 20, 5))

    compress = None
    if args.compress_grads:
        err = comp.init_error_state(state["params"])

        def compress(grads):
            nonlocal err
            grads, err = comp.compress_with_feedback(grads, err)
            return grads

    train_step = steps.make_train_step(cfg, adam_cfg, compression=compress)
    saver = ckpt.AsyncCheckpointer()
    losses = []
    t0 = time.time()
    for it in range(start_step, args.steps):
        state, metrics = train_step(state, stream.batch(it))
        losses.append(float(metrics["loss"]))
        if it % args.log_every == 0 or it == args.steps - 1:
            dt = time.time() - t0
            print(f"step {it:5d} loss {losses[-1]:.4f} "
                  f"gnorm {float(metrics['grad_norm']):.3f} "
                  f"({dt / max(it - start_step + 1, 1):.2f}s/step)")
        if ckdir and (it + 1) % args.ckpt_every == 0:
            saver.save(ckdir / f"ckpt_step{it + 1}", state,
                       {"step": it + 1, "loss": losses[-1]})
    saver.wait()
    if ckdir:
        ckpt.save(ckdir / f"ckpt_step{args.steps}", state,
                  {"step": args.steps, "loss": losses[-1]})
    print(f"final loss {losses[-1]:.4f} (start {losses[0]:.4f})")
    return losses


if __name__ == "__main__":
    main()
