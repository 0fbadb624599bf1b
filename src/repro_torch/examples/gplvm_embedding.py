"""Bayesian GPLVM dimensionality reduction (the paper's fig. 4 workflow;
torch copy of ``examples/gplvm_embedding.py``).

Fits a GPLVM on the oil-flow-like dataset, reports the ARD-selected
effective dimensionality and the 2-D embedding's separation by class, and
saves the embedding as an ``.npy`` file.

  PYTHONPATH=src python -m repro_torch.examples.gplvm_embedding \\
      [--device cpu] [--out embedding.npy]

  # smoke (seconds): 120 points, q 4, m 12, 20 SCG iterations
  PYTHONPATH=src python -m repro_torch.examples.gplvm_embedding --tiny
"""
import argparse

import numpy as np

from repro_torch.core import BayesianGPLVM
from repro_torch.data.synthetic import oilflow_like


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=500)
    ap.add_argument("--q", type=int, default=8, help="latent dimensions")
    ap.add_argument("--m", type=int, default=30, help="inducing points")
    ap.add_argument("--iters", type=int, default=250, help="SCG iterations")
    ap.add_argument("--tiny", action="store_true",
                    help="smoke: 120 points, q 4, m 12, 20 iterations")
    ap.add_argument("--out", default="gplvm_embedding.npy",
                    help="where the 2-D embedding is saved")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    if args.tiny:
        args.n, args.q, args.m, args.iters = 120, 4, 12, 20
    return args


def main(argv=None):
    args = parse(argv)
    rng = np.random.default_rng(0)
    y, labels = oilflow_like(rng, n=args.n)
    model = BayesianGPLVM(y, q=args.q, num_inducing=args.m, seed=0,
                          device=args.device)
    print(f"initial bound: {model.log_bound():10.2f}")
    model.fit(max_iters=args.iters)
    print(f"final bound:   {model.log_bound():10.2f}")

    w = model.ard_weights()
    order = np.argsort(w)[::-1]
    print("ARD weights (sorted):", np.round(np.sort(w)[::-1], 4))
    eff = int(np.sum(w > 0.1 * w.max()))
    print(f"effective latent dimensionality: {eff} of q={args.q}")

    # class separation in the top-2 ARD dims (silhouette-like score)
    emb = model.latent_mean()[:, order[:2]]
    mus = np.stack([emb[labels == c].mean(0) for c in range(3)])
    within = np.mean([np.linalg.norm(emb[labels == c]
                                     - mus[c], axis=1).mean()
                      for c in range(3)])
    between = np.mean([np.linalg.norm(mus[i] - mus[j])
                       for i in range(3) for j in range(i + 1, 3)])
    ratio = float(between / within)
    print(f"class separation (between/within): {ratio:.2f}x")
    np.save(args.out, emb)
    print(f"embedding saved to {args.out}")
    return ratio, eff


if __name__ == "__main__":
    main()
