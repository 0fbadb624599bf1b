"""Minibatch-stochastic (SVI) sparse GP regression (torch copy of
``examples/svi_sgpr.py``).

The exact bound folds every row block per optimiser step (O(n) a step);
the SVI mode folds ``batch_blocks`` random blocks and reweights, so a step
costs O(batch_blocks * chunk_size) however large n grows: Hensman et al.'s
estimator on the block machinery of ``core.stats``.

  PYTHONPATH=src python -m repro_torch.examples.svi_sgpr [--device cpu]
"""
import numpy as np

from repro_torch.core import SGPR
from repro_torch.examples import device_args


def main(argv=None):
    args = device_args(__doc__, argv)
    rng = np.random.default_rng(0)
    n = 4000
    x = rng.uniform(-3, 3, size=(n, 1))
    f = np.sin(2.0 * x) + 0.3 * np.cos(5.0 * x)
    y = f + 0.1 * rng.standard_normal((n, 1))

    # 32 blocks of 128 rows; each SVI step folds 4 of them (512 rows), an
    # 8x cheaper step than the exact fold.
    model = SGPR(x, y, num_inducing=30, seed=0, chunk_size=128,
                 batch_blocks=4, device=args.device)
    print(f"n={n}, blocks of {model.chunk_size} rows, "
          f"{model.batch_blocks} blocks/step")
    b0 = model.log_bound()
    print(f"initial exact bound: {b0:10.2f}")

    res = model.fit_svi(steps=300, lr=2e-2, seed=0, verbose=True)
    b1 = model.log_bound()
    print(f"final exact bound:   {b1:10.2f}  "
          f"({res.n_steps} Adam steps, each folding "
          f"{model.batch_blocks}/{-(-n // model.chunk_size)} blocks)")

    xs = np.linspace(-3, 3, 200)[:, None]
    mean, var = model.predict(xs, include_noise=False)
    true = np.sin(2.0 * xs) + 0.3 * np.cos(5.0 * xs)
    rmse = float(np.sqrt(np.mean((mean - true) ** 2)))
    sigma = float(1.0 / np.sqrt(np.exp(float(model.params["hyp"]["log_beta"]))))
    print(f"test RMSE vs noiseless truth: {rmse:.4f} "
          f"(noise sd used to generate: 0.100, learned: {sigma:.3f})")
    return b0, b1, rmse


if __name__ == "__main__":
    main()
