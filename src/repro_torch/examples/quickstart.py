"""Quickstart: sparse GP regression with the re-parametrised bound (torch
copy of ``examples/quickstart.py``).

  PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
"""
import numpy as np

from repro_torch.core import SGPR
from repro_torch.examples import device_args


def main(argv=None):
    args = device_args(__doc__, argv)
    rng = np.random.default_rng(0)
    n = 500
    x = rng.uniform(-3, 3, size=(n, 1))
    f = np.sin(2.0 * x) + 0.3 * np.cos(5.0 * x)
    y = f + 0.1 * rng.standard_normal((n, 1))

    model = SGPR(x, y, num_inducing=30, seed=0, device=args.device)
    print(f"initial bound: {model.log_bound():10.2f}")
    model.fit(max_iters=150, verbose=True)

    xs = np.linspace(-3, 3, 200)[:, None]
    mean, var = model.predict(xs, include_noise=False)
    true = np.sin(2.0 * xs) + 0.3 * np.cos(5.0 * xs)
    rmse = float(np.sqrt(np.mean((mean - true) ** 2)))
    sigma = float(1.0 / np.sqrt(np.exp(float(model.params["hyp"]["log_beta"]))))
    print(f"test RMSE vs noiseless truth: {rmse:.4f} "
          f"(noise sd used to generate: 0.100, learned: {sigma:.3f})")
    inside = np.mean(np.abs(mean - true) <= 2 * np.sqrt(var)[:, None])
    print(f"2-sigma coverage of the truth: {inside * 100:.1f}%")
    return rmse


if __name__ == "__main__":
    main()
