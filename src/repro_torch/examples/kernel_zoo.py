"""Kernel zoo walkthrough: a composite covariance end to end (torch copy of
``examples/kernel_zoo.py``).

Fits a function with a linear trend plus a smooth bump using
``Sum(SEARD(dims=(0,)), Linear(dims=(1,)))``, compares it against the
default SE-ARD, then serves the fitted posterior: the kernel spec rides in
the checkpoint sidecar, so the reload needs no model code.  The composite
takes the plain torch math on any device; the SE-ARD model the fused
kernels on the card.

  PYTHONPATH=src python -m repro_torch.examples.kernel_zoo [--device cpu]
"""
import os
import tempfile

import numpy as np

from repro_torch.core import SEARD, SGPR, Linear, Sum
from repro_torch.examples import device_args
from repro_torch.serve import (PredictEngine, load_state, save_state,
                               state_from_model)


def main(argv=None):
    args = device_args(__doc__, argv)
    rng = np.random.default_rng(0)
    n = 400
    # dim 0 drives a smooth nonlinearity, dim 1 a pure linear trend.
    x = rng.uniform(-3, 3, size=(n, 2))
    f = np.sin(2.0 * x[:, :1]) + 0.8 * x[:, 1:]
    y = f + 0.1 * rng.standard_normal((n, 1))

    kern = Sum(SEARD(dims=(0,)), Linear(dims=(1,)))
    print(f"kernel spec: {kern}")

    model = SGPR(x, y, num_inducing=30, kernel=kern, seed=0,
                 device=args.device)
    model.fit(max_iters=100)
    se = SGPR(x, y, num_inducing=30, seed=0, device=args.device)
    se.fit(max_iters=100)
    bounds = {"composite": model.log_bound(), "se-ard": se.log_bound()}
    print(f"bound  Sum(SE0, Linear1): {bounds['composite']:10.2f}")
    print(f"bound  SE-ARD (default) : {bounds['se-ard']:10.2f}")

    xs = rng.uniform(-3, 3, size=(200, 2))
    true = np.sin(2.0 * xs[:, :1]) + 0.8 * xs[:, 1:]
    rmse = {}
    for name, mdl in (("composite", model), ("se-ard", se)):
        mean, _ = mdl.predict(xs)
        rmse[name] = float(np.sqrt(np.mean((mean - true) ** 2)))
        print(f"test RMSE [{name:>9}]: {rmse[name]:.4f}")

    # Serving round trip: the sidecar carries the kernel spec.
    state = state_from_model(model)
    with tempfile.TemporaryDirectory() as td:
        path = os.path.join(td, "zoo_state.npz")
        save_state(path, state)
        loaded, _ = load_state(path, device=args.device)
    print(f"restored kernel from sidecar: {loaded.kernel}")
    eng = PredictEngine(loaded, block_size=64, device=args.device)
    mean, var = eng.predict_np(xs)
    rmse["served"] = float(np.sqrt(np.mean((mean - true) ** 2)))
    print(f"served RMSE (reloaded state): {rmse['served']:.4f}  "
          f"(mean var {float(np.mean(var)):.4f})")
    return bounds, rmse


if __name__ == "__main__":
    main()
