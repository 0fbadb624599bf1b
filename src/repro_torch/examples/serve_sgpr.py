"""Serving a trained sparse GP: extract state once, answer queries forever
(torch copy of ``examples/serve_sgpr.py``).

The paper's re-parametrisation means a fitted model compresses into a
constant-size ``PredictiveState``: kernel hyper-parameters, inducing
inputs, and the precomputed q(u) factor solves.  A serving process loads
that state from disk (never the training data) and answers query batches
through the block engine.

  PYTHONPATH=src python -m repro_torch.examples.serve_sgpr [--device cpu]
"""
import tempfile

import numpy as np

from repro_torch.core import SGPR
from repro_torch.examples import device_args
from repro_torch.serve import PredictEngine, load_state, save_state


def main(argv=None):
    args = device_args(__doc__, argv)
    rng = np.random.default_rng(0)
    n = 600
    x = rng.uniform(-3, 3, size=(n, 1))
    f = np.sin(2.0 * x) + 0.3 * np.cos(5.0 * x)
    y = f + 0.1 * rng.standard_normal((n, 1))

    # -- training side: fit, extract, persist -------------------------------
    model = SGPR(x, y, num_inducing=25, seed=0, device=args.device)
    model.fit(max_iters=80)
    state = model.predictive_state()
    n_factors = sum(a.numel() for a in (state.chol_kmm, state.chol_sigma,
                                        state.c2, state.a_mean, state.g))
    print(f"fitted bound: {model.log_bound():10.2f}; state: m={state.m} "
          f"q={state.q} d={state.d} (~{n_factors * 8 / 1024:.1f} KiB of factors)")
    with tempfile.TemporaryDirectory(prefix="serve_sgpr_") as ckpt_dir:
        path = save_state(f"{ckpt_dir}/pstate", state,
                          metadata={"example": "sgpr"})
        print(f"state saved to {path}")

        # -- serving side: restart from disk alone --------------------------
        loaded, meta = load_state(f"{ckpt_dir}/pstate", device=args.device)
    engine = PredictEngine(loaded, block_size=128, device=args.device)
    print(f"state loaded (metadata={meta}); engine: block_size=128")

    xs = np.linspace(-3, 3, 500)[:, None]
    mean, var = engine.predict_np(xs, include_noise=False)
    true = np.sin(2.0 * xs) + 0.3 * np.cos(5.0 * xs)
    rmse = float(np.sqrt(np.mean((mean - true) ** 2)))
    print(f"batched predict over {xs.shape[0]} queries: RMSE vs noiseless "
          f"truth {rmse:.4f}")
    assert rmse < 0.2, "serving-path predictions degraded"

    # Round-trip sanity: the served posterior == the model's own predict.
    m_model, v_model = model.predict(xs)
    assert np.allclose(mean, m_model, rtol=1e-9, atol=1e-11)
    assert np.allclose(var, v_model, rtol=1e-8, atol=1e-10)
    print("served mean/var match the training-side predict — OK")
    return rmse


if __name__ == "__main__":
    main()
