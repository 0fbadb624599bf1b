"""Serving an ensemble: N models, one engine; quantized wire states;
posterior samples (torch copy of ``examples/ensemble_serve.py``).

Fit a small fleet of SGPRs (bootstrap resamples of one dataset), extract
each model's constant-size ``PredictiveState``, quantize it to bf16 for
shipping (the state is the only artifact a server needs), restore the fleet
from disk, stack it into one state and serve every model per query through
one ``MultiPredictEngine``; then draw posterior functions from one member.

  PYTHONPATH=src python -m repro_torch.examples.ensemble_serve [--device cpu]
"""
import tempfile

import numpy as np
import torch

from repro_torch.core import SGPR
from repro_torch.examples import device_args
from repro_torch.serve import (MultiPredictEngine, PredictEngine, load_state,
                               save_state, stack_states)

N_MODELS = 3


def true_f(t):
    return np.sin(2.0 * t) + 0.3 * np.cos(5.0 * t)


def main(argv=None):
    args = device_args(__doc__, argv)
    rng = np.random.default_rng(0)
    n = 400
    x = rng.uniform(-3, 3, size=(n, 1))
    y = true_f(x) + 0.1 * rng.standard_normal((n, 1))

    # -- training side: a bootstrap fleet, quantized for the wire -----------
    ckpt_dir = tempfile.mkdtemp(prefix="ensemble_serve_")
    for k in range(N_MODELS):
        idx = rng.choice(n, n, replace=True)            # bootstrap resample
        model = SGPR(x[idx], y[idx], num_inducing=20, seed=k,
                     device=args.device)
        model.fit(max_iters=60)
        state16 = model.predictive_state().astype(torch.bfloat16)
        save_state(f"{ckpt_dir}/model_{k}", state16, metadata={"member": k})
        if k == 0:
            # Sampling re-factorises query covariances, which sub-f32
            # storage rounding can make indefinite: the member to draw
            # functions from also ships an f32 state (half the f64 bytes).
            save_state(f"{ckpt_dir}/model_0_f32",
                       model.predictive_state().astype(torch.float32))
        print(f"member {k}: bound={model.log_bound():9.2f}  "
              f"state={state16.nbytes / 1024:.1f} KiB (bf16 wire format)")

    # -- serving side: restore the fleet, serve it from one engine ----------
    fleet = [load_state(f"{ckpt_dir}/model_{k}", device=args.device)[0]
             for k in range(N_MODELS)]
    engine = MultiPredictEngine(stack_states(fleet), block_size=128,
                                device=args.device)
    print(f"fleet engine: {engine.n_models} models, storage "
          f"{engine.state.dtype}, compute {engine.compute_dtype}")

    xs = np.linspace(-3, 3, 500)[:, None]
    mean, var = (a.cpu().numpy() for a in engine.predict(xs))
    mu, v = (a.cpu().numpy() for a in engine.predict_mixture(xs))
    rmse = float(np.sqrt(np.mean((mu - true_f(xs)) ** 2)))
    print(f"ensemble of {N_MODELS} over {xs.shape[0]} queries: mixture RMSE "
          f"vs noiseless truth {rmse:.4f}")
    assert rmse < 0.2, "ensemble serving degraded"
    spread = float(np.mean(mean.std(axis=0)))
    print(f"between-member spread (mean over queries): {spread:.4f}")
    assert np.isfinite(v).all() and (v > 0).all()

    # -- posterior samples from member 0's sampling-grade f32 state ---------
    state0, _ = load_state(f"{ckpt_dir}/model_0_f32", device=args.device)
    eng0 = PredictEngine(state0, block_size=128, device=args.device)
    draws = eng0.sample(xs, 64, 0).cpu().numpy()
    m0, v0 = (a.cpu().numpy() for a in eng0.predict(xs))
    # Monte-Carlo sanity: 6 standard errors of the 64-draw mean estimator.
    gap = float(np.max(np.abs(draws.mean(axis=0) - m0)))
    bound = 6.0 * float(np.sqrt(v0.max() / draws.shape[0]))
    print(f"64 posterior draws from member 0: max |sample mean - posterior "
          f"mean| = {gap:.3f} (MC bound {bound:.3f})")
    assert gap < bound, "posterior samples drifted from the posterior mean"
    print("ensemble served, sampled, and sanity-checked: OK")
    return rmse, gap, bound


if __name__ == "__main__":
    main()
