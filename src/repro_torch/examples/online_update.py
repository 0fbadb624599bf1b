"""Continual learning: ingest new data into a served posterior, no retrain
(torch copy of ``examples/online_update.py``).

The paper's sufficient statistics are additive across data blocks, so a
fitted model absorbs (or forgets) a block by folding constant-size
statistics (``SGPR.update`` / ``SGPR.forget``), while the serving factors
refresh by a rank-k Cholesky update in O(m²k), never re-scanning history
and never refactorising the m×m system.

  PYTHONPATH=src python -m repro_torch.examples.online_update [--device cpu]
"""
import time

import numpy as np

from repro_torch.core import SGPR
from repro_torch.examples import device_args


def stream(rng, k):
    """The next k points of the sine stream the model is learning."""
    x = rng.uniform(-3, 3, size=(k, 1))
    y = (np.sin(2.0 * x) + 0.3 * np.cos(5.0 * x)
         + 0.1 * rng.standard_normal((k, 1)))
    return x, y


def main(argv=None):
    args = device_args(__doc__, argv)
    rng = np.random.default_rng(0)

    # -- day 0: fit on the history so far -----------------------------------
    x0, y0 = stream(rng, 400)
    model = SGPR(x0, y0, num_inducing=20, seed=0, device=args.device)
    model.fit(max_iters=60)
    xs = np.linspace(-3, 3, 200)[:, None]
    model.predict(xs)                      # build the serving engine
    print(f"fitted on n={model.n}; bound={model.log_bound():.2f}")

    # -- the ingest-update-serve loop ---------------------------------------
    # Each block folds in O(k·m²): the statistics add, the factors take a
    # rank-k update and the live engine swaps to the refreshed state.  The
    # parameters stay; the folded statistics give the exact bound on all
    # the data seen.
    blocks = []
    for _ in range(3):
        xb, yb = stream(rng, 50)
        t0 = time.perf_counter()
        blocks.append(model.update(xb, yb))
        dt = (time.perf_counter() - t0) * 1e3
        print(f"ingested block {blocks[-1]} (k=50) in {dt:.1f} ms "
              f"-> n={model.n}, bound={model.log_bound():.2f}")

    # Parity: the updated posterior equals a full rebuild on everything seen
    # so far (same hyper-parameters and inducing points).
    ref = SGPR(model.x.cpu().numpy(), model.y.cpu().numpy(),
               num_inducing=20, z=model.params["z"].cpu().numpy(),
               device=args.device)
    ref.params = model.params
    m_inc, _ = model.predict(xs)
    m_ref, _ = ref.predict(xs)
    err = float(np.max(np.abs(m_inc - m_ref)))
    print(f"incremental vs full-rescan posterior: max |Δmean| = {err:.2e}")
    assert err < 1e-8, "incremental update drifted from the exact posterior"

    # -- forget: remove a block (e.g. data retention) exactly ---------------
    model.forget(blocks[1])
    print(f"forgot block {blocks[1]} -> n={model.n}, "
          f"blocks held={model.num_blocks}, bound={model.log_bound():.2f}")

    # -- warm-start re-fit on the enlarged dataset --------------------------
    res = model.fit(max_iters=20)
    print(f"warm re-fit: bound={-res.f:.2f} in {res.n_iters} SCG iters")
    return err, -res.f


if __name__ == "__main__":
    main()
