"""Distributed sparse-GP inference over a process group, with node
failures mid-optimisation (the paper's §3.2 + §5.2 in one script; torch
copy of ``examples/distributed_sgpr.py``).

One process per data shard.  A group of one:

  PYTHONPATH=src python -m repro_torch.examples.distributed_sgpr

Several ranks on the CPU over gloo (the paper's Map-Reduce on N 'nodes'):

  PYTHONPATH=src torchrun --standalone --nproc-per-node=4 \\
      -m repro_torch.examples.distributed_sgpr --device cpu

Every rank runs the same SCG on the same reduced statistics, so every rank
prints the same bounds; rank 0 prints them.
"""
import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core.flat import Flat
from repro_torch.core.scg import scg
from repro_torch.distributed import FailureSimulator
from repro_torch.examples import device_args
from repro_torch.launch import make_data_group
from repro_torch.train.steps import make_gp_train_step


def main(argv=None):
    args = device_args(__doc__, argv)
    owned = not dist.is_initialized()
    group = make_data_group(args.device)
    try:
        return _run(group, args.device)
    finally:
        if owned:
            dist.destroy_process_group()


def _run(group, device):
    rank = dist.get_rank(group)
    # chunk_size streams each shard's map in 128-row blocks: per-device
    # memory is O(128 * m) regardless of how many rows the shard holds
    # (drop it to None to get the monolithic map; same bound either way).
    eng, step = make_gp_train_step(group, d=1, failure_mode="rescale",
                                   chunk_size=128, device=device)
    say = print if rank == 0 else (lambda *a, **k: None)
    say(f"group: {eng.n_shards} data shards "
        f"({dist.get_backend(group)}, {eng.device})")

    rng = np.random.default_rng(0)
    n = 4000
    x = rng.uniform(-3, 3, size=(n, 2))
    y = (np.sin(x @ np.array([[1.2], [-0.7]]))
         + 0.1 * rng.standard_normal((n, 1)))
    z0 = x[rng.choice(n, 32, replace=False)]

    def t64(a):
        return torch.as_tensor(np.asarray(a, np.float64), device=eng.device)

    params = {"hyp": {"log_sf2": t64(0.0), "log_ell": t64(np.zeros(2)),
                      "log_beta": t64(2.0)},
              "z": t64(z0)}
    data, w = eng.put_data(y=y, mu=x)
    # The same seed on every rank: every rank draws the same mask.
    sim = FailureSimulator(eng.n_shards, rate=0.01, seed=3)
    flat = Flat(params)

    def fg(xf):
        p = flat.unravel(xf)
        fmask = sim.mask()                    # 1% node failures/iteration
        v, (gh, gz) = step(p["hyp"], p["z"], data["mu"], None, data["y"], w,
                           fmask, float(n))
        return float(v), flat.ravel({"hyp": gh, "z": gz})

    v0, _ = fg(flat.ravel(params))
    say(f"initial bound: {-v0:10.2f}")
    res = scg(fg, flat.ravel(params), max_iters=100)
    say(f"final bound:   {-res.f:10.2f}  "
        f"({res.n_evals} map-reduce rounds, node failures @1%/iter, "
        f"rescaled partial sums)")
    return -v0, -res.f


if __name__ == "__main__":
    main()
