"""``spawn_ranks``, the one helper that runs the port's distributed tests'
ranks in spawned processes, and its own test: every rank's exit code comes
back, and a rank still running at the deadline is killed and reported as
None."""
import pathlib
import time

import torch.multiprocessing as mp

RANK_TIMEOUT_S = 120


def spawn_ranks(fn, world, tmp_path, timeout=RANK_TIMEOUT_S):
    """Run ``fn(rank, world, store_path, tmp_path)`` in ``world`` spawned
    processes; returns their exit codes (None: still running at the
    timeout, then killed) and the seconds they took."""
    ctx = mp.get_context("spawn")
    store = str(pathlib.Path(tmp_path) / "store")
    procs = [ctx.Process(target=fn, args=(r, world, store, str(tmp_path)))
             for r in range(world)]
    t0 = time.monotonic()
    for p in procs:
        p.start()
    for p in procs:
        p.join(max(0.0, timeout - (time.monotonic() - t0)))
    codes = [p.exitcode for p in procs]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    return codes, time.monotonic() - t0


def _exits_fails_or_hangs(rank, world, store_path, out_dir):
    if rank == 1:
        raise SystemExit(3)
    if rank == 2:
        time.sleep(3600)
    (pathlib.Path(out_dir) / f"rank{rank}").touch()


def test_spawn_ranks_returns_exit_codes_and_kills_at_the_timeout(tmp_path):
    codes, took = spawn_ranks(_exits_fails_or_hangs, 3, tmp_path, timeout=20)
    assert codes == [0, 3, None]
    assert (tmp_path / "rank0").exists()
    assert 20 <= took < 60
