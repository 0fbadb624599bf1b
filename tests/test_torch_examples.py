"""The port's examples (``repro_torch.examples``) run on the CPU at their own
sizes: quickstart and serve_sgpr in this process (serve_sgpr asserts that
the served posterior is the model's own to 1e-9), distributed_sgpr on 2
spawned gloo ranks, each rank printing and returning the same bounds."""
import datetime
import json
import pathlib

import numpy as np
import torch
import torch.distributed as dist

from test_torch_spawn import spawn_ranks


def test_quickstart(capsys):
    from repro_torch.examples import quickstart

    rmse = quickstart.main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert "SGPR fit: bound=" in out and "2-sigma coverage" in out
    assert rmse < 0.05


def test_serve_sgpr(capsys):
    from repro_torch.examples import serve_sgpr

    assert serve_sgpr.main(["--device", "cpu"]) < 0.2
    assert "match the training-side predict" in capsys.readouterr().out


def _example_rank(rank, world, store_path, out_dir):
    torch.set_num_threads(1)   # ranks share the cores: no oversubscription
    from repro_torch.examples import distributed_sgpr
    from repro_torch.launch import make_data_group

    make_data_group("cpu", store=dist.FileStore(store_path, world), rank=rank,
                    world_size=world, timeout=datetime.timedelta(seconds=60))
    bounds = distributed_sgpr.main(["--device", "cpu"])
    (pathlib.Path(out_dir) / f"rank{rank}.json").write_text(json.dumps(bounds))
    dist.destroy_process_group()


def test_distributed_sgpr_on_two_gloo_ranks(tmp_path):
    codes, _ = spawn_ranks(_example_rank, 2, tmp_path)
    assert codes == [0, 0], codes
    b = [json.loads((tmp_path / f"rank{r}.json").read_text()) for r in (0, 1)]
    assert b[0] == b[1], "the ranks took different SCG paths"
    initial, final = b[0]
    assert np.isfinite(final) and final > initial
