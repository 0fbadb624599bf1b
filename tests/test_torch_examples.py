"""The port's examples (``repro_torch.examples``) run on the CPU at their own
sizes: quickstart, serve_sgpr and svi_sgpr in this process (serve_sgpr
asserts that the served posterior is the model's own to 1e-9; svi_sgpr's
SVI must raise the exact bound), distributed_sgpr on 2 spawned gloo ranks,
each rank printing and returning the same bounds, flight_scale --tiny
in this process and on 2 spawned gloo ranks (the same bound and RMSE on
every rank), and gplvm_embedding --tiny (the classes separate in the
top two ARD dimensions; the embedding lands where the caller asks),
kernel_zoo (the composite beats SE-ARD's bound and serves the same answers
after a save/load round trip), online_update (incremental updates equal
a full rebuild to 1e-8), ensemble_serve (a bf16 fleet's mixture within
0.2 of the truth, 64 draws within 6 standard errors of the mean) and
serve_frontend (every response of a burst and a hot swap bitwise its
generation's engine), and lm_pretrain at 8 steps (trains, "crashes" and
resumes from its checkpoint in the directory the caller names)."""
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


def test_svi_sgpr(capsys):
    from repro_torch.examples import svi_sgpr

    b0, b1, rmse = svi_sgpr.main(["--device", "cpu"])
    assert "SGPR fit_svi: est. bound=" in capsys.readouterr().out
    assert b1 > b0 and rmse < 0.05


def test_flight_scale_tiny(capsys):
    from repro_torch.examples import flight_scale

    bound, rmse = flight_scale.main(["--tiny", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "10 SVI steps" in out and "served 4,096 streamed queries" in out
    assert np.isfinite(bound) and rmse < 1.0


def _flight_rank(rank, world, store_path, out_dir):
    torch.set_num_threads(1)   # ranks share the cores: no oversubscription
    from repro_torch.examples import flight_scale
    from repro_torch.launch import make_data_group

    make_data_group("cpu", store=dist.FileStore(store_path, world), rank=rank,
                    world_size=world, timeout=datetime.timedelta(seconds=60))
    out = flight_scale.main(["--tiny", "--device", "cpu"])
    (pathlib.Path(out_dir) / f"rank{rank}.json").write_text(json.dumps(out))
    dist.destroy_process_group()


def test_flight_scale_tiny_on_two_gloo_ranks(tmp_path):
    codes, _ = spawn_ranks(_flight_rank, 2, tmp_path)
    assert codes == [0, 0], codes
    out = [json.loads((tmp_path / f"rank{r}.json").read_text()) for r in (0, 1)]
    assert out[0] == out[1], "the ranks disagree"
    assert np.isfinite(out[0][0]) and out[0][1] < 1.0


def test_gplvm_embedding_tiny(capsys, tmp_path):
    from repro_torch.examples import gplvm_embedding

    out = tmp_path / "emb.npy"
    ratio, eff = gplvm_embedding.main(["--tiny", "--device", "cpu",
                                       "--out", str(out)])
    printed = capsys.readouterr().out
    assert "class separation (between/within)" in printed
    assert f"embedding saved to {out}" in printed
    assert np.load(out).shape == (120, 2)
    assert ratio > 2.0 and 1 <= eff <= 4


def test_kernel_zoo(capsys):
    from repro_torch.examples import kernel_zoo

    bounds, rmse = kernel_zoo.main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert 'restored kernel from sidecar: {"kind": "sum"' in out
    assert bounds["composite"] > bounds["se-ard"]
    assert rmse["composite"] < 0.05 and rmse["served"] == rmse["composite"]


def test_online_update(capsys):
    from repro_torch.examples import online_update

    err, bound = online_update.main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert "forgot block 2 -> n=500, blocks held=3" in out
    assert err < 1e-8 and np.isfinite(bound)


def test_ensemble_serve(capsys):
    from repro_torch.examples import ensemble_serve

    rmse, gap, bound = ensemble_serve.main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert "fleet engine: 3 models, storage torch.bfloat16" in out
    assert "ensemble served, sampled, and sanity-checked: OK" in out
    assert rmse < 0.2 and gap < bound


def test_serve_frontend(capsys):
    from repro_torch.examples import serve_frontend

    counters = serve_frontend.main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert "all responses bitwise-match their generation's state: OK" in out
    assert counters["completed"] == 81 and counters["expired"] == 0


def test_lm_pretrain(capsys, tmp_path):
    from repro_torch.examples import lm_pretrain

    ckdir = tmp_path / "ckpt"
    losses = lm_pretrain.main(["--steps", "8", "--device", "cpu",
                               "--ckpt-dir", str(ckdir)])
    out = capsys.readouterr().out
    assert "resumed from" in out and "ckpt_step4" in out
    assert "trained 8 steps total across a restart" in out
    assert len(losses) == 4 and np.all(np.isfinite(losses))
    assert sorted(p.name for p in ckdir.glob("*.npz")) == [
        "ckpt_step4.npz", "ckpt_step8.npz"]
