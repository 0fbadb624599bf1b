"""The port stands alone: no JAX, no ``repro``, no build at import, and no
silent CPU fallback for the entry points."""
import ast
import os
import pathlib
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FORBIDDEN = ("jax", "jaxlib", "repro")


def _port_files():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported(path: pathlib.Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_repro_imports(path):
    bad = [m for m in _imported(path) if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path} imports {bad}"


def _run(code: str, env_extra=None, **kw):
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), **(env_extra or {})}
    return subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120, **kw)


def test_import_leaves_jax_out():
    res = _run("import sys, repro_torch, repro_torch.convert, "
               "repro_torch.configs, repro_torch.data, "
               "repro_torch.core.gplvm, repro_torch.core.scg, "
               "repro_torch.kernels.reg_stats.kernel, "
               "repro_torch.kernels.psi_stats.kernel, "
               "repro_torch.kernels.predict.kernel, "
               "repro_torch.kernels.flash_attention.kernel, "
               "repro_torch.models.transformer, repro_torch.train.steps, "
               "repro_torch.configs.llama3p2_1b, "
               "repro_torch.core.distributed, repro_torch.data.stream, "
               "repro_torch.distributed.fault, repro_torch.launch.mesh, "
               "repro_torch.examples.quickstart, "
               "repro_torch.examples.serve_sgpr, "
               "repro_torch.examples.distributed_sgpr; "
               "bad = [m for m in sys.modules if m.split('.')[0] in "
               "('jax', 'repro')]; print(bad); assert not bad")
    assert res.returncode == 0, res.stdout + res.stderr


def test_kernel_modules_import_without_nvcc(tmp_path):
    """Importing builds nothing: no nvcc on PATH, and no build directory."""
    code = ("import pathlib, shutil, sys; sys.path.insert(0, 'src'); "
            "from repro_torch.kernels import _build as b; "
            "before = sorted(b.BUILD_DIR.glob('*')) if b.BUILD_DIR.exists() "
            "else None; "
            "import repro_torch.kernels.reg_stats.ops, "
            "repro_torch.kernels.psi_stats.ops, "
            "repro_torch.kernels.predict.ops, "
            "repro_torch.kernels.flash_attention.ops, "
            "repro_torch.models.transformer, repro_torch.train.steps, "
            "repro_torch; "
            "assert shutil.which('nvcc') is None; "
            "after = sorted(b.BUILD_DIR.glob('*')) if b.BUILD_DIR.exists() "
            "else None; assert before == after, (before, after)")
    res = _run(code, env_extra={"PATH": str(tmp_path)}, cwd=ROOT)
    assert res.returncode == 0, res.stdout + res.stderr


@pytest.fixture
def no_cuda():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")


def test_entry_points_raise_without_cuda(no_cuda, tmp_path):
    import repro_torch as rt
    from repro_torch.core.stats import partial_stats

    x = np.random.default_rng(0).standard_normal((20, 2))
    y = x[:, :1] ** 2
    with pytest.raises(RuntimeError, match="device='cpu'"):
        rt.SGPR(x, y, num_inducing=4)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        rt.BayesianGPLVM(y, q=1, num_inducing=4)
    model = rt.SGPR(x, y, num_inducing=4, device="cpu")
    state = model.predictive_state()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        rt.PredictEngine(state)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        rt.extract_state(model.params["hyp"], model.params["z"],
                         partial_stats(model.params["hyp"], model.params["z"],
                                       model.y, model.x))
    rt.save_state(tmp_path / "st", state)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        rt.load_state(tmp_path / "st")


def test_lm_entry_points_raise_without_cuda(no_cuda):
    from repro_torch.configs import get_config
    from repro_torch.convert import lm_params_from_numpy
    from repro_torch.models import transformer as tf

    cfg = get_config("llama3.2-1b").reduced()
    gen = torch.Generator().manual_seed(0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tf.init_params(cfg, gen)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tf.init_decode_cache(cfg, 1, 4)
    params = tf.init_params(cfg, gen, device="cpu")
    tree = {"embed": params["embed"].numpy(),
            "final_norm": {"scale": params["final_norm"]["scale"].numpy()},
            "groups": {"g0": {k: {n: a.numpy() for n, a in v.items()}
                              for k, v in params["groups"]["g0"].items()}}}
    with pytest.raises(RuntimeError, match="device='cpu'"):
        lm_params_from_numpy(cfg, tree)
    back = lm_params_from_numpy(cfg, tree, device="cpu")
    assert torch.equal(back["groups"]["g0"]["mlp"]["w_up"],
                       params["groups"]["g0"]["mlp"]["w_up"])
    tree["groups"]["g0"]["mlp"].pop("w_up")
    with pytest.raises(ValueError, match="keys"):
        lm_params_from_numpy(cfg, tree, device="cpu")


def test_chip_smoke_refuses_without_cuda(no_cuda, tmp_path):
    """No card: exit code 2 and nothing on stdout, in the checkout and in a
    directory holding chip_smoke.py alone."""
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    for where in (ROOT, tmp_path):
        res = subprocess.run([sys.executable, str(where / "chip_smoke.py")],
                             capture_output=True, text=True, timeout=120,
                             cwd=where)
        assert res.returncode == 2 and res.stdout == "", res.stderr


def test_build_needs_nvcc(tmp_path, monkeypatch):
    from repro_torch.kernels import _build

    if os.path.exists("/usr/local/cuda/bin/nvcc"):
        pytest.skip("this machine has nvcc")
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build._nvcc()
