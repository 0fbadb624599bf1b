"""Build and load the hand-written CUDA kernels.

Each ``src/repro_torch/csrc/<name>.cu`` is compiled by ``nvcc`` into a shared
library with a plain C interface, ``build/kernels/lib<name>-<hash>.so`` at
the repository root, and loaded with ``ctypes``.  The hash is of the source,
so an edited source builds anew and a stale library is never loaded.

Nothing here runs at import time: a kernel is built at its first CUDA call
(or by :func:`build_all`, which compiles every source in parallel), so the
CPU tests import every module on a machine without ``nvcc``.  The launch
helpers the wrappers share (stream, error check, the map kernels' grid
plans) live here too.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading

CSRC = pathlib.Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

_LIBS: dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError(
            "nvcc not found (PATH or /usr/local/cuda/bin): the CUDA kernels "
            "of repro_torch are built from source at first use")
    return nvcc


def _target(name: str) -> pathlib.Path:
    digest = hashlib.sha1((CSRC / f"{name}.cu").read_bytes()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def _start(name: str):
    """Start ``nvcc`` for one source; returns (process, tmp, target) or None
    when the library for this exact source is already built."""
    out = _target(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-Xptxas", "-v", "-o", str(tmp),
           str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish(name: str, job) -> str:
    """Wait for one build; move it into place.  Returns nvcc's output."""
    if job is None:
        return ""
    proc, tmp, out = job
    log, _ = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
    os.replace(tmp, out)
    (BUILD_DIR / f"{name}.ptxas.txt").write_text(log)
    return log


def build_all() -> dict[str, str]:
    """Compile every kernel source in parallel (one ``nvcc`` each, all started
    together); returns ``{name: nvcc output}``."""
    jobs = {n: _start(n) for n in sorted(p.stem for p in CSRC.glob("*.cu"))}
    return {n: _finish(n, job) for n, job in jobs.items()}


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            _finish(name, _start(name))
            lib = ctypes.CDLL(str(_target(name)))
            _LIBS[name] = lib
        return lib


def operand(t, dtype):
    """``t`` in ``dtype`` and contiguous, as a kernel takes it: ``t`` itself
    when it already is (no copy, no launch)."""
    return t if t.dtype == dtype and t.is_contiguous() else t.to(dtype).contiguous()


def stream_handle(device) -> int:
    """PyTorch's current CUDA stream on ``device``, as the C ``cudaStream_t``."""
    import torch

    return torch.cuda.current_stream(device).cuda_stream


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    import torch

    return torch.cuda.get_device_properties(index).multi_processor_count


def sm_count(device) -> int:
    """The SM count of a CUDA ``device``, looked up once per device."""
    import torch

    index = torch.device(device).index
    return _sm_count(torch.cuda.current_device() if index is None else index)


def fill_plan(n: int, m: int, sms: int, tile: int, rows: int
              ) -> tuple[int, int, int]:
    """Work split of a map kernel whose blocks fill the card once, its units
    each owning one upper ``tile``×``tile`` block of an (m, m) statistic
    and one slice of the n rows: as many n-slices as fill the ``sms`` block
    slots once (the SM count times the blocks an SM holds; at least one
    slice), the slices summed afterwards in a fixed order.  Returns (upper
    tiles, n-slices, rows per slice, a multiple of ``rows``).  The units go
    on gridDim.x, one block each (past ``sms`` upper tiles the card runs
    them in several waves), so no m is refused."""
    nts = -(-m // tile)
    n_tiles = nts * (nts + 1) // 2
    chunks = max(1, -(-n // rows))
    n_slices = max(1, min(chunks, sms // n_tiles))
    per_slice = -(-chunks // n_slices) * rows
    return n_tiles, max(1, -(-n // per_slice)), per_slice


def row_flags(needs) -> int:
    """The map backward kernels' row outputs wanted, from a Function's
    ``needs_input_grad`` (inputs 3, 4, 5: x / mu, y / s, w): bits 1, 2, 4."""
    return (1 if needs[3] else 0) | (2 if needs[4] else 0) \
        | (4 if needs[5] else 0)


def check(name: str, err: int) -> None:
    """Raise if a launcher returned a non-zero ``cudaError_t``."""
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"cudaError_t {err}")
