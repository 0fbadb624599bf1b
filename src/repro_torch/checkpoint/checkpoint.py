"""Checkpoint/restore of tensor trees: an ``.npz`` of leaves plus a JSON sidecar.

The on-disk format is the JAX package's (``repro.checkpoint``), so each
package loads the other's files:

* leaves are keyed by their tree path, ``"/"``-joined, where a dataclass
  field is ``"." + name`` (how JAX prints an attribute key) and a dict entry
  is its key: ``.z``, ``.hyp/log_sf2``;
* bfloat16, which npz cannot hold, is stored bit for bit as a ``uint16``
  view and restored through the template's dtype;
* the sidecar is ``{"metadata": {...}, "n_leaves": N}``.

Trees are frozen dataclasses, dicts and lists of tensors (a list entry's
key is its index, as JAX prints it); dataclass fields that
are not tensors or dicts (e.g. a kernel expression) are static and not
saved.  Writes are atomic: temporary files, then rename.  A path whose stem
is ``<base>_step<N>`` rotates: ``save(..., keep=k)`` leaves the k newest
steps of ``<base>``, and :func:`latest` names the newest.
:class:`AsyncCheckpointer` writes on a background thread.
"""
from __future__ import annotations

import dataclasses
import json
import pathlib
import re
import threading

import numpy as np
import torch


def _children(tree):
    """(key, child) pairs of a tree node, or None for a leaf."""
    if isinstance(tree, dict):
        return [(str(k), v) for k, v in sorted(tree.items())]
    if isinstance(tree, list):
        return [(str(i), v) for i, v in enumerate(tree)]
    if dataclasses.is_dataclass(tree):
        return [("." + f.name, getattr(tree, f.name))
                for f in dataclasses.fields(tree)
                if isinstance(getattr(tree, f.name), (torch.Tensor, dict))]
    return None


def _flatten_with_paths(tree, prefix: str = "") -> dict:
    kids = _children(tree)
    if kids is None:
        return {prefix: tree}
    flat = {}
    for key, child in kids:
        flat.update(_flatten_with_paths(child, f"{prefix}/{key}" if prefix
                                        else key))
    return flat


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _to_tensor(arr: np.ndarray, like: torch.Tensor, device) -> torch.Tensor:
    if like.dtype == torch.bfloat16 and arr.dtype == np.uint16:
        t = torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr, order="C")).to(like.dtype)
    return t.to(device)


def _host_leaves(tree) -> dict:
    """The tree's leaves as host arrays, keyed by path; copies, so the
    caller may change its tensors once this returns."""
    return {k: np.array(_to_numpy(v))
            for k, v in _flatten_with_paths(tree).items()}


def save(path: str | pathlib.Path, tree, metadata: dict | None = None,
         keep: int = 3) -> pathlib.Path:
    """Atomic checkpoint write; returns the ``.npz`` path.  Under a
    ``<base>_step<N>`` stem, only the ``keep`` newest steps of ``<base>``
    are left."""
    return _write(pathlib.Path(path), _host_leaves(tree), metadata, keep)


def _write(path: pathlib.Path, flat: dict, metadata, keep: int
           ) -> pathlib.Path:
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(".tmp.npz")
    np.savez(tmp, **flat)
    tmp_meta = path.with_suffix(".tmp.json")
    tmp_meta.write_text(json.dumps({"metadata": metadata or {},
                                    "n_leaves": len(flat)}))
    tmp.rename(path.with_suffix(".npz"))
    tmp_meta.rename(path.with_suffix(".json"))
    _rotate(path.parent, path.stem, keep)
    return path.with_suffix(".npz")


def _step(p: pathlib.Path) -> int:
    return int(re.search(r"_step(\d+)", p.stem).group(1))


def _steps(d: pathlib.Path, base: str) -> list:
    """The ``<base>_step<N>.npz`` files of ``d``, oldest step first."""
    return sorted(d.glob(f"{base}_step*.npz"), key=_step)


def _rotate(d: pathlib.Path, stem: str, keep: int) -> None:
    m = re.match(r"(.*)_step(\d+)$", stem)
    if not m:
        return
    for old in _steps(d, m.group(1))[:-keep]:
        old.unlink(missing_ok=True)
        old.with_suffix(".json").unlink(missing_ok=True)


def latest(d: str | pathlib.Path, base: str = "ckpt") -> pathlib.Path | None:
    """The newest ``<base>_step<N>`` checkpoint of ``d`` (the path without
    suffix), or None."""
    ckpts = _steps(pathlib.Path(d), base)
    return ckpts[-1].with_suffix("") if ckpts else None


class AsyncCheckpointer:
    """Checkpoint writes on one background thread, at most one in flight.

    ``save`` waits for the previous write, copies the tree's leaves to host
    arrays on the caller's thread (the device-to-host copy), starts the
    write and returns: the caller may change its tensors at once.  ``wait``
    joins the write in flight; a write that failed raises there."""

    def __init__(self):
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None

    def save(self, path, tree, metadata=None, keep: int = 3) -> None:
        self.wait()
        flat = _host_leaves(tree)

        def work():
            try:
                _write(pathlib.Path(path), flat, metadata, keep)
            except Exception as e:   # re-raised by wait()
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err


def _unflatten(like, data, device, prefix: str = ""):
    kids = _children(like)
    if kids is None:
        if prefix not in data:
            raise KeyError(f"checkpoint is missing leaf {prefix!r} — wrong "
                           "or partial artifact")
        return _to_tensor(data[prefix], like, device)
    out = {key: _unflatten(child, data, device,
                           f"{prefix}/{key}" if prefix else key)
           for key, child in kids}
    if isinstance(like, dict):
        return {k: out[str(k)] for k in like}
    if isinstance(like, list):
        return [out[str(i)] for i in range(len(like))]
    return dataclasses.replace(like, **{k[1:]: v for k, v in out.items()})


def restore(path: str | pathlib.Path, like, device) -> tuple:
    """Restore into the structure of ``like`` (a tree whose leaves are
    templates, e.g. ``torch.empty(shape, dtype=..., device="meta")``), with
    every leaf on ``device``.  Returns ``(tree, metadata)``."""
    path = pathlib.Path(path)
    meta = json.loads(path.with_suffix(".json").read_text())
    n_like = len(_flatten_with_paths(like))
    n_saved = meta.get("n_leaves")
    if n_saved is not None and n_saved != n_like:
        raise ValueError(
            f"checkpoint {path} holds {n_saved} leaves but the restore "
            f"template has {n_like} — wrong artifact for this tree")
    with np.load(path.with_suffix(".npz")) as data:
        tree = _unflatten(like, data, device)
    return tree, meta["metadata"]
