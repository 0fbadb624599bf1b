"""The port's LM trainer (``repro_torch.launch.train``) on the CPU:
resume equivalence, as ``tests/test_checkpoint_fault.py`` checks the JAX
package's (on ``mamba2-370m``, reduced, its arch), and train states
crossing between the two packages' trainers.

Across the packages both trainers read the JAX token stream (the port's
``TokenStream`` draws other tokens): the port's trainer gets it through a
stand-in class.  Losses are held at 1e-4 relative, the tolerance of
``tests/test_checkpoint_fault.py``.
"""
import functools

import jax
import numpy as np
import pytest
import torch

from repro.checkpoint import checkpoint as j_ckpt
from repro.configs import all_configs as j_all_configs
from repro.data.tokens import TokenStream as JTokenStream
from repro.launch.train import main as j_train_main
from repro.train import steps as j_steps
from repro_torch.launch import train

TOL = 1e-4
ARCH_ARGS = ["--reduced", "--batch", "2", "--seq", "32"]
ARGS = ["--arch", "mamba2-370m"] + ARCH_ARGS
# --compress-grads keeps llama3.2-1b: on 6 steps of this stream mamba2's
# loss does not fall, in either package (their losses agree).
COMPRESS_ARGS = ["--arch", "llama3.2-1b"] + ARCH_ARGS


class JaxStream:
    """The JAX package's token stream, its ``host_batch`` handed to the
    port's trainer as tensors."""

    def __init__(self, vocab_size, seq_len, global_batch, seed=0,
                 device=None):
        self._stream = JTokenStream(vocab_size, seq_len, global_batch,
                                    seed=seed)
        self.device = device

    def batch(self, step):
        return {k: torch.from_numpy(np.array(v)).to(self.device)
                for k, v in self._stream.host_batch(step).items()}


def _port(argv, ckdir=None, args=ARGS):
    extra = ["--ckpt-dir", str(ckdir)] if ckdir else []
    return train.main(args + argv + extra + ["--device", "cpu"])


def _jax_initial_checkpoint(ckdir, arch="mamba2-370m"):
    """The JAX trainer's initial train state (key 0), written by the JAX
    package's checkpoint module as step 0: a run resuming from it starts
    where the JAX trainer starts."""
    cfg = j_all_configs()[arch].reduced()
    state, _ = j_steps.init_train_state(cfg, jax.random.PRNGKey(0))
    j_ckpt.save(ckdir / "ckpt_step0", state, {"step": 0})


@functools.cache
def _jax_straight(steps: int, compress: bool = False):
    if compress:
        return j_train_main(COMPRESS_ARGS + ["--steps", str(steps),
                                             "--compress-grads"])
    return j_train_main(ARGS + ["--steps", str(steps)])


def test_train_resume_equivalence(tmp_path):
    """Training 8 steps == training 4, restarting from the checkpoint, then
    4 more (the state and the step-addressed stream)."""
    full = _port(["--steps", "8", "--ckpt-every", "100"], tmp_path / "a")
    _port(["--steps", "4", "--ckpt-every", "4"], tmp_path / "b")
    resumed = _port(["--steps", "8", "--ckpt-every", "100"], tmp_path / "b")
    assert len(full) == 8 and len(resumed) == 4
    assert resumed[-1] == pytest.approx(full[-1], rel=TOL)
    assert sorted(p.name for p in (tmp_path / "b").glob("*.npz")) == [
        "ckpt_step4.npz", "ckpt_step8.npz"]


def test_port_resumes_a_jax_checkpoint(tmp_path, monkeypatch):
    """The JAX package's trainer trains 4 steps and checkpoints; the port's
    trainer resumes there: its 4 losses are the JAX straight run's last 4."""
    j_train_main(ARGS + ["--steps", "4", "--ckpt-dir", str(tmp_path),
                         "--ckpt-every", "100"])
    monkeypatch.setattr(train, "TokenStream", JaxStream)
    resumed = _port(["--steps", "8", "--ckpt-every", "100"], tmp_path)
    np.testing.assert_allclose(resumed, _jax_straight(8)[4:], rtol=TOL)


def test_jax_resumes_a_port_checkpoint(tmp_path, monkeypatch):
    """The other way round: from the JAX package's initial state
    (checkpointed at step 0 by its checkpoint module), the port's trainer
    trains 4 steps and checkpoints, and the JAX trainer resumes to 8: the
    port's 4 losses are the JAX straight run's first 4, and the JAX
    trainer's next 4 its last 4."""
    _jax_initial_checkpoint(tmp_path)
    monkeypatch.setattr(train, "TokenStream", JaxStream)
    first = _port(["--steps", "4", "--ckpt-every", "100"], tmp_path)
    then = j_train_main(ARGS + ["--steps", "8", "--ckpt-dir", str(tmp_path),
                                "--ckpt-every", "100"])
    np.testing.assert_allclose(first + then, _jax_straight(8), rtol=TOL)


def test_compress_grads_matches_jax(tmp_path, monkeypatch):
    """``--compress-grads`` (int8 error feedback, the error state carried
    step to step) from the JAX package's initial state on the JAX stream:
    6 losses within 1e-4 of the JAX trainer's, finite and falling."""
    _jax_initial_checkpoint(tmp_path, "llama3.2-1b")
    monkeypatch.setattr(train, "TokenStream", JaxStream)
    got = _port(["--steps", "6", "--compress-grads", "--ckpt-every", "100"],
                tmp_path, args=COMPRESS_ARGS)
    want = _jax_straight(6, compress=True)
    np.testing.assert_allclose(got, want, rtol=TOL)
    assert np.all(np.isfinite(got)) and got[-1] < got[0]
