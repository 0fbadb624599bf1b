"""The port's token stream: the four properties of
``tests/test_data_pipeline.py``, mirrored, and its Zipf draw.  Its draws
are not ``jax.random``'s (tests that hold the model against the JAX
package feed both the JAX stream's tokens); ``zipf_logits`` is the JAX
package's, number for number."""
import numpy as np
import pytest

from repro.data.tokens import zipf_logits as j_zipf_logits
from repro_torch.data.tokens import TokenStream, zipf_logits


def _stream(**kw):
    return TokenStream(device="cpu", **kw)


def test_batch_is_step_addressed():
    s1 = _stream(vocab_size=1000, seq_len=32, global_batch=4, seed=7)
    s2 = _stream(vocab_size=1000, seq_len=32, global_batch=4, seed=7)
    for step in (0, 5, 1000):
        a = s1.host_batch(step)
        b = s2.host_batch(step)
        np.testing.assert_array_equal(a["tokens"], b["tokens"])
        np.testing.assert_array_equal(a["labels"], b["labels"])
    # out of order, and another seed
    np.testing.assert_array_equal(s1.host_batch(5)["tokens"],
                                  s2.host_batch(5)["tokens"])
    other = _stream(vocab_size=1000, seq_len=32, global_batch=4, seed=8)
    assert not np.array_equal(other.host_batch(5)["tokens"],
                              s1.host_batch(5)["tokens"])


def test_labels_are_shifted_tokens():
    s = _stream(vocab_size=512, seq_len=16, global_batch=2, seed=0)
    b = s.host_batch(3)
    assert b["tokens"].dtype == np.int32 and b["tokens"].shape == (2, 16)
    np.testing.assert_array_equal(b["tokens"][:, 1:], b["labels"][:, :-1])


def test_steps_differ_and_in_range():
    s = _stream(vocab_size=300, seq_len=64, global_batch=2, seed=1)
    a = s.host_batch(0)
    b = s.host_batch(1)
    assert not np.array_equal(a["tokens"], b["tokens"])
    assert a["tokens"].min() >= 0 and a["tokens"].max() < 300


def test_copy_structure_learnable():
    """Half the rows repeat their first half."""
    s = _stream(vocab_size=100, seq_len=64, global_batch=64, seed=2)
    b = s.host_batch(0)
    full = np.concatenate([b["tokens"], b["labels"][:, -1:]], axis=1)
    half = full.shape[1] // 2
    rep_rows = np.mean([
        np.array_equal(r[:half], r[half:2 * half]) for r in full])
    assert 0.3 < rep_rows < 0.7


@pytest.mark.parametrize("vocab", [1, 100, 128_256])
def test_zipf_logits_are_jax_packages(vocab):
    np.testing.assert_array_equal(zipf_logits(vocab), j_zipf_logits(vocab))


def test_draws_follow_the_zipf_unigram():
    """The first halves of 256 rows of 513 tokens (the repeated halves
    would count twice): the five most frequent ranks' shares within 5
    standard errors of the Zipf probabilities."""
    s = _stream(vocab_size=100, seq_len=512, global_batch=256, seed=3)
    b = s.host_batch(0)
    draws = b["tokens"][:, :256].ravel()
    p = np.exp(zipf_logits(100))
    share = np.bincount(draws, minlength=100) / draws.size
    se = np.sqrt(p * (1 - p) / draws.size)
    assert np.all(np.abs(share[:5] - p[:5]) < 5 * se[:5]), (share[:5], p[:5])
