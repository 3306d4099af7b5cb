"""The port's NIAH data (paper §4.2) against the JAX package's: the same
arguments give the same arrays, and the same logits the same accuracy."""
import numpy as np
import pytest

from repro.data.niah import niah_accuracy as jax_niah_accuracy
from repro.data.niah import niah_batch as jax_niah_batch
from repro_torch.data import niah_accuracy, niah_batch


@pytest.mark.parametrize("vocab,seq_len,batch", [(256, 64, 4), (50_257, 1024, 8),
                                                 (1000, 5, 3), (512, 4, 2)])
@pytest.mark.parametrize("seed,step", [(0, 0), (3, 17), (2**20, 123_457)])
def test_niah_batch_equals_the_reference(vocab, seq_len, batch, seed, step):
    got = niah_batch(vocab, seq_len, batch, seed=seed, step=step)
    want = jax_niah_batch(vocab, seq_len, batch, seed=seed, step=step)
    assert set(got) == set(want)
    for key in want:
        assert got[key].dtype == want[key].dtype, key
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


def test_niah_batch_other_token_map():
    got = niah_batch(400, 32, 5, seed=1, step=2, n_keys=16, n_vals=8)
    want = jax_niah_batch(400, 32, 5, seed=1, step=2, n_keys=16, n_vals=8)
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


def test_niah_batch_refuses_a_vocab_too_small():
    with pytest.raises(ValueError, match="too small"):
        niah_batch(100, 16, 2, seed=0, step=0)


def test_niah_accuracy_equals_the_reference():
    rs = np.random.RandomState(0)
    b = niah_batch(300, 48, 16, seed=4, step=1)
    logits = rs.randn(16, 300).astype(np.float32)
    logits[np.arange(9), b["answer"][:9]] = 10.0
    got = niah_accuracy(logits, b["answer"])
    assert got == jax_niah_accuracy(logits, b["answer"]) == 9 / 16
