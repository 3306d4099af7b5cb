"""The port's Markov batches against the JAX package's: bit-equal for a few
steps on a fresh transition-matrix cache and on a warm one, and the matrix
built once per (vocab, seed), where the reference rebuilds it on every
call."""
import numpy as np
import pytest

from repro.data.pipeline import DataConfig as JaxDataConfig
from repro.data.pipeline import markov_batch as jax_markov_batch
from repro_torch.data import DataConfig, markov_batch
from repro_torch.data import pipeline


@pytest.mark.parametrize("vocab,seq_len,batch,seed", [(256, 40, 2, 0), (50_257, 64, 3, 5)])
def test_markov_batches_equal_the_reference_fresh_and_warm(vocab, seq_len, batch, seed,
                                                           monkeypatch):
    monkeypatch.setattr(pipeline, "_MARKOV_CACHE", {})
    cfg = DataConfig(vocab_size=vocab, seq_len=seq_len, global_batch=batch, seed=seed)
    jcfg = JaxDataConfig(vocab_size=vocab, seq_len=seq_len, global_batch=batch, seed=seed)
    for step in (0, 1, 7, 0):                 # step 0 first on a fresh cache, last on a warm one
        got, want = markov_batch(cfg, step), jax_markov_batch(jcfg, step)
        for key in ("tokens", "labels"):
            assert got[key].dtype == want[key].dtype
            np.testing.assert_array_equal(got[key], want[key], err_msg=f"{key} step {step}")


def test_markov_matrix_is_built_once(monkeypatch):
    monkeypatch.setattr(pipeline, "_MARKOV_CACHE", {})
    calls = []
    build = pipeline._markov_matrix

    def counted(*args, **kwargs):
        calls.append(args)
        return build(*args, **kwargs)

    monkeypatch.setattr(pipeline, "_markov_matrix", counted)
    cfg = DataConfig(vocab_size=300, seq_len=16, global_batch=2, seed=1)
    for step in range(4):
        markov_batch(cfg, step)
    assert calls == [(300, 1)]
    markov_batch(DataConfig(vocab_size=300, seq_len=16, global_batch=2, seed=2), 0)
    assert calls == [(300, 1), (300, 2)]
