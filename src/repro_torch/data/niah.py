"""Needle-in-a-Haystack synthetic data (paper §4.2, RULER-style).

The port's own copy of the JAX package's ``repro/data/niah.py`` (pure
numpy): the same arguments give the same arrays. The haystack is a repeated
filler token ('#'); one (key, value) needle sits at a random depth, and the
sequence ends with a query mark, the key and its value, so the model must
predict the value token at the second-to-last position.

Token map, at the top of the vocab: FILLER = vocab - 1, QUERY_MARK =
vocab - 2, then ``n_keys`` KEY tokens below it and ``n_vals`` VALUE tokens
below those.
"""
from __future__ import annotations

import numpy as np


def niah_batch(vocab: int, seq_len: int, batch: int, *, seed: int, step: int,
               n_keys: int = 64, n_vals: int = 64):
    """{"tokens", "labels"} int32 (batch, seq_len) with full next-token
    labels (-1 at the end), and "answer" (batch,) the value token."""
    rs = np.random.RandomState((seed * 104729 + step) % (2**31))
    filler = vocab - 1
    qmark = vocab - 2
    key_base = vocab - 2 - n_keys
    val_base = key_base - n_vals
    if val_base <= 0:
        raise ValueError(f"vocab {vocab} too small for the NIAH token map "
                         f"({n_keys} keys, {n_vals} values)")
    toks = np.full((batch, seq_len), filler, np.int32)
    keys = rs.randint(0, n_keys, size=batch)
    vals = rs.randint(0, n_vals, size=batch)
    depth = rs.randint(0, max(1, seq_len - 4), size=batch)
    rows = np.arange(batch)
    toks[rows, depth] = key_base + keys
    toks[rows, depth + 1] = val_base + vals
    toks[:, seq_len - 3] = qmark
    toks[:, seq_len - 2] = key_base + keys
    toks[:, seq_len - 1] = val_base + vals          # the gold next token
    # every position supervised: the filler stream is easy to learn, the
    # value at position n-2 is the retrieval signal
    labels = np.concatenate([toks[:, 1:], np.full((batch, 1), -1, np.int32)], axis=1)
    return {"tokens": toks, "labels": labels,
            "answer": (val_base + vals).astype(np.int32)}


def niah_accuracy(logits_last: np.ndarray, answers: np.ndarray) -> float:
    """Share of rows whose argmax of ``logits_last`` (b, vocab), the logits
    at the position that predicts the value, is the answer."""
    return float((np.asarray(logits_last).argmax(-1) == np.asarray(answers)).mean())
