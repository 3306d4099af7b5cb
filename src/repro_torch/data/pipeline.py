"""Data pipeline: synthetic LM streams and batching.

The port's own copy of the JAX package's ``repro/data/pipeline.py`` (pure
numpy): the same seed and step give the same arrays. No external dataset
ships with the repository, so the streams are structured synthetic corpora
that a learning model must do better on than the unigram floor:

* ``markov`` — an order-1 Markov chain over the vocab with a low-entropy
  transition structure;
* ``copy``   — spaced copy tasks (retrieval-flavoured), labels only on the
  copied span.

Every generator is deterministic in (seed, step, host), so each
data-parallel host can derive its shard without a coordinator.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np


@dataclasses.dataclass
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    kind: str = "markov"           # markov | copy
    seed: int = 0


def _markov_matrix(vocab: int, seed: int, branch: int = 8):
    """Sparse-ish row-stochastic transition matrix (branch successors/token)."""
    rs = np.random.RandomState(seed)
    succ = rs.randint(0, vocab, size=(vocab, branch))
    probs = rs.dirichlet(np.ones(branch) * 0.5, size=vocab)
    return succ, probs


_MARKOV_CACHE: dict = {}


def markov_batch(cfg: DataConfig, step: int, host: int = 0, nhosts: int = 1):
    """One {"tokens", "labels"} batch of int32 (b, seq_len); labels are the
    next token."""
    rs = np.random.RandomState((cfg.seed * 9176 + step * 31 + host) % (2**31))
    key = (cfg.vocab_size, cfg.seed)
    if key not in _MARKOV_CACHE:          # built once per (vocab, seed)
        _MARKOV_CACHE[key] = _markov_matrix(cfg.vocab_size, cfg.seed)
    succ, probs = _MARKOV_CACHE[key]
    b = cfg.global_batch // nhosts
    toks = np.empty((b, cfg.seq_len + 1), np.int32)
    toks[:, 0] = rs.randint(0, cfg.vocab_size, size=b)
    for t in range(cfg.seq_len):
        cur = toks[:, t]
        choice = (rs.random(b)[:, None] > np.cumsum(probs[cur], -1)).sum(-1)
        choice = np.minimum(choice, probs.shape[1] - 1)
        toks[:, t + 1] = succ[cur, choice]
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:].copy()}


def copy_batch(cfg: DataConfig, step: int, host: int = 0, nhosts: int = 1,
               span: int = 16):
    """tokens = [prefix junk | span | junk | SEP | span]; labels (-1
    elsewhere) only on the copied span."""
    rs = np.random.RandomState((cfg.seed * 7919 + step * 17 + host) % (2**31))
    b = cfg.global_batch // nhosts
    n = cfg.seq_len
    sep = cfg.vocab_size - 1
    toks = rs.randint(0, cfg.vocab_size - 2, size=(b, n)).astype(np.int32)
    labels = np.full((b, n), -1, np.int32)
    start = rs.randint(1, max(2, n // 2 - span), size=b)
    for i in range(b):
        s = start[i]
        spanv = toks[i, s:s + span]
        toks[i, n - span - 1] = sep
        toks[i, n - span:] = spanv
        labels[i, n - span - 1:n - 1] = toks[i, n - span:n]
    return {"tokens": toks, "labels": labels}


def batches(cfg: DataConfig, start_step: int = 0, host: int = 0,
            nhosts: int = 1) -> Iterator[dict]:
    fn = markov_batch if cfg.kind == "markov" else copy_batch
    step = start_step
    while True:
        yield fn(cfg, step, host, nhosts)
        step += 1
