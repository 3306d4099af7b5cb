"""Self-speculative decoding via nested-k sparse codes.

Ported from the JAX package's ``repro/serve/speculative.py``. The top-k'
entries of a stored top-k code are the global top-k' code
(``core/sparse.py::sub_k``), so the same weights and the same cache give a
draft model for free. ``SpeculativeDecodeEngine`` is a tick of the paged
engine in four steps:

  1. **draft** — ``draft_len`` batched decode steps with ``sfa_draft_k``
     set: the backend reads the k'-wide sub-codes (the ``cuda`` backend
     narrows the pools with ``sub_k``, ``cuda_fm`` narrows the query). The
     draft K/V writes land at positions L..L+J-1 and are provisional.
  2. **verify** — one full-k pass per live slot (``verify_step``): the
     C = draft_len + 1 tokens [pending, d_1..d_J] are written at L..L+J with
     full-k codes (over the draft writes) and every query is scored at its
     own causal length through the backend's ``verify`` (one launch of the
     multi-query kernel per layer on ``cuda``).
  3. **accept** — with ``tg[j] = argmax(logits[j])``, the longest prefix
     with ``d_{j+1} == tg[j]`` is accepted, then the bonus token ``tg[m]``:
     at least one token a tick, each the token the non-speculative engine
     would have produced.
  4. **rewind** — reads are length-masked and later writes overwrite in
     order, so nothing is rolled back but the length and the pages
     allocated for the rejected lookahead.

Greedy only: the acceptance rule compares argmaxes, so ``temperature > 0``
is refused.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.model import Model, decode_step, verify_step
from repro_torch.serve.engine import PagedDecodeEngine, PagedEngineConfig


@dataclasses.dataclass
class SpeculativeEngineConfig(PagedEngineConfig):
    draft_len: int = 4               # J: drafted tokens per engine tick
    # draft-pass k' (None = max(1, sfa_k // 4))
    draft_k: Optional[int] = None


class SpeculativeDecodeEngine(PagedDecodeEngine):
    """The paged engine with draft / verify / accept / rewind in place of
    its single decode step. Scheduling (admission, chunked prefill,
    preemption by recompute) is inherited: after every tick ``lengths =
    prompt + emitted - 1`` with the last emitted token pending, so a
    preempted request resumes through the base engine's replay."""

    def __init__(self, params: Model, cfg: ModelConfig, ecfg: SpeculativeEngineConfig,
                 device=None):
        a = cfg.attention
        if a is None or a.sfa_k is None:
            raise ValueError(
                "speculative decoding drafts by re-thresholding stored top-k "
                "codes (sub_k): the config must set attention.sfa_k")
        if a.mla is not None:
            raise NotImplementedError(
                "speculative decoding does not cover MLA caches (no multi-token "
                "verify path through the latent cache)")
        if ecfg.temperature > 0:
            raise ValueError("speculative decoding is greedy-only: the acceptance "
                             "rule compares argmaxes (temperature must be 0)")
        if ecfg.draft_len < 1:
            raise ValueError(f"draft_len must be >= 1, got {ecfg.draft_len}")
        super().__init__(params, cfg, ecfg, device=device)
        dk = ecfg.draft_k if ecfg.draft_k is not None else max(1, a.sfa_k // 4)
        if not 1 <= dk <= a.sfa_k:
            raise ValueError(f"draft_k must be in [1, sfa_k={a.sfa_k}], got {dk}")
        self.draft_k = dk
        # self.cfg carries the decode_backend override the base applied
        self.draft_cfg = dataclasses.replace(self.cfg, attention=dataclasses.replace(
            self.cfg.attention, sfa_draft_k=dk))
        self._spec = {"ticks": 0, "drafted": 0, "accepted": 0, "emitted": 0}

    @property
    def spec_stats(self) -> dict:
        """``alpha`` = accepted drafts / drafted; ``acc_per_step`` = emitted
        tokens per tick (>= 1: the bonus token)."""
        s = dict(self._spec)
        s["alpha"] = s["accepted"] / max(s["drafted"], 1)
        s["acc_per_step"] = s["emitted"] / max(s["ticks"], 1)
        return s

    def _decode_page_span(self, slot: int):
        # draft writes reach L + J - 1 and verify writes L + J; positions
        # past the block table go to the trash page, never emitted
        page = self.ecfg.page_size
        first = int(self.lengths[slot])
        last = min(first + self.ecfg.draft_len, self.max_pages * page - 1)
        return range(first // page, last // page + 1)

    def _rewind(self, slot: int):
        """Return the pages past the accepted length to the free list."""
        keep = (int(self.lengths[slot]) - 1) // self.ecfg.page_size
        row = self.bt[slot]
        for j in range(keep + 1, self.max_pages):
            if row[j]:
                self.free_pages.append(int(row[j]))
                row[j] = 0
                self._bt_dirty = True

    def _decode_tick(self) -> dict[int, int]:
        if not self.live.any():
            return {}
        live_before = self.live.copy()
        self._push_bt()
        J = self.ecfg.draft_len
        # slot state (lengths, last_token) is committed only at acceptance
        t0 = self.last_token.cpu().numpy().astype(np.int64)
        cur = self.last_token
        drafts = np.zeros((J, self.ecfg.max_slots), np.int64)
        for j in range(J):
            logits, self.caches = decode_step(self.params, cur, self.caches,
                                              self._decode_lengths(j), self.draft_cfg)
            cur = self._sample(logits)
            drafts[j] = cur.cpu().numpy()
        out = {}
        self._spec["ticks"] += 1
        new_last = t0.copy()
        for slot in np.where(live_before)[0]:
            slot = int(slot)
            L = int(self.lengths[slot])
            toks = np.concatenate([t0[slot:slot + 1], drafts[:, slot]])
            logits, self.caches = verify_step(self.params, toks[None, :], self.caches,
                                              L, slot, self.cfg)
            tg = self._sample(logits).cpu().numpy().astype(np.int64)   # (C,)
            m = 0
            while m < J and drafts[m, slot] == tg[m]:
                m += 1
            self._spec["drafted"] += J
            self._spec["accepted"] += m
            rid = int(self.slot_rid[slot])
            emitted = 0
            # each token replays the base engine's checks: EOS, budget and
            # max_len cut the accepted run where plain ticks would stop
            for i in range(m + 1):
                t = int(tg[i])
                out[rid] = t
                self.outputs[rid].append(t)
                self.budgets[slot] -= 1
                emitted += 1
                self._spec["emitted"] += 1
                new_last[slot] = t
                if (t == self.ecfg.eos_id or self.budgets[slot] <= 0
                        or L + emitted >= self.ecfg.max_len):
                    self._finish(slot)
                    break
            self.lengths[slot] = L + emitted
            if self.live[slot]:
                self._rewind(slot)
        self.last_token = torch.as_tensor(new_last, device=self.device)
        return out
