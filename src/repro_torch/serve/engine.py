"""Batched decode engine: slots, prefill -> decode handoff, typed KV caches.

Ported from the slot engine of the JAX package's ``repro/serve/engine.py``.
A fixed number of slots; each request prefills alone (batch 1) and lands in
a slot of the batched decode cache; every ``step()`` decodes one token for
the whole slot batch — dead slots included, at their frozen lengths, as in
the JAX engine — and frees slots on EOS, budget or ``max_len``. Slot
lengths live on the host (NumPy), so per-slot bookkeeping needs no device
read beyond the sampled tokens.

The engine runs on the card unless the caller passes ``device="cpu"``.
``EngineConfig.decode_backend`` overrides the config's decode backend
("cuda" kernels, "torch" oracle, "auto").
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.kv_cache import cache_nbytes
from repro_torch.models.model import (
    Model, decode_step, default_device, init_decode_caches, insert_slot,
    prefill,
)


@dataclasses.dataclass
class EngineConfig:
    max_slots: int = 8
    max_len: int = 512
    eos_id: int = -1                 # -1: never stop on token
    temperature: float = 0.0         # 0 = greedy
    seed: int = 0
    # None = use cfg.attention.decode_backend; else "torch" | "cuda" | "auto"
    decode_backend: Optional[str] = None


class DecodeEngine:
    def __init__(self, params: Model, cfg: ModelConfig, ecfg: EngineConfig,
                 device=None):
        self.device = default_device(device)
        if params.device.type != self.device.type:
            raise ValueError(f"model parameters are on {params.device}, the "
                             f"engine on {self.device}")
        if ecfg.decode_backend is not None and cfg.attention is not None:
            cfg = dataclasses.replace(cfg, attention=dataclasses.replace(
                cfg.attention, decode_backend=ecfg.decode_backend))
        self.params = params
        self.cfg = cfg
        self.ecfg = ecfg
        self.caches = init_decode_caches(cfg, ecfg.max_slots, ecfg.max_len,
                                         device=self.device)
        self.lengths = np.zeros((ecfg.max_slots,), np.int64)
        self.last_token = torch.zeros((ecfg.max_slots,), dtype=torch.long,
                                      device=self.device)
        self.live = np.zeros((ecfg.max_slots,), bool)
        self.outputs: list[list[int]] = [[] for _ in range(ecfg.max_slots)]
        self.budgets = np.zeros((ecfg.max_slots,), np.int64)
        self._gen = torch.Generator(device=self.device).manual_seed(ecfg.seed)

    def cache_bytes(self) -> int:
        """At-rest bytes of the engine's KV caches."""
        return cache_nbytes(self.caches)

    def _sample(self, logits):
        """Greedy at temperature <= 0 (first max wins, as jnp.argmax), else
        temperature-scaled categorical from the engine's generator."""
        if self.ecfg.temperature <= 0:
            return torch.argmax(logits, dim=-1)
        probs = torch.softmax(logits / self.ecfg.temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=self._gen)[:, 0]

    def add_request(self, prompt: np.ndarray, max_new_tokens: int = 32) -> int:
        if max_new_tokens < 1:
            raise ValueError(f"max_new_tokens must be >= 1, got {max_new_tokens}")
        free = np.where(~self.live)[0]
        if len(free) == 0:
            raise RuntimeError("no free slots")
        slot = int(free[0])
        n = int(prompt.shape[0])
        if n >= self.ecfg.max_len:
            raise ValueError(
                f"prompt is {n} tokens but max_len is {self.ecfg.max_len}: the "
                f"engine needs at least one free cache position past the prompt")
        tokens = torch.as_tensor(np.asarray(prompt)[None, :], dtype=torch.long,
                                 device=self.device)
        logits, one_caches = prefill(self.params, {"tokens": tokens}, self.cfg)
        insert_slot(self.caches, one_caches, slot=slot, max_len=self.ecfg.max_len)
        tok = int(self._sample(logits)[0])
        self.lengths[slot] = n
        self.last_token[slot] = tok
        self.outputs[slot] = [tok]
        self.budgets[slot] = max_new_tokens - 1
        # a request whose budget is spent at once, or whose first token is
        # EOS, never goes live
        self.live[slot] = self.budgets[slot] > 0 and tok != self.ecfg.eos_id
        return slot

    def step(self) -> dict[int, int]:
        """Decode one token for every slot; returns {live slot: token}."""
        if not self.live.any():
            return {}
        live_before = self.live.copy()
        logits, self.caches = decode_step(
            self.params, self.last_token, self.caches,
            torch.as_tensor(self.lengths, device=self.device), self.cfg)
        toks = self._sample(logits)
        toks_host = toks.cpu().numpy()
        # every slot that decoded gained one cache entry; bump before the
        # free checks so a freed slot is frozen at its true length
        self.lengths = self.lengths + live_before.astype(np.int64)
        out = {}
        for slot in np.where(live_before)[0]:
            t = int(toks_host[slot])
            out[int(slot)] = t
            self.outputs[slot].append(t)
            self.budgets[slot] -= 1
            if (t == self.ecfg.eos_id or self.budgets[slot] <= 0
                    or int(self.lengths[slot]) >= self.ecfg.max_len):
                self.live[slot] = False
        self.last_token = toks
        return out

    def generate(self, prompt: np.ndarray, max_new_tokens: int = 32) -> list[int]:
        """Single-request convenience wrapper."""
        slot = self.add_request(prompt, max_new_tokens)
        while self.live[slot]:
            self.step()
        return self.outputs[slot]
