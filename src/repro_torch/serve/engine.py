"""Decode engines: slots or pages, prefill -> decode handoff, typed KV caches.

Ported from the JAX package's ``repro/serve/engine.py``:

  * ``DecodeEngine`` — a fixed number of slots; each request prefills alone
    (batch 1) and lands in a slot of the batched decode cache; every
    ``step()`` decodes one token for the whole slot batch — dead slots
    included, at their frozen lengths, as in the JAX engine — and frees
    slots on EOS, budget or ``max_len``. The cache's token axis is
    allocated in multiples of ``decode_cache_token_multiple`` (128 for the
    feature-major image), as in the JAX engine.
  * ``PagedDecodeEngine`` — block-table KV over a shared page pool: pages
    of ``page_size`` tokens allocated on demand from a host free list,
    whole-prompt (``insert_pages``) or chunked prefill (one chunk per tick,
    interleaved with decode), admission FCFS while slots and pages last,
    and, when decode runs out of pages, preemption of the youngest request
    with recompute on resume (greedy streams unchanged). Dead slots decode
    at a past-the-table sentinel length, so their writes land in the trash
    page. Requests are keyed by rid.

Slot lengths and block tables live on the host (NumPy); the block table is
copied to its one device tensor only when it changed. Sampling is shared
(``_SamplerMixin``): greedy at temperature <= 0, else categorical from the
engine's own generator.

A vlm's slot-engine request may carry its patches (``extra_inputs``),
whose prefix counts toward ``max_len``; the paged and speculative engines
take text-only prompts, as the JAX ones do. An encoder-only config has no
decode caches, so no engine takes it. MLA caches (deepseek-v2, headless
latent pools) land whole prompts only: chunked prefill meets the
reference's NotImplementedError at its first chunk, as the JAX engine
does. The recurrent families (jamba, rwkv) serve through the slot engine,
each slot carrying its recurrent state (``core.kv_cache.RecurrentState``,
landed by a plain slot update cast to the cache's dtype, and decoded for
every slot, dead ones included); the paged and speculative engines refuse
them through ``init_paged_decode_caches``, as the reference's do.

The engines run on the card unless the caller passes ``device="cpu"``.
``decode_backend`` in the engine configs overrides the config's decode
backend ("cuda" kernels, "cuda_fm" feature-major kernels, "torch" oracle,
"auto").
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.kv_cache import cache_nbytes, kv_cache_nodes, state_nbytes
from repro_torch.models.attention import decode_cache_token_multiple
from repro_torch.models.model import (
    Model, decode_step, default_device, init_decode_caches, init_paged_decode_caches,
    insert_slot, prefill, prefill_chunk,
)


def _with_decode_backend(cfg: ModelConfig, backend: Optional[str]) -> ModelConfig:
    if backend is not None and cfg.attention is not None:
        cfg = dataclasses.replace(cfg, attention=dataclasses.replace(
            cfg.attention, decode_backend=backend))
    return cfg


class _SamplerMixin:
    """Sampling shared by every engine: greedy at ``temperature <= 0``
    (first max wins, as jnp.argmax), else temperature-scaled categorical
    from the engine's own generator ``self._gen``."""

    def _sample(self, logits):
        if self.ecfg.temperature <= 0:
            return torch.argmax(logits, dim=-1)
        probs = torch.softmax(logits / self.ecfg.temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=self._gen)[:, 0]

    def _check_device(self, params: Model, device):
        self.device = default_device(device)
        if params.device.type != self.device.type:
            raise ValueError(f"model parameters are on {params.device}, the "
                             f"engine on {self.device}")


@dataclasses.dataclass
class EngineConfig:
    max_slots: int = 8
    max_len: int = 512
    eos_id: int = -1                 # -1: never stop on token
    temperature: float = 0.0         # 0 = greedy
    seed: int = 0
    # None = use cfg.attention.decode_backend; else "torch" | "cuda" |
    # "cuda_fm" | "auto"
    decode_backend: Optional[str] = None


class DecodeEngine(_SamplerMixin):
    def __init__(self, params: Model, cfg: ModelConfig, ecfg: EngineConfig,
                 device=None):
        self._check_device(params, device)
        cfg = _with_decode_backend(cfg, ecfg.decode_backend)
        self.params = params
        self.cfg = cfg
        self.ecfg = ecfg
        # the token axis in whole multiples (128 for the feature-major
        # image), as the JAX engine allocates it; max_len stays the cap
        mult = decode_cache_token_multiple(cfg)
        self._cache_len = -(-ecfg.max_len // mult) * mult
        self.caches = init_decode_caches(cfg, ecfg.max_slots, self._cache_len,
                                         device=self.device)
        self.lengths = np.zeros((ecfg.max_slots,), np.int64)
        self.last_token = torch.zeros((ecfg.max_slots,), dtype=torch.long,
                                      device=self.device)
        self.live = np.zeros((ecfg.max_slots,), bool)
        self.outputs: list[list[int]] = [[] for _ in range(ecfg.max_slots)]
        self.budgets = np.zeros((ecfg.max_slots,), np.int64)
        self._gen = torch.Generator(device=self.device).manual_seed(ecfg.seed)

    def cache_bytes(self) -> int:
        """At-rest bytes of the engine's KV caches (recurrent state apart)."""
        return cache_nbytes(self.caches)

    def state_bytes(self) -> int:
        """Bytes of the recurrent (SSM) state the slots carry (0 without)."""
        return state_nbytes(self.caches)

    def add_request(self, prompt: np.ndarray, max_new_tokens: int = 32,
                    extra_inputs: Optional[dict] = None) -> int:
        """Prefill ``prompt`` into a free slot. ``extra_inputs`` holds the
        request's frontend inputs without the batch axis (a vlm's
        ``"patches"`` (prefix_len, input_dim)), whose prefix counts toward
        ``max_len``."""
        if max_new_tokens < 1:
            raise ValueError(f"max_new_tokens must be >= 1, got {max_new_tokens}")
        free = np.where(~self.live)[0]
        if len(free) == 0:
            raise RuntimeError("no free slots")
        slot = int(free[0])
        n = int(prompt.shape[0])
        fe = self.cfg.frontend
        if fe is not None and fe.kind == "patch" and extra_inputs and "patches" in extra_inputs:
            n += fe.prefix_len
        if n >= self.ecfg.max_len:
            raise ValueError(
                f"prompt is {n} tokens (patch-frontend prefix included) but max_len is "
                f"{self.ecfg.max_len}: the engine needs at least one free cache "
                f"position past the prompt to decode")
        batch = {"tokens": torch.as_tensor(np.asarray(prompt)[None, :], dtype=torch.long,
                                           device=self.device)}
        for k, v in (extra_inputs or {}).items():
            batch[k] = torch.as_tensor(np.asarray(v)[None], device=self.device)
        logits, one_caches = prefill(self.params, batch, self.cfg)
        insert_slot(self.caches, one_caches, slot=slot, max_len=self._cache_len)
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

    def generate(self, prompt: np.ndarray, max_new_tokens: int = 32,
                 extra_inputs: Optional[dict] = None) -> list[int]:
        """Single-request convenience wrapper."""
        slot = self.add_request(prompt, max_new_tokens, extra_inputs)
        while self.live[slot]:
            self.step()
        return self.outputs[slot]


# ==========================================================================
# paged engine
# ==========================================================================

@dataclasses.dataclass
class PagedEngineConfig:
    max_slots: int = 8
    max_len: int = 512               # per-request cap (prompt + output)
    page_size: int = 128             # tokens per pool page
    # pool memory budget in bytes (KV pools, all layers). None sizes the
    # pool for full residency (max_slots x max_pages); smaller budgets make
    # admission queue and decode growth preempt (recompute on re-admission)
    mem_budget_bytes: Optional[int] = None
    # prefill granularity: None = whole-prompt prefill landed with
    # insert_pages; an int C = chunked prefill, one C-token chunk per step
    # interleaved with decode
    prefill_chunk: Optional[int] = None
    eos_id: int = -1
    temperature: float = 0.0
    seed: int = 0
    decode_backend: Optional[str] = None


@dataclasses.dataclass
class _PagedRequest:
    rid: int
    prompt: np.ndarray               # tokens to (re)prefill
    max_new: int
    # set on requeue after preemption: the sampled but unwritten token and
    # the remaining budget (greedy recompute resumes exactly)
    resume_token: Optional[int] = None
    budget: Optional[int] = None


class PagedDecodeEngine(_SamplerMixin):
    """Paged/block-KV serving engine (the JAX ``PagedDecodeEngine``).

    One page pool per layer, ``page_size``-token pages allocated on demand
    from a host free list, slots holding block-table rows. Prompts land
    whole (``insert_pages``) or chunked (``prefill_chunk``, one chunk per
    ``step()``); admission queues when slots or pages run out; decode-time
    page exhaustion preempts the youngest live request (recompute on
    resume). Greedy tokens equal the slot ``DecodeEngine``'s; requests are
    keyed by rid.
    """

    def __init__(self, params: Model, cfg: ModelConfig, ecfg: PagedEngineConfig,
                 device=None):
        self._check_device(params, device)
        cfg = _with_decode_backend(cfg, ecfg.decode_backend)
        self.params = params
        self.cfg = cfg
        self.ecfg = ecfg
        page = ecfg.page_size
        self.max_pages = -(-ecfg.max_len // page)
        if ecfg.mem_budget_bytes is None:
            pool = ecfg.max_slots * self.max_pages
        else:
            from repro_torch.serve.kv_cache import paged_page_bytes
            per = paged_page_bytes(cfg, page_size=page)
            pool = max(self.max_pages, ecfg.mem_budget_bytes // max(per, 1))
            pool = min(pool, ecfg.max_slots * self.max_pages)
        # + the reserved trash page 0 (dead-slot decode writes land there)
        self.num_pages = 1 + int(pool)
        self.caches = init_paged_decode_caches(
            cfg, slots=ecfg.max_slots, num_pages=self.num_pages, page_size=page,
            max_pages=self.max_pages, device=self.device)
        self.block_table = kv_cache_nodes(self.caches)[0].block_table
        self.bt = np.zeros((ecfg.max_slots, self.max_pages), np.int32)
        self._bt_dirty = True
        self.free_pages = list(range(self.num_pages - 1, 0, -1))  # pop() = 1
        self.lengths = np.zeros((ecfg.max_slots,), np.int64)
        self.live = np.zeros((ecfg.max_slots,), bool)
        self.last_token = torch.zeros((ecfg.max_slots,), dtype=torch.long,
                                      device=self.device)
        self.budgets = np.zeros((ecfg.max_slots,), np.int64)
        self.slot_rid = np.full((ecfg.max_slots,), -1, np.int64)
        self.slot_seq = np.zeros((ecfg.max_slots,), np.int64)  # admission age
        self.outputs: dict[int, list[int]] = {}
        self.done: dict[int, bool] = {}
        self.queue: list[_PagedRequest] = []
        self._by_rid: dict[int, _PagedRequest] = {}
        self._emitted: dict[int, int] = {}   # first tokens this tick
        self._inflight = None                # chunked prefill in progress
        self._next_rid = 0
        self._seq = 0
        self.preemptions = 0
        self._gen = torch.Generator(device=self.device).manual_seed(ecfg.seed)

    # ------------------------------------------------------------------
    def cache_bytes(self) -> int:
        """At-rest bytes of the paged pools and the block table."""
        return cache_nbytes(self.caches)

    def page_utilization(self) -> float:
        """Fraction of allocatable pool pages holding live data."""
        usable = self.num_pages - 1
        return (usable - len(self.free_pages)) / max(usable, 1)

    @property
    def busy(self) -> bool:
        return bool(self.queue) or self._inflight is not None or bool(self.live.any())

    # ------------------------------------------------------------------
    def add_request(self, prompt: np.ndarray, max_new_tokens: int = 32) -> int:
        if max_new_tokens < 1:
            raise ValueError(f"max_new_tokens must be >= 1, got {max_new_tokens}")
        n = int(prompt.shape[0])
        if n >= self.ecfg.max_len:
            raise ValueError(
                f"prompt is {n} tokens but max_len is {self.ecfg.max_len}: the "
                f"engine needs at least one free cache position past the prompt")
        page = self.ecfg.page_size
        worst = min(n + max_new_tokens, self.ecfg.max_len)
        if -(-worst // page) > self.num_pages - 1:
            raise ValueError(
                f"request needs up to {-(-worst // page)} pages but the pool "
                f"holds {self.num_pages - 1}: raise mem_budget_bytes or lower "
                f"max_new_tokens")
        rid = self._next_rid
        self._next_rid += 1
        self.outputs[rid] = []
        self.done[rid] = False
        self.queue.append(_PagedRequest(rid=rid, prompt=np.asarray(prompt, np.int64),
                                        max_new=max_new_tokens))
        return rid

    # ---- pages and the block table -----------------------------------
    def _push_bt(self):
        """Copy the host block table to its device tensor, which every layer
        of every cache shares, when it changed."""
        if self._bt_dirty:
            self.block_table.copy_(torch.from_numpy(self.bt))
            self._bt_dirty = False

    def _release_slot(self, slot: int):
        self.free_pages.extend(int(p) for p in self.bt[slot] if p)
        self.bt[slot, :] = 0
        self._bt_dirty = True
        self.live[slot] = False
        self.slot_rid[slot] = -1

    def _finish(self, slot: int):
        self.done[int(self.slot_rid[slot])] = True
        self._release_slot(slot)

    def _preempt(self, slot: int) -> _PagedRequest:
        """Evict a live slot. The requeued prompt replays everything already
        in the cache and ``resume_token`` re-seeds the pending (sampled,
        unwritten) token, so greedy streams resume exactly."""
        rid = int(self.slot_rid[slot])
        req = self._by_rid[rid]
        out = self.outputs[rid]
        requeued = _PagedRequest(
            rid=rid, prompt=np.concatenate([req.prompt, np.asarray(out[:-1], np.int64)]),
            max_new=req.max_new, resume_token=out[-1], budget=int(self.budgets[slot]))
        self._release_slot(slot)
        self.preemptions += 1
        return requeued

    # ---- scheduling phases -------------------------------------------
    def _admit(self):
        """Admit queued requests FCFS while slots and pages last. Whole
        prompts land at once (several a tick); chunked prefill carries one
        prompt in flight, so it admits one a tick."""
        while self.queue and self._inflight is None:
            free = np.where(~self.live & (self.slot_rid < 0))[0]
            if len(free) == 0:
                return
            req = self.queue[0]
            need = -(-(len(req.prompt) + 1) // self.ecfg.page_size)  # + 1 decode
            if len(self.free_pages) < need:
                return
            self.queue.pop(0)
            slot = int(free[0])
            for j in range(need):
                self.bt[slot, j] = self.free_pages.pop()
            self._bt_dirty = True
            self.slot_rid[slot] = req.rid
            self._seq += 1
            self.slot_seq[slot] = self._seq
            self._by_rid[req.rid] = req
            if self.ecfg.prefill_chunk is None:
                self._prefill_whole(slot, req)
            else:
                self._inflight = {"slot": slot, "req": req, "off": 0}

    def _prefill_whole(self, slot: int, req: _PagedRequest):
        tokens = torch.as_tensor(req.prompt[None, :], dtype=torch.long, device=self.device)
        logits, one_caches = prefill(self.params, {"tokens": tokens}, self.cfg)
        npg = -(-len(req.prompt) // self.ecfg.page_size)
        pids = torch.as_tensor(self.bt[slot, :npg], dtype=torch.long, device=self.device)
        for dst, src in zip(self.caches, one_caches):
            dst.insert_pages(src, pids)
        self._activate(slot, req, logits)

    def _prefill_tick(self):
        """Advance the in-flight chunked prefill by one chunk."""
        if self._inflight is None:
            return
        st = self._inflight
        slot, req, off = st["slot"], st["req"], st["off"]
        prompt, c = req.prompt, self.ecfg.prefill_chunk
        take = min(c, len(prompt) - off)
        chunk = np.zeros(c, np.int64)
        chunk[:take] = prompt[off:off + take]
        self._push_bt()
        logits, self.caches = prefill_chunk(self.params, chunk[None, :], self.caches,
                                            off, take, slot, self.cfg)
        st["off"] = off + take
        if st["off"] >= len(prompt):
            self._inflight = None
            self._activate(slot, req, logits[None])

    def _activate(self, slot: int, req: _PagedRequest, logits):
        """Prefill done: seed the first token and go live, or finish at once
        when the budget is spent or the token is EOS."""
        rid = req.rid
        if req.resume_token is None:
            tok = int(self._sample(logits)[0])
            self.outputs[rid].append(tok)
            self._emitted[rid] = tok
            budget = req.max_new - 1
        else:
            tok = req.resume_token            # sampled before the preemption
            budget = req.budget
        self.lengths[slot] = len(req.prompt)
        self.last_token[slot] = tok
        self.budgets[slot] = budget
        if budget > 0 and tok != self.ecfg.eos_id:
            self.live[slot] = True
        else:
            self._finish(slot)

    def _decode_page_span(self, slot: int):
        """Logical pages that must be allocated before this slot decodes
        this tick: the page under the next write position (the speculative
        engine widens it to its draft lookahead)."""
        pidx = int(self.lengths[slot]) // self.ecfg.page_size
        return range(pidx, pidx + 1)

    def _ensure_decode_pages(self):
        """Allocate the pages under each live slot's coming writes; when the
        pool runs dry the youngest live request is preempted (its pages go
        back to the pool, it requeues at the front)."""
        requeue = []
        for slot in np.where(self.live)[0]:
            if not self.live[slot]:
                continue                      # preempted earlier this tick
            for pidx in self._decode_page_span(slot):
                if not self.live[slot]:
                    break
                while self.bt[slot, pidx] == 0 and not self.free_pages:
                    live = np.where(self.live)[0]
                    victim = int(sorted(live, key=lambda s: int(self.slot_seq[s]))[-1])
                    requeue.append(self._preempt(victim))
                    if victim == slot:
                        break
                if not self.live[slot]:
                    break
                if self.bt[slot, pidx] == 0:
                    self.bt[slot, pidx] = self.free_pages.pop()
                    self._bt_dirty = True
        # the youngest went first; resume in admission order
        for req in requeue:
            self.queue.insert(0, req)

    def _decode_lengths(self, offset: int = 0):
        """Device lengths for a decode pass: live slots at their length +
        ``offset``, the others at the past-the-table sentinel, so their
        fixed-width batch writes land in the trash page."""
        sentinel = self.max_pages * self.ecfg.page_size
        lens = np.where(self.live, self.lengths + offset, sentinel)
        return torch.as_tensor(lens, device=self.device)

    def _decode_tick(self) -> dict[int, int]:
        if not self.live.any():
            return {}
        live_before = self.live.copy()
        self._push_bt()
        logits, self.caches = decode_step(self.params, self.last_token, self.caches,
                                          self._decode_lengths(), self.cfg)
        toks = self._sample(logits)
        toks_host = toks.cpu().numpy()
        self.lengths = self.lengths + live_before.astype(np.int64)
        out = {}
        for slot in np.where(live_before)[0]:
            t = int(toks_host[slot])
            rid = int(self.slot_rid[slot])
            out[rid] = t
            self.outputs[rid].append(t)
            self.budgets[slot] -= 1
            if (t == self.ecfg.eos_id or self.budgets[slot] <= 0
                    or int(self.lengths[slot]) >= self.ecfg.max_len):
                self._finish(slot)
        self.last_token = toks
        return out

    def step(self) -> dict[int, int]:
        """One tick: admit queued requests, advance the chunked prefill by
        one chunk, grow or steal decode pages, then decode one token for
        every live slot. Returns {rid: latest token this tick}
        (``outputs`` holds the whole streams)."""
        if not self.busy:
            return {}
        self._emitted = {}
        self._admit()
        self._prefill_tick()
        self._ensure_decode_pages()
        out = self._decode_tick()
        return {**self._emitted, **out}

    def generate(self, prompt: np.ndarray, max_new_tokens: int = 32) -> list:
        """Single-request convenience wrapper."""
        rid = self.add_request(prompt, max_new_tokens)
        while not self.done[rid]:
            self.step()
        return self.outputs[rid]
