"""The port's paged engine against the JAX package's on the same weights
(reduced gpt2-small-sfa8, float32, carried over by ``interop.from_jax``).

Greedy streams equal JAX's ``PagedDecodeEngine`` (backend ``xla``) for the
port's ``torch``, ``cuda`` and ``cuda_fm`` decode backends, whole-prompt
and chunked (the kernel wrappers run their plain versions on the CPU).
Scheduling is held against solo runs; ``prefill_chunk`` and
``verify_step`` logits against JAX's within 1e-4 on f32 caches (the
engines keep bf16 caches, where a 1e-7 difference can round a stored value
to the neighbouring bf16 number). Pages of 8 tokens: the kernels address
pages the same way at any size.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import init as jax_init
from repro.models import init_paged_decode_caches as jax_init_paged
from repro.models import prefill_chunk as jax_prefill_chunk
from repro.models import verify_step as jax_verify_step
from repro.serve import PagedDecodeEngine as JaxPaged
from repro.serve import PagedEngineConfig as JaxPagedConfig
from repro_torch.configs import get_config
from repro_torch.interop import from_jax
from repro_torch.kernels import launch_counts, reset_launches
from repro_torch.models import init_paged_decode_caches, prefill_chunk, verify_step
from repro_torch.models.backends import clear_fallback_reports, fallback_reports
from repro_torch.serve import (
    DecodeEngine, EngineConfig, PagedDecodeEngine, PagedEngineConfig, paged_page_bytes,
)

# weights of PRNGKey(2) and this prompt give a varied greedy stream (7
# distinct tokens in 16), so acceptance and rewinds are exercised
KEY = 2
PROMPT = np.random.RandomState(0).randint(0, 256, 11).astype(np.int64)
TOL = 1e-4


@pytest.fixture(scope="module")
def sfa():
    jc = dataclasses.replace(jax_get_config("gpt2-small-sfa8").reduced(), dtype="float32")
    tc = dataclasses.replace(get_config("gpt2-small-sfa8").reduced(), dtype="float32")
    jp = jax_init(jax.random.PRNGKey(KEY), jc)
    model = from_jax(jax.tree.map(np.asarray, jp), tc, device="cpu")
    return jc, tc, jp, model


@functools.lru_cache(maxsize=None)
def _jax_paged_stream(chunk):
    jc = dataclasses.replace(jax_get_config("gpt2-small-sfa8").reduced(), dtype="float32")
    jp = jax_init(jax.random.PRNGKey(KEY), jc)
    eng = JaxPaged(jp, jc, JaxPagedConfig(max_slots=2, max_len=48, page_size=8,
                                          prefill_chunk=chunk, decode_backend="xla"))
    return eng.generate(PROMPT, max_new_tokens=10)


def _paged(tc, model, **kw):
    kw.setdefault("max_slots", 2)
    kw.setdefault("max_len", 48)
    kw.setdefault("page_size", 8)
    return PagedDecodeEngine(model, tc, PagedEngineConfig(**kw), device="cpu")


def _solo(tc, model, prompt, max_new):
    eng = DecodeEngine(model, tc, EngineConfig(max_slots=1, max_len=48), device="cpu")
    return eng.generate(prompt, max_new_tokens=max_new)


@pytest.mark.parametrize("chunk", [None, 4])
@pytest.mark.parametrize("backend", ["torch", "cuda", "cuda_fm"])
def test_paged_streams_match_jax(sfa, backend, chunk):
    jc, tc, jp, model = sfa
    clear_fallback_reports()
    reset_launches()
    eng = _paged(tc, model, prefill_chunk=chunk, decode_backend=backend)
    layout = {"torch": "PagedSparseKV", "cuda": "PagedSparseKV",
              "cuda_fm": "PagedFeatureMajorKV"}[backend]
    assert type(eng.caches[0]).__name__ == layout
    assert eng.generate(PROMPT, max_new_tokens=10) == _jax_paged_stream(chunk)
    assert fallback_reports() == ()
    assert set(launch_counts().values()) == {0}          # plain versions on the CPU


@pytest.mark.parametrize("chunk", [None, 4])
def test_dense_model_pages_through_the_oracle(chunk):
    """The dense gpt2-small: PagedDenseKV pools, decode on the torch oracle
    through gather(), greedy stream equal to the slot engine's."""
    tc = dataclasses.replace(get_config("gpt2-small").reduced(), dtype="float32")
    from repro_torch.models.model import init
    model = init(tc, device="cpu", seed=KEY)
    eng = _paged(tc, model, prefill_chunk=chunk)
    assert type(eng.caches[0]).__name__ == "PagedDenseKV"
    assert eng.generate(PROMPT, max_new_tokens=8) == _solo(tc, model, PROMPT, 8)


@pytest.mark.parametrize("chunk", [None, 4])
def test_queueing_and_preemption_match_solo_runs(sfa, chunk):
    """Four requests, two slots, a pool of six 8-token pages: admission
    queues, decode-time page exhaustion preempts the youngest request, and
    recompute on resume keeps every greedy stream equal to its solo run;
    every page comes back."""
    jc, tc, jp, model = sfa
    prompts = [PROMPT, PROMPT[:7], PROMPT[:5], PROMPT[:9]]
    news = [20, 20, 10, 12]      # two live requests outgrow the six pages
    solo = [_solo(tc, model, p, mn) for p, mn in zip(prompts, news)]
    per = paged_page_bytes(tc, page_size=8)
    eng = _paged(tc, model, prefill_chunk=chunk, mem_budget_bytes=6 * per,
                 decode_backend="cuda")
    assert eng.num_pages == 1 + 6
    rids = [eng.add_request(p, max_new_tokens=mn) for p, mn in zip(prompts, news)]
    util_peak, steps, queued = 0.0, 0, 0
    while eng.busy:
        eng.step()
        util_peak = max(util_peak, eng.page_utilization())
        queued = max(queued, len(eng.queue))
        steps += 1
        assert steps < 500, "scheduler livelock"
    assert [eng.outputs[r] for r in rids] == solo
    assert queued >= 2 and eng.preemptions >= 1 and util_peak > 0.5
    assert len(eng.free_pages) == eng.num_pages - 1
    assert eng.page_utilization() == 0.0 and (eng.bt == 0).all()


def test_page_accounting_single_request(sfa):
    """Prompt pages up front, decode pages as the sequence crosses a page
    boundary, all back on finish; step() reports the first token."""
    jc, tc, jp, model = sfa
    eng = _paged(tc, model)
    total = eng.num_pages - 1
    rid = eng.add_request(PROMPT, max_new_tokens=8)     # 11 tokens, 8 a page
    out = eng.step()
    assert rid in out and eng.outputs[rid] == [eng.outputs[rid][0], out[rid]]
    assert len(eng.free_pages) == total - 2             # ceil(12 / 8)
    while not eng.done[rid]:
        eng.step()
    assert len(eng.outputs[rid]) == 8
    assert len(eng.free_pages) == total and not eng.busy
    with pytest.raises(ValueError, match="max_len"):
        eng.add_request(np.arange(48, dtype=np.int64))
    with pytest.raises(ValueError, match="max_new_tokens"):
        eng.add_request(PROMPT, max_new_tokens=0)


def test_budget_sizes_the_pool(sfa):
    """The pool follows the byte budget (paged_page_bytes is the marginal
    cost of a page) and is floored to one request's worst case."""
    jc, tc, jp, model = sfa
    per = paged_page_bytes(tc, page_size=8)
    small = _paged(tc, model, mem_budget_bytes=6 * per)
    big = _paged(tc, model, mem_budget_bytes=10 * per)
    assert big.num_pages - small.num_pages == 4
    assert big.cache_bytes() - small.cache_bytes() == 4 * per
    tiny = _paged(tc, model, mem_budget_bytes=2 * per)
    assert tiny.num_pages - 1 == tiny.max_pages
    assert tiny.generate(PROMPT, max_new_tokens=6) == _solo(tc, model, PROMPT, 6)


def _jax_caches(jc, bt, layers):
    caches = jax_init_paged(jc, slots=2, num_pages=13, page_size=8, max_pages=6,
                            dtype=jnp.float32)
    table = jnp.broadcast_to(jnp.asarray(bt), (layers,) + bt.shape)
    return [dataclasses.replace(c, block_table=table) for c in caches]


def test_prefill_chunk_and_verify_step_logits_match_jax(sfa):
    """Slot 1 of a shuffled block table: the prompt in chunks of 4, then a
    verify pass over 3 tokens, through the port's torch and cuda backends.
    Logits within 1e-4 of JAX's (xla backend) on f32 caches, the pools'
    indices equal."""
    jc, tc, jp, model = sfa
    bt = np.zeros((2, 6), np.int32)
    bt[1] = [7, 2, 11, 4, 9, 5]
    jcaches = _jax_caches(jc, bt, jc.num_layers)
    chunk = jax.jit(lambda p, t, c, o, v: jax_prefill_chunk(p, t, c, o, v, 1, jc))
    chunks, want = [], []
    for off in range(0, len(PROMPT), 4):
        toks = np.zeros(4, np.int64)
        take = min(4, len(PROMPT) - off)
        toks[:take] = PROMPT[off:off + take]
        jl, jcaches = chunk(jp, jnp.asarray(toks[None], jnp.int32), jcaches, off, take)
        chunks.append((toks, off, take))
        want.append(np.asarray(jl))
    draft = np.array([[5, 17, 3]], np.int64)
    jl, jcaches = jax.jit(lambda p, t, c: jax_verify_step(p, t, c, len(PROMPT), 1, jc))(
        jp, jnp.asarray(draft, jnp.int32), jcaches)
    for backend in ("torch", "cuda"):
        c = dataclasses.replace(tc, attention=dataclasses.replace(
            tc.attention, decode_backend=backend))
        tcaches = init_paged_decode_caches(c, slots=2, num_pages=13, page_size=8,
                                           max_pages=6, dtype=torch.float32, device="cpu")
        tcaches[0].block_table.copy_(torch.from_numpy(bt))
        for (toks, off, take), w in zip(chunks, want):
            tl, tcaches = prefill_chunk(model, toks[None], tcaches, off, take, 1, c)
            np.testing.assert_allclose(tl.numpy(), w, rtol=0, atol=TOL)
        tl, tcaches = verify_step(model, draft, tcaches, len(PROMPT), 1, c)
        assert tl.shape == (3, tc.vocab_size)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=TOL)
        np.testing.assert_array_equal(tcaches[0].k_idx.numpy(),
                                      np.asarray(jcaches[0].k_idx))
