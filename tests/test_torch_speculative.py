"""The port's speculative engine against the JAX package's on the same
weights (reduced gpt2-small-sfa8, float32, carried over by
``interop.from_jax``).

Streams and ``spec_stats`` equal JAX's ``SpeculativeDecodeEngine``
(backend ``xla``) for the port's ``torch`` and ``cuda`` backends at
draft_len 1 and 3, and the streams equal the port's own paged engine (also
for ``cuda_fm``, whose draft narrows the query instead of the codes, so its
acceptance differs by design). Then: drafting against max_len, preemption,
the refusals, and the launcher's paged, speculative and feature-major modes.
"""
import dataclasses
import functools

import jax
import numpy as np
import pytest

from repro.configs import get_config as jax_get_config
from repro.models import init as jax_init
from repro.serve import SpeculativeDecodeEngine as JaxSpec
from repro.serve import SpeculativeEngineConfig as JaxSpecConfig
from repro_torch.configs import get_config
from repro_torch.configs.base import MLAConfig
from repro_torch.interop import from_jax
from repro_torch.launch import serve as launcher
from repro_torch.models.backends import clear_fallback_reports, fallback_reports
from repro_torch.serve import (
    PagedDecodeEngine, PagedEngineConfig, SpeculativeDecodeEngine, SpeculativeEngineConfig,
    paged_page_bytes,
)

# weights of PRNGKey(2) and this prompt give a varied greedy stream (7
# distinct tokens in 16), so acceptance and rewinds are exercised
KEY = 2
PROMPT = np.random.RandomState(0).randint(0, 256, 11).astype(np.int64)


@pytest.fixture(scope="module")
def sfa():
    jc = dataclasses.replace(jax_get_config("gpt2-small-sfa8").reduced(), dtype="float32")
    tc = dataclasses.replace(get_config("gpt2-small-sfa8").reduced(), dtype="float32")
    jp = jax_init(jax.random.PRNGKey(KEY), jc)
    model = from_jax(jax.tree.map(np.asarray, jp), tc, device="cpu")
    return jc, tc, jp, model


@functools.lru_cache(maxsize=None)
def _jax_spec(draft_len):
    jc = dataclasses.replace(jax_get_config("gpt2-small-sfa8").reduced(), dtype="float32")
    jp = jax_init(jax.random.PRNGKey(KEY), jc)
    eng = JaxSpec(jp, jc, JaxSpecConfig(max_slots=2, max_len=48, page_size=8,
                                        draft_len=draft_len, decode_backend="xla"))
    return eng.generate(PROMPT, max_new_tokens=10), eng.spec_stats


def _kw(kw):
    kw.setdefault("max_slots", 2)
    kw.setdefault("max_len", 48)
    kw.setdefault("page_size", 8)
    return kw


def _paged(tc, model, **kw):
    return PagedDecodeEngine(model, tc, PagedEngineConfig(**_kw(kw)), device="cpu")


def _spec(tc, model, **kw):
    kw.setdefault("draft_len", 4)
    return SpeculativeDecodeEngine(model, tc, SpeculativeEngineConfig(**_kw(kw)),
                                   device="cpu")


@pytest.mark.parametrize("draft_len", [1, 3])
@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_speculative_matches_jax(sfa, backend, draft_len):
    jc, tc, jp, model = sfa
    want, want_stats = _jax_spec(draft_len)
    clear_fallback_reports()
    eng = _spec(tc, model, draft_len=draft_len, decode_backend=backend)
    assert eng.draft_k == max(1, tc.attention.sfa_k // 4)
    assert eng.generate(PROMPT, max_new_tokens=10) == want
    assert eng.spec_stats == want_stats
    assert eng.spec_stats["acc_per_step"] >= 1.0
    assert fallback_reports() == ()
    ref = _paged(tc, model, decode_backend=backend).generate(PROMPT, max_new_tokens=10)
    assert want == ref


def test_cuda_fm_speculative_falls_back_for_verify_only(sfa):
    """cuda_fm drafts through its own kernels (the query narrowed to k')
    and has no verify pass: verify falls back to torch with one report, and
    the stream is the paged engine's."""
    jc, tc, jp, model = sfa
    ref = _paged(tc, model, decode_backend="cuda_fm").generate(PROMPT, max_new_tokens=10)
    clear_fallback_reports()
    eng = _spec(tc, model, draft_len=3, decode_backend="cuda_fm")
    assert eng.generate(PROMPT, max_new_tokens=10) == ref
    reports = fallback_reports()
    assert {(r.requested, r.selected, r.request.speculative) for r in reports} == {
        ("cuda_fm", "torch", True)}
    clear_fallback_reports()


def test_speculative_near_max_len(sfa):
    """Drafting against max_len: lookahead past the block table goes to the
    trash page, and the per-token max_len check cuts the accepted run where
    the paged engine stops."""
    jc, tc, jp, model = sfa
    ref = _paged(tc, model, max_len=16).generate(PROMPT, max_new_tokens=12)
    got = _spec(tc, model, max_len=16, draft_len=4).generate(PROMPT, max_new_tokens=12)
    assert got == ref
    assert len(got) == 16 - len(PROMPT) + 1


PROMPTS = [PROMPT, PROMPT[:7], PROMPT[:5], PROMPT[:9]]
NEWS = [16, 16, 10, 12]          # two live requests outgrow six pages


@functools.lru_cache(maxsize=None)
def _jax_spec_preempted(chunk):
    from repro.serve import paged_page_bytes as jax_page_bytes
    jc = dataclasses.replace(jax_get_config("gpt2-small-sfa8").reduced(), dtype="float32")
    jp = jax_init(jax.random.PRNGKey(KEY), jc)
    eng = JaxSpec(jp, jc, JaxSpecConfig(
        max_slots=2, max_len=48, page_size=8, draft_len=4, prefill_chunk=chunk,
        mem_budget_bytes=6 * jax_page_bytes(jc, page_size=8), decode_backend="xla"))
    rids = [eng.add_request(p, max_new_tokens=mn) for p, mn in zip(PROMPTS, NEWS)]
    while eng.busy:
        eng.step()
    return [eng.outputs[r] for r in rids], eng.spec_stats


@pytest.mark.parametrize("chunk", [4])
def test_speculative_preemption_matches_jax(sfa, chunk):
    """Four requests, two slots, six 8-token pages, chunked prefill: the
    wider speculative page span preempts, the rewind returns
    rejected-lookahead pages, and every stream and the acceptance counts
    equal JAX's engine on the same schedule; every page comes back.
    Whole-prompt prefill is left out here only for time: JAX compiles one
    prefill per replayed prompt length (the paged engine's preemption test
    covers that path). Recompute on resume can turn a stream away from its
    solo run at a near-tie (the replay prefills over f32 K/V where the first
    pass read the bf16 cache); JAX's engine does the same, so the reference
    here is JAX's run of the same schedule."""
    jc, tc, jp, model = sfa
    eng = _spec(tc, model, prefill_chunk=chunk,
                mem_budget_bytes=6 * paged_page_bytes(tc, page_size=8))
    rids = [eng.add_request(p, max_new_tokens=mn) for p, mn in zip(PROMPTS, NEWS)]
    steps = 0
    while eng.busy:
        eng.step()
        steps += 1
        assert steps < 200, "scheduler livelock"
    want, want_stats = _jax_spec_preempted(chunk)
    assert [eng.outputs[r] for r in rids] == want
    assert eng.spec_stats == want_stats
    assert eng.preemptions >= 1
    assert len(eng.free_pages) == eng.num_pages - 1 and (eng.bt == 0).all()


def test_speculative_refusals(sfa):
    jc, tc, jp, model = sfa
    dense = dataclasses.replace(get_config("gpt2-small").reduced(), dtype="float32")
    with pytest.raises(ValueError, match="sfa_k"):
        SpeculativeDecodeEngine({}, dense, SpeculativeEngineConfig())
    mla = dataclasses.replace(tc, attention=dataclasses.replace(tc.attention,
                                                                mla=MLAConfig()))
    with pytest.raises(NotImplementedError, match="MLA"):
        SpeculativeDecodeEngine({}, mla, SpeculativeEngineConfig())
    with pytest.raises(ValueError, match="greedy"):
        _spec(tc, model, temperature=0.7)
    with pytest.raises(ValueError, match="draft_len"):
        _spec(tc, model, draft_len=0)
    with pytest.raises(ValueError, match="draft_k"):
        _spec(tc, model, draft_k=tc.attention.sfa_k + 1)


@pytest.mark.parametrize("argv,layout", [
    (["--speculative", "--page-size", "8", "--prefill-chunk", "8"], "PagedSparseKV"),
    (["--decode-backend", "cuda_fm", "--paged", "--fm-debug"], "PagedFeatureMajorKV"),
])
def test_launcher_serves_the_paged_modes(capsys, argv, layout):
    from repro_torch.models.backends import set_fm_debug
    clear_fallback_reports()
    try:
        launcher.main(["--device", "cpu", "--requests", "2", "--max-new", "5", *argv])
    finally:
        set_fm_debug(False)
    out = capsys.readouterr().out
    assert "engine ticks, 10 tokens" in out and layout in out
    assert "fallback" not in out
