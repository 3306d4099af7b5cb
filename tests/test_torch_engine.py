"""Serving parity: the port's prefill, decode_step and DecodeEngine against
the JAX package on the same weights (reduced gpt2-small-sfa8, float32).

The port runs its default backend ("auto" -> the kernels, whose wrappers
run their plain versions on the CPU) and the "torch" oracle. Logits agree
to 1e-4, cache indices exactly, greedy token streams exactly.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.core.kv_cache import KVCache
from repro.models import (decode_step as jax_decode_step, init as jax_init,
                          init_decode_caches as jax_init_caches,
                          prefill as jax_prefill)
from repro.serve.engine import DecodeEngine as JaxEngine
from repro.serve.engine import EngineConfig as JaxEngineConfig
from repro_torch.configs import get_config
from repro_torch.interop import from_jax
from repro_torch.kernels import launch_counts, reset_launches
from repro_torch.models import decode_step, init_decode_caches, prefill
from repro_torch.models.backends import (
    AttentionRequest, clear_fallback_reports, fallback_reports, select_backend,
)
from repro_torch.models.model import insert_slot
from repro_torch.serve import DecodeEngine, EngineConfig

TOL = 1e-4
MAX_LEN = 64


def _setup(name, backend="auto"):
    jc = dataclasses.replace(jax_get_config(name).reduced(), dtype="float32")
    tc = dataclasses.replace(get_config(name).reduced(), dtype="float32")
    tc = dataclasses.replace(tc, attention=dataclasses.replace(
        tc.attention, backend=backend, decode_backend=backend))
    jp = jax_init(jax.random.PRNGKey(0), jc)
    model = from_jax(jax.tree.map(np.asarray, jp), tc, device="cpu")
    return jc, tc, jp, model


@pytest.fixture(scope="module")
def sfa():
    return _setup("gpt2-small-sfa8")


def _prompt(seed, n, vocab):
    return np.random.RandomState(seed).randint(0, vocab, size=n).astype(np.int32)


def _jax_caches(jc, jp, prompt, dtype=jnp.bfloat16):
    logits, one = jax.jit(lambda p, t: jax_prefill(p, {"tokens": t}, jc))(
        jp, jnp.asarray(prompt[None]))
    caches = jax_init_caches(jc, 1, MAX_LEN, dtype)
    caches = jax.tree.map(
        lambda dst, src: dst.insert_slot(src, slot=0, max_len=MAX_LEN),
        caches, one, is_leaf=lambda x: isinstance(x, KVCache))
    return logits, one, caches


@pytest.mark.parametrize("backend", ["auto", "torch"])
def test_prefill_logits_and_caches_match(backend):
    jc, tc, jp, model = _setup("gpt2-small-sfa8", backend)
    prompt = _prompt(0, 37, tc.vocab_size)
    jl, jcache, _ = _jax_caches(jc, jp, prompt)
    tl, tcache = prefill(model, {"tokens": torch.from_numpy(prompt)[None].long()}, tc)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=TOL)
    j, t = jcache[0], tcache[0]
    assert t.k_idx.dtype == torch.uint8 and t.k_idx.shape == j.k_idx.shape
    np.testing.assert_array_equal(t.k_idx.numpy(), np.asarray(j.k_idx))
    np.testing.assert_allclose(t.k_vals.numpy(), np.asarray(j.k_vals), rtol=0, atol=TOL)
    np.testing.assert_allclose(t.v.numpy(), np.asarray(j.v), rtol=0, atol=TOL)


def _teacher_forced(jc, tc, jp, model, prompt, steps):
    """Teacher-forced decode_steps in both packages, with float32 caches:
    the engines keep bf16 caches, where a 1e-7 difference in a value can
    round to the neighbouring bf16 number, so the 1e-4 comparison of the
    arithmetic uses f32 caches (the engine tests cover the bf16 caches)."""
    stream = _prompt(1, steps, tc.vocab_size)
    _, _, jcaches = _jax_caches(jc, jp, prompt, jnp.float32)
    _, one = prefill(model, {"tokens": torch.from_numpy(prompt)[None].long()}, tc)
    tcaches = insert_slot(init_decode_caches(tc, 1, MAX_LEN, torch.float32,
                                             device="cpu"),
                          one, slot=0, max_len=MAX_LEN)
    n = len(prompt)
    step = jax.jit(lambda p, t, c, ln: jax_decode_step(p, t, c, ln, jc))
    out = []
    for i, tok in enumerate(stream):
        jl, jcaches = step(jp, jnp.asarray([tok], jnp.int32), jcaches,
                           jnp.asarray([n + i], jnp.int32))
        tl, tcaches = decode_step(model, torch.tensor([int(tok)]), tcaches,
                                  torch.tensor([n + i]), tc)
        out.append((np.asarray(jl), tl.numpy()))
    return out, jcaches, tcaches


def test_decode_steps_match(sfa):
    jc, tc, jp, model = sfa
    steps, jcaches, tcaches = _teacher_forced(jc, tc, jp, model,
                                              _prompt(2, 21, tc.vocab_size), 16)
    for jl, tl in steps:
        np.testing.assert_allclose(tl, jl, rtol=0, atol=TOL)
    # the decode writes landed where the JAX writes did
    np.testing.assert_array_equal(tcaches[0].k_idx.numpy(),
                                  np.asarray(jcaches[0].k_idx))


def test_decode_goes_through_every_kernel_wrapper(sfa):
    jc, tc, jp, model = sfa
    clear_fallback_reports()
    reset_launches()
    eng = DecodeEngine(model, tc, EngineConfig(max_slots=2, max_len=MAX_LEN),
                       device="cpu")
    eng.generate(_prompt(3, 9, tc.vocab_size), max_new_tokens=3)
    # on the CPU the wrappers run their plain versions: nothing launches
    counts = launch_counts()
    assert set(counts) >= {"rtopk", "flash_sfa", "flash_sfa_decode", "flash_sfa_bwd",
                           "flash_attention", "flash_attention_bwd"}
    assert counts == dict.fromkeys(counts, 0)
    assert fallback_reports() == ()


def _jax_stream(jc, jp, prompts, backend, max_new):
    eng = JaxEngine(jp, jc, JaxEngineConfig(max_slots=2, max_len=MAX_LEN,
                                            decode_backend=backend))
    slots = [eng.add_request(p, max_new_tokens=max_new) for p in prompts]
    while eng.live.any():
        eng.step()
    return [eng.outputs[s] for s in slots]


def _torch_stream(tc, model, prompts, max_new, **kw):
    eng = DecodeEngine(model, tc, EngineConfig(max_slots=2, max_len=MAX_LEN, **kw),
                       device="cpu")
    slots = [eng.add_request(p, max_new_tokens=max_new) for p in prompts]
    while eng.live.any():
        eng.step()
    return [eng.outputs[s] for s in slots]


@pytest.mark.parametrize("jax_backend", ["xla", "pallas"])
def test_engine_greedy_streams_match(sfa, jax_backend):
    jc, tc, jp, model = sfa
    prompts = [_prompt(4, 5, tc.vocab_size), _prompt(5, 11, tc.vocab_size)]
    want = _jax_stream(jc, jp, prompts, jax_backend, 32)
    got = _torch_stream(tc, model, prompts, 32)
    assert got == want
    assert _torch_stream(tc, model, prompts, 32, decode_backend="torch") == want


def test_eos_stops_at_first_occurrence(sfa):
    """Greedy decode stops at eos_id and keeps the EOS token. EOS is chosen
    at its first occurrence in the reference stream, so the expected output
    is the stream up to and including that index."""
    jc, tc, jp, model = sfa
    prompt = np.array([1, 2, 3], np.int32)
    ref = _torch_stream(tc, model, [prompt], 8)[0]
    assert len(ref) == 8
    eos = ref[3]
    first = ref.index(eos)
    out = _torch_stream(tc, model, [prompt], 8, eos_id=eos)[0]
    assert out == ref[:first + 1]


def test_dense_gpt2_small_path_matches():
    jc, tc, jp, model = _setup("gpt2-small", "torch")
    prompts = [_prompt(6, 6, tc.vocab_size), _prompt(7, 4, tc.vocab_size)]
    eng = DecodeEngine(model, tc, EngineConfig(max_slots=2, max_len=MAX_LEN),
                       device="cpu")
    assert type(eng.caches[0]).__name__ == "DenseKV"
    assert _torch_stream(tc, model, prompts, 12) == _jax_stream(jc, jp, prompts, "xla", 12)
    steps, _, _ = _teacher_forced(jc, tc, jp, model, prompts[0], 4)
    for jl, tl in steps:
        np.testing.assert_allclose(tl, jl, rtol=0, atol=TOL)


def test_auto_routes_a_dense_model_to_the_oracle_without_a_report():
    """A dense model's full-sequence attention goes to the kernels (the
    dense FlashAttention forward and backward), its decode to the torch
    oracle: there is no dense-decode kernel. "auto" records nothing; an
    explicit "cuda" records the decode fallback."""
    jc, tc, jp, model = _setup("gpt2-small", "auto")
    full = select_backend("auto", AttentionRequest(mode="full"))
    decode = select_backend("auto", AttentionRequest(mode="decode"))
    assert (full.backend.name, decode.backend.name) == ("cuda", "torch")
    clear_fallback_reports()
    _torch_stream(tc, model, [_prompt(8, 5, tc.vocab_size)], 3)
    assert fallback_reports() == ()
    jc, tc, jp, model = _setup("gpt2-small", "cuda")
    _torch_stream(tc, model, [_prompt(8, 5, tc.vocab_size)], 3)
    reports = fallback_reports()
    assert {(r.request.mode, r.reason) for r in reports} == {
        ("decode", "dense KV cache: no CUDA dense-decode kernel")}
    clear_fallback_reports()


def test_qwen3_gqa_rope_prefill_and_decode_match():
    """RoPE, qk-norm, RMSNorm, SwiGLU and GQA (2 kv heads under 4 query
    heads) through the port's default backend."""
    jc = dataclasses.replace(jax_get_config("qwen3-0.6b-sfa8").reduced(), dtype="float32")
    tc = dataclasses.replace(get_config("qwen3-0.6b-sfa8").reduced(), dtype="float32")
    jc = dataclasses.replace(jc, attention=dataclasses.replace(jc.attention, num_kv_heads=2))
    tc = dataclasses.replace(tc, attention=dataclasses.replace(tc.attention, num_kv_heads=2))
    jp = jax_init(jax.random.PRNGKey(2), jc)
    model = from_jax(jax.tree.map(np.asarray, jp), tc, device="cpu")
    prompt = _prompt(9, 13, tc.vocab_size)
    jl, _, _ = _jax_caches(jc, jp, prompt)
    tl, _ = prefill(model, {"tokens": torch.from_numpy(prompt)[None].long()}, tc)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=TOL)
    steps, jcaches, tcaches = _teacher_forced(jc, tc, jp, model, prompt, 4)
    for jl, tl in steps:
        np.testing.assert_allclose(tl, jl, rtol=0, atol=TOL)
    np.testing.assert_array_equal(tcaches[0].k_idx.numpy(), np.asarray(jcaches[0].k_idx))
