"""gemma3-4b's local/global windows in the port against the JAX package, f32.

Each layer gets its window from ``models.model._window_array``: the config's
window, or ``GLOBAL_WINDOW`` (1 << 30) on every ``local_global_pattern +
1``-th layer, counted across segments; every such layer requests a window,
so all of them run on the ``torch`` backend, as the reference runs them on
XLA. The reduced gemma3-4b (4 layers, window 16, qk-norm, GeGLU, tied
embeddings, 4 query heads over 2 kv heads of 32) with the pattern set to 1
so that layers 1 and 3 are global, on sequences longer than the window,
weights carried from the JAX tree by ``from_jax``:

  * the configs, ``_window_array`` and ``GLOBAL_WINDOW``, ``param_count``
    / ``step_flops`` / ``step_hbm_bytes`` of the full config;
  * the byte model (76,160 B a token at full width) and the realized
    caches;
  * the loss and every gradient (torch backend; an explicit cuda request
    under remat "full", which records only the window reason); the logits,
    and every serving mode held to them (``assert_modes_match_logits``);
  * the slot, chunked paged and speculative engines' greedy streams
    against the JAX slot engine's.

Tolerance 1e-4.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs.base import ShapeConfig as JaxShape
from repro.models import forward_logits as jax_forward_logits
from repro.models import init as jax_init
from repro.models import loss_fn as jax_loss_fn
from repro.models import model as jmodel
from repro.serve import kv_cache as jserve
from repro.serve.engine import DecodeEngine as JaxEngine
from repro.serve.engine import EngineConfig as JaxEngineConfig
from repro.utils import analytic as jax_analytic
from repro_torch.configs import NOT_YET_PORTED, get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.interop import from_jax
from repro_torch.models import backends as B
from repro_torch.models import forward_logits, loss_fn, segments
from repro_torch.models import model as tmodel
from repro_torch.serve import (
    DecodeEngine, EngineConfig, PagedDecodeEngine, PagedEngineConfig, SpeculativeDecodeEngine,
    SpeculativeEngineConfig,
)
from repro_torch.serve import kv_cache as tserve
from repro_torch.utils import analytic
from test_torch_rope_protect import _close, _flat_np, _prompt, assert_modes_match_logits

ARCH = "gemma3-4b"
TOL = 1e-4
MAX_LEN = 48


def _pair():
    """(JAX config, port config): reduced, f32, 4 layers, pattern 1 (layers
    1 and 3 global), 4 query heads over 2 kv heads."""
    out = []
    for get in (jax_get_config, get_config):
        c = dataclasses.replace(get(ARCH).reduced(), dtype="float32", loss_chunk=16,
                                num_layers=4)
        out.append(dataclasses.replace(c, attention=dataclasses.replace(
            c.attention, num_kv_heads=2, local_global_pattern=1)))
    return out


@pytest.mark.parametrize("reduced", [False, True], ids=["full", "reduced"])
def test_gemma3_config_equals_the_reference(reduced):
    jc, tc = jax_get_config(ARCH), get_config(ARCH)
    if reduced:
        jc, tc = jc.reduced(), tc.reduced()
    jd, td = dataclasses.asdict(jc), dataclasses.asdict(tc)
    for d in (jd, td):
        for field in ("backend", "decode_backend"):
            d["attention"].pop(field)
    assert td == jd
    assert ARCH not in NOT_YET_PORTED
    assert segments(tc) == [("block_dense", tc.num_layers)]


def test_window_array_equals_the_reference():
    """34 layers, 5 local then 1 global: layers 5, 11, ... carry
    GLOBAL_WINDOW; a count from an offset (a later segment) continues the
    pattern; a config without a window has none."""
    assert tmodel.GLOBAL_WINDOW == jmodel.GLOBAL_WINDOW
    jc, tc = jax_get_config(ARCH), get_config(ARCH)
    for count, offset in ((34, 0), (7, 3), (12, 0), (2, 11)):
        got = tmodel._window_array(tc, count, offset)
        assert got == np.asarray(jmodel._window_array(jc, count, offset)).tolist()
    full = tmodel._window_array(tc, 34)
    assert [i for i, w in enumerate(full) if w == tmodel.GLOBAL_WINDOW] == [5, 11, 17, 23, 29]
    assert set(full) == {1024, tmodel.GLOBAL_WINDOW}
    assert tmodel._window_array(get_config("llama3.2-3b"), 4) is None
    assert tmodel._window_array(_pair()[1], 4) == [16, tmodel.GLOBAL_WINDOW] * 2


def test_analytic_counts_equal_the_reference():
    """``param_count``, ``step_flops`` (local layers at their window,
    global ones unwindowed) and ``step_hbm_bytes`` of the full config (the
    parameter tree's names and shapes are ``from_jax``'s check below)."""
    jc, tc = jax_get_config(ARCH), get_config(ARCH)
    assert analytic.param_count(tc) == jax_analytic.param_count(jc)
    for kind, n, b in (("train", 1024, 8), ("prefill", 4096, 1), ("decode", 2048, 8)):
        got = analytic.step_flops(tc, ShapeConfig("s", n, b, kind))
        assert got == jax_analytic.step_flops(jc, JaxShape("s", n, b, kind))
        assert analytic.step_hbm_bytes(tc, ShapeConfig("s", n, b, kind), 1) == \
            jax_analytic.step_hbm_bytes(jc, JaxShape("s", n, b, kind), 1)


def test_byte_model_and_realized_caches_equal_the_reference():
    """34 layers x 4 kv heads x (16 x 3 + 256 x 2) = 76,160 B a token."""
    jc, tc = jax_get_config(ARCH), get_config(ARCH)
    per = tserve.cache_bytes_per_token(tc)
    assert per == jserve.cache_bytes_per_token(jc) and per["sfa"] == 76_160
    assert tserve.realized_cache_bytes_per_token(tc) == per["sfa"]
    # a pool page holds page_size tokens of the model (the block table cancels)
    rc = _pair()[1]
    assert tserve.paged_page_bytes(rc, page_size=8) == \
        tserve.cache_bytes_per_token(rc)["sfa"] * 8


@pytest.fixture(scope="module")
def gemma():
    jc, tc = _pair()
    jc = dataclasses.replace(jc, attention=dataclasses.replace(jc.attention, backend="xla"))
    jp = jax_init(jax.random.PRNGKey(11), jc)
    rs = np.random.RandomState(12)
    batch = {"tokens": rs.randint(0, jc.vocab_size, (2, 40)).astype(np.int32),
             "labels": rs.randint(0, jc.vocab_size, (2, 40)).astype(np.int32)}

    def run(p, b):
        (loss, _), grads = jax.value_and_grad(lambda p: jax_loss_fn(p, b, jc), has_aux=True)(p)
        return loss, grads, jax_forward_logits(p, {"tokens": b["tokens"]}, jc).logits

    loss, grads, logits = jax.jit(run)(jp, {k: jnp.asarray(v) for k, v in batch.items()})
    return dict(jc=jc, tc=tc, jp=jp, np_params=jax.tree.map(np.asarray, jp), batch=batch,
                loss=float(loss), grads=_flat_np(grads), logits=np.asarray(logits))


@pytest.mark.parametrize("backend,remat", [("torch", "none"), ("cuda", "full")])
def test_loss_and_every_grad_match_jax(gemma, backend, remat):
    tc = dataclasses.replace(gemma["tc"], remat=remat, attention=dataclasses.replace(
        gemma["tc"].attention, backend=backend))
    B.clear_fallback_reports()
    model = from_jax(gemma["np_params"], tc, device="cpu").requires_grad_(True)
    loss, _ = loss_fn(model, {k: torch.from_numpy(v).long()
                              for k, v in gemma["batch"].items()}, tc)
    named = dict(model.named_parameters())
    grads = dict(zip(named, torch.autograd.grad(loss, list(named.values()))))
    np.testing.assert_allclose(loss.item(), gemma["loss"], rtol=0, atol=TOL)
    assert set(grads) == set(gemma["grads"])
    for name, g in grads.items():
        np.testing.assert_allclose(g.numpy(), gemma["grads"][name], rtol=0, atol=TOL,
                                   err_msg=name)
    reasons = {(r.selected, r.reason) for r in B.fallback_reports()}
    assert reasons == ({("torch", "windowed attention not supported")}
                       if backend == "cuda" else set())
    B.clear_fallback_reports()


def test_logits_and_every_mode_match_jax(gemma):
    """forward_logits over 40 tokens (window 16), then prefill of 20,
    decode, chunked prefill, verify and paged decode held to them; without
    the windows the logits move, so the masks were in force."""
    tc = gemma["tc"]
    model = from_jax(gemma["np_params"], tc, device="cpu")
    tokens = gemma["batch"]["tokens"]
    with torch.no_grad():
        logits = forward_logits(model, {"tokens": torch.from_numpy(tokens).long()}, tc)
        _close(logits, gemma["logits"])
        unwindowed = forward_logits(model, {"tokens": torch.from_numpy(tokens).long()},
                                    dataclasses.replace(tc, attention=dataclasses.replace(
                                        tc.attention, window=None)))
    assert (unwindowed[:, 16:] - logits[:, 16:]).abs().max() > 1e-2
    _close(unwindowed[:, :16], gemma["logits"][:, :16])
    assert_modes_match_logits(model, tc, tokens, gemma["logits"], n0=20, chunk=8)


@pytest.fixture(scope="module")
def jax_stream(gemma):
    """The JAX slot engine's greedy stream of a 24-token prompt (bf16
    caches), decoding past the window."""
    prompt = _prompt(13, 24, 256)
    eng = JaxEngine(gemma["jp"], gemma["jc"], JaxEngineConfig(
        max_slots=2, max_len=MAX_LEN, decode_backend="xla"))
    return prompt, eng.generate(prompt, max_new_tokens=12)


@pytest.mark.parametrize("decode_backend", ["auto", "cuda_fm"])
def test_engine_streams_match_jax(gemma, jax_stream, decode_backend):
    """The slot engine, the paged engine with chunked prefill and the
    speculative engine on the windowed layers give the JAX engine's stream;
    the cache at rest is the byte model's; an explicit cuda_fm request
    keeps the token-major cache (the backend declines windows) and records
    only the window reason, which the verify pass's request meets first
    too."""
    tc = gemma["tc"]
    prompt, want = jax_stream
    model = from_jax(gemma["np_params"], tc, device="cpu")
    B.clear_fallback_reports()
    common = dict(max_slots=2, max_len=MAX_LEN, decode_backend=decode_backend)
    slot = DecodeEngine(model, tc, EngineConfig(**common), device="cpu")
    assert slot.generate(prompt, 12) == want
    assert slot.cache_bytes() == tserve.cache_bytes_per_token(tc)["sfa"] * 2 * MAX_LEN
    chunked = PagedDecodeEngine(model, tc, PagedEngineConfig(
        **common, page_size=8, prefill_chunk=8), device="cpu")
    assert chunked.generate(prompt, 12) == want
    spec = SpeculativeDecodeEngine(model, tc, SpeculativeEngineConfig(
        **common, page_size=8, draft_len=3), device="cpu")
    assert spec.generate(prompt, 12) == want
    reasons = {r.reason for r in B.fallback_reports()}
    assert reasons == ({"windowed attention not supported"}
                       if decode_backend == "cuda_fm" else set())
    B.clear_fallback_reports()
