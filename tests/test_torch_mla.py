"""MLA + SFA (deepseek-v2, paper Table 10) in the port against the JAX
package, f32.

MLA attends in the absorbed latent space: q_eff = q_nope · W_ukᵀ against
the shared latent c_kv (r = kv_lora_rank), plus the RoPE parts q_pe · k_pe;
SFA takes the top-k of q_eff and of c_kv. The full path is dense attention
over those latents (d = r + dr, dv = r); the decode cache keeps c_kv and
k_pe dense and each token's top-k latent code packed at
``idx_dtype(r)`` (uint16 at r = 512), which the decode reads per token. The
reduced deepseek-v2-236b (one dense and one MoE layer of 4 experts top-2 +
2 shared, r 16, 4 heads), weights carried from the JAX tree by
``from_jax``:

  * the configs, ``param_count`` (the full model in 2.0e11–2.6e11) and the
    other analytic counts, the byte model (1,216 B a token and layer at full
    width) and the realized caches;
  * ``MLASparseKV`` through writes and a slot insert, ``PagedMLASparseKV``
    and ``PagedMLAKV`` through writes, gathers and page inserts, exact;
  * the loss and every gradient (torch backend; an explicit cuda request,
    whose fallback reason is the reference's) against the JAX model's
    forward with ``loss_fn``'s cross entropy and MoE aux term; the logits,
    and prefill, decode, whole-prompt paged prefill and paged decode on f32
    caches held to them (``assert_modes_match_logits``);
  * the chunk and verify refusals, with the reference's message, and the
    engines that meet them;
  * the slot and paged engines' greedy streams, each token the argmax of
    the JAX model's logits over the stream before it.

Tolerance 1e-4; integer indices and moved values exact.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs.base import ShapeConfig as JaxShape
from repro.core import kv_cache as jkv
from repro.models import attention as jattn
from repro.models import forward_logits as jax_forward_logits
from repro.models import init as jax_init
from repro.serve import kv_cache as jserve
from repro.utils import analytic as jax_analytic
from repro_torch.configs import NOT_YET_PORTED, get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.core import kv_cache as tkv
from repro_torch.interop import from_jax
from repro_torch.models import attention as attn
from repro_torch.models import backends as B
from repro_torch.models import forward_logits, init_decode_caches, loss_fn, segments
from repro_torch.serve import (
    DecodeEngine, EngineConfig, PagedDecodeEngine, PagedEngineConfig, SpeculativeDecodeEngine,
    SpeculativeEngineConfig,
)
from repro_torch.serve import kv_cache as tserve
from repro_torch.utils import analytic
from test_torch_rope_protect import (
    _both, _close, _flat_np, _prompt, _same, assert_modes_match_logits,
)

ARCH = "deepseek-v2-236b"
TOL = 1e-4
MAX_LEN = 40


def _pair():
    """(JAX config, port config): reduced, f32, MoE capacity factor 2 (an
    expert takes a whole group: no token is dropped, so a token's output
    depends on that token alone, and every serving mode scores what the
    full sequence scores)."""
    out = []
    for get in (jax_get_config, get_config):
        c = dataclasses.replace(get(ARCH).reduced(), dtype="float32", loss_chunk=16)
        out.append(dataclasses.replace(c, moe=dataclasses.replace(c.moe, capacity_factor=2.0)))
    return out


# --------------------------------------------------------------------------
# configs, counts, bytes
# --------------------------------------------------------------------------

@pytest.mark.parametrize("reduced", [False, True], ids=["full", "reduced"])
def test_deepseek_config_equals_the_reference(reduced):
    jc, tc = jax_get_config(ARCH), get_config(ARCH)
    if reduced:
        jc, tc = jc.reduced(), tc.reduced()
    jd, td = dataclasses.asdict(jc), dataclasses.asdict(tc)
    for d in (jd, td):
        for field in ("backend", "decode_backend"):
            d["attention"].pop(field)
    assert td == jd
    assert ARCH not in NOT_YET_PORTED
    assert segments(tc) == [("block_dense", 1), ("block_moe", tc.num_layers - 1)]


def test_analytic_counts_equal_the_reference():
    jc, tc = jax_get_config(ARCH), get_config(ARCH)
    pc = analytic.param_count(tc)
    assert pc == jax_analytic.param_count(jc)
    assert 2.0e11 < pc["total"] < 2.6e11
    for kind, n, b in (("train", 4096, 8), ("prefill", 4096, 1), ("decode", 2048, 8)):
        got = analytic.step_flops(tc, ShapeConfig("s", n, b, kind))
        assert got == jax_analytic.step_flops(jc, JaxShape("s", n, b, kind))
        assert analytic.step_hbm_bytes(tc, ShapeConfig("s", n, b, kind), 4) == \
            jax_analytic.step_hbm_bytes(jc, JaxShape("s", n, b, kind), 4)


def test_byte_model_and_realized_caches_equal_the_reference():
    """(512 + 64) x 2 + 16 x (2 + 2) = 1,216 B a token and layer (indices
    uint16 over r = 512); the caches a config allocates realize it."""
    jc, tc = jax_get_config(ARCH), get_config(ARCH)
    per = tserve.cache_bytes_per_token(tc)
    assert per == jserve.cache_bytes_per_token(jc)
    assert per == {"dense": 1_152 * 60, "sfa": 1_216 * 60}
    assert tserve.realized_cache_bytes_per_token(tc) == per["sfa"]
    cache = init_decode_caches(tc, 1, 8, device="meta")[1]
    assert isinstance(cache, tkv.MLASparseKV) and cache.ckv_sp_idx.dtype == torch.uint16
    rc = _pair()[1]
    assert tserve.realized_cache_bytes_per_token(rc) == tserve.cache_bytes_per_token(rc)["sfa"]
    assert tserve.paged_page_bytes(rc, page_size=8) == \
        tserve.cache_bytes_per_token(rc)["sfa"] * 8


# --------------------------------------------------------------------------
# the caches
# --------------------------------------------------------------------------

R, DR, K, PAGE, MP, SLOTS = 16, 8, 4, 4, 3, 2
POOL = SLOTS * MP + 1


def _latents(rs, b, n, sparse=True):
    out = {"ckv": rs.randn(b, n, R).astype(np.float32),
           "kpe": rs.randn(b, n, DR).astype(np.float32)}
    if sparse:
        out["ckv_sp_vals"] = rs.randn(b, n, K).astype(np.float32)
        out["ckv_sp_idx"] = np.sort(np.argsort(rs.rand(b, n, R), -1)[..., :K], -1).astype(
            np.int32)
    return out


def test_mla_sparse_kv_writes_and_slot_insert_equal_jax():
    rs = np.random.RandomState(0)
    leaves = _latents(rs, 2, 10)
    leaves["ckv_sp_idx"] = leaves["ckv_sp_idx"].astype(np.uint8)
    t, j = _both(tkv.MLASparseKV, jkv.MLASparseKV, leaves)
    up = _latents(rs, 2, 1)
    pos = np.array([4, 9], np.int32)
    t.write(torch.from_numpy(pos), **{k: torch.from_numpy(a) for k, a in up.items()})
    j = j.write(jnp.asarray(pos), **{k: jnp.asarray(a) for k, a in up.items()})
    _same(t, j)
    tst = tkv.MLASparseKV.stack([t, t])
    jst = jax.tree.map(lambda x: jnp.stack([x, x]), j)
    src = {k: np.stack([a, a]) for k, a in _latents(rs, 1, 3).items()}
    s_t, s_j = _both(tkv.MLASparseKV, jkv.MLASparseKV, src)
    tst.insert_slot(s_t, slot=0, max_len=10)
    _same(tst, jst.insert_slot(s_j, slot=0, max_len=10))


@pytest.mark.parametrize("sparse", [True, False], ids=["sfa", "dense"])
def test_paged_mla_pools_equal_jax(sparse):
    """Headless (pages, page_size, F) pools: ragged decode writes (slot 1
    past the table: the trash page), the gathered view, and a page insert
    of a 6-token prefill into a 2-layer stacked pool."""
    tcls, jcls = ((tkv.PagedMLASparseKV, jkv.PagedMLASparseKV) if sparse
                  else (tkv.PagedMLAKV, jkv.PagedMLAKV))
    rs = np.random.RandomState(1)
    pools = {k: a[0] for k, a in _latents(rs, 1, POOL * PAGE, sparse).items()}
    pools = {k: a.reshape((POOL, PAGE) + a.shape[1:]) for k, a in pools.items()}
    if sparse:
        pools["ckv_sp_idx"] = pools["ckv_sp_idx"].astype(np.uint8)
    bt = rs.permutation(np.arange(1, POOL))[:SLOTS * MP].reshape(SLOTS, MP).astype(np.int32)
    t, j = _both(tcls, jcls, pools, block_table=bt)
    up = _latents(rs, SLOTS, 1, sparse)
    pos = np.array([6, MP * PAGE], np.int32)
    t.write(torch.from_numpy(pos), **{k: torch.from_numpy(a) for k, a in up.items()})
    j, jg = jax.jit(lambda j, p, u: (lambda w: (w, w.gather()))(j.write(p, **u)))(
        j, jnp.asarray(pos), up)
    _same(t, j)
    _same(t.gather(), jg)
    stacked = {n: np.stack([a, a + 1]) for n, a in pools.items()}
    t, j = _both(tcls, jcls, stacked, block_table=bt)
    src = {k: np.stack([a, 2 * a]) for k, a in _latents(rs, 1, 6, sparse).items()}
    s_t, s_j = _both(*((tkv.MLASparseKV, jkv.MLASparseKV) if sparse
                       else (tkv.MLAKV, jkv.MLAKV)), src)
    pids = bt[0, :2]
    t.insert_pages(s_t, torch.from_numpy(pids).long())
    _same(t, jax.jit(lambda j, s, p: j.insert_pages(s, p))(j, s_j, jnp.asarray(pids)))


# --------------------------------------------------------------------------
# the model
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def deepseek():
    """The JAX model's logits, loss and every gradient in one compiled
    function (its forward_logits with ``loss_fn``'s cross entropy and MoE
    aux term: one model-level compile serves the loss, the logits and the
    engine streams below)."""
    jc, tc = _pair()
    jc = dataclasses.replace(jc, attention=dataclasses.replace(jc.attention, backend="xla"))
    jp = jax.jit(lambda key: jax_init(key, jc))(jax.random.PRNGKey(21))
    rs = np.random.RandomState(22)
    batch = {"tokens": rs.randint(0, jc.vocab_size, (2, 24)).astype(np.int32),
             "labels": rs.randint(0, jc.vocab_size, (2, 24)).astype(np.int32)}

    def loss_and_logits(p, b):
        out = jax_forward_logits(p, {"tokens": b["tokens"]}, jc)
        lse = jax.nn.logsumexp(out.logits, axis=-1)
        gold = jnp.take_along_axis(out.logits, b["labels"][..., None], axis=-1)[..., 0]
        return (lse - gold).mean() + out.aux_loss, out.logits

    run = jax.jit(jax.value_and_grad(loss_and_logits, has_aux=True))
    (loss, logits), grads = run(jp, {k: jnp.asarray(v) for k, v in batch.items()})
    return dict(jc=jc, tc=tc, jp=jp, np_params=jax.tree.map(np.asarray, jp), batch=batch,
                loss=float(loss), grads=_flat_np(grads), logits=np.asarray(logits), run=run)


def test_from_jax_carries_every_mla_leaf(deepseek):
    model = from_jax(deepseek["np_params"], deepseek["tc"], device="cpu")
    names = {n.split(".")[-2] for n, _ in model.named_parameters() if ".attn." in n}
    assert names == {"w_dq", "q_norm", "w_uq_nope", "w_uq_pe", "w_dkv", "kv_norm", "w_kpe",
                     "w_uk", "w_uv", "w_o"}


@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_loss_and_every_grad_match_jax(deepseek, backend):
    """An explicit cuda request runs the MLA layers on torch, with the
    reason the reference's pallas backend gives (deepseek-v2 sets
    sfa_rope_protect, which the request meets before MLA)."""
    tc = dataclasses.replace(deepseek["tc"], attention=dataclasses.replace(
        deepseek["tc"].attention, backend=backend))
    B.clear_fallback_reports()
    model = from_jax(deepseek["np_params"], tc, device="cpu").requires_grad_(True)
    loss, _ = loss_fn(model, {k: torch.from_numpy(v).long()
                              for k, v in deepseek["batch"].items()}, tc)
    named = dict(model.named_parameters())
    grads = dict(zip(named, torch.autograd.grad(loss, list(named.values()))))
    np.testing.assert_allclose(loss.item(), deepseek["loss"], rtol=0, atol=TOL)
    assert set(grads) == set(deepseek["grads"])
    for name, g in grads.items():
        np.testing.assert_allclose(g.numpy(), deepseek["grads"][name], rtol=0, atol=TOL,
                                   err_msg=name)
    reports = [(r.where, r.selected, r.reason) for r in B.fallback_reports()]
    if backend == "cuda":
        jreq = jattn._request(deepseek["jc"].attention, mode="full", window=None)
        want = jattn.select_backend("pallas", jreq).reason
        assert reports == [(f"{tc.name}/mla", "torch", want)]
    else:
        assert not reports
    B.clear_fallback_reports()


def test_logits_and_every_mode_match_jax(deepseek):
    """forward_logits, then prefill, decode, whole-prompt paged prefill
    (``insert_pages`` into headless pools) and paged decode on f32 caches."""
    tc = deepseek["tc"]
    model = from_jax(deepseek["np_params"], tc, device="cpu")
    tokens = deepseek["batch"]["tokens"]
    with torch.no_grad():
        logits = forward_logits(model, {"tokens": torch.from_numpy(tokens).long()}, tc)
    _close(logits, deepseek["logits"])
    assert_modes_match_logits(model, tc, tokens, deepseek["logits"], n0=13, chunk=None)


def test_chunk_and_verify_refuse_mla_as_the_reference(deepseek):
    """The reference's message; the paged engine with chunked prefill meets
    it at its first chunk, and the speculative engine refuses MLA when it
    is built."""
    jc, tc = deepseek["jc"], deepseek["tc"]
    model = from_jax(deepseek["np_params"], tc, device="cpu")
    x = torch.zeros((1, 3, tc.d_model))
    for mode in ("chunk", "verify"):
        with pytest.raises(NotImplementedError) as want:
            jattn.attention_apply(None, jnp.zeros((1, 3, tc.d_model)), cfg=jc, mode=mode)
        with pytest.raises(NotImplementedError) as got:
            attn.attention_apply(None, x, cfg=tc, mode=mode)
        assert str(got.value) == str(want.value)
    eng = PagedDecodeEngine(model, tc, PagedEngineConfig(max_slots=2, max_len=MAX_LEN,
                                                         page_size=8, prefill_chunk=8),
                            device="cpu")
    eng.add_request(_prompt(1, 10, 256), 4)
    with pytest.raises(NotImplementedError, match="whole-prompt prefill"):
        eng.step()
    with pytest.raises(NotImplementedError, match="MLA"):
        SpeculativeDecodeEngine(model, tc, SpeculativeEngineConfig(max_slots=2, page_size=8),
                                device="cpu")


@pytest.mark.parametrize("decode_backend", ["auto", "cuda"])
def test_engine_streams_are_the_jax_models_greedy_streams(deepseek, decode_backend):
    """The slot engine and the paged engine (whole-prompt prefill) on two
    12-token prompts, 12 new tokens each (bf16 caches): each token is the
    argmax of the JAX model's logits over the stream so far (the fixture's
    compiled function, at its shape); the caches at rest are the byte
    model's (the paged one with its block table); an explicit cuda request
    serves on torch and records only the reference's reason."""
    tc = deepseek["tc"]
    model = from_jax(deepseek["np_params"], tc, device="cpu")
    prompts = [_prompt(23, 12, 256), _prompt(24, 12, 256)]
    B.clear_fallback_reports()
    common = dict(max_slots=2, max_len=MAX_LEN, decode_backend=decode_backend)
    slot = DecodeEngine(model, tc, EngineConfig(**common), device="cpu")
    streams = [slot.generate(p, 12) for p in prompts]
    per = tserve.cache_bytes_per_token(tc)["sfa"]
    assert slot.cache_bytes() == per * 2 * MAX_LEN
    paged = PagedDecodeEngine(model, tc, PagedEngineConfig(**common, page_size=8),
                              device="cpu")
    assert [paged.generate(p, 12) for p in prompts] == streams
    assert isinstance(paged.caches[1], tkv.PagedMLASparseKV)
    assert paged.cache_bytes() == per * 8 * paged.num_pages + paged.block_table.numel() * 4
    tokens = np.stack([np.concatenate([p, s]) for p, s in zip(prompts, streams)])
    (_, logits), _ = deepseek["run"](deepseek["jp"], {
        "tokens": jnp.asarray(tokens), "labels": jnp.zeros_like(jnp.asarray(tokens))})
    np.testing.assert_array_equal(np.asarray(logits)[:, 11:-1].argmax(-1), tokens[:, 12:])
    reasons = {(r.selected, r.reason) for r in B.fallback_reports()}
    assert reasons == ({("torch", "sfa_rope_protect dims not supported")}
                       if decode_backend == "cuda" else set())
    B.clear_fallback_reports()
