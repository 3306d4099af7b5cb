"""``sfa_rope_protect`` (paper A.1) in the port against the JAX package, f32.

A protected layer keeps the p leading head dims of q and k dense beside the
top-k of the d - p others; its cache stores those p dims dense
(``k_protect``) and codes whose indices are relative to the trailing
slice, packed at ``idx_dtype(d - p)``. The reduced llama3.2-3b with GQA (4
query heads over 2 kv heads of 32), k 4 and p 8, weights carried from the
JAX tree by ``from_jax``:

  * the caches: ``SparseKV.k_protect`` through writes and a slot insert,
    ``PagedSparseKV.k_protect`` through writes, chunk writes, page inserts
    and gathers, exact;
  * the byte model and the realized caches (llama3.2-3b at full width with
    p 64, the value deepseek-v2 sets: 13,824 B a token at 4 layers);
  * the backends' capabilities and fallback reasons (the JAX ``pallas``
    backends' flags and reasons);
  * the model's loss and every gradient, on the torch backend and through
    an explicit ``cuda`` request, dense emit and a compact request (which
    the seam declines with the reference's reason); its logits, and every
    serving mode (prefill, decode, chunked prefill, verify, paged decode)
    on f32 caches held to them (``assert_modes_match_logits``);
  * the slot, chunked paged and speculative engines' greedy streams
    against the JAX slot engine's.

Tolerance 1e-4; integer indices and moved values exact.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.core import kv_cache as jkv
from repro.models import backends as jB
from repro.models import forward_logits as jax_forward_logits
from repro.models import init as jax_init
from repro.models import loss_fn as jax_loss_fn
from repro.serve import kv_cache as jserve
from repro.serve.engine import DecodeEngine as JaxEngine
from repro.serve.engine import EngineConfig as JaxEngineConfig
from repro_torch.configs import get_config
from repro_torch.core import kv_cache as tkv
from repro_torch.interop import from_jax
from repro_torch.models import attention as attn
from repro_torch.models import backends as B
from repro_torch.core.kv_cache import kv_cache_nodes
from repro_torch.models import (
    decode_step, forward_logits, init_decode_caches, init_paged_decode_caches, loss_fn, prefill,
    prefill_chunk, verify_step,
)
from repro_torch.models.model import insert_slot
from repro_torch.serve import (
    DecodeEngine, EngineConfig, PagedDecodeEngine, PagedEngineConfig, SpeculativeDecodeEngine,
    SpeculativeEngineConfig,
)
from repro_torch.serve import kv_cache as tserve

ARCH = "llama3.2-3b"
P = 8
TOL = 1e-4
MAX_LEN = 48


def _pair(p=P):
    """(JAX config, port config): reduced, f32, 4 query heads over 2 kv
    heads, ``sfa_rope_protect`` p."""
    out = []
    for get in (jax_get_config, get_config):
        c = dataclasses.replace(get(ARCH).reduced(), dtype="float32", loss_chunk=16)
        out.append(dataclasses.replace(c, attention=dataclasses.replace(
            c.attention, num_kv_heads=2, sfa_rope_protect=p)))
    return out


def _eq(t, j):
    np.testing.assert_array_equal(t.numpy() if isinstance(t, torch.Tensor) else t,
                                  np.asarray(j))


def _same(t, j):
    names = [n for n, _ in t._tensors()]
    assert names == [f.name for f in dataclasses.fields(j)
                     if f.name != "block_table" and getattr(j, f.name) is not None]
    for name in names:
        _eq(getattr(t, name), getattr(j, name))


def _close(t, j, tol=TOL):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), rtol=0, atol=tol)


# --------------------------------------------------------------------------
# the caches
# --------------------------------------------------------------------------

HKV, K, D, DV, PAGE, MP, SLOTS = 2, 4, 24, 32, 4, 3, 2
POOL = SLOTS * MP + 1


def _tokens(rs, b, c):
    idx = np.sort(np.argsort(rs.rand(b, c, HKV, D), -1)[..., :K], -1).astype(np.int32)
    return {"k_vals": rs.randn(b, c, HKV, K).astype(np.float32), "k_idx": idx,
            "v": rs.randn(b, c, HKV, DV).astype(np.float32),
            "k_protect": rs.randn(b, c, HKV, P).astype(np.float32)}


def _both(cls_t, cls_j, arrays, **extra):
    return (cls_t(**{n: torch.from_numpy(a.copy()) for n, a in arrays.items()},
                  **{n: torch.from_numpy(a) for n, a in extra.items()}),
            cls_j(**{n: jnp.asarray(a) for n, a in arrays.items()},
                  **{n: jnp.asarray(a) for n, a in extra.items()}))


def test_sparse_kv_k_protect_writes_and_slot_insert_equal_jax():
    rs = np.random.RandomState(0)
    b, n = 2, 10
    leaves = {"k_vals": rs.randn(b, n, HKV, K).astype(np.float32),
              "k_idx": rs.randint(0, D, (b, n, HKV, K)).astype(np.uint8),
              "v": rs.randn(b, n, HKV, DV).astype(np.float32),
              "k_protect": rs.randn(b, n, HKV, P).astype(np.float32)}
    t, j = _both(tkv.SparseKV, jkv.SparseKV, leaves)
    up = _tokens(rs, b, 1)
    pos = np.array([3, 9], np.int32)
    t.write(torch.from_numpy(pos), **{k: torch.from_numpy(a) for k, a in up.items()})
    j = j.write(jnp.asarray(pos), **{k: jnp.asarray(a) for k, a in up.items()})
    _same(t, j)
    # a layer-stacked 2-layer cache takes a 4-token prefill in slot 1
    tst = tkv.SparseKV.stack([t, t])
    jst = jax.tree.map(lambda x: jnp.stack([x, x]), j)
    src = {k: np.stack([a, -a]) for k, a in _tokens(rs, 1, 4).items()}
    src["k_idx"] = src["k_idx"] % D
    s_t, s_j = _both(tkv.SparseKV, jkv.SparseKV, src)
    tst.insert_slot(s_t, slot=1, max_len=n)
    jst = jst.insert_slot(s_j, slot=1, max_len=n)
    _same(tst, jst)
    # a cache without protected dims has no k_protect leaf at all
    plain = tkv.SparseKV(*(torch.zeros(1, 2, 1, 1) for _ in range(3)))
    assert [n for n, _ in plain._tensors()] == ["k_vals", "k_idx", "v"]
    assert tkv.SparseKV.stack([plain, plain]).k_protect is None


def _paged(rs):
    pools = {"k_vals": rs.randn(HKV, POOL, PAGE, K).astype(np.float32),
             "k_idx": rs.randint(0, D, (HKV, POOL, PAGE, K)).astype(np.uint8),
             "v": rs.randn(HKV, POOL, PAGE, DV).astype(np.float32),
             "k_protect": rs.randn(HKV, POOL, PAGE, P).astype(np.float32)}
    bt = rs.permutation(np.arange(1, POOL))[:SLOTS * MP].reshape(SLOTS, MP).astype(np.int32)
    return pools, bt


def test_paged_sparse_kv_k_protect_equals_jax():
    """Ragged decode writes (slot 1 past the table: the trash page), a
    chunk write that runs past the table, the gathered views, and a page
    insert into a 2-layer stacked pool."""
    rs = np.random.RandomState(1)
    pools, bt = _paged(rs)
    t, j = _both(tkv.PagedSparseKV, jkv.PagedSparseKV, pools, block_table=bt)
    step = _tokens(rs, SLOTS, 1)
    pos = np.array([5, MP * PAGE + 1], np.int32)
    chunk = _tokens(rs, 1, 5)
    t.write(torch.from_numpy(pos), **{k: torch.from_numpy(a) for k, a in step.items()})
    t.write_chunk(0, MP * PAGE - 2, **{k: torch.from_numpy(a) for k, a in chunk.items()})

    @jax.jit
    def jax_side(j, pos, step, chunk):
        j = j.write(pos, **step).write_chunk(jnp.int32(0), jnp.int32(MP * PAGE - 2), **chunk)
        return j, j.gather(), j.gather_slot(jnp.int32(1))

    j, jg, jg1 = jax_side(j, jnp.asarray(pos), step, chunk)
    _same(t, j)
    _same(t.gather(), jg)
    _same(t.gather_slot(1), jg1)
    stacked = {n: np.stack([a, a + 1]) for n, a in pools.items()}
    t, j = _both(tkv.PagedSparseKV, jkv.PagedSparseKV, stacked, block_table=bt)
    j = dataclasses.replace(j, block_table=jnp.asarray(np.stack([bt, bt])))
    src = {k: np.stack([a, 2 * a]) for k, a in _tokens(rs, 1, 7).items()}
    s_t, s_j = _both(tkv.SparseKV, jkv.SparseKV, src)
    pids = bt[1, :2]
    t.insert_pages(s_t, torch.from_numpy(pids).long())
    _same(t, jax.jit(lambda j, s, p: j.insert_pages(s, p))(j, s_j, jnp.asarray(pids)))


# --------------------------------------------------------------------------
# the byte model, the backends
# --------------------------------------------------------------------------

@pytest.mark.parametrize("full", [True, False], ids=["full", "reduced"])
def test_byte_model_and_realized_caches_equal_jax(full):
    """llama3.2-3b at full width with p 64 (4 of 28 layers): 4 layers x 8
    kv heads x ((16 x 3 + 64 x 2) + 128 x 2) = 13,824 B a token; the
    reduced config with p 8. The caches a config allocates realize the
    model, contiguous and paged."""
    jc, tc = _pair(64) if full else _pair()
    if full:
        jc = dataclasses.replace(jax_get_config(ARCH), num_layers=4, attention=dataclasses.replace(
            jax_get_config(ARCH).attention, sfa_rope_protect=64))
        tc = dataclasses.replace(get_config(ARCH), num_layers=4, attention=dataclasses.replace(
            get_config(ARCH).attention, sfa_rope_protect=64))
    per = tserve.cache_bytes_per_token(tc)
    assert per == jserve.cache_bytes_per_token(jc)
    if full:
        assert per["sfa"] == 13_824
    assert tserve.realized_cache_bytes_per_token(tc) == per["sfa"]
    assert tserve.paged_page_bytes(tc, page_size=8) == jserve.paged_page_bytes(jc, page_size=8)
    cache = init_decode_caches(tc, 1, 8, device="meta")[0]
    a = tc.attention
    assert cache.k_idx.dtype == torch.uint8
    assert tuple(cache.k_protect.shape) == (tc.num_layers, 1, 8, a.num_kv_heads,
                                            a.sfa_rope_protect)


def _jreq(**kw):
    return jB.AttentionRequest(**dict(dict(mode="full", sparse=True), **kw))


def _treq(**kw):
    return B.AttentionRequest(**dict(dict(mode="full", sparse=True), **kw))


def test_capabilities_mirror_the_reference():
    """torch serves windows, protected dims and MLA (the JAX xla backend);
    cuda and cuda_fm decline all three (the JAX pallas and pallas_fm)."""
    for tname, jname in (("torch", "xla"), ("cuda", "pallas"), ("cuda_fm", "pallas_fm")):
        tc, jc = B.get_backend(tname).caps, jB.get_backend(jname).caps
        for flag in ("window", "rope_protect", "mla", "full", "decode", "paged",
                     "persistent_cache", "speculative"):
            assert getattr(tc, flag) == getattr(jc, flag), (tname, flag)


@pytest.mark.parametrize("kw", [dict(rope_protect=True), dict(mla=True), dict(window=True),
                                dict(mode="decode", rope_protect=True),
                                dict(mode="decode", mla=True, rope_protect=True)])
def test_capability_fallback_reasons_equal_the_reference(kw):
    B.clear_fallback_reports()
    sel = B.select_backend("cuda", _treq(**kw), where="test/caps")
    want = jB.select_backend("pallas", _jreq(**kw)).reason
    assert sel.backend.name == "torch" and sel.reason == want
    assert [(r.requested, r.selected, r.reason) for r in B.fallback_reports()] == \
        [("cuda", "torch", want)]
    if kw.get("mode") == "decode":
        assert B.select_backend("cuda_fm", _treq(**kw)).reason == \
            jB.select_backend("pallas_fm", _jreq(**kw)).reason
    assert B.resolve_backend_name("auto", _treq(**kw)) == "torch"
    B.clear_fallback_reports()


# --------------------------------------------------------------------------
# the model
# --------------------------------------------------------------------------

def _flat_np(tree, prefix=""):
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix[:-1]: np.asarray(tree)}
    out = {}
    for key, sub in items:
        out.update(_flat_np(sub, f"{prefix}{key}."))
    return out


@pytest.fixture(scope="module")
def protected():
    jc, tc = _pair()
    jc = dataclasses.replace(jc, attention=dataclasses.replace(jc.attention, backend="xla"))
    jp = jax_init(jax.random.PRNGKey(5), jc)
    rs = np.random.RandomState(6)
    batch = {"tokens": rs.randint(0, jc.vocab_size, (2, 24)).astype(np.int32),
             "labels": rs.randint(0, jc.vocab_size, (2, 24)).astype(np.int32)}

    def run(p, b):
        (loss, _), grads = jax.value_and_grad(lambda p: jax_loss_fn(p, b, jc), has_aux=True)(p)
        return loss, grads, jax_forward_logits(p, {"tokens": b["tokens"]}, jc).logits

    loss, grads, logits = jax.jit(run)(jp, {k: jnp.asarray(v) for k, v in batch.items()})
    return dict(jc=jc, tc=tc, jp=jp, np_params=jax.tree.map(np.asarray, jp), batch=batch,
                loss=float(loss), grads=_flat_np(grads), logits=np.asarray(logits))


@pytest.mark.parametrize("backend,emit", [("torch", "dense"), ("cuda", "dense"),
                                          ("cuda", "compact")])
def test_loss_and_every_grad_match_jax(protected, backend, emit):
    """An explicit cuda request falls back to torch with the protect
    reason; a compact request does not take the seam and says why."""
    tc = protected["tc"]
    tc = dataclasses.replace(tc, attention=dataclasses.replace(
        tc.attention, backend=backend, bwd_emit=emit))
    B.clear_fallback_reports()
    attn.clear_compact_seam_reports()
    model = from_jax(protected["np_params"], tc, device="cpu").requires_grad_(True)
    loss, _ = loss_fn(model, {k: torch.from_numpy(v).long()
                              for k, v in protected["batch"].items()}, tc)
    named = dict(model.named_parameters())
    grads = dict(zip(named, torch.autograd.grad(loss, list(named.values()))))
    np.testing.assert_allclose(float(loss), protected["loss"], rtol=0, atol=TOL)
    assert set(grads) == set(protected["grads"])
    for name, g in grads.items():
        np.testing.assert_allclose(g.numpy(), protected["grads"][name], rtol=0, atol=TOL,
                                   err_msg=name)
    reasons = {r.reason for r in B.fallback_reports()}
    assert reasons == ({"sfa_rope_protect dims not supported"} if backend == "cuda" else set())
    seams = attn.compact_seam_reports()
    if emit == "compact":
        assert [(s.taken, s.reason) for s in seams] == \
            [(False, "sfa_rope_protect keeps leading dims dense outside the codes")]
    else:
        assert not seams
    B.clear_fallback_reports()
    attn.clear_compact_seam_reports()


def _prompt(seed, n, vocab):
    return np.random.RandomState(seed).randint(0, vocab, size=n).astype(np.int32)


def assert_modes_match_logits(model, cfg, tokens, want, n0, *, chunk=4, page=4):
    """Every serving mode of the port's model against ``want``, the JAX
    package's full-sequence logits (2, n, vocab) of ``tokens`` (2, n), on
    f32 caches: prefill of both rows' first ``n0`` tokens into a slot
    cache, then teacher-forced decode steps of both slots to n; then a
    paged cache (a shuffled block table, pages of ``page``): row 1's
    prefill in ``chunk``-token chunks (``chunk=None``: whole, landed with
    ``insert_pages``), a verify pass over the next 3 tokens (with chunks
    only) and paged decode steps to n, slot 0 dead at the past-the-table
    sentinel. Each mode scores what the full sequence scores, so each gives
    the full-sequence logits at its positions within 1e-4."""
    n = tokens.shape[1]
    t = torch.from_numpy(np.asarray(tokens)).long()
    caches = init_decode_caches(cfg, 2, n, torch.float32, device="cpu")
    for row in (0, 1):
        lg, one = prefill(model, {"tokens": t[row:row + 1, :n0]}, cfg)
        _close(lg[0], want[row, n0 - 1])
        insert_slot(caches, one, slot=row, max_len=n)
    with torch.no_grad():
        for i in range(n0, n):
            lg, caches = decode_step(model, t[:, i], caches, torch.tensor([i, i]), cfg)
            _close(lg, want[:, i])
    mp = -(-n // page)
    caches = init_paged_decode_caches(cfg, slots=2, num_pages=2 * mp + 1, page_size=page,
                                      max_pages=mp, dtype=torch.float32, device="cpu")
    table = np.random.RandomState(n).permutation(np.arange(1, 2 * mp + 1)).reshape(2, mp)
    kv_cache_nodes(caches)[0].block_table.copy_(torch.from_numpy(table))
    if chunk is None:
        lg, one = prefill(model, {"tokens": t[1:, :n0]}, cfg)
        npg = -(-n0 // page)
        for dst, src in zip(caches, one):
            dst.insert_pages(src, torch.from_numpy(table[1, :npg]).long())
        pos = n0
    else:
        for off in range(0, n0, chunk):
            take = min(chunk, n0 - off)
            toks = torch.zeros((1, chunk), dtype=torch.long)
            toks[0, :take] = t[1, off:off + take]
            lg, caches = prefill_chunk(model, toks, caches, off, take, 1, cfg)
        lg, caches = verify_step(model, t[1:, n0:n0 + 3], caches, n0, 1, cfg)
        _close(lg, want[1, n0:n0 + 3])
        pos = n0 + 3
    _close(lg[-1], want[1, pos - 1])            # the prefill's row, verify's last
    with torch.no_grad():
        for i in range(pos, n):
            lg, caches = decode_step(model, t[:, i], caches, torch.tensor([mp * page, i]), cfg)
            _close(lg[1], want[1, i])


def test_model_logits_and_every_mode_match_jax(protected):
    """forward_logits, then prefill, decode, chunked prefill, verify and
    paged decode held to the same JAX logits."""
    tc = protected["tc"]
    model = from_jax(protected["np_params"], tc, device="cpu")
    tokens = protected["batch"]["tokens"]
    with torch.no_grad():
        logits = forward_logits(model, {"tokens": torch.from_numpy(tokens).long()}, tc)
    _close(logits, protected["logits"])
    assert_modes_match_logits(model, tc, tokens, protected["logits"], n0=14)


def _streams(eng, prompts, max_new, paged):
    ids = [eng.add_request(p, max_new_tokens=max_new) for p in prompts]
    while eng.busy if paged else eng.live.any():
        eng.step()
    return [eng.outputs[i] for i in ids]


@pytest.fixture(scope="module")
def jax_stream(protected):
    """The JAX slot engine's greedy stream of one prompt (bf16 caches)."""
    prompt = _prompt(9, 13, 256)
    eng = JaxEngine(protected["jp"], protected["jc"], JaxEngineConfig(
        max_slots=2, max_len=MAX_LEN, decode_backend="xla"))
    return prompt, eng.generate(prompt, max_new_tokens=12)


@pytest.mark.parametrize("decode_backend", ["auto", "cuda"])
def test_engine_streams_match_jax(protected, jax_stream, decode_backend):
    """The slot engine, the paged engine with chunked prefill (8-token
    chunks) and the speculative engine (draft_len 3, k' 1 of k 4) give the
    JAX engine's greedy stream; an explicit cuda request serves them on
    torch, recording only the protect reason."""
    tc = protected["tc"]
    prompt, want = jax_stream
    model = from_jax(protected["np_params"], tc, device="cpu")
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
    # the 11 tokens after the prefill's, some of them drafted and accepted
    assert spec.spec_stats["emitted"] == 11 and 0 < spec.spec_stats["alpha"] <= 1
    reasons = {(r.selected, r.reason) for r in B.fallback_reports()}
    assert reasons == ({("torch", "sfa_rope_protect dims not supported")}
                       if decode_backend == "cuda" else set())
    B.clear_fallback_reports()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_oracle_selection_is_the_references(dtype):
    """``sparsify`` and ``topk_st`` (the torch backend's top-k, one keyed
    torch.topk) select what ``topk_mask``, the reference's bisection,
    selects on tie-heavy rows: ties to the lower index, indices ascending
    (JAX parity of ``topk_mask`` is tests/test_torch_sparse.py's)."""
    from repro_torch.core.sparse import sparsify, topk_mask, topk_st
    rs = np.random.RandomState(3)
    x = rs.randn(64, 96).astype(np.float32)
    x[:, 1] = -x[:, 0]
    x[::2, 5] = x[::2, 4]
    x[::3] = np.round(x[::3])
    t = torch.from_numpy(x).to(dtype)
    for k in (1, 4, 16, 95, 96, 200):
        mask = topk_mask(t, k)
        code = sparsify(t, k)
        assert code.indices.shape[-1] == min(k, 96)
        assert (code.indices[:, 1:] > code.indices[:, :-1]).all()
        assert torch.equal(torch.zeros_like(mask).scatter_(-1, code.indices, True), mask)
        assert torch.equal(code.values, t.gather(-1, code.indices))
        assert torch.equal(topk_st(t, k), t * mask.to(dtype))
