"""The frontend families against the JAX package on the CPU, f32.

paligemma-3b (vlm: a 256-patch prefix through a dense connector, MQA, head
dim 256, RoPE) and hubert-xlarge (audio: frames through a dense frontend,
encoder-only, bidirectional, head dim 80, learned positions that the
reference never reads), each reduced with its head dim set back to the full
config's (``reduced()`` caps it at 32), weights carried from the JAX tree by
``from_jax``:

  * paligemma: the loss and every gradient with the patch prefix labelled
    -1, through the port's ``cuda`` backend (the wrappers' plain versions)
    and its ``torch`` oracle; prefill and teacher-forced decode logits with
    patches on f32 caches; the ``DecodeEngine`` stream with ``extra_inputs``
    against the JAX engine's; the prefix-overflow error;
  * hubert: ``forward_logits``, the loss and every gradient, bidirectional;
    ``pos.w``'s gradient is zero in both packages; decode is refused;
  * the plain ``flash_sfa`` / ``flash_sfa_bwd`` at d = dv 80 with
    ``causal=False`` and the plain decodes (rows 10-14) at dv 256 with 8
    query heads over 1 kv head, against the JAX kernels in interpret mode;
  * ``kernel_shape_reason`` at the new head dims, ``to_batch`` on float
    features, ``analytic.param_count`` and the parameter tree's names and
    shapes against JAX for both full configs.

Tolerance 1e-4 (1e-5 on the decode kernels). Each model-level JAX
reference compiles once (module fixtures).
"""
import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.core.kv_cache import KVCache
from repro.kernels.flash_sfa import flash_sfa as jax_flash_sfa
from repro.kernels.flash_sfa_bwd import flash_sfa_bwd as jax_flash_sfa_bwd
from repro.models import decode_step as jax_decode_step
from repro.models import forward_logits as jax_forward_logits
from repro.models import init as jax_init
from repro.models import init_decode_caches as jax_init_caches
from repro.models import loss_fn as jax_loss_fn
from repro.models import prefill as jax_prefill
from repro.serve.engine import DecodeEngine as JaxEngine
from repro.serve.engine import EngineConfig as JaxEngineConfig
from repro.utils import analytic as jax_analytic
from repro_torch.configs import NOT_YET_PORTED, get_config
from repro_torch.interop import _flatten, from_jax
from repro_torch.kernels import (
    flash_sfa, flash_sfa_bwd, flash_sfa_decode, flash_sfa_decode_fm, flash_sfa_decode_fm_paged,
    flash_sfa_decode_multi, flash_sfa_decode_paged,
)
from repro_torch.launch import serve as serve_launcher
from repro_torch.models import (
    decode_step, forward_logits, init_decode_caches, loss_fn, prefill, segments,
)
from repro_torch.models import attention as attn
from repro_torch.models.backends import (
    clear_fallback_reports, fallback_reports, kernel_shape_reason, resolve_backend_name,
)
from repro_torch.models.model import insert_slot, param_tree
from repro_torch.serve import DecodeEngine, EngineConfig
from repro_torch.train.train_step import to_batch
from repro_torch.utils import analytic

jk = importlib.import_module("repro.kernels.flash_sfa_decode")

TOL = 1e-4
MAX_LEN = 48
ARCHS = {"paligemma-3b": 256, "hubert-xlarge": 80}     # arch -> its full head dim


def _pair(name):
    """(JAX config, port config): reduced, f32, the full head dim."""
    out = []
    for get in (jax_get_config, get_config):
        c = dataclasses.replace(get(name).reduced(), dtype="float32", loss_chunk=16)
        out.append(dataclasses.replace(c, attention=dataclasses.replace(
            c.attention, head_dim=ARCHS[name])))
    return out


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


def _jax_reference(jc, batch, seed):
    """JAX parameters (numpy), loss and every leaf gradient on the XLA
    backend."""
    jc = dataclasses.replace(jc, attention=dataclasses.replace(jc.attention, backend="xla"))
    jp = jax_init(jax.random.PRNGKey(seed), jc)
    (loss, _), grads = jax.jit(jax.value_and_grad(
        lambda p, b: jax_loss_fn(p, b, jc), has_aux=True))(
            jp, {k: jnp.asarray(v) for k, v in batch.items()})
    return jc, jp, jax.tree.map(np.asarray, jp), float(loss), _flat_np(grads)


def _port_grads(tc, np_params, batch, backend):
    """The port's loss and every leaf gradient (an unused leaf's as zeros,
    with the names of the leaves autograd found unused)."""
    tc = dataclasses.replace(tc, attention=dataclasses.replace(tc.attention, backend=backend))
    model = from_jax(np_params, tc, device="cpu").requires_grad_(True)
    loss, _ = loss_fn(model, to_batch(batch, "cpu"), tc)
    named = dict(model.named_parameters())
    grads = torch.autograd.grad(loss, list(named.values()), allow_unused=True)
    unused = {n for n, g in zip(named, grads) if g is None}
    return float(loss.detach()), {n: (torch.zeros_like(p) if g is None else g)
                                  for (n, p), g in zip(named.items(), grads)}, unused


def _assert_grads(grads, jgrads):
    assert set(grads) == set(jgrads)
    for name, g in grads.items():
        np.testing.assert_allclose(g.numpy(), jgrads[name], rtol=0, atol=TOL, err_msg=name)


# --------------------------------------------------------------------------
# the configs, the parameter tree, the analytic count
# --------------------------------------------------------------------------

@pytest.mark.parametrize("reduced", [False, True], ids=["full", "reduced"])
@pytest.mark.parametrize("name", list(ARCHS))
def test_frontend_configs_equal_the_reference(name, reduced):
    jc, tc = jax_get_config(name), get_config(name)
    if reduced:
        jc, tc = jc.reduced(), tc.reduced()
    jd, td = dataclasses.asdict(jc), dataclasses.asdict(tc)
    for d in (jd, td):
        for field in ("backend", "decode_backend"):
            d["attention"].pop(field)
    assert td == jd
    assert name not in NOT_YET_PORTED
    assert segments(tc) == [("block_dense", tc.num_layers)]


@pytest.mark.parametrize("name", list(ARCHS))
def test_full_parameter_tree_and_count_equal_the_reference(name):
    """Every leaf name and shape of the full config's tree (audio: no
    ``embed``; a dense ``frontend``; hubert's learned ``pos.w`` and untied
    ``lm_head``), and ``param_count`` / ``step_flops`` / ``step_hbm_bytes``
    of the analytic model."""
    jc, tc = jax_get_config(name), get_config(name)
    jshapes = {k: tuple(v.shape) for k, v in _flatten(jax.eval_shape(
        lambda: jax_init(jax.random.PRNGKey(0), jc))).items()}
    tshapes = {k: tuple(v.shape) for k, v in _flatten(param_tree(tc, device="meta")).items()}
    assert tshapes == jshapes
    assert ("embed.w" in tshapes) == (name == "paligemma-3b")
    assert tshapes["frontend.w"] == (tc.frontend.input_dim, tc.d_model)
    assert analytic.param_count(tc) == jax_analytic.param_count(jc)
    from repro.configs.base import ShapeConfig as JaxShape
    from repro_torch.configs.base import ShapeConfig
    for kind in ("train", "prefill"):
        got = analytic.step_flops(tc, ShapeConfig("s", 1024, 8, kind))
        assert got == jax_analytic.step_flops(jc, JaxShape("s", 1024, 8, kind))
        assert analytic.step_hbm_bytes(tc, ShapeConfig("s", 1024, 8, kind), 1) == \
            jax_analytic.step_hbm_bytes(jc, JaxShape("s", 1024, 8, kind), 1)


def test_to_batch_keeps_float_features_float():
    """Tokens and labels become int64; frames and patches stay floats, in
    the model's dtype."""
    rs = np.random.RandomState(0)
    batch = {"tokens": rs.randint(0, 9, (2, 5)).astype(np.int32),
             "labels": rs.randint(0, 9, (2, 5)).astype(np.int32),
             "frames": rs.randn(2, 5, 3).astype(np.float32),
             "patches": rs.randn(2, 4, 3).astype(np.float32)}
    out = to_batch(batch, "cpu")
    assert out["tokens"].dtype == out["labels"].dtype == torch.int64
    for key in ("frames", "patches"):
        assert out[key].dtype == torch.float32
        np.testing.assert_array_equal(out[key].numpy(), batch[key])
    assert to_batch(batch, "cpu", torch.bfloat16)["frames"].dtype == torch.bfloat16


# --------------------------------------------------------------------------
# the kernels' new shapes and the backend's routing
# --------------------------------------------------------------------------

@pytest.mark.parametrize("hd,mode,backward,declined", [
    (80, "full", True, None),               # hubert trains on the CUDA kernels
    (80, "full", False, None),
    (256, "full", False, None),             # paligemma's prefill
    # a training layer at dv 256: the tensor-core backward in bf16, the
    # CUDA-core body's 32-row tiles in f32
    (256, "full", True, None),
    (96, "full", True, "v head dim 96"),    # no body at 96
    (256, "decode", True, None),
    (80, "decode", True, "v head dim 80"),
])
def test_kernel_shape_reason_checks_each_path_against_its_own_list(hd, mode, backward,
                                                                    declined):
    cfg = dataclasses.replace(get_config("paligemma-3b"))
    a = dataclasses.replace(cfg.attention, head_dim=hd)
    req = attn._request(a, mode=mode, window=None, backward=backward)
    reason = kernel_shape_reason(req)
    if declined is None:
        assert reason is None and resolve_backend_name("auto", req) == "cuda"
    else:
        assert declined in reason
        assert resolve_backend_name("auto", req) == "torch"


def test_cuda_backend_declares_bidirectional_and_hubert_resolves_to_it():
    from repro_torch.models.backends import get_backend
    assert get_backend("cuda").caps.bidirectional
    a = get_config("hubert-xlarge").attention
    req = attn._request(a, mode="full", window=None)
    assert req.causal is False and resolve_backend_name("auto", req) == "cuda"
    # no RoPE and head dim 80: a compact request takes the seam, as in the reference
    c = dataclasses.replace(get_config("hubert-xlarge"), attention=dataclasses.replace(
        a, bwd_emit="compact"))
    assert attn.compact_seam_ineligible_reason(c) is None


def _codes(rs, bh, n, k, d):
    vals = rs.randn(bh, n, k).astype(np.float32)
    idx = np.sort(np.argsort(rs.rand(bh, n, d), -1)[..., :k], -1).astype(np.int32)
    return vals, idx


def test_flash_sfa_and_its_backward_at_d80_bidirectional_match_jax():
    rs = np.random.RandomState(7)
    bh, n, k, d = 2, 96, 16, 80
    qv, qi = _codes(rs, bh, n, k, d)
    kv, ki = _codes(rs, bh, n, k, d)
    v, g = (rs.randn(bh, n, d).astype(np.float32) for _ in range(2))
    jin = [jnp.asarray(a) for a in (qv, qi, kv, ki, v)]
    tin = [torch.from_numpy(a) for a in (qv, qi, kv, ki, v)]
    jo, jl = jax_flash_sfa(*jin, d=d, causal=False, return_residuals=True, interpret=True)
    to, tl = flash_sfa(*tin, d=d, causal=False, return_residuals=True)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=0, atol=TOL)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=TOL)
    # bidirectional: the first query sees every key, unlike the causal call
    co = flash_sfa(*tin, d=d, causal=True)
    assert not torch.allclose(co[:, 0], to[:, 0])
    want = jax_flash_sfa_bwd(*jin, jo, jl, jnp.asarray(g), d=d, causal=False,
                             interpret=True)
    got = flash_sfa_bwd(*tin, to, tl, torch.from_numpy(g), d=d, causal=False)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=TOL, err_msg=name)


# rows 10-14 at paligemma's decode geometry: 8 query heads over 1 kv head,
# d = dv 256, k 16, pages of 8 tokens, 4 pages a slot
SLOTS, H, HKV, D, K, PAGE, MP = 2, 8, 1, 256, 16, 8, 4
POOL = SLOTS * MP + 1
DTOL = 1e-5


@pytest.fixture(scope="module")
def decode_data():
    rs = np.random.RandomState(8)
    bt = rs.permutation(np.arange(1, POOL))[:SLOTS * MP].reshape(SLOTS, MP).astype(np.int32)
    idx = np.sort(np.argsort(rs.rand(HKV, POOL, PAGE, D), -1)[..., :K], -1)
    return {
        "bt": bt, "lens": np.array([MP * PAGE - 3, 11], np.int32),
        "kv": rs.randn(HKV, POOL, PAGE, K).astype(np.float32),
        "ki": idx.astype(np.uint8),
        "v": rs.randn(HKV, POOL, PAGE, D).astype(np.float32),
        "kf": rs.randn(HKV, POOL, D, PAGE).astype(np.float32),
        "q": rs.randn(SLOTS * H, D).astype(np.float32),
        "qv": rs.randn(SLOTS * H, K).astype(np.float32),
        "qi": np.sort(np.argsort(rs.rand(SLOTS * H, D), -1)[..., :K], -1).astype(np.int32),
    }


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _dclose(got, want):
    assert got.dtype == torch.float32 and got.shape[-1] == D
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=DTOL)


def test_token_major_decodes_at_dv256_mqa_match_jax(decode_data):
    """Rows 10, 11, 12: the contiguous (b, n, 1, k) cache, the pools, and
    C = 3 verify queries of slot 1 (JAX: the kv head repeated to 8)."""
    dd = decode_data
    n = MP * PAGE
    leaves = {nm: dd[nm][:, dd["bt"]].reshape(HKV, SLOTS, n, -1).transpose(1, 2, 0, 3)
              for nm in ("kv", "ki", "v")}                          # (b, n, hkv, F)
    lens = np.repeat(dd["lens"], H).astype(np.int32)
    folded = {nm: np.repeat(x, H, axis=2).transpose(0, 2, 1, 3).reshape(SLOTS * H, n, -1)
              for nm, x in leaves.items()}
    want = jk.flash_sfa_decode(*(jnp.asarray(a) for a in (
        dd["q"], folded["kv"], folded["ki"].astype(np.int32), folded["v"], lens)), d=D,
        interpret=True)
    _dclose(flash_sfa_decode(_t(dd["q"]), _t(leaves["kv"]), _t(leaves["ki"]), _t(leaves["v"]),
                             _t(lens), d=D), want)
    want = jk.flash_sfa_decode_paged(*(jnp.asarray(dd[nm]) for nm in (
        "q", "kv", "ki", "v", "bt", "lens")), d=D, heads=H, interpret=True)
    _dclose(flash_sfa_decode_paged(*(_t(dd[nm]) for nm in ("q", "kv", "ki", "v", "bt", "lens")),
                                   d=D, heads=H), want)
    c, slot, cache_len = 3, 1, 17
    q = np.random.RandomState(9).randn(c * H, D).astype(np.float32)
    clens = np.repeat(cache_len + np.arange(c) + 1, H).astype(np.int32)
    views = [dd[nm][:, dd["bt"][slot]].reshape(HKV, n, -1) for nm in ("kv", "ki", "v")]
    want = jk.flash_sfa_decode_multi(jnp.asarray(q), *(jnp.asarray(np.repeat(x, H, 0))
                                                       for x in views),
                                     jnp.asarray(clens), d=D, heads=H, block_n=PAGE,
                                     interpret=True)
    _dclose(flash_sfa_decode_multi(_t(q), _t(dd["kv"]), _t(dd["ki"]), _t(dd["v"]), _t(clens),
                                   d=D, heads=H, block_tables=_t(dd["bt"]), slot=slot), want)


def test_feature_major_decodes_at_dv256_mqa_match_jax(decode_data):
    """Rows 13, 14: the image (slots, d, n) read by 8 query rows each
    (group 8), and its pools through the block table."""
    dd = decode_data
    n = MP * PAGE
    kf = dd["kf"][:, dd["bt"]].transpose(1, 0, 3, 2, 4).reshape(SLOTS * HKV, D, n)
    v = dd["v"][:, dd["bt"]].transpose(1, 0, 2, 3, 4).reshape(SLOTS * HKV, n, D)
    lens = np.repeat(dd["lens"], H).astype(np.int32)
    want = jk.flash_sfa_decode_fm(*(jnp.asarray(a) for a in (dd["qv"], dd["qi"], kf, v, lens)),
                                  block_n=8, group=H, interpret=True)
    _dclose(flash_sfa_decode_fm(_t(dd["qv"]), _t(dd["qi"]), _t(kf), _t(v), _t(lens), group=H),
            want)
    want = jk.flash_sfa_decode_fm_paged(*(jnp.asarray(dd[nm]) for nm in (
        "qv", "qi", "kf", "v", "bt", "lens")), heads=H, interpret=True)
    _dclose(flash_sfa_decode_fm_paged(*(_t(dd[nm]) for nm in (
        "qv", "qi", "kf", "v", "bt", "lens")), heads=H), want)


# --------------------------------------------------------------------------
# paligemma-3b (vlm)
# --------------------------------------------------------------------------

def _patches(seed, cfg, b=1):
    fe = cfg.frontend
    return np.random.RandomState(seed).randn(b, fe.prefix_len, fe.input_dim).astype(np.float32)


def _prompt(seed, n, vocab):
    return np.random.RandomState(seed).randint(0, vocab, size=n).astype(np.int32)


@pytest.fixture(scope="module")
def paligemma():
    jc, tc = _pair("paligemma-3b")
    rs = np.random.RandomState(20)
    b, n = 2, 24
    batch = {"tokens": rs.randint(0, jc.vocab_size, (b, n)).astype(np.int32),
             "patches": _patches(21, jc, b),
             "labels": rs.randint(0, jc.vocab_size, (b, n)).astype(np.int32)}
    batch["labels"][:, :2] = -1
    jc, jp, np_params, loss, grads = _jax_reference(jc, batch, seed=4)
    return dict(jc=jc, tc=tc, jp=jp, np_params=np_params, batch=batch, loss=loss, grads=grads)


@pytest.mark.parametrize("backend", ["cuda", "torch"])
def test_paligemma_loss_and_every_grad_match_jax(paligemma, backend):
    """An explicit "cuda" request takes the float32 training layer at dv 256
    (the f32 backward's CUDA-core body runs 32-row tiles there; on CPU
    tensors the wrappers' plain versions), recording no fallback; so does
    the torch backend."""
    tc = paligemma["tc"]
    assert tc.attention.num_kv_heads == 1 and tc.attention.head_dim == 256
    clear_fallback_reports()
    loss, grads, unused = _port_grads(tc, paligemma["np_params"], paligemma["batch"], backend)
    reasons = {r.reason for r in fallback_reports()}
    clear_fallback_reports()
    assert reasons == set()
    assert not unused
    np.testing.assert_allclose(loss, paligemma["loss"], rtol=0, atol=TOL)
    _assert_grads(grads, paligemma["grads"])
    assert np.abs(paligemma["grads"]["frontend.w"]).max() > 0


def test_paligemma_prefix_gets_no_labels(paligemma):
    """The loss over text labels equals the loss with the patch prefix
    labelled -1 explicitly."""
    tc, batch = paligemma["tc"], paligemma["batch"]
    model = from_jax(paligemma["np_params"], tc, device="cpu")
    full = dict(batch, labels=np.concatenate(
        [np.full((2, tc.frontend.prefix_len), -1, np.int32), batch["labels"]], 1))
    with torch.no_grad():
        a, ma = loss_fn(model, to_batch(batch, "cpu"), tc)
        b, mb = loss_fn(model, to_batch(full, "cpu"), tc)
    assert float(a) == float(b) and int(ma["tokens"]) == int(mb["tokens"])


def test_paligemma_prefill_and_decode_logits_match_jax(paligemma):
    """Prefill logits with the patch prefix, then teacher-forced decode
    steps on f32 caches at positions past it."""
    jc, tc, jp = paligemma["jc"], paligemma["tc"], paligemma["jp"]
    model = from_jax(paligemma["np_params"], tc, device="cpu")
    prompt, patches = _prompt(30, 9, tc.vocab_size), _patches(31, tc)
    jl, one = jax.jit(lambda p, t, x: jax_prefill(p, {"tokens": t, "patches": x}, jc))(
        jp, jnp.asarray(prompt[None]), jnp.asarray(patches))
    jcaches = jax.tree.map(lambda dst, src: dst.insert_slot(src, slot=0, max_len=MAX_LEN),
                           jax_init_caches(jc, 1, MAX_LEN, jnp.float32), one,
                           is_leaf=lambda x: isinstance(x, KVCache))
    tl, tone = prefill(model, to_batch({"tokens": prompt[None], "patches": patches}, "cpu"), tc)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=TOL)
    tcaches = insert_slot(init_decode_caches(tc, 1, MAX_LEN, torch.float32, device="cpu"),
                          tone, slot=0, max_len=MAX_LEN)
    step = jax.jit(lambda p, t, c, ln: jax_decode_step(p, t, c, ln, jc))
    n = len(prompt) + tc.frontend.prefix_len
    for i, tok in enumerate(_prompt(32, 5, tc.vocab_size)):
        jl, jcaches = step(jp, jnp.asarray([tok], jnp.int32), jcaches,
                           jnp.asarray([n + i], jnp.int32))
        tl, tcaches = decode_step(model, torch.tensor([int(tok)]), tcaches,
                                  torch.tensor([n + i]), tc)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=TOL)
    np.testing.assert_array_equal(tcaches[0].k_idx.numpy(), np.asarray(jcaches[0].k_idx))


@pytest.fixture(scope="module")
def paligemma_streams(paligemma):
    """The JAX engine's greedy streams of two requests with patches and one
    text-only request."""
    reqs = [(_prompt(34, 7, 256), _patches(35, paligemma["tc"])[0]),
            (_prompt(36, 11, 256), _patches(37, paligemma["tc"])[0]),
            (_prompt(38, 9, 256), None)]
    eng = JaxEngine(paligemma["jp"], paligemma["jc"],
                    JaxEngineConfig(max_slots=3, max_len=MAX_LEN, decode_backend="xla"))
    ids = [eng.add_request(p, 12, None if x is None else {"patches": x}) for p, x in reqs]
    while eng.live.any():
        eng.step()
    return reqs, [eng.outputs[i] for i in ids]


@pytest.mark.parametrize("decode_backend", ["cuda", "cuda_fm"])
def test_paligemma_engine_streams_with_patches_match_jax(paligemma, paligemma_streams,
                                                         decode_backend):
    """The slot engine takes each request's patches as ``extra_inputs``
    (bf16 caches, greedy): the JAX engine's streams."""
    reqs, want = paligemma_streams
    model = from_jax(paligemma["np_params"], paligemma["tc"], device="cpu")
    eng = DecodeEngine(model, paligemma["tc"], EngineConfig(
        max_slots=3, max_len=MAX_LEN, decode_backend=decode_backend), device="cpu")
    ids = [eng.add_request(p, 12, None if x is None else {"patches": x}) for p, x in reqs]
    assert [int(eng.lengths[i]) for i in ids] == [
        len(p) + (paligemma["tc"].frontend.prefix_len if x is not None else 0) for p, x in reqs]
    while eng.live.any():
        eng.step()
    assert [eng.outputs[i] for i in ids] == want
    # generate() passes them on too
    eng2 = DecodeEngine(model, paligemma["tc"], EngineConfig(max_slots=1, max_len=MAX_LEN),
                        device="cpu")
    assert eng2.generate(reqs[0][0], 12, {"patches": reqs[0][1]}) == want[0]


def test_paligemma_prefix_counts_toward_max_len(paligemma):
    """A prompt that fits alone but not behind its patch prefix is refused,
    by the port as by the reference."""
    tc, jc = paligemma["tc"], paligemma["jc"]
    model = from_jax(paligemma["np_params"], tc, device="cpu")
    prompt = _prompt(40, MAX_LEN - tc.frontend.prefix_len, tc.vocab_size)
    extra = {"patches": _patches(41, tc)[0]}
    eng = DecodeEngine(model, tc, EngineConfig(max_slots=1, max_len=MAX_LEN), device="cpu")
    with pytest.raises(ValueError, match="patch-frontend prefix included"):
        eng.add_request(prompt, 4, extra)
    jeng = JaxEngine(paligemma["jp"], jc, JaxEngineConfig(max_slots=1, max_len=MAX_LEN,
                                                          decode_backend="xla"))
    with pytest.raises(ValueError, match="patch-frontend prefix included"):
        jeng.add_request(prompt, 4, extra)
    eng.add_request(prompt[:-1], 1, extra)              # one position left: accepted


def test_paligemma_serve_launcher_runs_text_only_prompts(capsys):
    clear_fallback_reports()
    serve_launcher.main(["--arch", "paligemma-3b", "--device", "cpu", "--requests", "2",
                         "--max-new", "3", "--paged", "--speculative", "--page-size", "8"])
    out = capsys.readouterr().out
    assert "fallback" not in out


# --------------------------------------------------------------------------
# hubert-xlarge (audio, encoder-only)
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def hubert():
    jc, tc = _pair("hubert-xlarge")
    rs = np.random.RandomState(50)
    b, n = 2, 40
    batch = {"frames": rs.randn(b, n, jc.frontend.input_dim).astype(np.float32),
             "labels": rs.randint(0, jc.vocab_size, (b, n)).astype(np.int32)}
    batch["labels"][:, 5:8] = -1
    jc, jp, np_params, loss, grads = _jax_reference(jc, batch, seed=6)
    jlogits = jax.jit(lambda p, x: jax_forward_logits(p, {"frames": x}, jc).logits)(
        jp, jnp.asarray(batch["frames"]))
    return dict(jc=jc, tc=tc, np_params=np_params, batch=batch, loss=loss, grads=grads,
                logits=np.asarray(jlogits))


@pytest.mark.parametrize("backend", ["cuda", "torch"])
def test_hubert_logits_loss_and_every_grad_match_jax(hubert, backend):
    tc = hubert["tc"]
    assert not tc.causal and not tc.attention.causal and not tc.attention.rope
    loss, grads, unused = _port_grads(tc, hubert["np_params"], hubert["batch"], backend)
    np.testing.assert_allclose(loss, hubert["loss"], rtol=0, atol=TOL)
    _assert_grads(grads, hubert["grads"])
    # the frames skip the learned positions in both packages: pos.w is
    # carried, never read, and its gradient is zero
    assert unused == {"pos.w"}
    assert not np.any(hubert["grads"]["pos.w"])
    c = dataclasses.replace(tc, attention=dataclasses.replace(tc.attention, backend=backend))
    model = from_jax(hubert["np_params"], c, device="cpu")
    with torch.no_grad():
        logits = forward_logits(model, to_batch({"frames": hubert["batch"]["frames"]}, "cpu"), c)
    np.testing.assert_allclose(logits.numpy(), hubert["logits"], rtol=0, atol=TOL)


def test_hubert_attends_both_ways(hubert):
    """Changing the last frame moves the first frame's logits (a causal
    stack would leave them)."""
    tc = hubert["tc"]
    model = from_jax(hubert["np_params"], tc, device="cpu")
    frames = hubert["batch"]["frames"][:1].copy()
    with torch.no_grad():
        a = forward_logits(model, to_batch({"frames": frames}, "cpu"), tc)
        frames[0, -1] += 1.0
        b = forward_logits(model, to_batch({"frames": frames}, "cpu"), tc)
    assert (a[0, 0] - b[0, 0]).abs().max() > 1e-4


def test_hubert_refuses_decode(hubert):
    tc = hubert["tc"]
    model = from_jax(hubert["np_params"], tc, device="cpu")
    with pytest.raises(ValueError, match="encoder-only: no autoregressive decode step"):
        DecodeEngine(model, tc, EngineConfig(max_slots=1, max_len=MAX_LEN), device="cpu")
    with pytest.raises(ValueError, match="encoder-only"):
        decode_step(model, torch.tensor([0]), [], torch.tensor([0]), tc)
