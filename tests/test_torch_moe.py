"""The MoE family against the JAX package on the CPU, f32.

``moe_apply`` against ``repro.models.moe.moe_apply`` on the same numpy
inputs: output and aux loss to 1e-5, the gradients of x and of every leaf
(router, up, gate, down, shared experts) to 1e-4, over glu on and off, 0
and 2 shared experts, a token count 1024 does not divide (groups of 550),
and a capacity factor of 0.5, where tokens drop and the dropped set must be
the reference's. Routing is compared before anything else: a token that
the two packages send to another expert (a near-tie of the f32 router
probs broken apart) fails the test as a routing flip, which the tolerance
does not cover. Then the reduced moonshot-v1-16b-a3b (1 dense + 1 MoE
layer): its loss and every leaf gradient through ``from_jax``, its prefill
logits and teacher-forced decode logits on f32 caches, greedy streams
through ``DecodeEngine`` against the JAX engine, the same streams
through the paged and feature-major engines, the speculative engine's
stream and stats against the JAX speculative engine, a step with gradient
accumulation against its microbatches, and the launchers on the CPU. Each
JAX reference compiles once (module fixtures).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs.base import MoEConfig as JaxMoEConfig
from repro.core.sparse import topk_mask as jax_topk_mask
from repro.models import decode_step as jax_decode_step
from repro.models import init as jax_init
from repro.models import loss_fn as jax_loss_fn
from repro.models import moe as jax_moe
from repro.serve.engine import DecodeEngine as JaxEngine
from repro.serve.engine import EngineConfig as JaxEngineConfig
from repro.serve import SpeculativeDecodeEngine as JaxSpec
from repro.serve import SpeculativeEngineConfig as JaxSpecConfig
from repro_torch.configs import get_config
from repro_torch.configs.base import MoEConfig
from repro_torch.interop import from_jax
from repro_torch.launch import serve as serve_launcher
from repro_torch.launch import train as train_launcher
from repro_torch.models import decode_step, init_decode_caches, loss_fn, prefill, segments
from repro_torch.models import moe
from repro_torch.models.model import MOE_AUX_WEIGHT, insert_slot
from repro_torch.optim import OptimizerConfig
from repro_torch.optim.optimizer import init_opt_state
from repro_torch.serve import (
    DecodeEngine, EngineConfig, PagedDecodeEngine, PagedEngineConfig, SpeculativeDecodeEngine,
    SpeculativeEngineConfig, cache_bytes_per_token,
)
from repro_torch.train.train_step import make_train_step
from test_torch_code_grad import _flat

OUT_TOL, GRAD_TOL, TOL = 1e-5, 1e-4, 1e-4
ARCH = "moonshot-v1-16b-a3b"
MAX_LEN = 64

# (glu, shared experts, tokens as (b, n), capacity factor)
CASES = {
    "glu-shared2": (True, 2, (2, 48), 1.25),
    "noglu-shared0-groups-of-550": (False, 0, (2, 550), 1.25),
    "glu-shared2-cf0.5-drops": (True, 2, (1, 200), 0.5),
}
MOE = dict(num_experts=8, top_k=2, expert_dim=24)
D = 32


def _jax_routing(jp, x, mc, cf):
    """The reference's routing (repro/models/moe.py:57-87) replayed on its
    own functions: (sel, keep) as (g, gs, e) bool arrays."""
    t = x.shape[0] * x.shape[1]
    gs = moe.group_size(t)
    tokens = jnp.asarray(x).reshape(t // gs, gs, x.shape[2])
    logits = jnp.einsum("gsd,de->gse", tokens.astype(jnp.float32), jp["router"]["w"])
    sel = jax_topk_mask(jax.nn.softmax(logits, axis=-1), mc.top_k)
    cap = int(cf * mc.top_k * gs / mc.num_experts)
    cap = max(8, -(-cap // 8) * 8)
    pos = jnp.cumsum(sel.astype(jnp.float32), axis=1) - 1.0
    return np.asarray(sel), np.asarray(sel & (pos < cap))


@functools.lru_cache(maxsize=None)
def _case(name):
    """One case's inputs, and the JAX output, aux and gradients of
    sum(out * w) + aux with respect to x and every leaf."""
    glu, shared, (b, n), cf = CASES[name]
    jmc = JaxMoEConfig(**MOE, num_shared=shared)
    rs = np.random.RandomState(sorted(CASES).index(name))
    jp = jax.tree.map(np.asarray, jax_moe.moe_init(jax.random.PRNGKey(1), D, jmc, glu=glu))
    x = rs.randn(b, n, D).astype(np.float32)
    w = rs.randn(b, n, D).astype(np.float32)

    def f(p, x):
        out, aux = jax_moe.moe_apply(p, x, jmc, glu=glu, capacity_factor=cf)
        return jnp.sum(out * w) + aux, (out, aux)

    (_, (out, aux)), (gp, gx) = jax.jit(jax.value_and_grad(f, argnums=(0, 1), has_aux=True))(
        jp, jnp.asarray(x))
    sel, keep = _jax_routing(jp, x, jmc, cf)
    mc = MoEConfig(**MOE, num_shared=shared, capacity_factor=cf)
    return dict(glu=glu, mc=mc, cf=cf, jp=jp, x=x, w=w,
                out=np.asarray(out), aux=float(aux), grads=_flat(gp), gx=np.asarray(gx),
                sel=sel, keep=keep)


@pytest.fixture(params=list(CASES))
def layer_case(request):
    return _case(request.param)


def _torch_tree(jp):
    return jax.tree.map(lambda a: torch.tensor(np.asarray(a), requires_grad=True), jp)


def _route(c):
    x = torch.from_numpy(c["x"])
    t = x.shape[0] * x.shape[1]
    w = torch.from_numpy(np.array(c["jp"]["router"]["w"]))
    return moe.route(w, x.reshape(t, D), c["mc"], gs=moe.group_size(t), dtype=torch.float32)


def test_routing_equals_the_reference(layer_case):
    """Selected experts and the kept (not dropped) set, token for token:
    a difference is a routing flip (no flips met at these seeds)."""
    c = layer_case
    r = _route(c)
    flips = int((r.sel.numpy() != c["sel"]).any(-1).sum())
    assert flips == 0, f"{flips} tokens routed to other experts than the reference's"
    np.testing.assert_array_equal(r.keep.numpy(), c["keep"])
    if c["cf"] < 1:
        assert (c["sel"] & ~c["keep"]).any(), "capacity factor 0.5: no token dropped"


@pytest.mark.parametrize("e,k", [(8, 2), (64, 6), (300, 7)])
def test_select_experts_is_topk_mask(e, k):
    """``core.sparse.topk_select`` (the keyed topk that routes the
    experts) selects what ``core.sparse.topk_mask`` (the reference's
    bisection) selects, on rows full of ties: equal probs within a row, a
    row of one value, ±0."""
    from repro_torch.core.sparse import topk_mask, topk_select
    rs = np.random.RandomState(e)
    x = rs.rand(64, e).astype(np.float32)
    x[::2] = np.round(x[::2] * 4) / 4
    x[1::5] = 0.5
    x[3::7, : e // 2] = -0.0
    probs = torch.from_numpy(x)
    mask, idx = topk_select(probs, k)
    assert torch.equal(mask, topk_mask(probs, k))
    assert torch.equal(idx, torch.sort(idx, dim=-1).values)
    assert torch.equal(mask.gather(-1, idx), torch.ones_like(idx, dtype=torch.bool))


def test_moe_apply_and_its_gradients_match_jax(layer_case):
    c = layer_case
    tp = _torch_tree(c["jp"])
    x = torch.tensor(c["x"], requires_grad=True)
    out, aux = moe.moe_apply(tp, x, c["mc"], glu=c["glu"])
    np.testing.assert_allclose(out.detach().numpy(), c["out"], rtol=0, atol=OUT_TOL)
    np.testing.assert_allclose(aux.item(), c["aux"], rtol=0, atol=OUT_TOL)
    ((out * torch.from_numpy(c["w"])).sum() + aux).backward()
    np.testing.assert_allclose(x.grad.numpy(), c["gx"], rtol=0, atol=GRAD_TOL)
    grads = _flat(jax.tree.map(lambda t: t.grad.numpy(), tp))
    assert set(grads) == set(c["grads"])
    assert {"router.w", "up", "down"} <= set(grads)
    for name, g in grads.items():
        np.testing.assert_allclose(g, c["grads"][name], rtol=0, atol=GRAD_TOL, err_msg=name)


def test_moe_apply_without_aux_gives_the_same_output():
    """Serving asks for no aux loss: the output keeps its bits and the aux
    is None."""
    c = _case("glu-shared2-cf0.5-drops")
    tp = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), c["jp"])
    x = torch.from_numpy(c["x"])
    out, aux = moe.moe_apply(tp, x, c["mc"], glu=c["glu"])
    out2, aux2 = moe.moe_apply(tp, x, c["mc"], glu=c["glu"], with_aux=False)
    assert aux is not None and aux2 is None
    assert torch.equal(out, out2)


def test_dropped_tokens_get_no_routed_output():
    """A token all of whose experts dropped gets exactly the shared
    experts' output, as the one-hot combine gives."""
    c = _case("glu-shared2-cf0.5-drops")
    all_dropped = torch.from_numpy((~c["keep"]).all(-1).reshape(-1))
    assert all_dropped.any() and c["mc"].num_shared and c["glu"]
    tp = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), c["jp"])
    x = torch.from_numpy(c["x"])
    out, _ = moe.moe_apply(tp, x, c["mc"], glu=c["glu"])
    xs = x.reshape(-1, D)[all_dropped]
    su = (xs @ tp["shared_up"]["w"]) * torch.nn.functional.silu(xs @ tp["shared_gate"]["w"])
    torch.testing.assert_close(out.reshape(-1, D)[all_dropped], su @ tp["shared_down"]["w"],
                               rtol=0, atol=1e-6)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_moe_gives_the_same_bits_twice(dtype):
    """Two calls give the same bits, forward and backward (x and every
    leaf): dispatch and combine sum in a fixed order, nothing through
    atomics."""
    mc = MoEConfig(**MOE, num_shared=2)
    x = torch.randn(3, 40, D, generator=torch.Generator().manual_seed(1)).to(dtype)

    def run():
        p = moe.moe_init(torch.Generator().manual_seed(0), D, mc)
        leaves = _flat_torch(p)
        for t in leaves.values():
            t.requires_grad_(True)
        xx = x.clone().requires_grad_(True)
        out, aux = moe.moe_apply(p, xx, mc)
        (out.float().square().sum() + aux).backward()
        return [out.detach(), xx.grad] + [t.grad for t in leaves.values()]
    assert all(torch.equal(a, b) for a, b in zip(run(), run()))


def _flat_torch(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat_torch(v, f"{prefix}{k}."))
        return out
    return {prefix[:-1]: tree}


# --------------------------------------------------------------------------
# the reduced moonshot-v1-16b-a3b
# --------------------------------------------------------------------------

def _pair(**overrides):
    return [dataclasses.replace(get(ARCH).reduced(), dtype="float32", loss_chunk=16,
                                **overrides) for get in (jax_get_config, get_config)]


def _batch(seed, vocab, b=2, n=40):
    rs = np.random.RandomState(seed)
    tokens = rs.randint(0, vocab, size=(b, n)).astype(np.int32)
    labels = rs.randint(0, vocab, size=(b, n)).astype(np.int32)
    labels[:, :3] = -1
    return {"tokens": tokens, "labels": labels}


@pytest.fixture(scope="module")
def moonshot():
    """JAX's reduced moonshot in f32 (XLA backend): parameters, a batch,
    its loss, aux metric and every leaf gradient."""
    jc, tc = _pair()
    jc = dataclasses.replace(jc, attention=dataclasses.replace(jc.attention, backend="xla"))
    jp = jax_init(jax.random.PRNGKey(5), jc)
    batch = _batch(21, jc.vocab_size)
    (loss, metrics), grads = jax.jit(jax.value_and_grad(
        lambda p, b: jax_loss_fn(p, b, jc), has_aux=True))(
            jp, {k: jnp.asarray(v) for k, v in batch.items()})
    return dict(jc=jc, tc=tc, jp=jp, np_params=jax.tree.map(np.asarray, jp), batch=batch,
                loss=float(loss), aux=float(metrics["aux"]), grads=_flat(grads))


def test_reduced_moonshot_is_one_dense_and_one_moe_layer(moonshot):
    tc = moonshot["tc"]
    assert segments(tc) == [("block_dense", 1), ("block_moe", 1)]
    model = from_jax(moonshot["np_params"], tc, device="cpu")
    seg0, seg1 = model.tree()["segments"]
    # the dense layer's MLP is max(d_ff, expert_dim * top_k) wide
    width = max(tc.d_ff, tc.moe.expert_dim * tc.moe.top_k)
    assert tuple(seg0["mlp"]["up_gate"]["w"].shape) == (1, tc.d_model, 2 * width)
    assert tuple(seg1["moe"]["up"].shape) == (1, tc.moe.num_experts, tc.d_model,
                                              tc.moe.expert_dim)
    assert "lm_head" in dict(model.named_children())


@pytest.mark.parametrize("remat", ["none", "full"])
@pytest.mark.parametrize("backend", ["cuda", "torch"])
def test_moonshot_loss_aux_and_every_grad_match_jax(moonshot, backend, remat):
    tc = dataclasses.replace(moonshot["tc"], remat=remat, attention=dataclasses.replace(
        moonshot["tc"].attention, backend=backend))
    model = from_jax(moonshot["np_params"], tc, device="cpu").requires_grad_(True)
    loss, metrics = loss_fn(model, {k: torch.from_numpy(v).long()
                                    for k, v in moonshot["batch"].items()}, tc)
    np.testing.assert_allclose(float(loss), moonshot["loss"], rtol=0, atol=TOL)
    np.testing.assert_allclose(float(metrics["aux"]), moonshot["aux"], rtol=0, atol=1e-6)
    # the aux term is the weighted load-balance loss of the one MoE layer
    assert MOE_AUX_WEIGHT * 0.9 < float(metrics["aux"]) < MOE_AUX_WEIGHT * 2.5
    named = dict(model.named_parameters())
    grads = dict(zip(named, torch.autograd.grad(loss, list(named.values()))))
    assert set(grads) == set(moonshot["grads"])
    for name, g in grads.items():
        np.testing.assert_allclose(g.numpy(), moonshot["grads"][name], rtol=0, atol=TOL,
                                   err_msg=name)


def test_moonshot_accumulated_step_is_the_microbatches_mean(moonshot):
    """``accum_steps`` 2 on the reduced moonshot: the step's loss, ce, aux
    and every gradient (read back from AdamW's first moment after one
    step, clipping off) are the mean of the two microbatches' own. None of
    them is the unsplit batch's: a microbatch is a routing group of its
    own, with its own capacity and drops, and Switch's loss is a product
    of means over a group."""
    tc = moonshot["tc"]
    batch = {k: torch.from_numpy(v).long() for k, v in moonshot["batch"].items()}
    model = from_jax(moonshot["np_params"], tc, device="cpu").requires_grad_(True)
    named = dict(model.named_parameters())
    losses, ces, auxes, grads = [], [], [], []
    for i in range(2):
        loss, m = loss_fn(model, {k: v[i:i + 1] for k, v in batch.items()}, tc)
        losses.append(float(loss))
        ces.append(float(m["ce"]))
        auxes.append(float(m["aux"]))
        grads.append(torch.autograd.grad(loss, list(named.values())))
    opt = OptimizerConfig(grad_clip=1e9)
    step = make_train_step(tc, opt, accum_steps=2)
    _, state, metrics = step(model, init_opt_state(named), moonshot["batch"])
    for key, want in (("loss", losses), ("ce", ces), ("aux", auxes)):
        np.testing.assert_allclose(float(metrics[key]), np.mean(want), rtol=1e-6, err_msg=key)
    assert min(auxes) > 0
    for name, g0, g1 in zip(named, *grads):
        np.testing.assert_allclose((state.m[name] / (1 - opt.b1)).numpy(),
                                   ((g0 + g1) / 2).numpy(), rtol=1e-5, atol=1e-8,
                                   err_msg=name)


def _prompt(seed, n, vocab):
    return np.random.RandomState(seed).randint(0, vocab, size=n).astype(np.int32)


def test_moonshot_prefill_and_decode_logits_match_jax(moonshot):
    """Prefill logits, then teacher-forced decode steps on f32 caches (a
    bf16 cache can round a 1e-7 difference to the neighbouring number)."""
    from repro.core.kv_cache import KVCache
    from repro.models import init_decode_caches as jax_init_caches
    from repro.models import prefill as jax_prefill
    jc, tc, jp = moonshot["jc"], moonshot["tc"], moonshot["jp"]
    model = from_jax(moonshot["np_params"], tc, device="cpu")
    prompt = _prompt(30, 13, tc.vocab_size)
    jl, one = jax.jit(lambda p, t: jax_prefill(p, {"tokens": t}, jc))(
        jp, jnp.asarray(prompt[None]))
    jcaches = jax.tree.map(lambda dst, src: dst.insert_slot(src, slot=0, max_len=MAX_LEN),
                           jax_init_caches(jc, 1, MAX_LEN, jnp.float32), one,
                           is_leaf=lambda x: isinstance(x, KVCache))
    tl, tone = prefill(model, {"tokens": torch.from_numpy(prompt)[None].long()}, tc)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=TOL)
    tcaches = insert_slot(init_decode_caches(tc, 1, MAX_LEN, torch.float32, device="cpu"),
                          tone, slot=0, max_len=MAX_LEN)
    assert len(tcaches) == 2
    step = jax.jit(lambda p, t, c, ln: jax_decode_step(p, t, c, ln, jc))
    n = len(prompt)
    for i, tok in enumerate(_prompt(31, 6, tc.vocab_size)):
        jl, jcaches = step(jp, jnp.asarray([tok], jnp.int32), jcaches,
                           jnp.asarray([n + i], jnp.int32))
        tl, tcaches = decode_step(model, torch.tensor([int(tok)]), tcaches,
                                  torch.tensor([n + i]), tc)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=TOL)
    for si in range(2):
        np.testing.assert_array_equal(tcaches[si].k_idx.numpy(),
                                      np.asarray(jcaches[si].k_idx))


def _streams(eng, prompts, max_new, paged):
    ids = [eng.add_request(p, max_new_tokens=max_new) for p in prompts]
    while eng.busy if paged else eng.live.any():
        eng.step()
    return [eng.outputs[i] for i in ids]


@pytest.fixture(scope="module")
def jax_streams(moonshot):
    prompts = [_prompt(32, 13, 256), _prompt(33, 13, 256)]
    eng = JaxEngine(moonshot["jp"], moonshot["jc"],
                    JaxEngineConfig(max_slots=2, max_len=MAX_LEN, decode_backend="xla"))
    return prompts, _streams(eng, prompts, 16, paged=False)


@pytest.mark.parametrize("decode_backend", ["auto", "torch", "cuda_fm"])
def test_moonshot_engine_streams_match_jax(moonshot, jax_streams, decode_backend):
    """The slot engine (2 slots, bf16 caches) gives the JAX engine's greedy
    streams; the cache at rest is cache_bytes_per_token x slots x length
    over both segments' layers."""
    tc = moonshot["tc"]
    prompts, want = jax_streams
    model = from_jax(moonshot["np_params"], tc, device="cpu")
    eng = DecodeEngine(model, tc, EngineConfig(max_slots=2, max_len=MAX_LEN,
                                               decode_backend=decode_backend), device="cpu")
    assert _streams(eng, prompts, 16, paged=False) == want
    if decode_backend != "cuda_fm":
        per = cache_bytes_per_token(tc)["sfa"]
        assert eng.cache_bytes() == per * 2 * eng._cache_len
        assert per == tc.num_layers * cache_bytes_per_token(
            dataclasses.replace(tc, num_layers=1))["sfa"]


@pytest.mark.parametrize("decode_backend", ["cuda", "cuda_fm"])
def test_moonshot_paged_engine_streams_match_jax(moonshot, jax_streams, decode_backend):
    """Both segments' paged caches share one block table; whole-prompt
    prefill at full residency gives the slot engine's streams."""
    tc = moonshot["tc"]
    prompts, want = jax_streams
    model = from_jax(moonshot["np_params"], tc, device="cpu")
    eng = PagedDecodeEngine(model, tc, PagedEngineConfig(
        max_slots=2, max_len=MAX_LEN, page_size=8, decode_backend=decode_backend),
        device="cpu")
    assert len(eng.caches) == 2
    assert eng.caches[0].block_table is eng.caches[1].block_table
    assert _streams(eng, prompts, 16, paged=True) == want


@pytest.fixture(scope="module")
def jax_spec_stream(moonshot, jax_streams):
    """The JAX speculative engine's stream and stats on the first prompt:
    each verify pass routes a slot's draft tokens as one MoE group."""
    eng = JaxSpec(moonshot["jp"], moonshot["jc"], JaxSpecConfig(
        max_slots=2, max_len=MAX_LEN, page_size=8, draft_len=3, decode_backend="xla"))
    return eng.generate(jax_streams[0][0], max_new_tokens=16), eng.spec_stats


@pytest.mark.parametrize("decode_backend", ["torch", "cuda"])
def test_moonshot_speculative_matches_jax(moonshot, jax_streams, jax_spec_stream,
                                          decode_backend):
    """The speculative engine on the MoE family: the JAX engine's stream
    and acceptance stats, and the stream of the port's slot engine."""
    tc = moonshot["tc"]
    want, want_stats = jax_spec_stream
    model = from_jax(moonshot["np_params"], tc, device="cpu")
    eng = SpeculativeDecodeEngine(model, tc, SpeculativeEngineConfig(
        max_slots=2, max_len=MAX_LEN, page_size=8, draft_len=3,
        decode_backend=decode_backend), device="cpu")
    assert eng.generate(jax_streams[0][0], max_new_tokens=16) == want
    assert eng.spec_stats == want_stats
    assert want == jax_streams[1][0]


def test_moonshot_launchers_on_the_cpu(capsys):
    train_launcher.main(["--arch", ARCH, "--device", "cpu", "--batch", "2", "--seq-len", "32",
                         "--steps", "3"])
    out = capsys.readouterr().out
    assert "done: final loss" in out and "aux" in out and "fallback" not in out
    serve_launcher.main(["--arch", ARCH, "--device", "cpu", "--requests", "2", "--max-new",
                         "4", "--paged", "--page-size", "8"])
    out = capsys.readouterr().out
    assert "request 1:" in out and "fallback" not in out
