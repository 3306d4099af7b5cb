"""The SSM family (rwkv6-3b, RWKV-6 "Finch") in the port against the JAX
package, f32.

RWKV has no QKᵀ score matrix, so no attention and no kernel: a layer is a
time mix (token shift, five mixes, the data-dependent decay w = exp(-exp(w0
+ LoRA)) in f32, the WKV recurrence in chunks of 128, sequential inside,
``ln_out`` over all of d) and a squared-ReLU channel mix. The decode cache
is a ``RecurrentState`` (token-shift rows and the WKV state, no token
axis). Held here:

  * ``rwkv_time_mix`` and ``rwkv_channel_mix`` alone, weights carried from
    the reference's inits: a prompt longer than the chunk with a ragged tail
    (outputs and states on chunks of 128; every parameter gradient too on
    chunks of 8, through the chunk checkpoints), and prefill -> decode steps
    equal to the full forward and to the reference's decode steps;
  * a reduced rwkv6-3b (2 layers, d 64, heads of 16), the port's random
    weights carried into the JAX tree and back by ``from_jax``: the loss
    and every gradient (remat none and full), the logits, prefill and
    decode logits on f32 caches, the slot engine's greedy streams against
    the JAX model's (``assert_greedy_streams``), the state's bytes;
  * the paged and speculative engines' refusal with the reference's
    messages, the byte model ({"dense": 0, "sfa": 0}) and the realized
    caches, the state's slot insert against the reference's slot update,
    and the launchers on the CPU.

Tolerance 1e-4.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import forward_logits as jax_forward_logits
from repro.models import model as jmodel
from repro.models import rwkv as jrwkv
from repro.serve import kv_cache as jserve
from repro.serve.speculative import SpeculativeDecodeEngine as JaxSpeculative
from repro.serve.speculative import SpeculativeEngineConfig as JaxSpecConfig
from repro_torch.configs import get_config
from repro_torch.core.kv_cache import RecurrentState, cache_nbytes, state_nbytes
from repro_torch.interop import from_jax
from repro_torch.launch import serve as serve_launcher
from repro_torch.launch import train as train_launcher
from repro_torch.models import (
    decode_step, forward_logits, init_decode_caches, init_paged_decode_caches, loss_fn,
    prefill, segments,
)
from repro_torch.models import rwkv as trwkv
from repro_torch.models.model import insert_slot
from repro_torch.serve import (
    DecodeEngine, EngineConfig, PagedDecodeEngine, PagedEngineConfig, SpeculativeDecodeEngine,
    SpeculativeEngineConfig,
)
from repro_torch.serve import kv_cache as tserve
from test_torch_jamba import _jax_params, _np_tree, _torch_tree, assert_greedy_streams
from test_torch_rope_protect import _close, _flat_np, _prompt

ARCH = "rwkv6-3b"
TOL = 1e-4
MAX_LEN = 40


def _pair():
    """(JAX config, port config): reduced (2 layers), f32."""
    return [dataclasses.replace(get(ARCH).reduced(), dtype="float32", loss_chunk=16)
            for get in (jax_get_config, get_config)]


# --------------------------------------------------------------------------
# the time and channel mixes alone
# --------------------------------------------------------------------------

D = 32


def _mixes(seed):
    rcfg = jax_get_config(ARCH).reduced().rwkv
    k1, k2 = jax.random.split(jax.random.PRNGKey(seed))
    tm = jrwkv.rwkv_tm_init(k1, D, rcfg)
    # w0 -6 decays slowly; -1 makes the data-dependent decay matter here
    tm = dict(tm, w0=tm["w0"] + 5.0)
    cm = jrwkv.rwkv_cm_init(k2, D, 2 * D)
    return rcfg, tm, cm


@pytest.mark.parametrize("n,chunk,grads", [(300, 128, False), (20, 8, True)],
                         ids=["three-chunks-ragged", "chunks-of-8-grads"])
def test_time_and_channel_mix_match_jax(n, chunk, grads):
    """Prefill outputs and states against the reference, on chunks of 128
    (300 = 2 x 128 + 44) and of 8 (20 = 8 + 8 + 4, with every parameter
    gradient of the time mix, through the port's chunk checkpoints)."""
    rcfg, tm, cm = _mixes(n)
    rs = np.random.RandomState(n)
    x = rs.randn(2, n, D).astype(np.float32)
    g = rs.randn(2, n, D).astype(np.float32)
    jtm = jax.jit(lambda p, x: jrwkv.rwkv_time_mix(p, x, rcfg, mode="prefill", chunk=chunk))
    jo, js = jtm(tm, jnp.asarray(x))
    jco, jcs = jrwkv.rwkv_channel_mix(cm, jnp.asarray(x), mode="prefill")
    ttm, tcm = _torch_tree(_np_tree(tm)), _torch_tree(_np_tree(cm))
    with torch.no_grad():
        to, ts = trwkv.rwkv_time_mix(ttm, torch.from_numpy(x), rcfg, mode="prefill",
                                     chunk=chunk)
        tco, tcs = trwkv.rwkv_channel_mix(tcm, torch.from_numpy(x), mode="prefill")
    _close(to, jo)
    _close(ts["s"], js["s"])
    np.testing.assert_array_equal(ts["x_prev"].numpy(), np.asarray(js["x_prev"]))
    _close(tco, jco)
    np.testing.assert_array_equal(tcs["x_prev"].numpy(), np.asarray(jcs["x_prev"]))
    if not grads:
        return
    jgrads = jax.jit(jax.grad(lambda p: (jrwkv.rwkv_time_mix(p, jnp.asarray(x), rcfg,
                                                             chunk=chunk)[0] * g).sum()))(tm)
    for leaf in jax.tree.leaves(ttm):
        leaf.requires_grad_(True)
    out, _ = trwkv.rwkv_time_mix(ttm, torch.from_numpy(x), rcfg, chunk=chunk)
    (out * torch.from_numpy(g)).sum().backward()
    want = _flat_np(jgrads)
    got = _flat_np(jax.tree.map(lambda t: t.grad.numpy(), ttm))
    assert set(got) == set(want)
    for name in want:
        np.testing.assert_allclose(got[name], want[name], rtol=1e-4, atol=TOL, err_msg=name)


def test_decode_continues_the_prefill_as_the_full_forward():
    """Prefill of 6 tokens, then 4 decode steps on the carried state: each
    output is the full forward's at its position and the reference's decode
    step's."""
    rcfg, tm, cm = _mixes(7)
    x = np.random.RandomState(8).randn(2, 10, D).astype(np.float32)
    ttm, tcm = _torch_tree(_np_tree(tm)), _torch_tree(_np_tree(cm))
    jtm = jax.jit(lambda p, x, st, mode: jrwkv.rwkv_time_mix(p, x, rcfg, mode=mode, state=st),
                  static_argnums=3)
    with torch.no_grad():
        full, _ = trwkv.rwkv_time_mix(ttm, torch.from_numpy(x), rcfg)
        cfull, _ = trwkv.rwkv_channel_mix(tcm, torch.from_numpy(x))
        _, st = trwkv.rwkv_time_mix(ttm, torch.from_numpy(x[:, :6]), rcfg, mode="prefill")
        _, cst = trwkv.rwkv_channel_mix(tcm, torch.from_numpy(x[:, :6]), mode="prefill")
        _, jst = jtm(tm, jnp.asarray(x[:, :6]), None, "prefill")
        for i in range(6, 10):
            xi = torch.from_numpy(x[:, i:i + 1])
            out, st = trwkv.rwkv_time_mix(ttm, xi, rcfg, mode="decode", state=st)
            cout, cst = trwkv.rwkv_channel_mix(tcm, xi, mode="decode", state=cst)
            jout, jst = jtm(tm, jnp.asarray(x[:, i:i + 1]), jst, "decode")
            _close(out[:, 0], full[:, i].numpy())
            _close(cout[:, 0], cfull[:, i].numpy())
            _close(out, jout)
            _close(st["s"], jst["s"])
    _close(full, jtm(tm, jnp.asarray(x), None, "train")[0])


# --------------------------------------------------------------------------
# the model
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def rwkv():
    """The JAX model's loss (forward_logits' cross entropy), every gradient
    and the logits of a (2, 24) batch, in one compiled function."""
    jc, tc = _pair()
    jp = _jax_params(tc, 41)
    rs = np.random.RandomState(42)
    batch = {"tokens": rs.randint(0, jc.vocab_size, (2, 24)).astype(np.int32),
             "labels": rs.randint(0, jc.vocab_size, (2, 24)).astype(np.int32)}

    def loss_and_logits(p, b):
        out = jax_forward_logits(p, {"tokens": b["tokens"]}, jc)
        lse = jax.nn.logsumexp(out.logits, axis=-1)
        gold = jnp.take_along_axis(out.logits, b["labels"][..., None], axis=-1)[..., 0]
        return (lse - gold).mean() + out.aux_loss, out.logits

    run = jax.jit(jax.value_and_grad(loss_and_logits, has_aux=True))
    (loss, logits), grads = run(jp, {k: jnp.asarray(v) for k, v in batch.items()})
    return dict(jc=jc, tc=tc, jp=jp, np_params=_np_tree(jp), batch=batch, loss=float(loss),
                grads=_flat_np(grads), logits=np.asarray(logits), run=run)


@pytest.mark.parametrize("remat", ["none", "full"])
def test_loss_and_every_grad_match_jax(rwkv, remat):
    tc = dataclasses.replace(rwkv["tc"], remat=remat)
    assert segments(tc) == [("rwkv", 2)] == jmodel.segments(rwkv["jc"])
    model = from_jax(rwkv["np_params"], tc, device="cpu").requires_grad_(True)
    loss, metrics = loss_fn(model, {k: torch.from_numpy(v).long()
                                    for k, v in rwkv["batch"].items()}, tc)
    assert metrics["aux"].item() == 0
    named = dict(model.named_parameters())
    grads = dict(zip(named, torch.autograd.grad(loss, list(named.values()))))
    np.testing.assert_allclose(loss.item(), rwkv["loss"], rtol=0, atol=TOL)
    assert set(grads) == set(rwkv["grads"])
    for name, g in grads.items():
        np.testing.assert_allclose(g.numpy(), rwkv["grads"][name], rtol=0, atol=TOL,
                                   err_msg=name)


def test_logits_prefill_and_decode_match_jax(rwkv):
    """forward_logits; each row's first 11 tokens prefilled into its slot
    of f32 caches, then teacher-forced decode steps of both slots to 24."""
    tc = rwkv["tc"]
    model = from_jax(rwkv["np_params"], tc, device="cpu")
    t = torch.from_numpy(rwkv["batch"]["tokens"]).long()
    want = rwkv["logits"]
    with torch.no_grad():
        _close(forward_logits(model, {"tokens": t}, tc), want)
    n0, n = 11, t.shape[1]
    caches = init_decode_caches(tc, 2, n, torch.float32, device="cpu")
    for row in (0, 1):
        lg, one = prefill(model, {"tokens": t[row:row + 1, :n0]}, tc)
        _close(lg[0], want[row, n0 - 1])
        insert_slot(caches, one, slot=row, max_len=n)
    for i in range(n0, n):
        lg, caches = decode_step(model, t[:, i], caches, torch.tensor([i, i]), tc)
        _close(lg, want[:, i])


@pytest.mark.parametrize("cache_dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_engine_streams_are_the_jax_models_greedy_streams(rwkv, cache_dtype):
    """The slot engine on two 12-token prompts, 12 new tokens each: the JAX
    model's greedy choices; no KV at rest, the state 2 x 2 x (2 x d x 2 +
    h x dh x dh x 4) bytes on bf16 caches."""
    tc = rwkv["tc"]
    model = from_jax(rwkv["np_params"], tc, device="cpu")
    prompts = [_prompt(43, 12, 256), _prompt(44, 12, 256)]
    eng = DecodeEngine(model, tc, EngineConfig(max_slots=2, max_len=MAX_LEN), device="cpu")
    if cache_dtype == torch.bfloat16:
        assert eng.cache_bytes() == 0
        d, dh = tc.d_model, tc.rwkv.head_dim
        assert eng.state_bytes() == 2 * 2 * (2 * d * 2 + (d // dh) * dh * dh * 4)
    else:
        eng.caches = init_decode_caches(tc, 2, MAX_LEN, torch.float32, device="cpu")
    streams = [eng.generate(p, 12) for p in prompts]

    def run_ref(tokens):
        (_, logits), _ = rwkv["run"](rwkv["jp"], {
            "tokens": jnp.asarray(tokens), "labels": jnp.zeros_like(jnp.asarray(tokens))})
        return logits

    assert_greedy_streams(run_ref, prompts, streams, cache_dtype)


def test_paged_and_speculative_engines_refuse_as_the_reference(rwkv):
    """The paged caches raise the reference's message; the speculative
    engine needs SFA codes, and says so as the reference's does."""
    jc, tc = rwkv["jc"], rwkv["tc"]
    model = from_jax(rwkv["np_params"], tc, device="cpu")
    with pytest.raises(NotImplementedError) as want:
        jmodel.init_paged_decode_caches(jc, slots=2, num_pages=5, page_size=8, max_pages=2)
    with pytest.raises(NotImplementedError) as got:
        init_paged_decode_caches(tc, slots=2, num_pages=5, page_size=8, max_pages=2,
                                 device="cpu")
    assert str(got.value) == str(want.value)
    with pytest.raises(NotImplementedError, match="recurrent state"):
        PagedDecodeEngine(model, tc, PagedEngineConfig(max_slots=2, page_size=8), device="cpu")
    with pytest.raises(ValueError) as want:
        JaxSpeculative(rwkv["jp"], jc, JaxSpecConfig(max_slots=2, page_size=8))
    with pytest.raises(ValueError) as got:
        SpeculativeDecodeEngine(model, tc, SpeculativeEngineConfig(max_slots=2, page_size=8),
                                device="cpu")
    assert str(got.value) == str(want.value)


def test_byte_model_and_realized_caches_equal_the_reference():
    """No KV: the byte model is {"dense": 0, "sfa": 0} as the reference's,
    the caches hold recurrent state only: 32 x (2 x 2,560 x 2 + 40 x 64 x
    64 x 4) bytes a slot at full width."""
    jc, tc = jax_get_config(ARCH), get_config(ARCH)
    assert tserve.cache_bytes_per_token(tc) == jserve.cache_bytes_per_token(jc) \
        == {"dense": 0, "sfa": 0}
    assert tserve.realized_cache_bytes_per_token(tc) == \
        jserve.realized_cache_bytes_per_token(jc) == 0
    caches = init_decode_caches(tc, 8, 2048, device="meta")
    assert cache_nbytes(caches) == 0
    assert state_nbytes(caches) == 8 * 32 * (2 * 2560 * 2 + 40 * 64 * 64 * 4) \
        == 162.5 * 2**20


def test_recurrent_state_slot_insert_is_the_references():
    """A layer-stacked bf16 state (token-shift rows bf16, WKV state f32)
    takes an f32 batch-1 prefill state in slot 2, cast as the reference's
    slot update casts."""
    tc = _pair()[1]
    st = init_decode_caches(tc, 3, 8, device="cpu")[0]
    assert isinstance(st, RecurrentState)
    rs = np.random.RandomState(9)
    d, h, dh = tc.d_model, tc.d_model // tc.rwkv.head_dim, tc.rwkv.head_dim
    src = {"tm": {"x_prev": rs.randn(2, 1, d), "s": rs.randn(2, 1, h, dh, dh)},
           "cm": {"x_prev": rs.randn(2, 1, d)}}
    src = jax.tree.map(lambda a: a.astype(np.float32), src)
    st.insert_slot(RecurrentState(_torch_tree(src)), slot=2)
    ref = jax.tree.map(lambda a: jnp.zeros((2, 3) + a.shape[2:], a.dtype), src)
    ref["tm"]["x_prev"] = ref["tm"]["x_prev"].astype(jnp.bfloat16)
    ref["cm"]["x_prev"] = ref["cm"]["x_prev"].astype(jnp.bfloat16)
    ref = jax.tree.map(lambda dst, s: jax.lax.dynamic_update_slice(
        dst, jnp.asarray(s).astype(dst.dtype), (0, 2) + (0,) * (s.ndim - 2)), ref, src)
    got = {"tm": dict(st.tree["tm"]), "cm": dict(st.tree["cm"])}
    for (name, want), t in zip(_flat_np(jax.tree.map(lambda a: a.astype(jnp.float32), ref)).items(),
                               _flat_np(jax.tree.map(lambda t: t.float().numpy(), got)).values()):
        np.testing.assert_array_equal(t, want, err_msg=name)
    assert st.tree["tm"]["x_prev"].dtype == torch.bfloat16
    assert st.tree["tm"]["s"].dtype == torch.float32


def test_launchers_on_the_cpu(capsys):
    """Both launchers take the arch: the serve launcher prints the state's
    bytes and no KV; ``--speculative`` raises the reference's error."""
    train_launcher.main(["--arch", ARCH, "--device", "cpu", "--batch", "2", "--seq-len", "16",
                         "--steps", "2"])
    serve_launcher.main(["--arch", ARCH, "--device", "cpu", "--requests", "2", "--max-new",
                         "3"])
    out = capsys.readouterr().out
    assert "done: final loss" in out
    assert "kv cache at rest: 0.00 MiB" in out and "recurrent state:" in out
    with pytest.raises(ValueError, match="sfa_k"):
        serve_launcher.main(["--arch", ARCH, "--device", "cpu", "--speculative"])
