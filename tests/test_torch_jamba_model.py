"""A one-super-block reduced jamba-v0.1-52b in the port against the JAX
package, f32 (the pieces, ``mamba_apply`` and the caches, are in
``test_torch_jamba.py``).

8 sublayers (Mamba, attention at index 4 with 4 query heads over 2 kv heads
of 32 and k 4, MoE on every second sublayer at capacity factor 2 so no
token drops and every mode is position-wise), the port's random weights
carried into the JAX tree (the trees share their layout) and back by
``from_jax``; one model-level JAX compile, the loss, every gradient and
the logits in one function:

  * the super-block's tree and ``segments``;
  * the loss and every gradient (remat none and full), the logits,
    prefill and decode logits on f32 caches;
  * the slot engine's greedy streams (the ``cuda`` and ``cuda_fm``
    decode backends; ``auto`` resolves to ``cuda`` wherever it serves the
    layer, as here) token by token the JAX model's greedy
    choice over the stream (``assert_greedy_streams``: the argmax on f32
    caches, within a near-tie of it on bf16 ones), with the KV at rest and
    the recurrent state's bytes.

Tolerance 1e-4.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import forward_logits as jax_forward_logits
from repro.models import model as jmodel
from repro_torch.interop import from_jax
from repro_torch.models import (
    decode_step, forward_logits, init_decode_caches, loss_fn, prefill, segments,
)
from repro_torch.models.model import insert_slot
from repro_torch.serve import DecodeEngine, EngineConfig
from repro_torch.serve import kv_cache as tserve
from test_torch_jamba import _jax_params, _np_tree, _pair, assert_greedy_streams
from test_torch_rope_protect import _close, _flat_np, _prompt

TOL = 1e-4
MAX_LEN = 40


@pytest.fixture(scope="module")
def jamba():
    """The JAX model's loss (forward_logits' cross entropy + MoE aux term),
    every gradient and the logits of a (2, 24) batch, in one compiled
    function that the engine streams reuse."""
    jc, tc = _pair()
    jc = dataclasses.replace(jc, attention=dataclasses.replace(jc.attention, backend="xla"))
    jp = _jax_params(tc, 31)
    rs = np.random.RandomState(32)
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


def test_one_super_block_tree_and_segments(jamba):
    tc = jamba["tc"]
    assert segments(tc) == [("jamba", 1)] == jmodel.segments(jamba["jc"])
    model = from_jax(jamba["np_params"], tc, device="cpu")
    subs = model.segments[0].subs.tree()
    kinds = [("attn" if "attn" in sub else "mamba", "moe" if "moe" in sub else "mlp")
             for sub in subs]
    assert kinds == [("mamba", "mlp"), ("mamba", "moe")] * 2 + [("attn", "mlp"),
                                                                 ("mamba", "moe")] + \
        [("mamba", "mlp"), ("mamba", "moe")]
    # the MLP is d_ff wide (not widened to expert_dim x top_k as a dense
    # layer of an MoE model is)
    assert tuple(subs[0]["mlp"]["up_gate"]["w"].shape) == (1, tc.d_model, 2 * tc.d_ff)


@pytest.mark.parametrize("remat", ["none", "full"])
def test_loss_and_every_grad_match_jax(jamba, remat):
    tc = dataclasses.replace(jamba["tc"], remat=remat)
    model = from_jax(jamba["np_params"], tc, device="cpu").requires_grad_(True)
    loss, metrics = loss_fn(model, {k: torch.from_numpy(v).long()
                                    for k, v in jamba["batch"].items()}, tc)
    assert metrics["aux"].item() > 0
    named = dict(model.named_parameters())
    grads = dict(zip(named, torch.autograd.grad(loss, list(named.values()))))
    np.testing.assert_allclose(loss.item(), jamba["loss"], rtol=0, atol=TOL)
    assert set(grads) == set(jamba["grads"])
    for name, g in grads.items():
        np.testing.assert_allclose(g.numpy(), jamba["grads"][name], rtol=0, atol=TOL,
                                   err_msg=name)


def test_logits_prefill_and_decode_match_jax(jamba):
    """forward_logits; then each row's first 13 tokens prefilled into its
    slot of f32 caches and teacher-forced decode steps to 24, both slots at
    once: each step's logits are the full sequence's at its position."""
    tc = jamba["tc"]
    model = from_jax(jamba["np_params"], tc, device="cpu")
    t = torch.from_numpy(jamba["batch"]["tokens"]).long()
    want = jamba["logits"]
    with torch.no_grad():
        _close(forward_logits(model, {"tokens": t}, tc), want)
    n0, n = 13, t.shape[1]
    caches = init_decode_caches(tc, 2, n, torch.float32, device="cpu")
    for row in (0, 1):
        lg, one = prefill(model, {"tokens": t[row:row + 1, :n0]}, tc)
        _close(lg[0], want[row, n0 - 1])
        insert_slot(caches, one, slot=row, max_len=n)
    for i in range(n0, n):
        lg, caches = decode_step(model, t[:, i], caches, torch.tensor([i, i]), tc)
        _close(lg, want[:, i])


@pytest.mark.parametrize("cache_dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("decode_backend", ["cuda", "cuda_fm"])
def test_engine_streams_are_the_jax_models_greedy_streams(jamba, decode_backend, cache_dtype):
    """The slot engine on two 12-token prompts, 12 new tokens each, on f32
    caches (swapped in before the requests) and on its own bf16 ones: each
    token is the JAX model's greedy choice over the stream so far
    (``assert_greedy_streams``); the KV at rest is one attention layer's
    (the byte model's per-layer bytes), the recurrent state 7 Mamba states
    a slot."""
    tc = jamba["tc"]
    model = from_jax(jamba["np_params"], tc, device="cpu")
    prompts = [_prompt(33, 12, 256), _prompt(34, 12, 256)]
    eng = DecodeEngine(model, tc, EngineConfig(max_slots=2, max_len=MAX_LEN,
                                               decode_backend=decode_backend), device="cpu")
    if cache_dtype == torch.bfloat16:
        per_layer = tserve.cache_bytes_per_token(dataclasses.replace(
            eng.cfg, num_layers=1))["fm" if decode_backend == "cuda_fm" else "sfa"]
        assert eng.cache_bytes() == per_layer * 2 * eng._cache_len
        di, s, cw = 2 * tc.d_model, tc.ssm.state_dim, tc.ssm.conv_dim
        assert eng.state_bytes() == 7 * 2 * (cw * di * 2 + di * s * 4)
    else:
        eng.caches = init_decode_caches(eng.cfg, 2, eng._cache_len, torch.float32,
                                        device="cpu")
    streams = [eng.generate(p, 12) for p in prompts]

    def run_ref(tokens):
        (_, logits), _ = jamba["run"](jamba["jp"], {
            "tokens": jnp.asarray(tokens), "labels": jnp.zeros_like(jnp.asarray(tokens))})
        return logits

    assert_greedy_streams(run_ref, prompts, streams, cache_dtype)
