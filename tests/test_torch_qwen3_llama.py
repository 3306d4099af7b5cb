"""The slice's models against the JAX package on the CPU, f32, reduced.

Reduced qwen3-0.6b-sfa8 (GQA: 4 query heads over 2 kv heads; RoPE,
qk-norm, RMSNorm, SwiGLU): the loss and every parameter gradient of the
dense emit against ``repro.models.loss_fn`` on its XLA backend, through the
port's ``cuda`` backend (the kernel wrappers' plain versions inside the
same autograd Functions as on the card) and its ``torch`` oracle. Reduced
llama3.2-3b with GQA kept (2 kv heads): the loss and every gradient through
the compact seam's RoPE branch (proj_rtopk's RoPE, the compact2 pair
closure, ``rope_code_vjp``) against JAX on its Pallas backend in interpret
mode. The three llama-family configs against the JAX registry's, and
``from_jax`` carrying an untied LM head (llama3-8b). ``sfa_distill`` (paper
Eq. 8) on reduced gpt2-small-sfa8: loss, aux term and every gradient
against JAX, under each remat policy. Tolerance 1e-4; the seam report
exact. Each JAX reference compiles once (a module fixture).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import init as jax_init
from repro.models import loss_fn as jax_loss_fn
from repro_torch.configs import NOT_YET_PORTED, get_config
from repro_torch.interop import from_jax
from repro_torch.models import attention as attn
from repro_torch.models import loss_fn
from test_torch_code_grad import _flat, jax_compact_grads, torch_grads

TOL = 1e-4
LLAMAS = ("llama3.2-3b", "llama3-8b", "deepseek-7b")


def _pair(name, hkv=2, **overrides):
    """(JAX config, port config): reduced, f32, ``hkv`` kv heads."""
    out = []
    for get in (jax_get_config, get_config):
        c = dataclasses.replace(get(name).reduced(), dtype="float32", loss_chunk=16,
                                **overrides)
        out.append(dataclasses.replace(c, attention=dataclasses.replace(
            c.attention, num_kv_heads=hkv)))
    return out


def _batch(seed, vocab, b=2, n=40):
    rs = np.random.RandomState(seed)
    tokens = rs.randint(0, vocab, size=(b, n)).astype(np.int32)
    labels = rs.randint(0, vocab, size=(b, n)).astype(np.int32)
    labels[:, :3] = -1
    return {"tokens": tokens, "labels": labels}


def _jax_grads(jc, batch, seed=3):
    """JAX loss, metrics and gradients of ``jc`` as configured."""
    jp = jax_init(jax.random.PRNGKey(seed), jc)
    (loss, metrics), grads = jax.jit(jax.value_and_grad(
        lambda p, b: jax_loss_fn(p, b, jc), has_aux=True))(
            jp, {k: jnp.asarray(v) for k, v in batch.items()})
    return jax.tree.map(np.asarray, jp), float(loss), metrics, _flat(grads)


def _assert_grads(grads, jgrads):
    assert set(grads) == set(jgrads)
    for name, g in grads.items():
        np.testing.assert_allclose(g.numpy(), jgrads[name], rtol=0, atol=TOL, err_msg=name)


# --------------------------------------------------------------------------
# qwen3-0.6b-sfa8: the dense emit's loss and gradients
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def qwen3_reference():
    jc, tc = _pair("qwen3-0.6b-sfa8")
    jc = dataclasses.replace(jc, attention=dataclasses.replace(jc.attention, backend="xla"))
    batch = _batch(11, jc.vocab_size)
    jp, jloss, _, jgrads = _jax_grads(jc, batch)
    return tc, batch, jp, jloss, jgrads


@pytest.mark.parametrize("backend", ["cuda", "torch"])
def test_qwen3_loss_and_every_grad_match_jax(qwen3_reference, backend):
    tc, batch, jp, jloss, jgrads = qwen3_reference
    assert tc.attention.qk_norm and tc.attention.rope and tc.norm == "rmsnorm" and tc.glu
    loss, grads = torch_grads(tc, jp, batch, backend=backend)
    np.testing.assert_allclose(loss, jloss, rtol=0, atol=TOL)
    _assert_grads(grads, jgrads)


# --------------------------------------------------------------------------
# llama3.2-3b: the compact seam's RoPE branch with GQA
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def llama_reference():
    jc, tc = _pair("llama3.2-3b")
    batch = _batch(12, jc.vocab_size)
    jp, jloss, jgrads = jax_compact_grads(jc, batch)
    return tc, batch, jp, jloss, jgrads


@pytest.mark.parametrize("emit", ["compact", "compact2"])
def test_llama_rope_seam_loss_and_every_grad_match_jax(llama_reference, emit):
    """The RoPE layer widens a "compact" request to the pair closure; both
    requests take the seam and give JAX's loss and gradients."""
    tc, batch, jp, jloss, jgrads = llama_reference
    assert tc.attention.rope and not tc.attention.qk_norm
    assert tc.attention.num_kv_heads < tc.attention.num_heads
    attn.clear_compact_seam_reports()
    loss, grads = torch_grads(tc, jp, batch, backend="cuda", bwd_emit=emit)
    assert [r.taken for r in attn.compact_seam_reports()] == [True]
    attn.clear_compact_seam_reports()
    np.testing.assert_allclose(loss, jloss, rtol=0, atol=TOL)
    _assert_grads(grads, jgrads)


# --------------------------------------------------------------------------
# the llama-family configs and an untied head
# --------------------------------------------------------------------------

@pytest.mark.parametrize("reduced", [False, True], ids=["full", "reduced"])
@pytest.mark.parametrize("name", LLAMAS)
def test_llama_configs_equal_the_reference(name, reduced):
    """Every field equal but the backend names, which follow each
    package's registry (tests/test_torch_configs.py)."""
    jc, tc = jax_get_config(name), get_config(name)
    if reduced:
        jc, tc = jc.reduced(), tc.reduced()
    jd, td = dataclasses.asdict(jc), dataclasses.asdict(tc)
    for d in (jd, td):
        for field in ("backend", "decode_backend"):
            d["attention"].pop(field)
    assert td == jd
    assert name not in NOT_YET_PORTED


def test_from_jax_carries_the_untied_head():
    jc, tc = jax_get_config("llama3-8b").reduced(), get_config("llama3-8b").reduced()
    assert not tc.tie_embeddings
    jp = jax.tree.map(np.asarray, jax_init(jax.random.PRNGKey(5), jc))
    model = from_jax(jp, tc, device="cpu")
    np.testing.assert_array_equal(model.lm_head.w.numpy(), jp["lm_head"]["w"])
    np.testing.assert_array_equal(model.embed.w.numpy(), jp["embed"]["w"])
    assert not np.array_equal(jp["lm_head"]["w"].T, jp["embed"]["w"])


# --------------------------------------------------------------------------
# sfa_distill (paper Eq. 8)
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def distill_reference():
    jc, tc = _pair("gpt2-small-sfa8", hkv=4, sfa_distill=0.1)
    jc = dataclasses.replace(jc, attention=dataclasses.replace(jc.attention, backend="xla"))
    batch = _batch(13, jc.vocab_size)
    jp, jloss, metrics, jgrads = _jax_grads(jc, batch)
    return tc, batch, jp, jloss, float(metrics["aux"]), jgrads


@pytest.mark.parametrize("backend,remat", [("cuda", "none"), ("cuda", "full"),
                                           ("cuda", "codes"), ("torch", "none")])
def test_sfa_distill_loss_aux_and_grads_match_jax(distill_reference, backend, remat):
    tc, batch, jp, jloss, jaux, jgrads = distill_reference
    assert jaux > 0
    tc = dataclasses.replace(tc, remat=remat, attention=dataclasses.replace(
        tc.attention, backend=backend))
    model = from_jax(jp, tc, device="cpu").requires_grad_(True)
    loss, metrics = loss_fn(model, {k: torch.from_numpy(v).long() for k, v in batch.items()},
                            tc)
    named = dict(model.named_parameters())
    grads = dict(zip(named, torch.autograd.grad(loss, list(named.values()))))
    loss = loss.item()
    np.testing.assert_allclose(loss, jloss, rtol=0, atol=TOL)
    np.testing.assert_allclose(metrics["aux"].item(), jaux, rtol=0, atol=TOL)
    np.testing.assert_allclose(metrics["ce"].item() + metrics["aux"].item(), loss, rtol=1e-6)
    _assert_grads(grads, jgrads)


def test_distill_declines_the_seam_and_is_zero_outside_training():
    _, tc = _pair("gpt2-small-sfa8", hkv=4, sfa_distill=0.1)
    tc = dataclasses.replace(tc, attention=dataclasses.replace(
        tc.attention, backend="cuda", bwd_emit="compact"))
    assert "distill" in attn.compact_seam_ineligible_reason(tc)
    gen = torch.Generator().manual_seed(0)
    params = attn.attention_init(gen, tc)
    x = torch.randn(1, 24, tc.d_model, generator=gen)
    attn.clear_compact_seam_reports()
    out = attn.attention_apply(params, x, cfg=tc, mode="train")
    assert out.distill is not None and float(out.distill) > 0
    assert [r.taken for r in attn.compact_seam_reports()] == [False]
    attn.clear_compact_seam_reports()
    with torch.no_grad():
        assert attn.attention_apply(params, x, cfg=tc, mode="eval").distill is None
