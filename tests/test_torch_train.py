"""Training parity: the port's backward path against the JAX package.

Op level, ``sfa_attention_op``'s gradients against JAX
``sfa_attention_op(impl="pallas", bwd_emit="dense")`` (Pallas in interpret
mode); the plain versions of the three backward-path kernels against the
JAX kernels; the chunked cross-entropy; model level, ``loss_fn`` and every
parameter gradient against ``repro.models.loss_fn`` on reduced
gpt2-small-sfa8 in f32, through the ``cuda`` backend (its kernel wrappers
run their plain versions on the CPU, inside the same autograd Functions as
on the card) and the ``torch`` oracle; and 6 steps of the ``Trainer``
against JAX's ``Trainer`` on the same initial weights, for SFA and for the
dense baseline. Inputs are numpy arrays from a seed, handed to both.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs.base import TrainPolicy as JaxTrainPolicy
from repro.data import DataConfig as JaxDataConfig
from repro.kernels import flash_attention as jax_flash_attention
from repro.kernels import flash_attention_bwd as jax_flash_attention_bwd
from repro.kernels import flash_sfa as jax_flash_sfa
from repro.kernels import flash_sfa_bwd as jax_flash_sfa_bwd
from repro.kernels import sfa_attention_op as jax_sfa_attention_op
from repro.models import init as jax_init
from repro.models import loss_fn as jax_loss_fn
from repro.models.layers import chunked_cross_entropy as jax_chunked_ce
from repro.optim import OptimizerConfig as JaxOptimizerConfig
from repro.train import Trainer as JaxTrainer
from repro.train import TrainerConfig as JaxTrainerConfig
from repro_torch.configs import get_config
from repro_torch.data import DataConfig
from repro_torch.interop import from_jax
from repro_torch.kernels import (
    flash_attention, flash_attention_bwd, flash_sfa_bwd, sfa_attention_op,
)
from repro_torch.kernels.ref import flash_attention_bwd_ref, flash_attention_ref, flash_sfa_bwd_ref
from repro_torch.models import loss_fn
from repro_torch.models.backends import get_backend
from repro_torch.models.layers import chunked_cross_entropy
from repro_torch.optim import OptimizerConfig
from repro_torch.train import Trainer, TrainerConfig

TOL = 1e-4          # f32 parity, sums in another order


def _t(*arrays, grad=False):
    return [torch.from_numpy(np.asarray(a)).requires_grad_(grad) for a in arrays]


def _codes(rs, bh, n, k, d):
    vals = rs.randn(bh, n, k).astype(np.float32)
    idx = np.sort(np.argsort(rs.rand(bh, n, d), axis=-1)[..., :k], axis=-1)
    return vals, idx.astype(np.int32)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix[:-1]: np.asarray(tree)}
    out = {}
    for key, sub in items:
        out.update(_flat(sub, f"{prefix}{key}."))
    return out


# --------------------------------------------------------------------------
# (a) the cuda backend's full-sequence path passes gradients to q, k and v
# --------------------------------------------------------------------------

@pytest.mark.parametrize("sfa_k", [4, None])
def test_cuda_backend_full_attention_passes_gradients(sfa_k):
    """The kernels' wrappers fill outputs with no grad_fn, so the cuda
    backend must go through its autograd Function, on the card and here
    alike: the output hangs off that Function, and q, k and v get the torch
    oracle's gradients (GQA: 4 query heads over 2 kv heads)."""
    rs = np.random.RandomState(0)
    q = rs.randn(2, 50, 4, 32).astype(np.float32)
    k, v = (rs.randn(2, 50, 2, 32).astype(np.float32) for _ in range(2))
    w = torch.from_numpy(rs.randn(2, 50, 4, 32).astype(np.float32))
    grads = {}
    for name in ("cuda", "torch"):
        tq, tk, tv = _t(q, k, v, grad=True)
        o = get_backend(name).full(tq, tk, tv, num_heads=4, sfa_k=sfa_k, causal=True,
                                   window=None, scale=32 ** -0.5)
        if name == "cuda":
            want = "_SFAAttentionBackward" if sfa_k else "_DenseAttentionBackward"
            assert type(o.grad_fn).__name__ == want
        grads[name] = torch.autograd.grad((o * w).sum(), (tq, tk, tv))
    for a, b in zip(grads["cuda"], grads["torch"]):
        assert a.abs().sum() > 0
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=TOL)


# --------------------------------------------------------------------------
# (b) op level: sfa_attention_op gradients against JAX's Pallas backward
# --------------------------------------------------------------------------

@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("sfa_k", [4, 8, 32])          # 32 == d: dense support
def test_sfa_attention_op_grads_match_jax_pallas(causal, sfa_k):
    """Shapes of tests/test_flash_sfa_bwd.py: n=160 is not a multiple of
    the JAX kernel's 128 block; the same non-uniform cotangent. 1e-4 in
    f32; gradients in the inputs' dtype."""
    rs = np.random.RandomState(1)
    q, k, v = (rs.randn(2, 160, 2, 32).astype(np.float32) for _ in range(3))

    def jloss(q, k, v):
        o = jax_sfa_attention_op(q, k, v, sfa_k=sfa_k, causal=causal, impl="pallas",
                                 bwd_impl="pallas", bwd_emit="dense")
        w = jnp.arange(o.size, dtype=o.dtype).reshape(o.shape) / o.size
        return jnp.sum(o * w + 0.5 * o * o)

    jg = jax.grad(jloss, argnums=(0, 1, 2))(q, k, v)
    tq, tk, tv = _t(q, k, v, grad=True)
    o = sfa_attention_op(tq, tk, tv, sfa_k=sfa_k, causal=causal)
    w = torch.arange(o.numel(), dtype=o.dtype).reshape(o.shape) / o.numel()
    tg = torch.autograd.grad((o * w + 0.5 * o * o).sum(), (tq, tk, tv))
    for name, a, b in zip("qkv", tg, jg):
        assert a.dtype == tq.dtype, name
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=TOL,
                                   err_msg=f"d{name}")


def test_sfa_attention_op_bf16_grads_come_back_in_bf16():
    rs = np.random.RandomState(2)
    tq, tk, tv = (t.bfloat16().requires_grad_() for t in
                  _t(*(rs.randn(1, 64, 2, 32).astype(np.float32) for _ in range(3))))
    o = sfa_attention_op(tq, tk, tv, sfa_k=4)
    grads = torch.autograd.grad(o.float().sum(), (tq, tk, tv))
    assert [g.dtype for g in grads] == [torch.bfloat16] * 3


# --------------------------------------------------------------------------
# (c, d) the plain versions against the JAX kernels
# --------------------------------------------------------------------------

@pytest.mark.parametrize("causal,k", [(True, 4), (False, 8)])
def test_flash_sfa_bwd_ref_matches_jax_dense_emit(causal, k):
    """dQ, dK and dV to 1e-4, and dQ/dK exactly zero off each row's stored
    coordinates in both packages (a padding row stores index 0 k times)."""
    rs = np.random.RandomState(3)
    bh, n, d, dv = 4, 160, 32, 32
    qv, qi = _codes(rs, bh, n, k, d)
    kv, ki = _codes(rs, bh, n, k, d)
    kv[:, 5], ki[:, 5] = 0.0, 0
    v, g = (rs.randn(bh, n, dv).astype(np.float32) for _ in range(2))
    o, lse = jax_flash_sfa(qv, qi, kv, ki, v, d=d, causal=causal, return_residuals=True)
    o, lse = np.asarray(o), np.asarray(lse)
    want = jax_flash_sfa_bwd(qv, qi, kv, ki, v, o, lse, g, d=d, causal=causal, emit="dense")
    got = flash_sfa_bwd(*_t(qv, qi, kv, ki, v, o, lse, g), d=d, causal=causal)
    plain = flash_sfa_bwd_ref(*_t(qv, qi, kv, ki, v, o, lse, g), d=d, causal=causal)
    for name, a, p, b in zip(("dq", "dk", "dv"), got, plain, want):
        assert torch.equal(a, p), name                  # the wrapper runs the plain version
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=TOL, err_msg=name)
    for grad, jgrad, idx in ((got[0], want[0], qi), (got[1], want[1], ki)):
        support = np.zeros((bh, n, d), bool)
        np.put_along_axis(support, idx, True, axis=-1)
        assert (grad.numpy()[~support] == 0).all()
        assert (np.asarray(jgrad)[~support] == 0).all()
    # the compact emit is the dense rows gathered at the stored indices
    compact = flash_sfa_bwd(*_t(qv, qi, kv, ki, v, o, lse, g), d=d, causal=causal,
                            emit="compact")
    for grad, dense, idx in ((compact[0], got[0], qi), (compact[1], got[1], ki)):
        assert torch.equal(grad, dense.gather(-1, torch.from_numpy(idx).long()))


@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_ref_and_bwd_match_jax(causal):
    rs = np.random.RandomState(4)
    q, k, v, g = (rs.randn(4, 160, 32).astype(np.float32) for _ in range(4))
    jo, jl = jax_flash_attention(q, k, v, causal=causal, return_residuals=True)
    to, tl = flash_attention(*_t(q, k, v), causal=causal, return_residuals=True)
    po = flash_attention_ref(*_t(q, k, v), causal=causal)
    assert torch.equal(to, po)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=0, atol=TOL)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=TOL)
    o, lse = np.asarray(jo), np.asarray(jl)
    want = jax_flash_attention_bwd(q, k, v, o, lse, g, causal=causal)
    got = flash_attention_bwd(*_t(q, k, v, o, lse, g), causal=causal)
    plain = flash_attention_bwd_ref(*_t(q, k, v, o, lse, g), causal=causal)
    for name, a, p, b in zip(("dq", "dk", "dv"), got, plain, want):
        assert torch.equal(a, p), name
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=TOL, err_msg=name)


# --------------------------------------------------------------------------
# (e) chunked cross-entropy
# --------------------------------------------------------------------------

def test_chunked_cross_entropy_matches_jax_with_padding_and_ignored_labels():
    """n=70 with chunk 32: the last chunk is short here and padded in JAX;
    labels -1 carry no loss. Loss, token count and both gradients to 1e-5
    (f32), and the loss equals unchunked ``F.cross_entropy``."""
    rs = np.random.RandomState(5)
    h = rs.randn(2, 70, 16).astype(np.float32)
    w = (0.3 * rs.randn(50, 16)).astype(np.float32)
    y = rs.randint(0, 50, size=(2, 70)).astype(np.int32)
    y[0, :9] = -1
    y[1, 60:] = -1
    (jl, jc), jg = jax.value_and_grad(
        lambda h, w: jax_chunked_ce(h, w, y, chunk=32), argnums=(0, 1), has_aux=True)(h, w)
    th, tw = _t(h, w, grad=True)
    tl, tc = chunked_cross_entropy(th, tw, torch.from_numpy(y), chunk=32)
    tg = torch.autograd.grad(tl, (th, tw))
    assert float(tc) == float(jc) == float((y >= 0).sum())
    np.testing.assert_allclose(float(tl), float(jl), rtol=0, atol=1e-5)
    for a, b in zip(tg, jg):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-5)
    full = torch.nn.functional.cross_entropy(
        (th @ tw.T).reshape(-1, 50), torch.from_numpy(y).long().reshape(-1), ignore_index=-1)
    np.testing.assert_allclose(float(tl), float(full), rtol=0, atol=1e-5)


# --------------------------------------------------------------------------
# (h) loss_fn and every parameter gradient, reduced gpt2-small-sfa8
# --------------------------------------------------------------------------

def _configs(name, **overrides):
    jc = dataclasses.replace(jax_get_config(name).reduced(), dtype="float32", **overrides)
    tc = dataclasses.replace(get_config(name).reduced(), dtype="float32", **overrides)
    return jc, tc


@pytest.fixture(scope="module")
def sfa_grads():
    """JAX loss and gradients (xla backend) on reduced gpt2-small-sfa8,
    loss_chunk 16 so the 40-token sequence spans three chunks."""
    jc, tc = _configs("gpt2-small-sfa8", loss_chunk=16)
    jc = dataclasses.replace(jc, attention=dataclasses.replace(jc.attention, backend="xla"))
    jp = jax_init(jax.random.PRNGKey(3), jc)
    rs = np.random.RandomState(6)
    tokens = rs.randint(0, jc.vocab_size, size=(2, 40)).astype(np.int32)
    labels = rs.randint(0, jc.vocab_size, size=(2, 40)).astype(np.int32)
    labels[:, :3] = -1
    batch = {"tokens": tokens, "labels": labels}
    (loss, metrics), grads = jax.jit(jax.value_and_grad(
        lambda p, b: jax_loss_fn(p, b, jc), has_aux=True))(
            jp, {k: jnp.asarray(v) for k, v in batch.items()})
    return tc, jax.tree.map(np.asarray, jp), batch, float(loss), metrics, _flat(grads)


@pytest.mark.parametrize("backend,remat", [("cuda", "none"), ("cuda", "full"),
                                           ("torch", "none")])
def test_loss_and_every_param_grad_match_jax(sfa_grads, backend, remat):
    tc, jp, batch, jloss, jmetrics, jgrads = sfa_grads
    tc = dataclasses.replace(tc, remat=remat, attention=dataclasses.replace(
        tc.attention, backend=backend))
    model = from_jax(jp, tc, device="cpu").requires_grad_(True)
    loss, metrics = loss_fn(model, {k: torch.from_numpy(v).long() for k, v in batch.items()}, tc)
    named = dict(model.named_parameters())
    grads = torch.autograd.grad(loss, list(named.values()))
    np.testing.assert_allclose(float(loss), jloss, rtol=0, atol=TOL)
    assert float(metrics["tokens"]) == float(jmetrics["tokens"]) == 74
    assert set(named) == set(jgrads)
    for name, g in zip(named, grads):
        np.testing.assert_allclose(g.numpy(), jgrads[name], rtol=0, atol=TOL, err_msg=name)


# --------------------------------------------------------------------------
# (i, j) six Trainer steps against JAX's Trainer, SFA and dense
# --------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["gpt2-small-sfa8", "gpt2-small"])
def test_trainer_six_steps_match_jax(arch):
    """Same initial weights (the JAX trainer's, through ``from_jax``), same
    Markov batches, AdamW with warmup and cosine decay. Step 0's loss is
    held to 1e-4. Later losses to 1e-3 absolute and the gradient norm to
    1e-3 relative: AdamW divides each moment by its own root, so an f32
    rounding difference on a near-zero gradient can move that parameter by
    up to 2·lr, and the two runs drift apart by that much from step 1 on."""
    jc, tc = _configs(arch)
    jdata = JaxDataConfig(vocab_size=jc.vocab_size, seq_len=32, global_batch=2)
    tdata = DataConfig(vocab_size=tc.vocab_size, seq_len=32, global_batch=2)
    jtr = JaxTrainer(jc, JaxOptimizerConfig(lr=3e-3, warmup_steps=2, total_steps=6), jdata,
                     JaxTrainerConfig(total_steps=6, policy=JaxTrainPolicy.from_model(
                         jc, backend="xla")))
    model = from_jax(jax.tree.map(np.asarray, jtr.params), tc, device="cpu")
    ttr = Trainer(tc, OptimizerConfig(lr=3e-3, warmup_steps=2, total_steps=6), tdata,
                  TrainerConfig(total_steps=6), device="cpu", params=model)
    for step in range(6):
        jm, tm = jtr.run_step(step), ttr.run_step(step)
        tol = TOL if step == 0 else 1e-3
        np.testing.assert_allclose(tm["loss"], jm["loss"], rtol=0, atol=tol, err_msg=str(step))
        np.testing.assert_allclose(tm["grad_norm"], jm["grad_norm"], rtol=1e-3,
                                   err_msg=str(step))
        np.testing.assert_allclose(tm["lr"], jm["lr"], rtol=1e-6)
        assert np.isfinite(tm["loss"])
