"""The compact code-gradient seam of the port against the JAX package.

Kernels: ``code_grad_dx`` / ``code_grad_dw`` (their plain versions, which
the wrappers run on CPU tensors) and ``scatter_code_grads`` against the JAX
kernels (Pallas in interpret mode), duplicate and out-of-range indices
planted; ``sparse_proj_bwd`` against JAX's. Model level: reduced
gpt2-small-sfa8 in f32 with ``bwd_emit="compact"`` through the ``cuda``
backend's compact seam, the loss and every parameter gradient against
``repro.models.loss_fn`` with the same policy (``backend="pallas"``), for
h = hkv and for GQA; the seam is taken (and qk-norm is refused); and six
``Trainer`` steps under ``TrainPolicy(bwd_emit="compact", fwd_fuse=True,
remat="codes")`` against JAX's ``Trainer`` under the same policy. Inputs
are numpy arrays from a seed, handed to both. Tolerance: 1e-4 in f32 (sums
in another order); integer codes exact.
"""
import dataclasses
import functools
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs.base import TrainPolicy as JaxTrainPolicy
from repro.data import DataConfig as JaxDataConfig
from repro.kernels.code_grad import code_grad_dw as jax_code_grad_dw
from repro.kernels.code_grad import code_grad_dx as jax_code_grad_dx
from repro.kernels.code_grad import scatter_code_grads as jax_scatter_code_grads
from repro.models import init as jax_init
from repro.models import loss_fn as jax_loss_fn
from repro.models.layers import sparse_proj_bwd as jax_sparse_proj_bwd
from repro.optim import OptimizerConfig as JaxOptimizerConfig
from repro.train import Trainer as JaxTrainer
from repro.train import TrainerConfig as JaxTrainerConfig
from repro_torch.configs import get_config
from repro_torch.configs.base import TrainPolicy
from repro_torch.data import DataConfig
from repro_torch.interop import from_jax
from repro_torch.kernels import code_grad_dw, code_grad_dx, scatter_code_grads
from repro_torch.kernels.ref import code_grad_dw_ref, code_grad_dx_ref
from repro_torch.models import attention as attn
from repro_torch.models import loss_fn
from repro_torch.models.layers import sparse_proj_bwd
from repro_torch.optim import OptimizerConfig
from repro_torch.train import Trainer, TrainerConfig

TOL = 1e-4


def _t(*arrays):
    return [torch.from_numpy(np.asarray(a)) for a in arrays]


def _codes(rs, nh, n, d, kw, plant=True):
    """Unique ascending indices per row, as rtopk emits; with ``plant``,
    some rows repeat an index (as pair closures do), some are padding rows
    (idx 0 × kw, val 0) and some carry an index outside [0, d)."""
    vals = rs.randn(nh, n, kw).astype(np.float32)
    idx = np.sort(np.argsort(rs.rand(nh, n, d), axis=-1)[..., :kw], axis=-1).astype(np.int32)
    if plant:
        idx[:, 3::7, 1] = idx[:, 3::7, 0]          # duplicates sum
        idx[:, 5, :], vals[:, 5, :] = 0, 0.0       # a padding row
        idx[:, 9::11, -1] = d                      # outside [0, d): adds nothing
    return vals, idx


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
# kernels against JAX
# --------------------------------------------------------------------------

@pytest.mark.parametrize("nh,n,m,d,kw", [
    (1, 128, 128, 64, 8),     # aligned with the JAX tiles
    (3, 200, 96, 64, 16),     # ragged n and m; a pair-closure width
    (2, 70, 130, 32, 4),
])
def test_code_grad_kernels_match_jax(nh, n, m, d, kw):
    rs = np.random.RandomState(0)
    vals, idx = _codes(rs, nh, n, d, kw)
    w = rs.randn(nh, m, d).astype(np.float32)
    x = rs.randn(n, m).astype(np.float32)
    tv, ti, tw, tx = _t(vals, idx, w, x)
    dx, dw = code_grad_dx(tv, ti, tw, d=d), code_grad_dw(tx, tv, ti, d=d)
    assert dx.dtype == dw.dtype == torch.float32
    assert torch.equal(dx, code_grad_dx_ref(tv, ti, tw, d=d))
    assert torch.equal(dw, code_grad_dw_ref(tx, tv, ti, d=d))
    np.testing.assert_allclose(dx.numpy(), np.asarray(jax_code_grad_dx(vals, idx, w, d=d)),
                               rtol=0, atol=TOL)
    np.testing.assert_allclose(dw.numpy(), np.asarray(jax_code_grad_dw(x, vals, idx, d=d)),
                               rtol=0, atol=TOL)


def test_scatter_code_grads_sums_duplicates_like_jax():
    rs = np.random.RandomState(1)
    vals, idx = _codes(rs, 2, 40, 16, 6)
    got = scatter_code_grads(*_t(vals, idx), 16)
    want = np.asarray(jax_scatter_code_grads(jnp.asarray(vals), jnp.asarray(idx), 16))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    row = got[0, 3]                                 # a planted duplicate
    assert torch.isclose(row[int(idx[0, 3, 0])], torch.tensor(vals[0, 3, :2].sum()))


def test_sparse_proj_bwd_matches_jax():
    rs = np.random.RandomState(2)
    nh, n, m, d, k = 2, 96, 48, 32, 4
    vals, idx = _codes(rs, nh, n, d, k)
    w = rs.randn(nh, m, d).astype(np.float32)
    x = rs.randn(n, m).astype(np.float32)
    got = sparse_proj_bwd(*_t(x, w, vals, idx), d=d)
    want = jax_sparse_proj_bwd(x, w, vals, idx, d=d)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=TOL)


def test_compact_backward_never_scatters_dense():
    """The seam's backward hands the compact codes to the code_grad
    kernels: no scatter back to dense rows anywhere on it."""
    from repro_torch.kernels.flash_sfa_bwd import pair_closure_indices
    from repro_torch.models.layers import rope_code_vjp
    for fn in (attn._SFAProjAttendCompact.backward, sparse_proj_bwd, rope_code_vjp,
               pair_closure_indices):
        src = inspect.getsource(fn)
        for banned in ("scatter_code_grads", "densify", "scatter_add", "one_hot"):
            assert banned not in src, (fn.__qualname__, banned)


# --------------------------------------------------------------------------
# model level: loss and every parameter gradient against repro.loss_fn
# --------------------------------------------------------------------------

def _configs(name, hkv=None, **overrides):
    jc = dataclasses.replace(jax_get_config(name).reduced(), dtype="float32", **overrides)
    tc = dataclasses.replace(get_config(name).reduced(), dtype="float32", **overrides)
    if hkv is not None:
        jc = dataclasses.replace(jc, attention=dataclasses.replace(jc.attention,
                                                                   num_kv_heads=hkv))
        tc = dataclasses.replace(tc, attention=dataclasses.replace(tc.attention,
                                                                   num_kv_heads=hkv))
    return jc, tc


def _batch(rs, vocab, b=2, n=40):
    tokens = rs.randint(0, vocab, size=(b, n)).astype(np.int32)
    labels = rs.randint(0, vocab, size=(b, n)).astype(np.int32)
    labels[:, :3] = -1
    return {"tokens": tokens, "labels": labels}


def jax_compact_grads(jc, batch, seed=3):
    """JAX loss and gradients with the seam's policy on the pallas backend
    (Pallas in interpret mode)."""
    jc = dataclasses.replace(jc, attention=dataclasses.replace(
        jc.attention, backend="pallas", bwd_emit="compact"))
    jp = jax_init(jax.random.PRNGKey(seed), jc)
    (loss, _), grads = jax.jit(jax.value_and_grad(
        lambda p, b: jax_loss_fn(p, b, jc), has_aux=True))(
            jp, {k: jnp.asarray(v) for k, v in batch.items()})
    return jax.tree.map(np.asarray, jp), float(loss), _flat(grads)


def torch_grads(tc, jp, batch, **attention):
    tc = dataclasses.replace(tc, attention=dataclasses.replace(tc.attention, **attention))
    model = from_jax(jp, tc, device="cpu").requires_grad_(True)
    loss, _ = loss_fn(model, {k: torch.from_numpy(v).long() for k, v in batch.items()}, tc)
    named = dict(model.named_parameters())
    grads = torch.autograd.grad(loss, list(named.values()))
    return float(loss.detach()), dict(zip(named, grads))


@functools.lru_cache(maxsize=None)
def compact_reference(hkv):
    """Reduced gpt2-small-sfa8 in f32 (GQA at ``hkv`` kv heads), a batch,
    and JAX's parameters, loss and gradients under the seam's policy with
    remat="codes". Shared by the model-level tests of this file and of
    tests/test_torch_remat.py: each JAX reference compiles once."""
    jc, tc = _configs("gpt2-small-sfa8", hkv=hkv, loss_chunk=16)
    batch = _batch(np.random.RandomState(6), jc.vocab_size)
    jp, jloss, jgrads = jax_compact_grads(dataclasses.replace(jc, remat="codes"), batch)
    return tc, batch, jp, jloss, jgrads


@pytest.mark.parametrize("hkv", [None, 2], ids=["mha", "gqa"])
def test_compact_seam_loss_and_grads_match_jax(hkv):
    tc, batch, jp, jloss, jgrads = compact_reference(hkv)
    attn.clear_compact_seam_reports()
    loss, grads = torch_grads(tc, jp, batch, backend="cuda", bwd_emit="compact")
    assert [r.taken for r in attn.compact_seam_reports()] == [True]
    np.testing.assert_allclose(loss, jloss, rtol=0, atol=TOL)
    assert set(grads) == set(jgrads)
    for name, g in grads.items():
        np.testing.assert_allclose(g.numpy(), jgrads[name], rtol=0, atol=TOL, err_msg=name)


def test_compact_seam_is_taken(monkeypatch):
    """An eligible layer goes through the seam Function (counted by a spy),
    a qk-norm layer does not, and the torch backend is not the seam's."""
    calls = []
    orig = attn._SFAProjAttendCompact.apply

    def spy(*a):
        calls.append(1)
        return orig(*a)

    monkeypatch.setattr(attn._SFAProjAttendCompact, "apply", spy)
    _, cfg = _configs("gpt2-small-sfa8")
    cfg = dataclasses.replace(cfg, attention=dataclasses.replace(
        cfg.attention, bwd_emit="compact", backend="cuda"))
    gen = torch.Generator().manual_seed(0)
    params = attn.attention_init(gen, cfg)
    x = torch.randn(1, 24, cfg.d_model, generator=gen)
    attn.clear_compact_seam_reports()
    attn.attention_apply(params, x, cfg=cfg, mode="train")
    assert calls and attn.compact_train_eligible(cfg)
    calls.clear()
    for change, why in ((dict(qk_norm=True), "qk-norm"), (dict(backend="torch"), "backend")):
        c = dataclasses.replace(cfg, attention=dataclasses.replace(cfg.attention, **change))
        attn.attention_apply(attn.attention_init(gen, c), x, cfg=c, mode="train")
        assert not calls, change
        assert any(not r.taken and why in r.reason for r in attn.compact_seam_reports())
    attn.clear_compact_seam_reports()


# --------------------------------------------------------------------------
# six Trainer steps under the slice's policy against JAX's Trainer
# --------------------------------------------------------------------------

def test_trainer_six_steps_compact_policy_match_jax():
    """Same initial weights (the JAX trainer's, through ``from_jax``), same
    Markov batches, AdamW with warmup and cosine decay, both under
    bwd_emit="compact", fwd_fuse=True, remat="codes" (JAX: pallas backend).
    Tolerances as tests/test_torch_train.py: step 0's loss 1e-4; later
    losses 1e-3 and the gradient norm 1e-3 relative (AdamW's division by
    each moment's root amplifies f32 rounding on near-zero gradients)."""
    jc, tc = _configs("gpt2-small-sfa8")
    jdata = JaxDataConfig(vocab_size=jc.vocab_size, seq_len=32, global_batch=2)
    tdata = DataConfig(vocab_size=tc.vocab_size, seq_len=32, global_batch=2)
    jpol = JaxTrainPolicy.from_model(jc, backend="pallas", bwd_emit="compact",
                                     fwd_fuse=True, remat="codes")
    jtr = JaxTrainer(jc, JaxOptimizerConfig(lr=3e-3, warmup_steps=2, total_steps=6), jdata,
                     JaxTrainerConfig(total_steps=6, policy=jpol))
    model = from_jax(jax.tree.map(np.asarray, jtr.params), tc, device="cpu")
    tpol = TrainPolicy.from_model(tc, backend="cuda", bwd_emit="compact", fwd_fuse=True,
                                  remat="codes")
    ttr = Trainer(tc, OptimizerConfig(lr=3e-3, warmup_steps=2, total_steps=6), tdata,
                  TrainerConfig(total_steps=6, policy=tpol), device="cpu", params=model)
    for step in range(6):
        jm, tm = jtr.run_step(step), ttr.run_step(step)
        tol = TOL if step == 0 else 1e-3
        np.testing.assert_allclose(tm["loss"], jm["loss"], rtol=0, atol=tol, err_msg=str(step))
        np.testing.assert_allclose(tm["grad_norm"], jm["grad_norm"], rtol=1e-3,
                                   err_msg=str(step))
        assert np.isfinite(tm["loss"])
