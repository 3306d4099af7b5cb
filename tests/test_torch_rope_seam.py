"""The pair-widened (n, 2k) compact backward through RoPE, against JAX.

``pair_closure_indices`` (full and partial rotation); the FlashSFA
backward's "compact" and "compact2" emits (the wrapper's plain version on
CPU tensors) against the JAX kernel in interpret mode, duplicates planted,
and scattered back onto the dense emit; ``rope_code_vjp`` against JAX's and
against autograd of the port's ``rope``; "compact2" forced on a RoPE-free
seam; the op-level "compact2" gradients; the eligibility matrix; and the
RoPE branch of the seam at model level on a test-only geometry:
``dataclasses.replace(reduced qwen3-0.6b-sfa8, qk_norm=False)`` with two kv
heads, in both packages. Tolerance 1e-4 in f32; integer codes exact.
"""
import dataclasses
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs.base import AttentionConfig as JaxAttentionConfig
from repro.configs.base import MLAConfig as JaxMLAConfig
from repro.configs.base import ModelConfig as JaxModelConfig
from repro.kernels import sfa_attention_op as jax_sfa_attention_op
from repro.kernels.flash_sfa import flash_sfa as jax_flash_sfa
from repro.kernels.flash_sfa_bwd import flash_sfa_bwd as jax_flash_sfa_bwd
from repro.kernels.flash_sfa_bwd import pair_closure_indices as jax_pair_closure_indices
from repro.models import attention as jattn
from repro.models.layers import rope_code_vjp as jax_rope_code_vjp
from repro_torch.configs import get_config
from repro_torch.configs.base import AttentionConfig, MLAConfig, ModelConfig
from repro_torch.kernels import flash_sfa_bwd, pair_closure_indices, sfa_attention_op
from repro_torch.kernels.ref import flash_sfa_bwd_ref, scatter_code_grads
from repro_torch.models import attention as attn
from repro_torch.models.layers import rope, rope_code_vjp
from test_torch_code_grad import compact_reference, jax_compact_grads, torch_grads

TOL = 1e-4


def _t(*arrays, grad=False):
    return [torch.from_numpy(np.array(a)).requires_grad_(grad) for a in arrays]


def _codes(rs, shape, d, k):
    vals = rs.randn(*shape, k).astype(np.float32)
    idx = np.sort(np.argsort(rs.rand(*shape, d), axis=-1)[..., :k], axis=-1)
    return vals, idx.astype(np.int32)


# --------------------------------------------------------------------------
# pair-closure map
# --------------------------------------------------------------------------

@pytest.mark.parametrize("idx,rot,want", [
    ([[0, 3, 6, 7]], 8, [[0, 2, 6, 6, 1, 3, 7, 7]]),     # both members of (6, 7)
    ([[1, 4, 5, 7]], 4, [[0, 4, 5, 7, 1, 4, 5, 7]]),     # tail >= rot unwidened
])
def test_pair_closure_indices_match_jax(idx, rot, want):
    got = pair_closure_indices(torch.tensor(idx, dtype=torch.int32), rot)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jax_pair_closure_indices(jnp.asarray(idx, jnp.int32), rot)))


# --------------------------------------------------------------------------
# the backward's compact emits
# --------------------------------------------------------------------------

@pytest.mark.parametrize("d,k,rot", [(32, 4, 32), (32, 4, 16), (64, 8, 64)])
def test_flash_sfa_bwd_compact_emits_match_jax(d, k, rot):
    """Both compact emits against the JAX kernel's; scattered back (on the
    closure for compact2) they are the dense emit; dV is the same. Ragged
    n; a padding row (idx 0 × k) puts duplicates on both sides."""
    rs = np.random.RandomState(3)
    bh, n = 2, 176
    qv, qi = _codes(rs, (bh, n), d, k)
    kv, ki = _codes(rs, (bh, n), d, k)
    qv[:, 7], qi[:, 7] = 0.0, 0
    ki[:, 11, 1] = ki[:, 11, 0]
    v, g = (rs.randn(bh, n, d).astype(np.float32) for _ in range(2))
    o, lse = (np.asarray(a) for a in jax_flash_sfa(qv, qi, kv, ki, v, d=d,
                                                    return_residuals=True))
    args = _t(qv, qi, kv, ki, v, o, lse, g)
    dense = flash_sfa_bwd(*args, d=d)
    for emit in ("compact", "compact2"):
        got = flash_sfa_bwd(*args, d=d, emit=emit, rot_dim=rot)
        plain = flash_sfa_bwd_ref(*args, d=d, emit=emit, rot_dim=rot)
        want = jax_flash_sfa_bwd(qv, qi, kv, ki, v, o, lse, g, d=d, emit=emit, rot_dim=rot)
        width = k if emit == "compact" else 2 * k
        assert got[0].shape == (bh, n, width) and got[1].shape == (bh, n, width)
        for name, a, p, b in zip(("dq", "dk", "dv"), got, plain, want):
            assert torch.equal(a, p), name
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=TOL,
                                       err_msg=f"{emit} {name}")
        sq, sk = (torch.from_numpy(qi), torch.from_numpy(ki))
        if emit == "compact2":
            sq, sk = pair_closure_indices(sq, rot), pair_closure_indices(sk, rot)
        # a row with a duplicate index gathers the full value once per
        # copy (as JAX does), so it scatters back to a multiple of the
        # dense row: compare the rows with unique indices
        uq = torch.tensor([len(set(r)) == k for r in qi.reshape(-1, k).tolist()])
        uk = torch.tensor([len(set(r)) == k for r in ki.reshape(-1, k).tolist()])
        back_q = scatter_code_grads(got[0], sq, d).reshape(-1, d)
        back_k = scatter_code_grads(got[1], sk, d).reshape(-1, d)
        np.testing.assert_allclose(back_q[uq].numpy(), dense[0].reshape(-1, d)[uq].numpy(),
                                   rtol=0, atol=1e-5)
        np.testing.assert_allclose(back_k[uk].numpy(), dense[1].reshape(-1, d)[uk].numpy(),
                                   rtol=0, atol=1e-5)
        assert torch.equal(got[2], dense[2])


# --------------------------------------------------------------------------
# RoPE's vjp on codes
# --------------------------------------------------------------------------

@pytest.mark.parametrize("rot", [32, 16])        # full and partial rotation
def test_rope_code_vjp_matches_jax_and_rope_autograd(rot):
    rs = np.random.RandomState(4)
    n, h, d, k, theta = 24, 2, 32, 4, 500_000.0
    pos = np.arange(n)[None, :]
    vals, idx = _codes(rs, (1, n, h), d, k)
    idx2 = pair_closure_indices(torch.from_numpy(idx), rot)
    odd = (idx < rot) & (idx % 2 == 1)
    vals2 = np.concatenate([vals * ~odd, vals * odd], -1).astype(np.float32)
    pos3 = torch.from_numpy(pos)[..., None]
    got = rope_code_vjp(torch.from_numpy(vals2), idx2, pos3, theta=theta, rot_dim=rot)
    want = jax_rope_code_vjp(vals2, idx2.numpy(), pos[..., None], theta=theta, rot_dim=rot)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)
    # against autograd of rope fed the scattered post-rope cotangent
    x = torch.from_numpy(rs.randn(1, n, h, d).astype(np.float32)).requires_grad_()
    g_dense = scatter_code_grads(torch.from_numpy(vals), torch.from_numpy(idx), d)
    (dpre,) = torch.autograd.grad(rope(x, torch.from_numpy(pos), theta=theta, rot_dim=rot),
                                  x, g_dense)
    np.testing.assert_allclose(scatter_code_grads(got, idx2, d).numpy(), dpre.numpy(),
                               rtol=0, atol=TOL)


def test_rope_code_vjp_partial_rotation_is_identity_on_tail():
    rot, k = 4, 4
    idx = torch.tensor([[[6, 8, 10, 12]]], dtype=torch.int32)
    vals = torch.randn(1, 1, k)
    vals2 = torch.cat([vals, torch.zeros_like(vals)], -1)
    out = rope_code_vjp(vals2, pair_closure_indices(idx, rot), torch.full((1, 1), 7),
                        theta=1e4, rot_dim=rot)
    assert torch.equal(out, vals2)


# --------------------------------------------------------------------------
# the seam: forced compact2, op level, the RoPE branch at model level
# --------------------------------------------------------------------------

def test_forced_compact2_on_ropefree_seam_matches_jax():
    """bwd_emit="compact2" on RoPE-free reduced gpt2-small-sfa8 runs the
    widened emit (a lossless relayout, no rotation): its loss and every
    parameter gradient equal the "compact" seam's and JAX's compact seam's
    (the reference of tests/test_torch_code_grad.py)."""
    tc, batch, jp, jloss, jgrads = compact_reference(None)
    forced = dataclasses.replace(tc, attention=dataclasses.replace(
        tc.attention, backend="cuda", bwd_emit="compact2"))
    assert attn.compact_train_eligible(forced)
    attn.clear_compact_seam_reports()
    loss2, got2 = torch_grads(tc, jp, batch, backend="cuda", bwd_emit="compact2")
    assert [r.taken for r in attn.compact_seam_reports()] == [True]
    loss1, got1 = torch_grads(tc, jp, batch, backend="cuda", bwd_emit="compact")
    np.testing.assert_allclose(loss2, loss1, rtol=0, atol=1e-6)
    np.testing.assert_allclose(loss2, jloss, rtol=0, atol=TOL)
    assert set(got2) == set(jgrads)
    for name, g in got2.items():
        np.testing.assert_allclose(g.numpy(), got1[name].numpy(), rtol=0, atol=1e-6,
                                   err_msg=name)
        np.testing.assert_allclose(g.numpy(), jgrads[name], rtol=0, atol=TOL, err_msg=name)


def test_op_level_compact2_grads_match_jax():
    rs = np.random.RandomState(6)
    q, k, v = (rs.randn(2, 96, 2, 32).astype(np.float32) for _ in range(3))

    def jloss(q, k, v):
        o = jax_sfa_attention_op(q, k, v, sfa_k=4, impl="pallas", bwd_emit="compact2")
        return jnp.sum(o * o)

    jg = jax.jit(jax.grad(jloss, argnums=(0, 1, 2)))(q, k, v)
    tq, tk, tv = _t(q, k, v, grad=True)
    o = sfa_attention_op(tq, tk, tv, sfa_k=4, bwd_emit="compact2")
    tg = torch.autograd.grad((o * o).sum(), (tq, tk, tv))
    for name, a, b in zip("qkv", tg, jg):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=TOL, err_msg=name)


def test_rope_seam_loss_and_grads_match_jax():
    """The RoPE branch of the seam (compact2 + rope_code_vjp) at model
    level: reduced qwen3-0.6b-sfa8 with qk-norm off (qk-norm is not
    seam-eligible) and 2 kv heads, a test geometry in both packages."""
    jc = jax_get_config("qwen3-0.6b-sfa8").reduced()
    tc = get_config("qwen3-0.6b-sfa8").reduced()
    jc, tc = (dataclasses.replace(c, dtype="float32", loss_chunk=16,
                                  attention=dataclasses.replace(c.attention, qk_norm=False,
                                                                num_kv_heads=2))
              for c in (jc, tc))
    rs = np.random.RandomState(7)
    batch = {"tokens": rs.randint(0, jc.vocab_size, size=(2, 40)).astype(np.int32),
             "labels": rs.randint(0, jc.vocab_size, size=(2, 40)).astype(np.int32)}
    jp, jloss, jgrads = jax_compact_grads(jc, batch)
    attn.clear_compact_seam_reports()
    loss, grads = torch_grads(tc, jp, batch, backend="cuda", bwd_emit="compact")
    assert [r.taken for r in attn.compact_seam_reports()] == [True]
    np.testing.assert_allclose(loss, jloss, rtol=0, atol=TOL)
    for name, g in grads.items():
        np.testing.assert_allclose(g.numpy(), jgrads[name], rtol=0, atol=TOL, err_msg=name)


# --------------------------------------------------------------------------
# eligibility: rope × qk-norm × MLA × window
# --------------------------------------------------------------------------

def _matrix_cfgs(rope_on, qk_norm, mla, window):
    kw = dict(num_heads=2, num_kv_heads=2, head_dim=32, sfa_k=4, rope=rope_on,
              qk_norm=qk_norm, window=window, bwd_emit="compact")
    common = dict(name=f"mx-r{int(rope_on)}q{int(qk_norm)}m{int(mla)}w{int(bool(window))}",
                  family="dense", num_layers=1, d_model=48, d_ff=64, vocab_size=64)
    jmla = JaxMLAConfig(16, 24, 16, 8, 16) if mla else None
    tmla = MLAConfig(16, 24, 16, 8, 16) if mla else None
    return (JaxModelConfig(attention=JaxAttentionConfig(mla=jmla, backend="pallas", **kw),
                           **common),
            ModelConfig(attention=AttentionConfig(mla=tmla, backend="cuda", **kw), **common))


def test_seam_eligibility_matrix_matches_jax():
    """Every (rope, qk-norm, MLA, window) combination gets JAX's reason (or
    None) and routes as the reason says, one report each (an MLA layer
    records its reason and runs its latent path)."""
    attn.clear_compact_seam_reports()
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(1, 64, 48, generator=gen)
    for rope_on, qk_norm, mla, window in itertools.product(
            (False, True), (False, True), (False, True), (None, 16)):
        jcfg, tcfg = _matrix_cfgs(rope_on, qk_norm, mla, window)
        reason = attn.compact_seam_ineligible_reason(tcfg)
        assert reason == jattn.compact_seam_ineligible_reason(jcfg), tcfg.name
        assert (reason is None) == (not qk_norm and not mla and window is None)
        attn.attention_apply(attn.attention_init(gen, tcfg), x, cfg=tcfg, mode="train")
        reports = [r for r in attn.compact_seam_reports()
                   if r.where == f"{tcfg.name}/attention"]
        assert len(reports) == 1 and reports[0].taken == (reason is None), reports
        assert reports[0].reason == reason
    attn.clear_compact_seam_reports()
