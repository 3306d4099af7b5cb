"""The fused forward of the compact seam against the JAX package.

``proj_rtopk`` (its plain version, which the wrapper runs on CPU tensors)
against the JAX kernel in interpret mode, with and without RoPE, and its
canonical padded rows; ``fused_qk_codes`` with GQA; the block-skip
schedule: ``_block_maps`` against JAX's at equal (64) tile sizes,
``block_skip_stats``, occupancy that ignores value-zero entries, and the
skip forward on banded codes (most tile pairs take the closed form) against
the plain forward and JAX's skip kernel; and the seam's fused forward
against its unfused one, outputs and gradients, with the fused flag in its
report. Tolerance 1e-4 in f32 (1e-5 on code values); integer codes exact.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels.flash_sfa import _block_maps as jax_block_maps
from repro.kernels.flash_sfa import _pad_codes as jax_pad_codes
from repro.kernels.flash_sfa import block_skip_stats as jax_block_skip_stats
from repro.kernels.flash_sfa import flash_sfa as jax_flash_sfa
from repro.kernels.rtopk import proj_rtopk as jax_proj_rtopk
from repro.models import attention as jattn
from repro_torch.configs.base import AttentionConfig, ModelConfig
from repro_torch.kernels import block_skip_stats, flash_sfa, fused_qk_codes, proj_rtopk
from repro_torch.kernels.flash_sfa import _block_maps, _pad_rows
from repro_torch.kernels.ops import repeat_heads
from repro_torch.kernels.ref import flash_sfa_ref
from repro_torch.models import attention as attn

TOL = 1e-4


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


# --------------------------------------------------------------------------
# proj_rtopk and fused_qk_codes
# --------------------------------------------------------------------------

@pytest.mark.parametrize("n,rope_on", [(128, False), (200, False), (200, True), (64, True)])
def test_proj_rtopk_matches_jax(n, rope_on):
    rs = np.random.RandomState(0)
    b, m, nh, d, k = 2, 48, 3, 64, 8
    x = rs.randn(b, n, m).astype(np.float32)
    w = (0.1 * rs.randn(nh, m, d)).astype(np.float32)
    pos = np.broadcast_to(np.arange(n), (b, n)).astype(np.int32)
    spec = (10_000.0, d) if rope_on else None
    vals, idx = proj_rtopk(*_t(x, w), torch.from_numpy(pos) if rope_on else None, k=k,
                           rope_spec=spec)
    jv, ji = jax_proj_rtopk(x, w, pos if rope_on else None, k=k, rope_spec=spec)
    assert vals.shape == idx.shape == (b, nh, n, k) and idx.dtype == torch.int32
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ji))
    np.testing.assert_allclose(vals.numpy(), np.asarray(jv), rtol=0, atol=1e-5)


def test_proj_rtopk_emits_canonical_padded_rows():
    """An all-zero projection row selects indices 0..k-1 with value 0: the
    padding pattern that densifies to zeros."""
    x = torch.zeros(1, 64, 16)
    w = torch.randn(1, 16, 32)
    vals, idx = proj_rtopk(x, w, k=8)
    assert torch.equal(vals, torch.zeros_like(vals))
    assert torch.equal(idx, torch.arange(8, dtype=torch.int32).expand(1, 1, 64, 8))


def test_fused_qk_codes_match_jax_and_repeat_gqa():
    rs = np.random.RandomState(1)
    b, n, m, h, hkv, hd, k = 2, 96, 48, 4, 2, 64, 8
    w = (0.1 * rs.randn(m, (h + 2 * hkv) * hd)).astype(np.float32)
    x = rs.randn(b, n, m).astype(np.float32)
    pos = np.broadcast_to(np.arange(n), (b, n)).astype(np.int32)
    spec = (10_000.0, hd)
    qv, qi, kv, ki = fused_qk_codes(*_t(x, w), torch.from_numpy(pos), h=h, hkv=hkv, hd=hd,
                                    sfa_k=k, rope_spec=spec)
    assert kv.shape == (b * hkv, n, k)             # keys stay at hkv heads
    kv, ki = repeat_heads(kv, b, h), repeat_heads(ki, b, h)
    ki4 = ki.reshape(b, hkv, h // hkv, n, k)
    assert torch.equal(ki4[:, :, 0], ki4[:, :, 1])
    want = jops.fused_qk_codes(x, w, pos, h=h, hkv=hkv, hd=hd, sfa_k=k, rope_spec=spec)
    for name, a, bb in zip(("qv", "qi", "kv", "ki"), (qv, qi, kv, ki), want):
        np.testing.assert_allclose(a.numpy(), np.asarray(bb), rtol=0, atol=1e-5, err_msg=name)


# --------------------------------------------------------------------------
# the block-skip schedule
# --------------------------------------------------------------------------

def banded_codes(rs, bh, n, k, block=64, bands=8):
    """Codes whose row i stores the k features of band (i // block) % bands:
    tiles of different bands share no feature, so most tile pairs of a
    causal grid are zero-overlap (level 1)."""
    band = (np.arange(n) // block) % bands
    idx = (band[:, None] * k + np.arange(k)[None, :]).astype(np.int32)
    idx = np.broadcast_to(idx, (bh, n, k)).copy()
    vals = rs.randn(bh, n, k).astype(np.float32)
    vals[np.abs(vals) < 1e-3] = 1.0
    return vals, idx


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("nq,nk", [(256, 256), (200, 160)])
def test_block_maps_match_jax(causal, nq, nk):
    rs = np.random.RandomState(2)
    bh, d, k = 2, 64, 8
    qv, qi = banded_codes(rs, bh, nq, k)
    kv, ki = banded_codes(rs, bh, nk, k)
    kv[:, :40] = rs.randn(bh, 40, k)               # a mixed tile: random values
    ki[:, :40] = np.sort(rs.permutation(d)[:k])
    jq = jax_pad_codes(qv, qi, kv, ki, None, 64, 64)
    jlevel, _ = jax_block_maps(*jq[:4], d=d, causal=causal, block_q=64, block_k=64,
                               nq_real=nq, nk_real=nk)
    tq = [_pad_rows(t, 64) for t in _t(qv, qi, kv, ki)]
    level = _block_maps(*tq, d=d, causal=causal, block_q=64, block_k=64, nq_real=nq,
                        nk_real=nk)
    assert level.dtype == torch.int32
    np.testing.assert_array_equal(level.numpy(), np.asarray(jlevel))
    stats = block_skip_stats(*_t(qv, qi, kv, ki), d=d, causal=causal)
    jstats = jax_block_skip_stats(qv, qi, kv, ki, d=d, causal=causal, block_q=64, block_k=64)
    np.testing.assert_allclose(stats, [float(s) for s in jstats], rtol=0, atol=1e-7)
    assert stats[1] > 0


def test_block_skip_occupancy_ignores_value_zero_entries():
    """Value-zero entries add nothing to any score, so they must not mark
    a feature occupied (padded rows, idx 0 × k with val 0, would pin
    feature 0): here they sit on a key feature and the grid stays level 1."""
    rs = np.random.RandomState(3)
    qv, qi = banded_codes(rs, 1, 128, 8)           # q on features 0..15
    kv, ki = banded_codes(rs, 1, 128, 8)
    ki = ki + 32                                   # keys on features 32..47
    qv[:, 10:20], qi[:, 10:20] = 0.0, 32
    _, s1, _ = block_skip_stats(*_t(qv, qi, kv, ki), d=64, causal=False)
    assert s1 == 1.0


@pytest.mark.parametrize("causal", [True, False])
def test_block_skip_forward_on_banded_codes_matches_plain_and_jax(causal):
    """The skip forward's function is the plain forward's; JAX's skip kernel
    (its closed form at the same 64-row tiles) agrees on banded codes."""
    rs = np.random.RandomState(4)
    bh, n, d, k = 2, 320, 64, 8
    qv, qi = banded_codes(rs, bh, n, k)
    kv, ki = banded_codes(rs, bh, n, k)
    v = rs.randn(bh, n, d).astype(np.float32)
    out, lse = flash_sfa(*_t(qv, qi, kv, ki, v), d=d, causal=causal, block_skip=True,
                         return_residuals=True)
    po, pl = flash_sfa_ref(*_t(qv, qi, kv, ki, v), d=d, causal=causal, return_residuals=True)
    assert torch.equal(out, po) and torch.equal(lse, pl)
    jo, jl = jax_flash_sfa(qv, qi, kv, ki, v, d=d, causal=causal, block_q=64, block_k=64,
                           block_skip=True, return_residuals=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(jo), rtol=0, atol=TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jl), rtol=0, atol=TOL)


# --------------------------------------------------------------------------
# the seam: fused forward == unfused forward, gradients included
# --------------------------------------------------------------------------

def _seam(w, x, pos, h, hkv, hd, k, fuse, rope_spec, causal=True):
    return attn.sfa_proj_attend_compact(w, x, pos, h=h, hkv=hkv, hd=hd, sfa_k=k,
                                        causal=causal, scale=hd ** -0.5,
                                        rope_spec=rope_spec, req_emit="compact2",
                                        fwd_fuse=fuse)


@pytest.mark.parametrize("hkv,rope_on", [(4, True), (2, False)])
def test_seam_fused_forward_and_gradients_match_unfused(hkv, rope_on):
    rs = np.random.RandomState(5)
    b, n, m, h, hd, k = 2, 120, 48, 4, 64, 8
    w0 = torch.from_numpy((0.05 * rs.randn(m, (h + 2 * hkv) * hd)).astype(np.float32))
    x0 = torch.from_numpy(rs.randn(b, n, m).astype(np.float32))
    pos = torch.arange(n)[None, :]
    spec = (10_000.0, hd) if rope_on else None
    wgt = torch.sin(torch.arange(b * n * h * hd, dtype=torch.float32)).reshape(b, n, h, hd)
    outs = []
    for fuse in (False, True):
        w, x = w0.clone().requires_grad_(), x0.clone().requires_grad_()
        o = _seam(w, x, pos, h, hkv, hd, k, fuse, spec)
        outs.append((o.detach(), *torch.autograd.grad((o * wgt).sum(), (w, x))))
    for a, bb in zip(*outs):
        np.testing.assert_allclose(a.numpy(), bb.numpy(), rtol=0, atol=TOL)
    # the fused forward against JAX's fused seam primal
    jo, _ = jattn._sfa_proj_attend_fwd_impl(w0.numpy(), x0.numpy(), jnp.asarray(pos), h, hkv,
                                            hd, k, True, hd ** -0.5, spec, True)
    np.testing.assert_allclose(outs[1][0].numpy(), np.asarray(jo), rtol=0, atol=TOL)


def test_seam_report_records_fused_fwd():
    attn.clear_compact_seam_reports()
    gen = torch.Generator().manual_seed(0)
    for fuse in (True, False):
        a = AttentionConfig(num_heads=2, num_kv_heads=2, head_dim=32, sfa_k=4, rope=True,
                            backend="cuda", bwd_emit="compact", fwd_fuse=fuse)
        cfg = ModelConfig(name=f"fused-fwd-{fuse}", family="dense", num_layers=1,
                          d_model=48, d_ff=64, vocab_size=64, attention=a)
        attn.attention_apply(attn.attention_init(gen, cfg), torch.randn(1, 64, 48),
                             cfg=cfg, mode="train")
    assert {r.fused_fwd for r in attn.compact_seam_reports() if r.taken} == {True, False}
    attn.clear_compact_seam_reports()
