"""The tensor-core FlashSFA bodies' arithmetic, emulated on the CPU.

The bf16 bodies of ``csrc/flash_sfa_tc.cu`` (the schedule of
``csrc/attention_tc.cuh``) densify each code tile into shared memory: the
thread that owns a row stores each code's value at its column, a repeated
index the f32 sum of its codes, rounded once to bf16 (the value the TPU's
iota-compare densify gives). From there every product is the dense
tensor-core attention's: 64-key tiles, online softmax in f32 (log2 units),
P and dS split into bf16 hi + lo whose products accumulate in f32; the
block-skip map's level 1 applies the closed form from the tile's V row sum;
dQ and dK are emitted from the dense f32 accumulator (masked to the support,
or gathered at the stored indices). The emulation below does the same
arithmetic in plain torch and is held, at chip_smoke's bf16 tolerance (2^-7
relative + 1e-4 absolute; the LSE 1e-5 + 1e-4), against the port's plain
versions and the JAX package's Pallas kernels in interpret mode, so the
design holds that tolerance before the card runs it.
"""
import math

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.kernels.flash_sfa import flash_sfa as jax_flash_sfa
from repro.kernels.flash_sfa_bwd import flash_sfa_bwd as jax_flash_sfa_bwd
from repro_torch.kernels.flash_sfa import BLOCK, _pad_rows, _skip_schedule, tensor_core_body
from repro_torch.kernels.ref import (
    _support, flash_sfa_bwd_ref, flash_sfa_ref, gather_support, pair_closure_gather,
)

TILE = 64                    # rows of a warpgroup, keys per tile
RTOL, ATOL = 2 ** -7, 1e-4   # chip_smoke's bf16 tolerance
LOG2E = 1 / math.log(2)
BH, D, K = 4, 64, 8


def _split_mm(x, b):
    """x . b with x split into bf16 hi + lo, two products into one f32 sum."""
    hi = x.bfloat16().float()
    return hi @ b + (x - hi).bfloat16().float() @ b


def densify(vals, idx, d):
    """The kernels' densify: column c of a row holds the f32 sum of the
    values whose index is c (one value where indices are distinct), rounded
    once to bf16. An index outside [0, d) lands in no column."""
    cols = torch.arange(d)
    hits = idx.long()[..., :, None] == cols                        # (..., k, d)
    return (hits * vals.float()[..., :, None]).sum(-2).bfloat16().float()


def _visible(t, r0, nk, causal):
    """Does key tile t hold a key that some row of [r0, r0 + 64) sees?"""
    return t * TILE < (min(nk, r0 + TILE) if causal else nk)


def emulate_fwd(qv, qi, kv, ki, v, *, d, causal, scale, level=None):
    """The forward body: per 64-row query tile (one warpgroup), key tiles
    at their level (2 compute, 1 the closed form off V's tile row sums, 0
    skip; every visible tile computes without a map), P.V with P split.
    -> out (bf16), lse (f32)."""
    qd, kd, vf = densify(qv, qi, d), densify(kv, ki, d), v.float()
    bh, nq, _ = qv.shape
    nk, dv = v.shape[1], v.shape[2]
    vsum = _pad_rows(v, BLOCK).float().reshape(bh, -1, BLOCK, dv).sum(2)
    out = torch.zeros(bh, nq, dv)
    lse = torch.zeros(bh, nq)
    for b in range(bh):
        for r0 in range(0, nq, TILE):
            rows = torch.arange(r0, min(r0 + TILE, nq))
            m = torch.full((len(rows),), -math.inf)
            l = torch.zeros(len(rows))
            o = torch.zeros(len(rows), dv)
            for t in range((nk + TILE - 1) // TILE):
                lvl = 0 if not _visible(t, r0, nk, causal) else (
                    2 if level is None else int(level[b, r0 // TILE, t]))
                if lvl == 1:
                    m_new = torch.clamp(m, min=0.0)
                    corr, e = torch.exp2(m - m_new), torch.exp2(-m_new)
                    o = o * corr[:, None] + e[:, None] * vsum[b, t]
                    l = l * corr + TILE * e
                    m = m_new
                if lvl != 2:
                    continue
                keys = torch.arange(t * TILE, min(t * TILE + TILE, nk))
                x = (qd[b, rows] @ kd[b, keys].T) * (scale * LOG2E)
                if causal:
                    x = torch.where(keys[None] <= rows[:, None], x, -math.inf)
                m_new = torch.maximum(m, x.amax(-1))
                base = torch.where(m_new == -math.inf, 0.0, m_new)
                corr = torch.exp2(m - base)
                p = torch.exp2(x - base[:, None])
                l = l * corr + p.sum(-1)
                o = o * corr[:, None] + _split_mm(p, vf[b, keys])
                m = m_new
            l = torch.clamp(l, min=1e-30)
            out[b, rows] = o / l[:, None]
            lse[b, rows] = (m + torch.log2(l)) * math.log(2)
    return out.bfloat16(), lse


def emulate_bwd(qv, qi, kv, ki, v, o, lse, g, *, d, causal, scale, emit="dense",
                rot_dim=None):
    """The backward bodies: P from the LSE, dS = P (dP - D) scale in f32, dV,
    dK and dQ over 64-key tiles with P and dS split; dQ and dK emitted from
    the f32 accumulators rounded to bf16 (dense: masked to the support;
    compact, compact2: the rounded values gathered at the stored indices)."""
    qd, kd, vf, gf = densify(qv, qi, d), densify(kv, ki, d), v.float(), g.float()
    nq, nk = qv.shape[1], kv.shape[1]
    delta = (gf * o.float()).sum(-1)
    dq, dk, dv = torch.zeros_like(qd), torch.zeros_like(kd), torch.zeros_like(vf)
    rows = torch.arange(nq)
    for k0 in range(0, nk, TILE):
        keys = torch.arange(k0, min(k0 + TILE, nk))
        kt, vt = kd[:, keys], vf[:, keys]
        s = qd @ kt.transpose(1, 2)
        p = torch.exp2(s * (scale * LOG2E) - (lse * LOG2E)[..., None])
        if causal:
            p = torch.where(keys[None] <= rows[:, None], p, 0.0)
        ds = p * (gf @ vt.transpose(1, 2) - delta[..., None]) * scale
        dv[:, keys] = _split_mm(p.transpose(1, 2), gf)
        dk[:, keys] = _split_mm(ds.transpose(1, 2), qd)
        dq += _split_mm(ds, kt)
    dq, dk = dq.bfloat16().float(), dk.bfloat16().float()
    if emit == "dense":
        dq, dk = dq * _support(qi, d), dk * _support(ki, d)
    elif emit == "compact":
        dq, dk = gather_support(dq, qi), gather_support(dk, ki)
    else:
        rot = d if rot_dim is None else rot_dim
        dq, dk = pair_closure_gather(dq, qi, rot), pair_closure_gather(dk, ki, rot)
    return dq.bfloat16(), dk.bfloat16(), dv.bfloat16()


def _close(got, want, what):
    torch.testing.assert_close(got.float(), want.float(), rtol=RTOL, atol=ATOL, msg=what)


def _bf16(x):
    return np.asarray(x, dtype=np.float32).astype(ml_dtypes.bfloat16)


def _np(x):
    return torch.from_numpy(np.asarray(x).astype(np.float32))


def _inputs(n, *, banded=False, seed=16):
    """bh 4 x n, d = dv 64, k 8 bf16 codes (distinct indices; one padding
    row of zero values at index 0) and v, dO: numpy (for JAX) and torch.
    ``banded``: row i stores the 8 features of band (i // 64) % 8, so tiles
    of different bands do not overlap (chip_smoke's planted input)."""
    rs = np.random.RandomState(seed)
    sides = []
    for _ in range(2):
        vals = _bf16(rs.randn(BH, n, K))
        if banded:
            band = (np.arange(n) // BLOCK) % (D // K)
            idx = np.broadcast_to(band[:, None] * K + np.arange(K), (BH, n, K))
        else:
            idx = np.sort(np.argsort(rs.rand(BH, n, D), axis=-1)[..., :K], axis=-1)
        idx = np.ascontiguousarray(idx, dtype=np.int32)
        vals[:, 3], idx[:, 3] = 0, 0
        sides += [vals, idx]
    v, g = _bf16(rs.randn(BH, n, D)), _bf16(rs.randn(BH, n, D))
    arrays = [*sides, v, g]
    tensors = [torch.from_numpy(a) if a.dtype == np.int32 else _np(a).bfloat16()
               for a in arrays]
    return arrays, tensors


def test_the_main_path_shape_takes_the_tensor_core_body():
    assert tensor_core_body(torch.bfloat16, 64, 64, 8, 8)
    assert tensor_core_body(torch.bfloat16, 32, 32, 32, 32)
    assert not tensor_core_body(torch.float32, 64, 64, 8, 8)       # exact CUDA-core f32
    assert not tensor_core_body(torch.bfloat16, 64, 128, 8, 8)     # d != dv
    assert tensor_core_body(torch.bfloat16, 256, 256, 8, 8)        # two warpgroups a block
    assert not tensor_core_body(torch.bfloat16, 64, 64, 33, 8)


def test_densify_sums_duplicates_once_and_drops_indices_outside():
    vals = torch.tensor([[1.0, 2.0 ** -8, 0.5, 3.0]]).bfloat16()
    idx = torch.tensor([[5, 5, 70, -1]], dtype=torch.int32)
    got = densify(vals, idx, 64)
    want = torch.zeros(1, 64)
    want[0, 5] = torch.tensor(1.0 + 2.0 ** -8).bfloat16().float()  # one rounding
    assert torch.equal(got, want)


@pytest.mark.parametrize("n", [256, 200])
@pytest.mark.parametrize("causal", [True, False])
def test_forward_emulation_holds_the_bf16_tolerance(n, causal):
    arrays, (qv, qi, kv, ki, v, _) = _inputs(n)
    scale = D ** -0.5
    eo, el = emulate_fwd(qv, qi, kv, ki, v, d=D, causal=causal, scale=scale)
    po, pl = flash_sfa_ref(qv, qi, kv, ki, v, d=D, causal=causal, scale=scale,
                           return_residuals=True)
    wants = [("plain", po, pl)]
    for skip in (False, True):
        jo, jl = jax_flash_sfa(*(jnp.asarray(a) for a in arrays[:5]), d=D, causal=causal,
                               scale=scale, interpret=True, return_residuals=True,
                               block_skip=skip)
        wants.append((f"jax block_skip={skip}", _np(jo), _np(jl)))
    for name, want, want_lse in wants:
        _close(eo, want, f"forward vs {name}")
        torch.testing.assert_close(el, want_lse, rtol=1e-5, atol=1e-4, msg=f"lse vs {name}")
    # the block-skip schedule on the same codes: the level map changes no output
    level = _skip_schedule(qv, qi, kv, ki, d=D, causal=causal, block_q=BLOCK, block_k=BLOCK)
    so, sl = emulate_fwd(qv, qi, kv, ki, v, d=D, causal=causal, scale=scale, level=level)
    _close(so, po, "block-skip forward vs plain")
    torch.testing.assert_close(sl, pl, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("causal", [True, False])
def test_block_skip_closed_form_holds_the_bf16_tolerance(causal):
    # banded codes: the off-band tiles that every row sees take level 1
    arrays, (qv, qi, kv, ki, v, _) = _inputs(256, banded=True)
    scale = D ** -0.5
    level = _skip_schedule(qv, qi, kv, ki, d=D, causal=causal, block_q=BLOCK, block_k=BLOCK)
    assert int((level == 1).sum()) >= (3 if causal else 6) * BH
    eo, el = emulate_fwd(qv, qi, kv, ki, v, d=D, causal=causal, scale=scale, level=level)
    po, pl = flash_sfa_ref(qv, qi, kv, ki, v, d=D, causal=causal, scale=scale,
                           return_residuals=True)
    jo, jl = jax_flash_sfa(*(jnp.asarray(a) for a in arrays[:5]), d=D, causal=causal,
                           scale=scale, interpret=True, return_residuals=True,
                           block_skip=True)
    for name, want, want_lse in (("plain", po, pl), ("jax", _np(jo), _np(jl))):
        _close(eo, want, f"closed-form forward vs {name}")
        torch.testing.assert_close(el, want_lse, rtol=1e-5, atol=1e-4, msg=f"lse vs {name}")


@pytest.mark.parametrize("n", [256, 200])
@pytest.mark.parametrize("causal", [True, False])
def test_backward_emulation_holds_the_bf16_tolerance_for_every_emit(n, causal):
    arrays, (qv, qi, kv, ki, v, g) = _inputs(n, seed=17)
    scale = D ** -0.5
    # every backward on the same O and LSE (the plain forward's), as chip_smoke does
    po, pl = flash_sfa_ref(qv, qi, kv, ki, v, d=D, causal=causal, scale=scale,
                           return_residuals=True)
    jargs = [jnp.asarray(a) for a in arrays[:5]] + [
        jnp.asarray(_bf16(po.float().numpy())), jnp.asarray(pl.numpy()), jnp.asarray(arrays[5])]
    dense = None
    for emit, rot in (("dense", D), ("compact", D), ("compact2", D), ("compact2", D // 2)):
        got = emulate_bwd(qv, qi, kv, ki, v, po, pl, g, d=D, causal=causal, scale=scale,
                          emit=emit, rot_dim=rot)
        plain = flash_sfa_bwd_ref(qv, qi, kv, ki, v, po, pl, g, d=D, causal=causal,
                                  scale=scale, emit=emit, rot_dim=rot)
        jax_grads = jax_flash_sfa_bwd(*jargs, d=D, causal=causal, scale=scale,
                                      interpret=True, emit=emit, rot_dim=rot)
        for name, a, b, c in zip(("dq", "dk", "dv"), got, plain, jax_grads):
            _close(a, b, f"{emit}/{rot} {name} vs plain")
            _close(a, _np(c), f"{emit}/{rot} {name} vs jax")
        if emit == "dense":
            dense = got
        elif emit == "compact":
            # the compact emit is the dense emit gathered, bit for bit
            for a, b, idx in ((got[0], dense[0], qi), (got[1], dense[1], ki)):
                assert torch.equal(a, b.gather(-1, idx.long()))
