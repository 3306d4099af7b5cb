"""The tensor-core FlashSFA bodies at d = dv 80 and 256, emulated on the CPU.

``csrc/flash_sfa_tc_wide.cu`` runs the schedule of ``csrc/attention_tc.cuh``
at two widths its d 32 / 64 / 128 bodies do not take:

* d 80 in tiles of 96 columns (three 64-byte swizzle spans): the densify
  zeroes columns 80-95 of the Q and K tiles, TMA fills those of V and dO
  with zeros, the products that sum over the head (P.V, dQ, dK, dV) run at
  N = 96, and every store writes the 80 real columns;
* d 256 with two warpgroups a block on the same 64 rows: each computes the
  whole S (and dP) itself and owns one 128-column half of every output
  accumulator (O; dQ; dK and dV), the LSE written by the first.

The emulation below does that arithmetic in plain torch, on top of the
d 32 / 64 / 128 emulation of ``test_torch_flash_sfa_tc.py`` (the same
densify, 64-key tiles, online softmax in log2 units, P and dS split into
bf16 hi + lo), and holds it at chip_smoke's bf16 tolerance (2^-7 relative +
1e-4 absolute; the LSE 1e-5 + 1e-4) against the port's plain versions and
the JAX package's Pallas kernels in interpret mode, so the designs hold
that tolerance before the card runs them. Then the routing: which calls
take these bodies, and which layers the ``cuda`` backend declines.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_sfa import flash_sfa as jax_flash_sfa
from repro.kernels.flash_sfa_bwd import flash_sfa_bwd as jax_flash_sfa_bwd
from repro_torch.configs import get_config
from repro_torch.kernels.flash_sfa import TC_DIMS, WIDE_DIMS, tc_library, tensor_core_body
from repro_torch.kernels.ref import (
    _support, flash_sfa_bwd_ref, flash_sfa_ref, gather_support, pair_closure_gather,
)
from repro_torch.models import attention as attn
from repro_torch.models.backends import kernel_shape_reason, resolve_backend_name
from test_torch_flash_sfa_tc import (
    LOG2E, TILE, _bf16, _close, _np, _split_mm, densify, emulate_fwd,
)

BH, N, K = 2, 200, 16        # a ragged n: the last query and key tiles are partial
TILES = {80: (96, 96), 256: (256, 128)}   # d -> (tile width W, columns N a warpgroup owns)


def _pad(x, w):
    """(..., d) -> (..., w), zero columns past d (the tile's padding)."""
    return torch.nn.functional.pad(x, (0, w - x.shape[-1]))


def emulate_fwd_wide(qv, qi, kv, ki, v, *, d, causal, scale):
    """The forward at d 80 / 256: per warpgroup, the d 64-key-tile schedule
    over its own full S with V's N columns from c0 (``emulate_fwd`` on that
    column block: its S over the real columns is the padded tile's S, the
    zero columns adding nothing), O's real columns kept, the LSE the first
    warpgroup's. -> out (bf16), lse, and the padding columns of O."""
    w, n_cols = TILES[d]
    vp = _pad(v.float(), w).bfloat16()
    outs, lses = [], []
    for c0 in range(0, w, n_cols):
        o, lse = emulate_fwd(qv, qi, kv, ki, vp[..., c0:c0 + n_cols], d=d, causal=causal,
                             scale=scale)
        outs.append(o)
        lses.append(lse)
    out = torch.cat(outs, -1)
    for lse in lses[1:]:                     # every warpgroup's S is the same S
        assert torch.equal(lse, lses[0])
    return out[..., :d], lses[0], out[..., d:]


def emulate_bwd_wide(qv, qi, kv, ki, v, o, lse, g, *, d, causal, scale, emit, rot_dim):
    """The backward at d 80 / 256: Q and K densified into W-column tiles (V
    and dO zero-padded as TMA fills them), per 64-key tile S and dP in f32,
    P from the LSE and dS = P (dP - D) scale, then per warpgroup its N
    columns of dV = P^T.dO, dK = dS^T.Q and dQ += dS.K with P and dS split;
    the padding columns must stay zero, the real ones are emitted as the
    d 32 / 64 / 128 bodies emit them."""
    w, n_cols = TILES[d]
    qd, kd = _pad(densify(qv, qi, d), w), _pad(densify(kv, ki, d), w)
    vf, gf = _pad(v.float(), w), _pad(g.float(), w)
    nq, nk = qv.shape[1], kv.shape[1]
    delta = (g.float() * o.float()).sum(-1)
    dq, dk, dv = torch.zeros_like(qd), torch.zeros_like(kd), torch.zeros_like(vf)
    rows = torch.arange(nq)
    for k0 in range(0, nk, TILE):
        keys = torch.arange(k0, min(k0 + TILE, nk))
        kt, vt = kd[:, keys], vf[:, keys]
        s = qd[..., :d] @ kt[..., :d].transpose(1, 2)         # d / 16 k-steps
        p = torch.exp2(s * (scale * LOG2E) - (lse * LOG2E)[..., None])
        if causal:
            p = torch.where(keys[None] <= rows[:, None], p, 0.0)
        ds = p * (gf[..., :d] @ vt[..., :d].transpose(1, 2) - delta[..., None]) * scale
        for c0 in range(0, w, n_cols):
            cols = slice(c0, c0 + n_cols)
            dv[:, keys, cols] = _split_mm(p.transpose(1, 2), gf[..., cols])
            dk[:, keys, cols] = _split_mm(ds.transpose(1, 2), qd[..., cols])
            dq[..., cols] += _split_mm(ds, kt[..., cols])
    for name, t in (("dq", dq), ("dk", dk), ("dv", dv)):
        assert not t[..., d:].any(), f"{name}: a padding column is not zero"
    dq, dk, dv = (t[..., :d].bfloat16().float() for t in (dq, dk, dv))
    if emit == "dense":
        dq, dk = dq * _support(qi, d), dk * _support(ki, d)
    elif emit == "compact":
        dq, dk = gather_support(dq, qi), gather_support(dk, ki)
    else:
        dq, dk = pair_closure_gather(dq, qi, rot_dim), pair_closure_gather(dk, ki, rot_dim)
    return dq.bfloat16(), dk.bfloat16(), dv.bfloat16()


def _inputs(d, seed):
    """bh 2 x n 200, k 16 bf16 codes at distinct indices (row 3 all padding:
    index 0, value 0) and v, dO of width d: numpy (for JAX) and torch."""
    rs = np.random.RandomState(seed)
    sides = []
    for _ in range(2):
        vals = _bf16(rs.randn(BH, N, K))
        idx = np.sort(np.argsort(rs.rand(BH, N, d), axis=-1)[..., :K], axis=-1).astype(np.int32)
        vals[:, 3], idx[:, 3] = 0, 0
        sides += [vals, idx]
    arrays = [*sides, _bf16(rs.randn(BH, N, d)), _bf16(rs.randn(BH, N, d))]
    tensors = [torch.from_numpy(a) if a.dtype == np.int32 else _np(a).bfloat16()
               for a in arrays]
    return arrays, tensors


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", [80, 256])
def test_wide_forward_emulation_holds_the_bf16_tolerance(d, causal):
    arrays, (qv, qi, kv, ki, v, _) = _inputs(d, seed=d)
    scale = d ** -0.5
    eo, el, pad = emulate_fwd_wide(qv, qi, kv, ki, v, d=d, causal=causal, scale=scale)
    assert not pad.any()                     # the zero columns of V give zero columns of O
    po, pl = flash_sfa_ref(qv, qi, kv, ki, v, d=d, causal=causal, scale=scale,
                           return_residuals=True)
    jo, jl = jax_flash_sfa(*(jnp.asarray(a) for a in arrays[:5]), d=d, causal=causal,
                           scale=scale, interpret=True, return_residuals=True)
    for name, want, want_lse in (("plain", po, pl), ("jax", _np(jo), _np(jl))):
        _close(eo, want, f"d {d} forward vs {name}")
        torch.testing.assert_close(el, want_lse, rtol=1e-5, atol=1e-4, msg=f"lse vs {name}")


@pytest.mark.parametrize("causal,emits", [(True, ("dense", "compact", "compact2")),
                                          (False, ("dense",))])
@pytest.mark.parametrize("d", [80, 256])
def test_wide_backward_emulation_holds_the_bf16_tolerance(d, causal, emits):
    arrays, (qv, qi, kv, ki, v, g) = _inputs(d, seed=d + 1)
    scale, rot = d ** -0.5, d // 2           # compact2: half the dims rotated
    po, pl = flash_sfa_ref(qv, qi, kv, ki, v, d=d, causal=causal, scale=scale,
                           return_residuals=True)
    jargs = [jnp.asarray(a) for a in arrays[:5]] + [
        jnp.asarray(_bf16(po.float().numpy())), jnp.asarray(pl.numpy()), jnp.asarray(arrays[5])]
    got = {}
    for emit in emits:
        got[emit] = emulate_bwd_wide(qv, qi, kv, ki, v, po, pl, g, d=d, causal=causal,
                                     scale=scale, emit=emit, rot_dim=rot)
        plain = flash_sfa_bwd_ref(qv, qi, kv, ki, v, po, pl, g, d=d, causal=causal,
                                  scale=scale, emit=emit, rot_dim=rot)
        jax_grads = jax_flash_sfa_bwd(*jargs, d=d, causal=causal, scale=scale,
                                      interpret=True, emit=emit, rot_dim=rot)
        for name, a, b, c in zip(("dq", "dk", "dv"), got[emit], plain, jax_grads):
            _close(a, b, f"d {d} {emit} {name} vs plain")
            _close(a, _np(c), f"d {d} {emit} {name} vs jax")
    if "compact" in got:
        # the compact emit is the dense emit gathered, bit for bit
        for a, b, idx in ((got["compact"][0], got["dense"][0], qi),
                          (got["compact"][1], got["dense"][1], ki)):
            assert torch.equal(a, b.gather(-1, idx.long()))


def test_wide_widths_take_the_tensor_core_bodies_in_bf16_only():
    assert TC_DIMS == (32, 64, 80, 128, 256) and WIDE_DIMS == (80, 256)
    for d in (80, 256):
        assert tensor_core_body(torch.bfloat16, d, d, 16, 16)
        assert tensor_core_body(torch.bfloat16, d, d, 32, 32)
        assert tc_library(d) == "flash_sfa_tc_wide"
        assert not tensor_core_body(torch.float32, d, d, 16, 16)       # exact CUDA-core f32
        assert not tensor_core_body(torch.bfloat16, d, d, 33, 16)
    assert not tensor_core_body(torch.bfloat16, 256, 80, 16, 16)       # d != dv
    for d in (32, 64, 128):
        assert tensor_core_body(torch.bfloat16, d, d, 8, 8)
        assert tc_library(d) == "flash_sfa_tc"


@pytest.mark.parametrize("backward", [True, False])
def test_kernel_shape_reason_passes_a_bf16_dv256_training_layer(backward):
    """paligemma's d = dv 256 trains on the kernels in bf16 (the tensor-core
    body) and in f32 (the CUDA-core body's 32-row tiles): the request no
    longer says a dtype, since no shape the backward takes depends on it;
    hubert's d 80 the same."""
    for name in ("paligemma-3b", "hubert-xlarge"):
        a = get_config(name).attention
        req = attn._request(a, mode="full", window=None, backward=backward)
        assert kernel_shape_reason(req) is None and resolve_backend_name("auto", req) == "cuda"
    assert get_config("paligemma-3b").attention.head_dim == 256

