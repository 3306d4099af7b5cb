"""The tensor-core dense attention's arithmetic, emulated on the CPU.

The bf16 bodies of ``csrc/flash_attention.cu`` run every product on the
tensor cores: Q, K, V and dO enter as bf16 (exact), the f32 values P and dS
enter split into two bf16 parts (hi = bf16(x), lo = bf16(x - hi)) whose
products accumulate into the same f32 registers, over 64-key tiles with the
online softmax rescaling in f32. The emulation below does the same
arithmetic in plain torch and is held, at chip_smoke's bf16 tolerance
(2^-7 relative + 1e-4 absolute; the LSE 1e-5 + 1e-4), against the port's
plain versions and against the JAX package's Pallas kernels in interpret
mode: the precision design holds that tolerance before the card runs it.

Also here: the build key of ``kernels/_build.py`` covers the shared
headers ``csrc/*.cuh``, so an edited header builds anew.
"""
import math

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.kernels import flash_attention as jax_flash_attention
from repro.kernels import flash_attention_bwd as jax_flash_attention_bwd
from repro_torch.kernels import _build
from repro_torch.kernels.ref import flash_attention_bwd_ref, flash_attention_ref

TILE = 64                    # keys per tile, as the kernels walk them
RTOL, ATOL = 2 ** -7, 1e-4   # chip_smoke's bf16 tolerance
LOG2E = 1 / math.log(2)


def _split(x):
    """f32 -> (hi, lo), both bf16 values held in f32."""
    hi = x.bfloat16().float()
    return hi, (x - hi).bfloat16().float()


def _mm_split(x, b):
    """x . b with x split hi + lo, two products into one f32 sum."""
    hi, lo = _split(x)
    return hi @ b + lo @ b


def _mm_once(x, b):
    """x . b with x rounded once to bf16 (the usual FlashAttention habit)."""
    return x.bfloat16().float() @ b


def _mask(nq, k0, kt, causal):
    cols = k0 + torch.arange(kt)[None, :]
    return cols <= torch.arange(nq)[:, None] if causal else torch.ones(nq, kt, dtype=torch.bool)


def emulate_fwd(q, k, v, *, causal, scale, mm=_mm_split):
    """The forward body's arithmetic: online softmax in log2 units over
    64-key tiles, P.V with P split (``mm``). -> out (bf16), lse (f32)."""
    qf, kf, vf = q.float(), k.float(), v.float()
    bh, nq, d = q.shape
    m = torch.full((bh, nq), -math.inf)
    l = torch.zeros(bh, nq)
    o = torch.zeros(bh, nq, d)
    for k0 in range(0, k.shape[1], TILE):
        kt, vt = kf[:, k0:k0 + TILE], vf[:, k0:k0 + TILE]
        x = (qf @ kt.transpose(1, 2)) * (scale * LOG2E)
        x = torch.where(_mask(nq, k0, kt.shape[1], causal), x, -math.inf)
        m_new = torch.maximum(m, x.amax(-1))
        base = torch.where(m_new == -math.inf, 0.0, m_new)
        corr = torch.exp2(m - base)
        p = torch.exp2(x - base[..., None])
        l = l * corr + p.sum(-1)
        o = o * corr[..., None] + mm(p, vt)
        m = m_new
    return (o / l[..., None]).bfloat16(), (m + torch.log2(l)) * math.log(2)


def emulate_bwd(q, k, v, o, lse, g, *, causal, scale, mm=_mm_split):
    """The backward bodies' arithmetic: P from the LSE, dS = P (dP - D)
    scale in f32, and dV, dK, dQ with P and dS split (``mm``). -> bf16 dq,
    dk, dv."""
    qf, kf, vf, gf = q.float(), k.float(), v.float(), g.float()
    nq = q.shape[1]
    delta = (gf * o.float()).sum(-1)
    dq, dk, dv = torch.zeros_like(qf), torch.zeros_like(kf), torch.zeros_like(vf)
    for k0 in range(0, k.shape[1], TILE):
        kt, vt = kf[:, k0:k0 + TILE], vf[:, k0:k0 + TILE]
        s = qf @ kt.transpose(1, 2)
        p = torch.exp2(s * (scale * LOG2E) - (lse * LOG2E)[..., None])
        p = torch.where(_mask(nq, k0, kt.shape[1], causal), p, 0.0)
        ds = p * (gf @ vt.transpose(1, 2) - delta[..., None]) * scale
        dv[:, k0:k0 + TILE] = mm(p.transpose(1, 2), gf)
        dk[:, k0:k0 + TILE] = mm(ds.transpose(1, 2), qf)
        dq += mm(ds, kt)
    return dq.bfloat16(), dk.bfloat16(), dv.bfloat16()


def _close(got, want, what):
    torch.testing.assert_close(got.float(), want.float(), rtol=RTOL, atol=ATOL, msg=what)


def _bf16(x):
    return np.asarray(x, dtype=np.float32).astype(ml_dtypes.bfloat16)


def _inputs():
    """bh 4 x n 256 x d 64 bf16 q, k, v, dO: numpy (for JAX) and torch."""
    rs = np.random.RandomState(15)
    arrays = [_bf16(rs.randn(4, 256, 64)) for _ in range(4)]
    return arrays, [torch.from_numpy(a.astype(np.float32)).bfloat16() for a in arrays]


@pytest.mark.parametrize("causal", [True, False])
def test_split_emulation_holds_the_bf16_tolerance(causal):
    arrays, (q, k, v, g) = _inputs()
    scale = 64 ** -0.5

    eo, el = emulate_fwd(q, k, v, causal=causal, scale=scale)
    po, pl = flash_attention_ref(q, k, v, causal=causal, scale=scale, return_residuals=True)
    jo, jl = jax_flash_attention(*(jnp.asarray(a) for a in arrays[:3]), causal=causal,
                                 scale=scale, interpret=True, return_residuals=True)
    jo = torch.from_numpy(np.asarray(jo).astype(np.float32))
    jl = torch.from_numpy(np.array(jl))
    for name, want, want_lse in (("plain", po, pl), ("jax", jo, jl)):
        _close(eo, want, f"forward vs {name}")
        torch.testing.assert_close(el, want_lse, rtol=1e-5, atol=1e-4, msg=f"lse vs {name}")

    # every backward on the same O and LSE (the plain forward's), as chip_smoke does
    got = emulate_bwd(q, k, v, po, pl, g, causal=causal, scale=scale)
    plain = flash_attention_bwd_ref(q, k, v, po, pl, g, causal=causal, scale=scale)
    jax_grads = jax_flash_attention_bwd(
        *(jnp.asarray(a) for a in arrays[:3]), jnp.asarray(_bf16(po.float().numpy())),
        jnp.asarray(pl.numpy()), jnp.asarray(arrays[3]), causal=causal, scale=scale,
        interpret=True)
    for name, a, b, c in zip(("dq", "dk", "dv"), got, plain, jax_grads):
        _close(a, b, f"{name} vs plain")
        _close(a, torch.from_numpy(np.asarray(c).astype(np.float32)), f"{name} vs jax")


@pytest.mark.parametrize("causal", [True, False])
def test_one_bf16_rounding_of_p_and_ds_misses_the_tolerance(causal):
    # why the kernels split: the same arithmetic with P and dS rounded once
    # fails chip_smoke's bf16 tolerance on every output
    _, (q, k, v, g) = _inputs()
    scale = 64 ** -0.5
    po, pl = flash_attention_ref(q, k, v, causal=causal, scale=scale, return_residuals=True)
    once = emulate_fwd(q, k, v, causal=causal, scale=scale, mm=_mm_once)[0]
    grads = emulate_bwd(q, k, v, po, pl, g, causal=causal, scale=scale, mm=_mm_once)
    wants = flash_attention_bwd_ref(q, k, v, po, pl, g, causal=causal, scale=scale)
    for name, got, want in zip(("out", "dq", "dk", "dv"), (once, *grads), (po, *wants)):
        with pytest.raises(AssertionError):
            _close(got, want, name)


def test_split_keeps_sixteen_bits_where_one_bf16_keeps_eight():
    # what the split buys: P.V before the output rounding, against f32
    rs = np.random.RandomState(16)
    p = torch.from_numpy(rs.rand(4, 64, 256).astype(np.float32))
    v = torch.from_numpy(rs.randn(4, 256, 64).astype(np.float32)).bfloat16().float()
    exact = (p.double() @ v.double()).float()
    scale = (p.abs() @ v.abs()).amax()
    split_err = ((_mm_split(p, v) - exact).abs().max() / scale).item()
    once_err = ((_mm_once(p, v) - exact).abs().max() / scale).item()
    assert split_err < 2 ** -16 < once_err


def test_library_key_covers_the_shared_headers(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    (tmp_path / "k.cu").write_text('#include "hopper.cuh"\n')
    (tmp_path / "hopper.cuh").write_text("// v1\n")
    first = _build.library_path("k")
    assert _build.library_path("k") == first                 # unchanged: reused
    (tmp_path / "hopper.cuh").write_text("// v2\n")
    edited_header = _build.library_path("k")
    assert edited_header != first
    (tmp_path / "extra.cuh").write_text("// new\n")
    assert _build.library_path("k") != edited_header          # a new header counts too
    (tmp_path / "k.cu").write_text('#include "hopper.cuh"\n// edited\n')
    assert _build.library_path("k") not in (first, edited_header)
    assert first.parent == _build.BUILD_DIR and first.name.startswith("libk-")
