"""Kernel parity: the port's kernel wrappers against the JAX package.

On the CPU each wrapper runs its plain version; it is held against the JAX
Pallas kernel in interpret mode and against ``repro.kernels.ref``, on the
same numpy inputs. Indices must be exactly equal; f32 outputs agree to
1e-4 (sums run in another order). The CUDA kernels themselves are held
against these plain versions on the card in tests/test_torch_gpu.py.
"""
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.flash_sfa import flash_sfa as jax_flash_sfa
from repro.kernels.flash_sfa_decode import flash_sfa_decode as jax_decode
from repro.kernels.rtopk import rtopk as jax_rtopk
from repro_torch.kernels import flash_sfa, flash_sfa_decode, rtopk

TOL = 1e-4


def _x(seed, rows, d, *, ties=True, nan=False):
    rs = np.random.RandomState(seed)
    x = rs.randn(rows, d).astype(np.float32)
    if ties:
        x[::3, 1] = -x[::3, 0]
        x[1::3, 4:12] = x[1::3, 3:4]
        x[2::3, :] = np.round(x[2::3, :])           # many equal magnitudes
    if nan:
        x[::4, 2] = np.nan
        x[1::4, :5] = np.nan
    return x


def _codes(rs, bh, n, k, d):
    vals = rs.randn(bh, n, k).astype(np.float32)
    idx = np.sort(np.stack([np.stack([rs.choice(d, k, replace=False)
                                      for _ in range(n)]) for _ in range(bh)]),
                  axis=-1).astype(np.int32)
    return vals, idx


# --------------------------------------------------------------------------
# rtopk
# --------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d,k", [(64, 8), (32, 4), (128, 16)])
def test_rtopk_matches_jax_kernel_and_ref(d, k, dtype):
    x = _x(0, 48, d)
    if dtype == "bfloat16":
        xb = x.astype(ml_dtypes.bfloat16)
        jx = jnp.asarray(xb)
        tx = torch.from_numpy(xb.astype(np.float32)).to(torch.bfloat16)
    else:
        jx, tx = jnp.asarray(x), torch.from_numpy(x)
    jv, ji = jax_rtopk(jx, k, block_rows=16, interpret=True)
    rv, ri = jref.rtopk_ref(jx, k)
    tv, ti = rtopk(tx, k)
    assert ti.dtype == torch.int32 and tv.dtype == tx.dtype
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ri))
    np.testing.assert_array_equal(tv.float().numpy(), np.asarray(jv).astype(np.float32))
    np.testing.assert_array_equal(tv.float().numpy(), np.asarray(rv).astype(np.float32))


def test_rtopk_nan_rows_follow_contract():
    x = _x(1, 32, 64, ties=False, nan=True)
    jv, ji = jax_rtopk(jnp.asarray(x), 8, block_rows=16, interpret=True)
    tv, ti = rtopk(torch.from_numpy(x), 8)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    assert not torch.isnan(tv).any()
    # the contract: top-k of |nan_to_zero(x)|
    _, want = jref.rtopk_ref(jnp.asarray(np.nan_to_num(x, nan=0.0)), 8)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(want))


def test_rtopk_leading_dims_and_bad_k():
    x = torch.from_numpy(_x(2, 24, 32)).reshape(2, 3, 4, 32)
    v, i = rtopk(x, 4)
    assert v.shape == (2, 3, 4, 4) and i.shape == (2, 3, 4, 4)
    v2, i2 = rtopk(x.reshape(24, 32), 4)
    np.testing.assert_array_equal(i.reshape(24, 4).numpy(), i2.numpy())
    with pytest.raises(ValueError):
        rtopk(x, 33)


# --------------------------------------------------------------------------
# flash_sfa
# --------------------------------------------------------------------------

@pytest.mark.parametrize("causal", [True, False])
def test_flash_sfa_matches_jax_kernel(causal):
    rs = np.random.RandomState(3)
    bh, n, k, d, dv = 2, 200, 8, 64, 64              # ragged: 200 % 128 != 0
    qv, qi = _codes(rs, bh, n, k, d)
    kv, ki = _codes(rs, bh, n, k, d)
    v = rs.randn(bh, n, dv).astype(np.float32)
    jo, jl = jax_flash_sfa(*(jnp.asarray(a) for a in (qv, qi, kv, ki, v)), d=d,
                           causal=causal, return_residuals=True, interpret=True)
    to, tl = flash_sfa(*(torch.from_numpy(a) for a in (qv, qi, kv, ki, v)), d=d,
                       causal=causal, return_residuals=True)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=0, atol=TOL)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=TOL)
    if causal:
        ro = jref.flash_sfa_ref(*(jnp.asarray(a) for a in (qv, qi, kv, ki, v)), d=d)
        np.testing.assert_allclose(to.numpy(), np.asarray(ro), rtol=0, atol=TOL)


def test_flash_sfa_padding_rows_densify_to_zero():
    """Duplicate indices sum on densify: a (idx 0, val 0) x k row is an
    all-zero key, as in the JAX kernel."""
    rs = np.random.RandomState(4)
    bh, n, k, d = 1, 40, 4, 32
    qv, qi = _codes(rs, bh, n, k, d)
    kv, ki = _codes(rs, bh, n, k, d)
    kv[:, 5], ki[:, 5] = 0.0, 0
    ki[:, 7] = 3                                      # duplicate indices sum
    v = rs.randn(bh, n, 32).astype(np.float32)
    jo = jax_flash_sfa(*(jnp.asarray(a) for a in (qv, qi, kv, ki, v)), d=d,
                       interpret=True)
    to = flash_sfa(*(torch.from_numpy(a) for a in (qv, qi, kv, ki, v)), d=d)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=0, atol=TOL)


# --------------------------------------------------------------------------
# flash_sfa_decode
# --------------------------------------------------------------------------

def _decode_inputs(seed, b, h, hkv, n, k, d, dv):
    rs = np.random.RandomState(seed)
    q = rs.randn(b * h, d).astype(np.float32)
    kv, ki = _codes(rs, b * hkv, n, k, d)
    kv = kv.reshape(b, hkv, n, k).transpose(0, 2, 1, 3)        # (b, n, hkv, k)
    ki = ki.reshape(b, hkv, n, k).transpose(0, 2, 1, 3)
    v = rs.randn(b, n, hkv, dv).astype(np.float32)
    lens = rs.randint(1, n + 1, size=b)
    return q, np.ascontiguousarray(kv), np.ascontiguousarray(ki), v, lens


def _fold(t, h):
    """(b, n, hkv, F) -> (b*h, n, F), GQA-expanded (the JAX backend's copy)."""
    b, n, hkv, f = t.shape
    t = np.repeat(t, h // hkv, axis=2)
    return t.transpose(0, 2, 1, 3).reshape(b * h, n, f)


def test_flash_sfa_decode_matches_jax_kernel():
    b, h, n, k, d, dv = 3, 4, 200, 8, 64, 64
    q, kv, ki, v, lens = _decode_inputs(5, b, h, h, n, k, d, dv)
    lens_bh = np.repeat(lens, h).astype(np.int32)
    fkv, fki, fv = _fold(kv, h), _fold(ki, h), _fold(v, h)
    jo = jax_decode(jnp.asarray(q), jnp.asarray(fkv), jnp.asarray(fki),
                    jnp.asarray(fv), jnp.asarray(lens_bh), d=d, interpret=True)
    ro = jref.flash_sfa_decode_ref(jnp.asarray(q), jnp.asarray(fkv),
                                   jnp.asarray(fki), jnp.asarray(fv),
                                   jnp.asarray(lens_bh), d=d)
    # folded (bh, n, k) layout with packed uint8 indices
    to = flash_sfa_decode(torch.from_numpy(q), torch.from_numpy(fkv),
                          torch.from_numpy(fki.astype(np.uint8)),
                          torch.from_numpy(fv), torch.from_numpy(lens_bh), d=d)
    assert to.dtype == torch.float32 and to.shape == (b * h, dv)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=0, atol=TOL)
    np.testing.assert_allclose(to.numpy(), np.asarray(ro), rtol=0, atol=TOL)
    # the SparseKV layout (b, n, hkv, k) as it is, uint8 indices
    so = flash_sfa_decode(torch.from_numpy(q), torch.from_numpy(kv),
                          torch.from_numpy(ki.astype(np.uint8)),
                          torch.from_numpy(v), torch.from_numpy(lens_bh), d=d)
    np.testing.assert_allclose(so.numpy(), np.asarray(jo), rtol=0, atol=TOL)


def test_flash_sfa_decode_gqa_cache_layout():
    b, h, hkv, n, k, d, dv = 2, 4, 2, 96, 4, 32, 32
    q, kv, ki, v, lens = _decode_inputs(6, b, h, hkv, n, k, d, dv)
    lens_bh = np.repeat(lens, h).astype(np.int32)
    jo = jax_decode(jnp.asarray(q), jnp.asarray(_fold(kv, h)),
                    jnp.asarray(_fold(ki, h)), jnp.asarray(_fold(v, h)),
                    jnp.asarray(lens_bh), d=d, interpret=True)
    to = flash_sfa_decode(torch.from_numpy(q), torch.from_numpy(kv),
                          torch.from_numpy(ki.astype(np.uint8)),
                          torch.from_numpy(v), torch.from_numpy(lens_bh), d=d)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=0, atol=TOL)
