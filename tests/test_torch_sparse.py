"""core/sparse.py parity: the port's top-k codes equal the JAX package's.

Inputs come from a numpy seed and go to both packages; indices must be
exactly equal, values equal (they are moved, not computed).
"""
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.core import sparse as jsp
from repro_torch.core import sparse as tsp


def _rows(seed, shape, *, ties=False):
    rs = np.random.RandomState(seed)
    x = rs.randn(*shape).astype(np.float32)
    if ties:
        # plant magnitude ties around the k-th value: equal |x| with both
        # signs, and a block of exact duplicates
        x[..., 1] = -x[..., 0]
        x[..., 5:9] = x[..., 4:5]
        x[..., 10] = 0.0
        x[..., 11] = -0.0
    return x


CASES = [
    ((6, 16), 4, False),
    ((3, 5, 32), 8, True),
    ((2, 64), 8, True),
    ((4, 7), 7, False),       # k == d
    ((4, 12), 1, True),
]


def _both(x, dtype):
    if dtype == "bfloat16":
        xb = x.astype(ml_dtypes.bfloat16)
        return jnp.asarray(xb), torch.from_numpy(xb.astype(np.float32)).to(torch.bfloat16)
    return jnp.asarray(x), torch.from_numpy(x)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,k,ties", CASES)
def test_topk_mask_matches(shape, k, ties, dtype):
    x = _rows(0, shape, ties=ties)
    jx, tx = _both(x, dtype)
    want = np.asarray(jsp.topk_mask(jx, k))
    got = tsp.topk_mask(tx, k).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,k,ties", CASES)
def test_sparsify_matches(shape, k, ties, dtype):
    x = _rows(1, shape, ties=ties)
    jx, tx = _both(x, dtype)
    jc = jsp.sparsify(jx, k)
    tc = tsp.sparsify(tx, k)
    np.testing.assert_array_equal(tc.indices.numpy(), np.asarray(jc.indices))
    np.testing.assert_array_equal(tc.values.float().numpy(),
                                  np.asarray(jc.values).astype(np.float32))
    assert tc.dim == jc.dim
    assert tc.values.dtype == tx.dtype


@pytest.mark.parametrize("shape,k,ties", CASES)
def test_topk_st_matches(shape, k, ties):
    x = _rows(2, shape, ties=ties)
    want = np.asarray(jsp.topk_st(jnp.asarray(x), k))
    got = tsp.topk_st(torch.from_numpy(x), k).numpy()
    np.testing.assert_array_equal(got, want)


def test_densify_sums_duplicates():
    rs = np.random.RandomState(3)
    vals = rs.randn(5, 6).astype(np.float32)
    idx = rs.randint(0, 4, size=(5, 6)).astype(np.int32)   # many duplicates
    want = np.asarray(jsp.densify(jsp.SparseCode(jnp.asarray(vals),
                                                 jnp.asarray(idx), 10)))
    got = tsp.densify(tsp.SparseCode(torch.from_numpy(vals),
                                     torch.from_numpy(idx).long(), 10)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_sparsify_densify_round_trip():
    x = torch.from_numpy(_rows(4, (8, 32)))
    c = tsp.sparsify(x, 5)
    np.testing.assert_array_equal(tsp.densify(c).numpy(), tsp.topk_st(x, 5).numpy())
    assert bool((c.indices[..., 1:] > c.indices[..., :-1]).all())
