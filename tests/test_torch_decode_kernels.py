"""The plain versions of the decode kernels 11-14 (through their wrappers,
on CPU tensors) against the JAX package's Pallas kernels in interpret mode,
on the same numpy inputs in f32.

Shapes: 3 slots x 4 query heads over 2 kv heads (GQA group 2), d 16, k 4,
dv 16, pages of 8 tokens, 4 pages a slot (n 32), a shuffled non-monotone
block table, ragged lengths and one slot at the past-the-table sentinel
length. Row 12 scores C = 3 queries with block_n = page; row 13 reads an
image of n 32 with block_n 8. Tolerance 1e-5 absolute: f32 outputs of
magnitude ~1, the sums taken in another order.
"""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.sparse import SparseCode as JaxCode
from repro.core.sparse import to_feature_major as jax_to_feature_major
from repro_torch.kernels import (
    feature_major_prefill, flash_sfa_decode_fm, flash_sfa_decode_fm_paged,
    flash_sfa_decode_multi, flash_sfa_decode_paged, launch_counts, reset_launches,
)

# the module (repro.kernels re-exports a function of the same name)
jk = importlib.import_module("repro.kernels.flash_sfa_decode")

SLOTS, H, HKV, D, K, DV, PAGE, MP = 3, 4, 2, 16, 4, 16, 8, 4
POOL = SLOTS * MP + 1
TOL = 1e-5


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=TOL)


@pytest.fixture(scope="module")
def data():
    rs = np.random.RandomState(0)
    bt = rs.permutation(np.arange(1, POOL))[:SLOTS * MP].reshape(SLOTS, MP).astype(np.int32)
    lens = np.array([13, MP * PAGE + 1, 27], np.int32)   # slot 1: the sentinel
    idx = np.sort(np.argsort(rs.rand(HKV, POOL, PAGE, D), -1)[..., :K], -1)
    return {
        "bt": bt, "lens": lens,
        "kv": rs.randn(HKV, POOL, PAGE, K).astype(np.float32),
        "ki": idx.astype(np.uint8),
        "v": rs.randn(HKV, POOL, PAGE, DV).astype(np.float32),
        "kf": rs.randn(HKV, POOL, D, PAGE).astype(np.float32),
        "q": rs.randn(SLOTS * H, D).astype(np.float32),
        "qv": rs.randn(SLOTS * H, K).astype(np.float32),
        "qi": np.sort(np.argsort(rs.rand(SLOTS * H, D), -1)[..., :K], -1).astype(np.int32),
    }


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def test_paged_decode_plain_matches_pallas(data):
    """Row 11: (hkv, P, page, k) pools with packed uint8 indices."""
    reset_launches()
    got = flash_sfa_decode_paged(_t(data["q"]), _t(data["kv"]), _t(data["ki"]), _t(data["v"]),
                                 _t(data["bt"]), _t(data["lens"]), d=D, heads=H)
    want = jk.flash_sfa_decode_paged(
        jnp.asarray(data["q"]), jnp.asarray(data["kv"]), jnp.asarray(data["ki"]),
        jnp.asarray(data["v"]), jnp.asarray(data["bt"]), jnp.asarray(data["lens"]),
        d=D, heads=H, interpret=True)
    assert got.dtype == torch.float32 and got.shape == (SLOTS * H, DV)
    _close(got, want)
    assert launch_counts()["flash_sfa_decode_paged"] == 0      # plain on the CPU


def _slot_view(a, bt_row):
    """One slot's (hkv, n, F) contiguous leaf from a (hkv, P, page, F) pool."""
    return a[:, bt_row].reshape(a.shape[0], MP * PAGE, a.shape[-1])


@pytest.mark.parametrize("form", ["pools", "contiguous"])
def test_multi_decode_plain_matches_pallas(data, form):
    """Row 12: C = 3 queries of slot 2 at lengths cache_len + c + 1, with
    the JAX kernel's block_n = page; the port reads the pools through the
    block table, or the contiguous (hkv, n, k) slot view."""
    c, slot, cache_len = 3, 2, 21
    rs = np.random.RandomState(1)
    q = rs.randn(c * H, D).astype(np.float32)
    lens = np.repeat(cache_len + np.arange(c) + 1, H).astype(np.int32)
    row = data["bt"][slot]
    views = [_slot_view(data[n], row) for n in ("kv", "ki", "v")]
    folded = [np.repeat(x, H // HKV, axis=0) for x in views]       # (h, n, F)
    want = jk.flash_sfa_decode_multi(jnp.asarray(q), *(jnp.asarray(x) for x in folded),
                                     jnp.asarray(lens), d=D, heads=H, block_n=PAGE,
                                     interpret=True)
    if form == "pools":
        got = flash_sfa_decode_multi(_t(q), _t(data["kv"]), _t(data["ki"]), _t(data["v"]),
                                     _t(lens), d=D, heads=H, block_tables=_t(data["bt"]),
                                     slot=slot)
    else:
        got = flash_sfa_decode_multi(_t(q), *(_t(x) for x in views), _t(lens), d=D, heads=H)
    _close(got, want)


def test_fm_decode_plain_matches_pallas(data):
    """Row 13: the contiguous image (slots·hkv, d, n 32) with block_n 8,
    query row i reading image row i // group, per-row lengths."""
    bt = data["bt"]
    kf = data["kf"][:, bt].transpose(1, 0, 3, 2, 4).reshape(SLOTS * HKV, D, MP * PAGE)
    v = data["v"][:, bt].transpose(1, 0, 2, 3, 4).reshape(SLOTS * HKV, MP * PAGE, DV)
    lens = np.minimum(np.repeat(data["lens"], H), MP * PAGE).astype(np.int32)
    lens[1] = 5                                            # ragged within a slot
    got = flash_sfa_decode_fm(_t(data["qv"]), _t(data["qi"]), _t(kf), _t(v), _t(lens),
                              group=H // HKV)
    want = jk.flash_sfa_decode_fm(jnp.asarray(data["qv"]), jnp.asarray(data["qi"]),
                                  jnp.asarray(kf), jnp.asarray(v), jnp.asarray(lens),
                                  block_n=8, group=H // HKV, interpret=True)
    _close(got, want)


def test_fm_paged_decode_plain_matches_pallas(data):
    """Row 14: the (hkv, P, d, page) image pool through the block table."""
    got = flash_sfa_decode_fm_paged(_t(data["qv"]), _t(data["qi"]), _t(data["kf"]),
                                    _t(data["v"]), _t(data["bt"]), _t(data["lens"]), heads=H)
    want = jk.flash_sfa_decode_fm_paged(
        jnp.asarray(data["qv"]), jnp.asarray(data["qi"]), jnp.asarray(data["kf"]),
        jnp.asarray(data["v"]), jnp.asarray(data["bt"]), jnp.asarray(data["lens"]),
        heads=H, interpret=True)
    _close(got, want)


def test_feature_major_prefill_equals_jax(data):
    """The persistent image of a prefill's codes (b, n, hkv, k) -> (b, hkv,
    d, n): a scatter, exact."""
    rs = np.random.RandomState(2)
    vals = rs.randn(2, 11, HKV, K).astype(np.float32)
    idx = np.sort(np.argsort(rs.rand(2, 11, HKV, D), -1)[..., :K], -1).astype(np.int32)
    got = feature_major_prefill(_t(vals), _t(idx), D)
    want = jk.feature_major_prefill(jnp.asarray(vals), jnp.asarray(idx), D)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert np.array_equal(np.asarray(want), np.asarray(jax_to_feature_major(JaxCode(
        jnp.moveaxis(jnp.asarray(vals), 1, 2), jnp.moveaxis(jnp.asarray(idx), 1, 2), D))))
