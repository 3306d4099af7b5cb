"""rtopk's selection: the plain version against JAX at the bodies' borders,
and the CUDA bodies' choice emulated on the CPU.

``csrc/rtopk.cu`` has two bodies (``kernels/rtopk.py::one_thread_body``):
one thread a row for d in {32, 64, 128} and k <= 16, whose lanes keep
descending lists of their largest keys and merge them (bf16: keys packed
with their index, so the first k are the codes; f32: magnitude keys, the
ties split by an exclusive scan); and one warp a row bisecting over the raw bits,
16 steps for bf16's 15-bit keys, 32 for f32's. The kernels run only on the
card (tests/test_torch_gpu.py); here their arithmetic is emulated in numpy,
on the raw bits, as ``csrc/topk_select.cuh`` does it, and held to the plain
version ``rtopk_ref``, which is held to JAX's Pallas ``rtopk`` in
interpret mode. Indices must be equal and values bit-equal.
"""
import importlib
import re
from pathlib import Path

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.kernels.rtopk import rtopk as jax_rtopk
from repro_torch.kernels import BODY_COUNTERS, body_counts, reset_launches, rtopk
from repro_torch.kernels.ref import rtopk_ref

rtopk_module = importlib.import_module("repro_torch.kernels.rtopk")

CSRC = Path(rtopk_module.__file__).resolve().parent.parent / "csrc"


def _rows(seed, rows, d):
    """Tie-heavy rows and the contract's edge values: equal magnitudes of
    both signs, a row of one magnitude, ±0 among subnormals, ±inf, NaN."""
    rs = np.random.RandomState(seed)
    x = rs.randn(rows, d).astype(np.float32)
    x[::6, 1] = -x[::6, 0]
    x[1::6, 4:12] = x[1::6, 3:4]
    x[2::6, :] = np.round(x[2::6, :])
    x[3::6, :] = np.where(rs.rand(d) < 0.5, 1.5, -1.5)          # all-equal magnitudes
    x[4::6, :] = np.where(rs.rand(d) < 0.5, 0.0, -0.0)          # ±0 ...
    x[4::6, ::5] = rs.randint(1, 4, size=(len(x[4::6]), len(range(0, d, 5)))) * 1e-39
    x[5::6, 3] = np.inf                                          # ±inf and NaN
    x[5::6, 7] = -np.inf
    x[5::6, 9::11] = np.nan
    return x


def _as(x, dtype):
    """(torch tensor, its raw bits as numpy) in dtype."""
    t = torch.from_numpy(x).to(dtype)
    bits = t.view(torch.int16 if dtype == torch.bfloat16 else torch.int32).numpy()
    return t, bits.astype(np.int64) & (0xFFFF if dtype == torch.bfloat16 else 0xFFFFFFFF)


def _keys(bits, dtype):
    """topk::key_of on raw bits: the magnitude's bit pattern, NaN as 0."""
    if dtype == torch.bfloat16:
        m = bits & 0x7FFF
        return np.where(m > 0x7F80, 0, m)
    m = bits & 0x7FFFFFFF
    return np.where(m > 0x7F800000, 0, m)


def _one_thread_body(keys, k, lanes, kl):
    """The one-thread body's choice as rtopk.cu makes it: each of ``lanes``
    lanes keeps the kl largest keys of its d / lanes entries, the lists
    merge to the row's top kl, top[k - 1] is the threshold, and each lane
    counts its entries above it and its ties from its own list only; an
    exclusive scan over the lanes gives each its first slot and tie quota,
    and each writes its entries in index order. (rows, k) indices."""
    rows, d = keys.shape
    n = d // lanes
    part = keys.reshape(rows, lanes, n)
    mine = -np.sort(-part, axis=-1)[..., :kl]
    if n < kl:
        mine = np.concatenate([mine, np.full((rows, lanes, kl - n), -1)], axis=-1)
    merged = -np.sort(-mine.reshape(rows, -1), axis=-1)[:, :kl]
    theta = merged[:, k - 1]
    n_hi = (merged > theta[:, None]).sum(-1)
    hi = (mine > theta[:, None, None]).sum(-1)
    ties = (mine == theta[:, None, None]).sum(-1)
    hi_before = np.cumsum(hi, axis=-1) - hi
    ties_before = np.cumsum(ties, axis=-1) - ties
    out = np.full((rows, k), -1)
    for r in range(rows):
        quota = k - n_hi[r]
        for lane in range(lanes):
            o = hi_before[r, lane] + min(ties_before[r, lane], quota)
            q, seen = max(quota - ties_before[r, lane], 0), 0
            for e in range(n):
                key = part[r, lane, e]
                if key > theta[r] or (key == theta[r] and seen < q):
                    out[r, o] = lane * n + e
                    o += 1
                seen += key == theta[r]
    return out


def _packed_body(keys, k, lanes, kl):
    """The one-thread body's bf16 choice: each lane keeps the kl largest
    packed keys (key << 8 | 255 - index) of its entries, the lists merge,
    and the first k of the row's list, their indices sorted, are the codes."""
    rows, d = keys.shape
    assert keys.max() < 2 ** 15 and d <= 256
    pk = keys << 8 | (255 - np.arange(d))
    mine = -np.sort(-pk.reshape(rows, lanes, d // lanes), axis=-1)[..., :kl]
    merged = -np.sort(-mine.reshape(rows, -1), axis=-1)[:, :k]
    return np.sort(255 - (merged & 255), axis=-1)


def _warp_body(keys, k, dtype):
    """The warp body's choice: the bisection of topk::select_row over the
    key range of the raw type (bf16: below 0x7F81 in 16 steps; f32: below
    0x7F800001 in 32), then the entries above and the first ties."""
    hi_key, steps = (0x7F81, 16) if dtype == torch.bfloat16 else (0x7F800001, 32)
    lo = np.zeros(keys.shape[0], np.int64)
    hi = np.full(keys.shape[0], hi_key, np.int64)
    for _ in range(steps):
        mid = lo + (hi - lo) // 2
        take = (keys >= mid[:, None]).sum(-1) >= k
        lo, hi = np.where(take, mid, lo), np.where(take, hi, mid)
    above = keys > lo[:, None]
    tie = keys == lo[:, None]
    quota = k - above.sum(-1, keepdims=True)
    sel = above | (tie & (np.cumsum(tie, axis=-1) <= quota))
    assert (sel.sum(-1) == k).all()
    return np.stack([np.flatnonzero(s) for s in sel])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("d,k", [(128, 16), (128, 17), (256, 16), (256, 17)])
def test_plain_matches_jax_at_the_body_borders(d, k, dtype):
    """rtopk_ref against JAX's Pallas rtopk (interpret mode) where the
    bodies part: k 16 | 17, d 128 | 256."""
    x = _rows(20, 24, d)
    t, _ = _as(x, dtype)
    jx = jnp.asarray(x.astype(ml_dtypes.bfloat16) if dtype == torch.bfloat16 else x)
    jv, ji = jax_rtopk(jx, k, block_rows=8, interpret=True)
    pv, pi = rtopk_ref(t, k)
    assert pi.dtype == torch.int32 and pv.dtype == dtype
    np.testing.assert_array_equal(pi.numpy(), np.asarray(ji))
    want = np.asarray(jv).view(np.int16 if dtype == torch.bfloat16 else np.int32)
    got = pv.view(torch.int16 if dtype == torch.bfloat16 else torch.int32).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("lanes", [1, 2, 4, 8])
@pytest.mark.parametrize("d", [32, 64, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_one_thread_body_choice_equals_plain(dtype, d, lanes):
    """The one-thread body's lists, merge and lane scan (emulated; for
    bf16 the packed keys, for f32 the threshold and tie pass) choose
    rtopk_ref's indices at the KL borders k 1, 8, 9, 16."""
    x = _rows(21, 36, d)
    t, bits = _as(x, dtype)
    keys = _keys(bits, dtype)
    body = _packed_body if dtype == torch.bfloat16 else _one_thread_body
    for k in (1, 8, 9, 16):
        want = rtopk_ref(t, k)[1].numpy()
        np.testing.assert_array_equal(body(keys, k, lanes, 8 if k <= 8 else 16), want,
                                      err_msg=f"k={k}")


@pytest.mark.parametrize("lanes", [1, 2, 4, 8])
@pytest.mark.parametrize("d", [32, 64, 128])
def test_tie_pass_on_bf16_keys_equals_plain(d, lanes):
    """The threshold and tie pass (the f32 path, and proj_rtopk's) on bf16
    keys too: both one-thread forms choose the same codes."""
    x = _rows(24, 36, d)
    t, bits = _as(x, torch.bfloat16)
    keys = _keys(bits, torch.bfloat16)
    for k in (1, 8, 9, 16):
        np.testing.assert_array_equal(_one_thread_body(keys, k, lanes, 8 if k <= 8 else 16),
                                      rtopk_ref(t, k)[1].numpy(), err_msg=f"k={k}")


@pytest.mark.parametrize("d,k", [(20, 3), (64, 17), (256, 32), (256, 256)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_warp_body_choice_equals_plain(dtype, d, k):
    """The warp body's bisection over raw bits (16 steps for bf16)
    chooses rtopk_ref's indices."""
    x = _rows(22, 36, d)
    t, bits = _as(x, dtype)
    np.testing.assert_array_equal(_warp_body(_keys(bits, dtype), k, dtype),
                                  rtopk_ref(t, k)[1].numpy())


def _sort8_pairs():
    """The (i, j) pairs of topk_select.cuh's sort8 network, in order."""
    src = (CSRC / "topk_select.cuh").read_text()
    body = src[src.index("void sort8("):src.index("// a descending bitonic sequence")]
    return [(int(i), int(j)) for i, j in re.findall(r"order\(b\[(\d)\], b\[(\d)\]\)", body)]


def _top_list(keys, kl):
    """topk::top_list on rows of keys: groups of 8 sorted by the header's
    network, each merged into the list (the larger of slot kl - 1 - i and
    b[i], then a bitonic merge)."""
    rows, n = keys.shape
    top = np.full((rows, kl), -1, np.int64)

    def order(a, i, j):
        hi, lo = np.maximum(a[:, i], a[:, j]), np.minimum(a[:, i], a[:, j])
        a[:, i], a[:, j] = hi, lo

    for g in range(0, n, 8):
        b = keys[:, g:g + 8].copy()
        for i, j in _sort8_pairs():
            order(b, i, j)
        top[:, kl - 8:] = np.maximum(top[:, kl - 8:], b[:, ::-1])
        s = kl // 2
        while s:
            for i in range(kl):
                if not i & s:
                    order(top, i, i + s)
            s //= 2
    return top


def test_sort8_network_sorts():
    """sort8 is a sorting network: it sorts every 0/1 input (the 0-1
    principle), with 19 pairs."""
    pairs = _sort8_pairs()
    assert len(pairs) == 19
    b = np.array([[(m >> i) & 1 for i in range(8)] for m in range(256)])
    for i, j in pairs:
        b[:, i], b[:, j] = np.maximum(b[:, i], b[:, j]), np.minimum(b[:, i], b[:, j])
    assert (np.diff(b, axis=1) <= 0).all()


@pytest.mark.parametrize("n,kl", [(8, 8), (16, 8), (64, 8), (8, 16), (32, 16), (128, 16)])
def test_top_list_keeps_the_largest(n, kl):
    """top_list's groups and merges leave the kl largest keys, descending,
    on tie-heavy rows and rows shorter than the list."""
    rs = np.random.RandomState(n + kl)
    keys = np.concatenate([rs.randint(0, 1 << 20, (40, n)), rs.randint(0, 4, (40, n))])
    want = -np.sort(-keys, axis=-1)[:, :kl]
    if n < kl:
        want = np.concatenate([want, np.full((80, kl - n), -1)], axis=-1)
    np.testing.assert_array_equal(_top_list(keys, kl), want)


def test_one_thread_body_is_the_instantiated_shapes():
    """one_thread_body(d, k) names exactly the shapes rtopk.cu instantiates
    and accepts for its one-thread body."""
    src = (CSRC / "rtopk.cu").read_text()
    body = src[src.index("int by_d("):src.index("template <int E, typename T>")]
    dims = {int(v) for v in re.findall(r"by_rows<(\d+),", body)}
    assert dims == set(rtopk_module.THREAD_HEAD_DIMS) == {32, 64, 128}
    assert f"k > {rtopk_module.THREAD_MAX_K}" in src
    for d in (32, 64, 128):
        assert all(rtopk_module.one_thread_body(d, k) for k in range(1, 17))
        assert not rtopk_module.one_thread_body(d, 17)
    assert not any(rtopk_module.one_thread_body(d, 8) for d in (20, 48, 96, 256))
    assert '#include "topk_select.cuh"' in src
    # proj_rtopk's two sources share the selection through their common header
    assert '#include "topk_select.cuh"' in (CSRC / "proj_rtopk.cuh").read_text()
    for name in ("proj_rtopk.cu", "proj_rtopk_wide.cu"):
        assert '#include "proj_rtopk.cuh"' in (CSRC / name).read_text()


def test_warp_body_counter_is_a_body_counter():
    """rtopk_warp is read by body_counts(); the CPU path launches nothing."""
    assert BODY_COUNTERS["rtopk_warp"] == (rtopk, "warp_body_launches")
    reset_launches()
    x = torch.from_numpy(_rows(23, 8, 64))
    for k in (8, 17):
        rtopk(x, k)
    assert body_counts()["rtopk_warp"] == 0 and rtopk.launches == 0
