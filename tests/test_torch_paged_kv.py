"""The port's nested-k and feature-major code helpers, its paged and
feature-major caches, and its cache byte accounting against the JAX
package on the same numpy inputs.

``sub_k`` and ``to_feature_major`` are held exactly (values, indices and
tie-breaks). The caches' writes, chunk writes, page inserts and gathered
views are held exactly too: they move values without arithmetic (a
densified column sums one value with zeros). Byte counts are integers and
equal.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.core import kv_cache as jkv
from repro.core.sparse import SparseCode as JaxCode
from repro.core.sparse import sub_k as jax_sub_k
from repro.core.sparse import to_feature_major as jax_to_feature_major
from repro.serve import kv_cache as jserve
from repro_torch.configs import get_config
from repro_torch.core import kv_cache as tkv
from repro_torch.core.sparse import SparseCode, sub_k, to_feature_major
from repro_torch.serve import kv_cache as tserve

SLOTS, HKV, PAGE, MP, K, D, DV = 3, 2, 8, 4, 4, 16, 16
POOL = SLOTS * MP + 1                     # + the trash page 0


def _eq(t, j):
    np.testing.assert_array_equal(t.numpy() if isinstance(t, torch.Tensor) else t,
                                  np.asarray(j))


def _tied_rows(rs, shape):
    x = rs.randn(*shape).astype(np.float32)
    x[..., 1] = -x[..., 0]                # equal magnitudes, both signs
    x[::2, ..., 3] = x[::2, ..., 2]       # equal values
    x[::3] = np.round(x[::3])             # many ties at the threshold
    return x


@pytest.mark.parametrize("k_draft", [1, 2, 3, 8])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sub_k_equals_jax(k_draft, dtype):
    rs = np.random.RandomState(k_draft)
    vals = _tied_rows(rs, (40, 3, 6))
    idx = np.sort(np.argsort(rs.rand(40, 3, 64), -1)[..., :6], -1).astype(np.int32)
    tv = torch.from_numpy(vals).to(getattr(torch, dtype))
    jv = jnp.asarray(vals).astype(dtype)
    gv, gi = sub_k(tv, torch.from_numpy(idx).long(), k_draft)
    wv, wi = jax_sub_k(jv, jnp.asarray(idx), k_draft)
    _eq(gi, wi)
    _eq(gv.float(), jnp.asarray(wv, jnp.float32))
    if k_draft < 6:
        assert (gi[..., 1:] > gi[..., :-1]).all()     # ascending, as stored


def test_to_feature_major_equals_jax():
    rs = np.random.RandomState(1)
    vals = rs.randn(2, 3, 10, K).astype(np.float32)
    idx = np.sort(np.argsort(rs.rand(2, 3, 10, D), -1)[..., :K], -1).astype(np.int32)
    got = to_feature_major(SparseCode(torch.from_numpy(vals), torch.from_numpy(idx).long(), D))
    want = jax_to_feature_major(JaxCode(jnp.asarray(vals), jnp.asarray(idx), D))
    assert got.shape == (2, 3, D, 10)
    _eq(got, want)


# --------------------------------------------------------------------------
# paged caches
# --------------------------------------------------------------------------

def _block_table(rs):
    """Shuffled, non-monotone page ids 1.. for every slot."""
    return rs.permutation(np.arange(1, POOL))[:SLOTS * MP].reshape(SLOTS, MP).astype(np.int32)


def _pools(rs, layout):
    if layout == "sparse":
        return {"k_vals": rs.randn(HKV, POOL, PAGE, K).astype(np.float32),
                "k_idx": rs.randint(0, D, (HKV, POOL, PAGE, K)).astype(np.uint8),
                "v": rs.randn(HKV, POOL, PAGE, DV).astype(np.float32)}
    if layout == "fm":
        return {"k_feat": rs.randn(HKV, POOL, D, PAGE).astype(np.float32),
                "v": rs.randn(HKV, POOL, PAGE, DV).astype(np.float32)}
    return {"k": rs.randn(HKV, POOL, PAGE, DV).astype(np.float32),
            "v": rs.randn(HKV, POOL, PAGE, DV).astype(np.float32)}


_CLASSES = {"sparse": (tkv.PagedSparseKV, jkv.PagedSparseKV),
            "fm": (tkv.PagedFeatureMajorKV, jkv.PagedFeatureMajorKV),
            "dense": (tkv.PagedDenseKV, jkv.PagedDenseKV)}


def _pair(layout, seed=0):
    rs = np.random.RandomState(seed)
    pools, bt = _pools(rs, layout), _block_table(rs)
    tcls, jcls = _CLASSES[layout]
    t = tcls(**{n: torch.from_numpy(a.copy()) for n, a in pools.items()},
             block_table=torch.from_numpy(bt))
    j = jcls(**{n: jnp.asarray(a) for n, a in pools.items()}, block_table=jnp.asarray(bt))
    return t, j


def _tokens(rs, layout, b, c):
    """One write's updates in the model's token-major form (b, c, hkv, F)."""
    if layout == "dense":
        return {"k": rs.randn(b, c, HKV, DV).astype(np.float32),
                "v": rs.randn(b, c, HKV, DV).astype(np.float32)}
    idx = np.sort(np.argsort(rs.rand(b, c, HKV, D), -1)[..., :K], -1).astype(np.int32)
    return {"k_vals": rs.randn(b, c, HKV, K).astype(np.float32), "k_idx": idx,
            "v": rs.randn(b, c, HKV, DV).astype(np.float32)}


def _same(t, j):
    for name, leaf in t._tensors():
        _eq(leaf, getattr(j, name))


@pytest.mark.parametrize("layout", ["sparse", "fm", "dense"])
def test_paged_write_and_gather_equal_jax(layout):
    """Ragged decode writes, slot 1 at a past-the-table sentinel (its write
    must go to the trash page, not the slot's last page), then the gathered
    views of every slot and of one slot."""
    t, j = _pair(layout)
    rs = np.random.RandomState(5)
    for pos in ([3, MP * PAGE, 17], [8, MP * PAGE + 5, 31]):
        up = _tokens(rs, layout, SLOTS, 1)
        p = np.asarray(pos, np.int32)
        t.write(torch.from_numpy(p), **{n: torch.from_numpy(a) for n, a in up.items()})
        j = j.write(jnp.asarray(p), **{n: jnp.asarray(a) for n, a in up.items()})
    _same(t, j)
    _same(t.gather(), j.gather())
    _same(t.gather_slot(2), j.gather_slot(jnp.int32(2)))
    # the sentinel writes went to the trash page only
    last_page = int(t.block_table[1, -1])
    np.testing.assert_array_equal(t.v[:, last_page].numpy(), _pair(layout)[0].v[:, last_page].numpy())


@pytest.mark.parametrize("layout", ["sparse", "fm", "dense"])
def test_paged_write_chunk_routes_past_the_table_to_trash(layout):
    """A chunk that runs past the block table (verify lookahead near
    max_len) writes its overflow into the trash page, exactly as JAX."""
    t, j = _pair(layout, seed=1)
    rs = np.random.RandomState(6)
    for start, c in ((5, 6), (MP * PAGE - 3, 5)):
        up = _tokens(rs, layout, 1, c)
        t.write_chunk(0, start, **{n: torch.from_numpy(a) for n, a in up.items()})
        j = j.write_chunk(jnp.int32(0), jnp.int32(start),
                          **{n: jnp.asarray(a) for n, a in up.items()})
    _same(t, j)
    _same(t.gather_slot(0), j.gather_slot(jnp.int32(0)))


@pytest.mark.parametrize("layout", ["sparse", "fm", "dense"])
def test_paged_insert_pages_equals_jax(layout):
    """A layer-stacked batch-1 prefill of 19 tokens lands in 3 whole pages
    (the last zero-padded) of a 2-layer stacked pool."""
    rs = np.random.RandomState(2)
    pools, bt = _pools(rs, layout), _block_table(rs)
    tcls, jcls = _CLASSES[layout]
    stacked = {n: np.stack([a, a + 1]) for n, a in pools.items()}
    t = tcls(**{n: torch.from_numpy(a.copy()) for n, a in stacked.items()},
             block_table=torch.from_numpy(bt))
    j = jcls(**{n: jnp.asarray(a) for n, a in stacked.items()},
             block_table=jnp.asarray(np.stack([bt, bt])))
    n = 19
    up = {k: np.stack([a, 2 * a]) for k, a in _tokens(rs, layout, 1, n).items()}
    if layout == "fm":          # the prefill's persistent image and V
        code = JaxCode(jnp.moveaxis(jnp.asarray(up["k_vals"]), 2, 3),
                       jnp.moveaxis(jnp.asarray(up["k_idx"]), 2, 3), D)
        src_j = jkv.FeatureMajorKV(k_feat=jax_to_feature_major(code),
                                   v=jnp.moveaxis(jnp.asarray(up["v"]), 2, 3))
        src_t = tkv.FeatureMajorKV(k_feat=torch.from_numpy(np.array(src_j.k_feat)),
                                   v=torch.from_numpy(np.array(src_j.v)))
    elif layout == "sparse":
        src_j = jkv.SparseKV(**{k: jnp.asarray(a) for k, a in up.items()})
        src_t = tkv.SparseKV(**{k: torch.from_numpy(a) for k, a in up.items()})
    else:
        src_j = jkv.DenseKV(**{k: jnp.asarray(a) for k, a in up.items()})
        src_t = tkv.DenseKV(**{k: torch.from_numpy(a) for k, a in up.items()})
    pids = bt[1, :3]
    t.insert_pages(src_t, torch.from_numpy(pids).long())
    j = j.insert_pages(src_j, jnp.asarray(pids))
    _same(t, j)
    j1 = dataclasses.replace(j, block_table=jnp.asarray(bt), **{
        n: getattr(j, n)[1] for n, _ in t._tensors()})
    _same(t.layer(1).gather_slot(1), j1.gather_slot(1))


def test_feature_major_write_and_insert_slot_equal_jax():
    """FeatureMajorKV keeps tokens last in k_feat (b, hkv, d, n) and at 2
    in v (b, hkv, n, dv): ragged writes and a slot insert (zero tail over a
    previous tenant) follow those axes, as JAX's _TOKEN_AXES do."""
    rs = np.random.RandomState(3)
    b, n = 2, 12
    kf = rs.randn(b, HKV, D, n).astype(np.float32)
    v = rs.randn(b, HKV, n, DV).astype(np.float32)
    t = tkv.FeatureMajorKV(k_feat=torch.from_numpy(kf.copy()), v=torch.from_numpy(v.copy()))
    j = jkv.FeatureMajorKV(k_feat=jnp.asarray(kf), v=jnp.asarray(v))
    up = _tokens(rs, "sparse", b, 1)
    pos = np.array([4, 11], np.int32)
    t.write(torch.from_numpy(pos), **{k: torch.from_numpy(a) for k, a in up.items()})
    j = j.write(jnp.asarray(pos), **{k: jnp.asarray(a) for k, a in up.items()})
    _same(t, j)
    assert tkv.FeatureMajorKV.token_axis("k_feat", stacked=True) == 4
    # stacked (L=2) insert of a 5-token prefill into slot 1
    tst = tkv.FeatureMajorKV.stack([t, t])
    jst = jkv.FeatureMajorKV(k_feat=jnp.stack([j.k_feat] * 2), v=jnp.stack([j.v] * 2))
    src = {"k_feat": rs.randn(2, 1, HKV, D, 5).astype(np.float32),
           "v": rs.randn(2, 1, HKV, 5, DV).astype(np.float32)}
    tst.insert_slot(tkv.FeatureMajorKV(**{k: torch.from_numpy(a) for k, a in src.items()}),
                    slot=1, max_len=n)
    jst = jst.insert_slot(jkv.FeatureMajorKV(**{k: jnp.asarray(a) for k, a in src.items()}),
                          slot=1, max_len=n)
    _same(tst, jst)


# --------------------------------------------------------------------------
# byte accounting
# --------------------------------------------------------------------------

def _pair_cfgs(jax_backend, torch_backend):
    jc = jax_get_config("gpt2-small-sfa8")
    tc = get_config("gpt2-small-sfa8")
    jc = dataclasses.replace(jc, attention=dataclasses.replace(
        jc.attention, decode_backend=jax_backend))
    tc = dataclasses.replace(tc, attention=dataclasses.replace(
        tc.attention, decode_backend=torch_backend))
    return jc, tc


@pytest.mark.parametrize("backends", [("pallas", "cuda"), ("pallas_fm", "cuda_fm")])
def test_cache_bytes_equal_jax(backends):
    """gpt2-small-sfa8 at full width, token-major and feature-major."""
    jc, tc = _pair_cfgs(*backends)
    assert tserve.cache_bytes_per_token(tc) == jserve.cache_bytes_per_token(jc)
    got = tserve.realized_cache_bytes_per_token(tc)
    assert got == jserve.realized_cache_bytes_per_token(jc)
    layout = "fm" if backends[1] == "cuda_fm" else "sfa"
    assert got == tserve.cache_bytes_per_token(tc)[layout]
    assert (tserve.paged_page_bytes(tc, page_size=128)
            == jserve.paged_page_bytes(jc, page_size=128))
