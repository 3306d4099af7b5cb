"""The split token-major decode's arithmetic (rows 10-12), emulated on the CPU.

``csrc/flash_sfa_decode.cu`` cuts a row's tokens into runs of ``SPLIT``
positions by position alone, scores a run in parallel (each token's k codes
gather the f32 query, an index outside [0, d) landing nowhere), takes the
run's max m and p_j = exp(s_j - m), adds p_j * V_j in four warps of 32
tokens summed in warp order, and writes the run's (m, l, acc); a second
kernel merges a row's runs in run order, a zero-length row (no run) giving
0 and a run with m = -inf weighing 0. The emulation below does the same in
plain torch through each form's addressing (contiguous leaves, paged pools
through the block table, one slot's verify rows) and is held at 1e-4 (f32
outputs, the sums in another order) against the port's plain versions and
the JAX package's Pallas kernels in interpret mode. It also checks that the
contiguous and the paged addressing split a row into the same runs with the
same partials, bit for bit: the equality the engines rely on.

Shapes: 8 slots x 4 query heads over 2 kv heads (GQA group 2), d 64, pages
of 64 tokens, 6 a slot (n_cap 384 = 3 runs), a shuffled block table;
lengths 0, 1, SPLIT - 1, SPLIT, SPLIT + 1, 2 SPLIT + 1, n_cap and the
past-the-table sentinel n_cap + 1, one per slot.
"""
import importlib
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_sfa_decode, flash_sfa_decode_multi, flash_sfa_decode_paged
from repro_torch.kernels.flash_sfa_decode import SPLIT
from repro_torch.kernels.ref import _pool_view, flash_sfa_decode_ref

# the module (repro.kernels re-exports a function of the same name)
jk = importlib.import_module("repro.kernels.flash_sfa_decode")

SLOTS, H, HKV, D, PAGE, MP = 8, 4, 2, 64, 64, 6
N_CAP = MP * PAGE
POOL = SLOTS * MP + 1
LENGTHS = np.array([0, 1, SPLIT - 1, SPLIT, SPLIT + 1, 2 * SPLIT + 1, N_CAP, N_CAP + 1],
                   np.int32)
WARP = 32
TOL = 1e-4
CASES = [(32, 2, np.int32), (64, 8, np.uint8), (128, 8, np.int32), (64, 2, np.uint8)]


def runs(length, n_cap):
    """The runs [j0, j1) of a row: SPLIT positions each, by position alone,
    over the first min(length, n_cap) tokens."""
    n = min(max(int(length), 0), n_cap)
    return [(j0, min(j0 + SPLIT, n)) for j0 in range(0, n, SPLIT)]


def run_partial(q, kv, ki, v, *, d, scale):
    """The split kernel on one run: q (d,), codes (m, kk), V (m, dv) ->
    (m, l, acc (dv,)). s_j = scale * sum_t kv[j,t] q[ki[j,t]] in t order;
    each warp's 32 tokens add p_j V_j in order, the warps in warp order."""
    ki = ki.long()
    part = torch.zeros(kv.shape[0])
    for t in range(kv.shape[1]):
        ok = (ki[:, t] >= 0) & (ki[:, t] < d)
        part = part + torch.where(ok, kv[:, t].float() * q[torch.where(ok, ki[:, t], 0)], 0.0)
    s = part * scale
    m = s.max()
    p = torch.exp(s - m)
    l, acc = torch.zeros(()), torch.zeros(v.shape[-1])
    for w in range(0, len(p), WARP):
        l = l + p[w:w + WARP].sum()
        acc = acc + p[w:w + WARP] @ v[w:w + WARP].float()
    return m, l, acc


def merge(parts, dv):
    """The merge kernel: a row's partials in run order."""
    if not parts:
        return torch.zeros(dv)                   # a zero-length row
    mx = max(float(m) for m, _, _ in parts)
    lsum, a = torch.zeros(()), torch.zeros(dv)
    for m, l, acc in parts:
        f = 0.0 if float(m) == -math.inf else math.exp(float(m) - mx)
        lsum, a = lsum + l * f, a + acc * f
    return a / max(float(lsum), 1e-30)


def emulate(q, fetch, lengths, n_cap, *, d, scale, dv):
    """Every row through its runs: fetch(row, positions) -> (kv, ki, v) of
    those tokens in the form's addressing. -> (out (rows, dv), partials)."""
    outs, partials = [], []
    for r in range(q.shape[0]):
        parts = [run_partial(q[r], *fetch(r, torch.arange(j0, j1)), d=d, scale=scale)
                 for j0, j1 in runs(lengths[r], n_cap)]
        partials.append(parts)
        outs.append(merge(parts, dv))
    return torch.stack(outs), partials


def contiguous_fetch(leaves, heads):
    """SparseKV leaves (b, n, hkv, F): row r reads batch r // heads, kv head
    (r % heads) // group, token j at [b, j, hk]."""
    group = heads // leaves[0].shape[2]
    return lambda r, j: tuple(t[r // heads, j, (r % heads) // group] for t in leaves)


def paged_fetch(pools, bt, heads, slot=None):
    """Pools (hkv, P, page, F) through the block table: token j of the slot
    (row // heads, or a fixed one) at [hk, bt[slot, j // page], j % page]."""
    page = pools[0].shape[2]
    group = heads // pools[0].shape[0]

    def fetch(r, j):
        s = r // heads if slot is None else slot
        pages = bt[s].long()[j // page]
        return tuple(t[(r % heads) // group, pages, j % page] for t in pools)
    return fetch


def _case(dv, kk, idx_dtype, seed=0):
    rs = np.random.RandomState(seed)
    idx = np.sort(np.argsort(rs.rand(HKV, POOL, PAGE, D), -1)[..., :kk], -1)
    # an index outside [0, d) lands nowhere
    idx[:, ::7, ::5, 0] = 200 if idx_dtype == np.uint8 else D + 5
    if idx_dtype == np.int32:
        idx[:, ::11, ::3, -1] = -1
    bt = rs.permutation(np.arange(1, POOL))[:SLOTS * MP].reshape(SLOTS, MP).astype(np.int32)
    return {"kv": torch.from_numpy(rs.randn(HKV, POOL, PAGE, kk).astype(np.float32)),
            "ki": torch.from_numpy(idx.astype(idx_dtype)),
            "v": torch.from_numpy(rs.randn(HKV, POOL, PAGE, dv).astype(np.float32)),
            "bt": torch.from_numpy(bt), "lens": torch.from_numpy(LENGTHS),
            "q": torch.from_numpy(rs.randn(SLOTS * H, D).astype(np.float32))}


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0, atol=TOL)


def test_runs_depend_on_the_length_only():
    """Boundaries sit at multiples of SPLIT whatever n_cap (or page size);
    the sentinel length past the table walks exactly n_cap tokens."""
    for length in LENGTHS:
        n = min(int(length), N_CAP)
        want = [(j, min(j + SPLIT, n)) for j in range(0, n, SPLIT)]
        assert runs(length, N_CAP) == want
        assert runs(length, 16 * N_CAP) == runs(min(int(length), 16 * N_CAP), 16 * N_CAP)
        assert runs(min(int(length), N_CAP), 4 * N_CAP) == want
    assert runs(0, N_CAP) == [] and runs(-3, N_CAP) == []
    assert runs(N_CAP + 1, N_CAP) == runs(N_CAP, N_CAP)
    assert [len(runs(n, N_CAP)) for n in (SPLIT - 1, SPLIT, SPLIT + 1)] == [1, 1, 2]


@pytest.mark.parametrize("dv,kk,idx_dtype", CASES)
def test_split_contiguous_matches_plain_and_pallas(dv, kk, idx_dtype):
    """Row 10 on the gathered SparseKV leaves (b, n, hkv, F)."""
    t = _case(dv, kk, idx_dtype)
    leaves = [_pool_view(t[n], t["bt"]).contiguous() for n in ("kv", "ki", "v")]
    lens = t["lens"].repeat_interleave(H)
    scale = D ** -0.5
    got, _ = emulate(t["q"], contiguous_fetch(leaves, H), lens, N_CAP, d=D, scale=scale, dv=dv)
    plain = flash_sfa_decode(t["q"], *leaves, lens, d=D)        # the wrapper's plain path
    _close(got, plain)
    assert torch.equal(plain, flash_sfa_decode_ref(t["q"], *leaves, lens, d=D))
    assert not plain[lens == 0].any()            # a row with no key gives 0
    folded = [np.repeat(x.permute(0, 2, 1, 3).numpy(), H // HKV, axis=1)
              .reshape(SLOTS * H, N_CAP, -1) for x in leaves]
    want = jk.flash_sfa_decode(jnp.asarray(t["q"].numpy()), *(jnp.asarray(x) for x in folded),
                               jnp.asarray(lens.numpy()), d=D, block_n=SPLIT, interpret=True)
    _close(got, want)


@pytest.mark.parametrize("dv,kk,idx_dtype", CASES)
def test_split_paged_matches_plain_pallas_and_contiguous_bits(dv, kk, idx_dtype):
    """Row 11 through the block table; the contiguous addressing on the
    gathered view splits every row into the same runs with the same
    partials, bit for bit."""
    t = _case(dv, kk, idx_dtype, seed=1)
    scale = D ** -0.5
    pools = (t["kv"], t["ki"], t["v"])
    got, parts = emulate(t["q"], paged_fetch(pools, t["bt"], H), t["lens"].repeat_interleave(H),
                         N_CAP, d=D, scale=scale, dv=dv)
    leaves = [_pool_view(x, t["bt"]).contiguous() for x in pools]
    got_c, parts_c = emulate(t["q"], contiguous_fetch(leaves, H), t["lens"].repeat_interleave(H),
                             N_CAP, d=D, scale=scale, dv=dv)
    assert torch.equal(got, got_c)
    for row, row_c in zip(parts, parts_c):
        assert len(row) == len(row_c)
        for run, run_c in zip(row, row_c):
            assert all(torch.equal(x, y) for x, y in zip(run, run_c))
    plain = flash_sfa_decode_paged(t["q"], *pools, t["bt"], t["lens"], d=D, heads=H)
    _close(got, plain)
    want = jk.flash_sfa_decode_paged(
        jnp.asarray(t["q"].numpy()), *(jnp.asarray(x.numpy()) for x in pools),
        jnp.asarray(t["bt"].numpy()), jnp.asarray(t["lens"].numpy()), d=D, heads=H,
        interpret=True)
    _close(got, want)


@pytest.mark.parametrize("dv,kk,idx_dtype", CASES)
def test_split_verify_rows_match_plain_pallas_and_paged_bits(dv, kk, idx_dtype):
    """Row 12: C = 8 queries of one slot at the LENGTHS; each row equals the
    paged emulation of that slot at its length bit for bit."""
    t = _case(dv, kk, idx_dtype, seed=2)
    scale = D ** -0.5
    pools = (t["kv"], t["ki"], t["v"])
    slot, c = 5, len(LENGTHS)
    lens = t["lens"].repeat_interleave(H)
    q = t["q"]
    got, _ = emulate(q, paged_fetch(pools, t["bt"], H, slot=slot), lens, N_CAP, d=D,
                     scale=scale, dv=dv)
    for i, length in enumerate(LENGTHS):
        one, _ = emulate(q[i * H:(i + 1) * H], paged_fetch(pools, t["bt"], H, slot=slot),
                         torch.full((H,), int(length)), N_CAP, d=D, scale=scale, dv=dv)
        assert torch.equal(got[i * H:(i + 1) * H], one)
    plain = flash_sfa_decode_multi(q, *pools, lens, d=D, heads=H, block_tables=t["bt"],
                                   slot=slot)
    _close(got, plain)
    view = [x[:, t["bt"][slot].long()].reshape(HKV, N_CAP, x.shape[-1]).numpy() for x in pools]
    folded = [np.repeat(x, H // HKV, axis=0) for x in view]              # (h, n, F)
    want = jk.flash_sfa_decode_multi(jnp.asarray(q.numpy()), *(jnp.asarray(x) for x in folded),
                                     jnp.asarray(lens.numpy()), d=D, heads=H, block_n=PAGE,
                                     interpret=True)
    assert got.shape == (c * H, dv)
    _close(got, want)
