"""The split feature-major decode (rows 13-14), emulated on the CPU, and the
zero-length row of its plain versions.

``csrc/flash_sfa_decode_fm.cu`` cuts a row's tokens into runs of ``SPLIT``
positions by position alone; thread i of a run's block scores token i by
reading the query's kq feature rows of the dense image, s_j = scale·Σ_t
qv[t]·K_feat[qi[t], j] in t order (an index outside [0, d) adds nothing);
the run's max m, p_j = exp(s_j − m), four warps of 32 tokens add p_j·V_j in
warp order, and the run's (m, l, acc) goes to a workspace that the token-
major decode's merge kernel folds in run order (a zero-length row, no run,
gives 0). The emulation below does the same in plain torch through the
contiguous image and through the paged pools, and is held at 1e-5 (f32
outputs of magnitude ~1, sums in another order) against the port's plain
versions and the JAX package's Pallas kernels in interpret mode; the paged
addressing must give the contiguous one's bits.

Shapes: 8 slots x 2 query heads over 1 kv head (GQA group 2), d 64, pages of
64 tokens, 6 a slot (n_cap 384 = 3 runs), a shuffled block table; lengths
0, 1, SPLIT − 1, SPLIT, SPLIT + 1, 2·SPLIT + 1, n_cap and the
past-the-table sentinel n_cap + 1.
"""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_sfa_decode_fm, flash_sfa_decode_fm_paged
from repro_torch.kernels.flash_sfa_decode import SPLIT
from repro_torch.kernels.ref import flash_sfa_decode_fm_paged_ref, flash_sfa_decode_fm_ref
from test_torch_decode_split import WARP, merge, runs

# the module (repro.kernels re-exports a function of the same name)
jk = importlib.import_module("repro.kernels.flash_sfa_decode")

SLOTS, H, HKV, D, PAGE, MP = 8, 2, 1, 64, 64, 6
N_CAP = MP * PAGE
POOL = SLOTS * MP + 1
LENGTHS = np.array([0, 1, SPLIT - 1, SPLIT, SPLIT + 1, 2 * SPLIT + 1, N_CAP, N_CAP + 1],
                   np.int32)
TOL = 1e-5
CASES = [(32, 4), (64, 8), (128, 8)]


def run_partial(qv, qi, cols, v, *, d, scale):
    """The split kernel on one run: the query's (kq,) code, the run's image
    columns cols (d, m) and V rows (m, dv) -> (m, l, acc (dv,))."""
    part = torch.zeros(cols.shape[1])
    for t in range(qv.shape[0]):                   # t order; outside [0, d): nothing
        f = int(qi[t])
        if 0 <= f < d:
            part = part + qv[t] * cols[f]
    s = part * scale
    m = s.max()
    p = torch.exp(s - m)
    l, acc = torch.zeros(()), torch.zeros(v.shape[-1])
    for w in range(0, len(p), WARP):
        l = l + p[w:w + WARP].sum()
        acc = acc + p[w:w + WARP] @ v[w:w + WARP]
    return m, l, acc


def emulate(qv, qi, fetch, lengths, n_cap, *, d, scale, dv):
    """Every row through its runs: fetch(row, positions) -> (image columns
    (d, m), V rows (m, dv)) in the form's addressing. -> (out, partials)."""
    outs, partials = [], []
    for r in range(qv.shape[0]):
        parts = [run_partial(qv[r], qi[r], *fetch(r, torch.arange(j0, j1)), d=d, scale=scale)
                 for j0, j1 in runs(lengths[r], n_cap)]
        partials.append(parts)
        outs.append(merge(parts, dv))
    return torch.stack(outs), partials


def contiguous_fetch(kf, v, group):
    """Image (R, d, n) and V (R, n, dv): row r reads image row r // group."""
    return lambda r, j: (kf[r // group][:, j], v[r // group][j])


def paged_fetch(kf_pool, v_pool, bt, heads):
    """Pools (hkv, P, d, page) / (hkv, P, page, dv) through the block table:
    token j of slot r // heads at column j % page of pool page
    bt[slot, j // page], kv head (r % heads) // group."""
    page = v_pool.shape[2]
    group = heads // v_pool.shape[0]

    def fetch(r, j):
        hk, pages = (r % heads) // group, bt[r // heads].long()[j // page]
        return kf_pool[hk, pages, :, j % page].T, v_pool[hk, pages, j % page]
    return fetch


def _case(dv, k, seed=0):
    rs = np.random.RandomState(seed)
    bt = rs.permutation(np.arange(1, POOL))[:SLOTS * MP].reshape(SLOTS, MP).astype(np.int32)
    qi = np.sort(np.argsort(rs.rand(SLOTS * H, D), -1)[..., :k], -1).astype(np.int32)
    return {"kf": torch.from_numpy(rs.randn(HKV, POOL, D, PAGE).astype(np.float32)),
            "v": torch.from_numpy(rs.randn(HKV, POOL, PAGE, dv).astype(np.float32)),
            "bt": torch.from_numpy(bt), "lens": torch.from_numpy(LENGTHS),
            "qv": torch.from_numpy(rs.randn(SLOTS * H, k).astype(np.float32)),
            "qi": torch.from_numpy(qi)}


def _image(t):
    """The gathered contiguous image (slots·hkv, d, n_cap) and V."""
    bt = t["bt"].long()
    kf = t["kf"][:, bt].permute(1, 0, 3, 2, 4).reshape(SLOTS * HKV, D, N_CAP)
    v = t["v"][:, bt].transpose(0, 1).reshape(SLOTS * HKV, N_CAP, t["v"].shape[-1])
    return kf.contiguous(), v.contiguous()


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0, atol=TOL)


def test_zero_length_rows_give_zero_like_pallas():
    """The plain versions (what the wrappers run on CPU tensors) give 0 for
    a row of length 0 and a slot of length 0, as the Pallas kernels do (and
    the CUDA kernel), and agree with them elsewhere."""
    t = _case(32, 4, seed=5)
    kf, v = _image(t)
    lens = np.minimum(np.repeat(LENGTHS, H), N_CAP).astype(np.int32)
    lens[3] = 0                                    # a zero-length row inside slot 1
    got = flash_sfa_decode_fm(t["qv"], t["qi"], kf, v, torch.from_numpy(lens), group=H // HKV)
    want = np.asarray(jk.flash_sfa_decode_fm(
        jnp.asarray(t["qv"].numpy()), jnp.asarray(t["qi"].numpy()), jnp.asarray(kf.numpy()),
        jnp.asarray(v.numpy()), jnp.asarray(lens), group=H // HKV, interpret=True))
    zero = lens == 0
    assert zero.sum() == 3 and not want[zero].any() and not got[zero].any()
    _close(got, want)
    paged = flash_sfa_decode_fm_paged(t["qv"], t["qi"], t["kf"], t["v"], t["bt"], t["lens"],
                                      heads=H)
    want_p = np.asarray(jk.flash_sfa_decode_fm_paged(
        jnp.asarray(t["qv"].numpy()), jnp.asarray(t["qi"].numpy()), jnp.asarray(t["kf"].numpy()),
        jnp.asarray(t["v"].numpy()), jnp.asarray(t["bt"].numpy()), jnp.asarray(LENGTHS),
        heads=H, interpret=True))
    assert not want_p[:H].any() and not paged[:H].any()      # slot 0 has length 0
    _close(paged, want_p)


@pytest.mark.parametrize("dv,k", CASES)
def test_split_fm_matches_plain_and_pallas(dv, k):
    """Row 13 on the gathered image, every row at its slot's length."""
    t = _case(dv, k)
    kf, v = _image(t)
    lens = t["lens"].repeat_interleave(H)
    scale = D ** -0.5
    got, _ = emulate(t["qv"], t["qi"], contiguous_fetch(kf, v, H // HKV), lens, N_CAP, d=D,
                     scale=scale, dv=dv)
    clipped = lens.clamp(max=N_CAP)
    plain = flash_sfa_decode_fm(t["qv"], t["qi"], kf, v, clipped, group=H // HKV)
    assert torch.equal(plain, flash_sfa_decode_fm_ref(t["qv"], t["qi"], kf, v, clipped,
                                                      group=H // HKV))
    _close(got, plain)
    assert not got[lens == 0].any()
    want = jk.flash_sfa_decode_fm(jnp.asarray(t["qv"].numpy()), jnp.asarray(t["qi"].numpy()),
                                  jnp.asarray(kf.numpy()), jnp.asarray(v.numpy()),
                                  jnp.asarray(clipped.numpy()), block_n=SPLIT,
                                  group=H // HKV, interpret=True)
    _close(got, want)


@pytest.mark.parametrize("dv,k", CASES)
def test_split_fm_paged_matches_plain_pallas_and_contiguous_bits(dv, k):
    """Row 14 through the block table; the contiguous addressing on the
    gathered image splits every row into the same runs with the same
    partials, bit for bit."""
    t = _case(dv, k, seed=1)
    scale = D ** -0.5
    lens = t["lens"].repeat_interleave(H)
    got, parts = emulate(t["qv"], t["qi"], paged_fetch(t["kf"], t["v"], t["bt"], H), lens,
                         N_CAP, d=D, scale=scale, dv=dv)
    kf, v = _image(t)
    got_c, parts_c = emulate(t["qv"], t["qi"], contiguous_fetch(kf, v, H // HKV), lens, N_CAP,
                             d=D, scale=scale, dv=dv)
    assert torch.equal(got, got_c)
    for row, row_c in zip(parts, parts_c):
        assert len(row) == len(row_c)
        for run, run_c in zip(row, row_c):
            assert all(torch.equal(x, y) for x, y in zip(run, run_c))
    plain = flash_sfa_decode_fm_paged(t["qv"], t["qi"], t["kf"], t["v"], t["bt"], t["lens"],
                                      heads=H)
    assert torch.equal(plain, flash_sfa_decode_fm_paged_ref(
        t["qv"], t["qi"], t["kf"], t["v"], t["bt"], t["lens"], heads=H))
    _close(got, plain)
    want = jk.flash_sfa_decode_fm_paged(
        jnp.asarray(t["qv"].numpy()), jnp.asarray(t["qi"].numpy()), jnp.asarray(t["kf"].numpy()),
        jnp.asarray(t["v"].numpy()), jnp.asarray(t["bt"].numpy()), jnp.asarray(LENGTHS),
        heads=H, interpret=True)
    _close(got, want)


def test_split_fm_skips_indices_outside_d():
    """A query index outside [0, d) adds nothing, in the emulation and in
    the plain version alike."""
    t = _case(64, 8, seed=2)
    qi = t["qi"].clone()
    qi[::3, 0], qi[1::3, -1] = D + 3, -1
    kf, v = _image(t)
    lens = t["lens"].repeat_interleave(H).clamp(max=N_CAP)
    got, _ = emulate(t["qv"], qi, contiguous_fetch(kf, v, H // HKV), lens, N_CAP, d=D,
                     scale=D ** -0.5, dv=64)
    _close(got, flash_sfa_decode_fm(t["qv"], qi, kf, v, lens, group=H // HKV))
