"""The tensor-core ``code_grad_dw`` and ``code_grad_dx`` bodies' arithmetic,
emulated on the CPU.

``csrc/code_grad.cu``'s tensor-core dW body computes dWᵀ = Sᵀ·x as one GEMM
over the token axis: per token and head it sums a repeated index's code
values in f32, in code order, and keeps the sum as bf16 hi plus bf16 lo =
bf16(sum − hi) (a code without a duplicate is a bf16 input, exact in hi);
each chunk of 64 tokens adds its bf16 products hi·x and lo·x into an f32
accumulator, each token split keeps its own, and the splits add in order.
Its dx body computes dx = S·Wᵀ as one GEMM over the head-feature axis from
the same hi and lo tiles and w split into bf16 hi + lo = bf16(w − hi):
per head in order, per step of 64 features (32 at d 32 and 80), S_hi·W_hiᵀ +
S_hi·W_loᵀ + S_lo·W_hiᵀ into an f32 accumulator (S_lo·W_loᵀ, below 2^-16
of a product, is left out; a bf16 w has no lo). At code width 32 (a k-16
RoPE model's pair closure) the bodies are the same, with twice the packed
rows a stage; the dx body stages them twice rather than three times, which
moves no product and no sum, so one emulation serves every width. The
emulations below do the same in plain torch and are held against the port's plain versions (the
wrappers on CPU tensors) and the JAX package's Pallas ``code_grad_dw`` /
``code_grad_dx`` in interpret mode at the card's tolerance, rtol 1e-4 and
atol 1e-4·max (f32 sums in another order; ~16 bits of each summed
duplicate and of each f32 weight). Inputs are bf16 codes (and x), as on the
compact seam, with duplicates planted on every 7th row, padding rows,
indices outside [0, d), and the 2k pair closure of RoPE at k 8 and 16 (code
widths 16 and 32, the latter at d 64 and 128), at d 32, 64, 80, 128 and 256;
n, m and the head
count ragged to the bodies' 64-token chunks, 128-token and 128-column
blocks; w f32 (a strided per-head view of a packed weight) and bf16. On
exact inputs (codes in {-1, 1} with a 1 + 2^-9 duplicate and a w whose lo
part is zero, or no duplicate and a w with a nonzero lo part) the dx
emulation equals the plain version bit for bit.

The routing (which body a dtype and shape take, the token splits) is pure
Python and checked here too; the bodies themselves run on the card
(tests/test_torch_gpu.py, chip_smoke.py).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.code_grad import code_grad_dw as jax_code_grad_dw
from repro.kernels.code_grad import code_grad_dx as jax_code_grad_dx
from repro_torch.kernels import (
    body_counts, code_grad_dw, code_grad_dx, launch_counts, reset_launches,
)
from repro_torch.kernels.code_grad import (
    CUDA_CORE_SHAPES, TC_HEAD_DIMS, TC_KW, _DW_MAX_SPLITS, dw_feature_blocks, library,
    tc_splits, tensor_core_body,
)
from repro_torch.kernels.flash_sfa_bwd import pair_closure_indices
from repro_torch.kernels.ops import head_blocks
from repro_torch.kernels.ref import code_grad_dw_ref, code_grad_dx_ref

TOK = 64          # tokens of the body's chunk (csrc kTcTok)
H100_SMS = 132


def _bf16(a):
    return torch.from_numpy(np.asarray(a, np.float32)).bfloat16()


def _codes(rs, nh, n, d, k, closure):
    """bf16 code gradients (nh, n, kw) with planted duplicates, padding rows
    and out-of-range indices; ``closure``: kw = 2k on the pair closure of
    the k stored indices (both members of a pair stored -> a repeated
    index whose shares sum)."""
    idx = np.sort(np.argsort(rs.rand(nh, n, d), axis=-1)[..., :k], axis=-1)
    idx[:, 3::7, 1] = idx[:, 3::7, 0]             # duplicates sum
    idx[:, 9::11, -1] = d + 2                      # outside [0, d): adds nothing
    idx = torch.from_numpy(idx.astype(np.int32))
    if closure:
        idx = pair_closure_indices(idx, d).int()
    vals = _bf16(rs.randn(*idx.shape))
    vals[:, 5], idx[:, 5] = 0.0, 0                 # a padding row: index 0 repeated
    return vals, idx


def densify_hi_lo(vals, idx, d):
    """(H, n, kw) codes -> (hi, lo) (H, n, d), bf16 values in f32: each
    index's codes summed in f32 in code order, hi = bf16(sum), lo =
    bf16(sum − hi)."""
    ok = (idx >= 0) & (idx < d)
    at = torch.where(ok, idx, 0).long()
    v = torch.where(ok, vals.float(), 0.0)
    s = torch.zeros(idx.shape[:-1] + (d,))
    for u in range(idx.shape[-1]):                 # code order, one add each
        s.scatter_add_(-1, at[..., u:u + 1], v[..., u:u + 1])
    hi = s.bfloat16().float()
    return hi, (s - hi).bfloat16().float()


def emulate_dw(x, vals, idx, d, splits, split_len, lo_products=True):
    """The body: per split, per 64-token chunk, acc += hiᵀ·x (+ loᵀ·x), f32;
    the splits added in order. -> (H, m, d) f32."""
    hi, lo = densify_hi_lo(vals, idx, d)
    xf = x.float()
    n = x.shape[0]
    out = None
    for s in range(splits):
        acc = torch.zeros(hi.shape[0], x.shape[1], d)
        for c0 in range(s * split_len, min(n, (s + 1) * split_len), TOK):
            t = slice(c0, min(c0 + TOK, (s + 1) * split_len, n))
            acc = acc + torch.einsum("nm,hnd->hmd", xf[t], hi[:, t])
            if lo_products:
                acc = acc + torch.einsum("nm,hnd->hmd", xf[t], lo[:, t])
        out = acc if out is None else out + acc
    return out


def _close(got, want):
    want = torch.from_numpy(np.array(want))
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4 * want.abs().max().item())


CASES = [(3, 300, 200, 64, 8, False), (3, 300, 200, 64, 8, True), (5, 257, 136, 32, 8, True),
         (2, 190, 264, 128, 8, False), (2, 130, 128, 128, 8, True), (4, 64, 64, 32, 8, False),
         (2, 200, 136, 128, 16, True), (3, 130, 264, 64, 16, True), (3, 130, 136, 80, 8, False),
         (2, 130, 136, 256, 16, True)]


@pytest.mark.parametrize("nh,n,m,d,k,closure", CASES)
def test_tensor_core_dw_emulation_matches_plain_and_pallas(nh, n, m, d, k, closure):
    rs = np.random.RandomState(nh * 1000 + n + d)
    vals, idx = _codes(rs, nh, n, d, k, closure)
    x = _bf16(rs.randn(n, m))
    kw = idx.shape[-1]
    assert tensor_core_body(torch.bfloat16, d, kw, m)
    plain = code_grad_dw(x, vals, idx, d=d)        # the wrapper's CPU path
    assert torch.equal(plain, code_grad_dw_ref(x, vals, idx, d=d))
    want = jax_code_grad_dw(jnp.asarray(x.float().numpy()), jnp.asarray(vals.float().numpy()),
                            jnp.asarray(idx.numpy()), d=d, interpret=True)
    _close(plain, want)
    for splits, split_len in {tc_splits(n, nh, d, m, H100_SMS), tc_splits(n, nh, d, m, 10 ** 6),
                              (1, -(-n // TOK) * TOK)}:
        got = emulate_dw(x, vals, idx, d, splits, split_len)
        _close(got, plain)
        _close(got, want)


def test_duplicates_need_the_lo_tile():
    """On the pair closure with duplicates, rounding each summed duplicate
    once to bf16 (hi alone) moves dW by more than the tolerance; hi + lo
    does not."""
    rs = np.random.RandomState(3)
    nh, n, m, d = 2, 512, 128, 64
    idx = torch.from_numpy(np.sort(np.argsort(rs.rand(nh, n, d), -1)[..., :8], -1)
                           .astype(np.int32))
    idx[..., 1::2] = idx[..., 0::2]                # every code has a partner
    vals = torch.empty(nh, n, 8, dtype=torch.bfloat16)
    vals[..., 0::2] = _bf16(rs.randn(nh, n, 4))
    vals[..., 1::2] = _bf16(rs.randn(nh, n, 4) * 2 ** -5)   # sums need more than 8 bits
    x = _bf16(rs.randn(n, m))
    want = code_grad_dw_ref(x, vals, idx, d=d)
    _close(emulate_dw(x, vals, idx, d, 1, n), want)
    with pytest.raises(AssertionError):
        _close(emulate_dw(x, vals, idx, d, 1, n, lo_products=False), want)


def test_body_routing_by_dtype_and_shape():
    """bf16 with d in {32, 64, 80, 128, 256}, kw in {8, 16, 32} and m a
    multiple of 8 takes the tensor cores (80 and 256 from the wide source),
    but for width 32 at d 32 (CUDA_CORE_SHAPES: dW's staged rows would not
    fit a block's shared memory); f32 and every other shape the CUDA-core
    body."""
    assert TC_HEAD_DIMS == (32, 64, 80, 128, 256) and TC_KW == (8, 16, 32)
    for d in TC_HEAD_DIMS:
        assert library(d) == ("code_grad_wide" if d in (80, 256) else "code_grad")
    assert tensor_core_body(torch.bfloat16, 80, 16, 1280)     # hubert-xlarge's seam
    assert tensor_core_body(torch.bfloat16, 256, 32, 2048)    # paligemma-3b's, compact2
    assert CUDA_CORE_SHAPES == ((32, 32),)
    assert tensor_core_body(torch.bfloat16, 64, 8, 768)       # the compact seam
    assert tensor_core_body(torch.bfloat16, 64, 16, 768)      # its pair closure
    assert tensor_core_body(torch.bfloat16, 128, 32, 3072)    # llama3.2-3b's, k 16
    assert tensor_core_body(torch.bfloat16, 128, 32, 2048)    # moonshot's
    for m in range(8, 4097, 8):
        assert tensor_core_body(torch.bfloat16, 128, 32, m)
    for d in TC_HEAD_DIMS:
        for kw in TC_KW:
            assert tensor_core_body(torch.bfloat16, d, kw, 136) == ((d, kw) != (32, 32))
            assert not tensor_core_body(torch.float32, d, kw, 768)
            assert not tensor_core_body(torch.bfloat16, d, kw, 130)
    for d, kw in ((16, 8), (96, 8), (48, 16), (64, 4), (32, 32), (192, 32), (64, 64),
                  (32, 12), (128, 24), (80, 24), (256, 64)):
        assert not tensor_core_body(torch.bfloat16, d, kw, 768)


@pytest.mark.parametrize("n", [1, 63, 64, 65, 255, 256, 1000, 8191, 8192, 65536])
@pytest.mark.parametrize("nh,d,m", [(12, 64, 768), (3, 32, 200), (16, 128, 2048),
                                    (16, 80, 1280), (1, 256, 2048)])
def test_token_splits_cover_every_token_once(n, nh, d, m):
    """Whole 64-token chunks per split, none empty, every token in one
    split, and one wave of blocks on the H100's 132 SMs."""
    splits, split_len = tc_splits(n, nh, d, m, H100_SMS)
    assert split_len % TOK == 0 and 1 <= splits <= _DW_MAX_SPLITS
    assert (splits - 1) * split_len < n <= splits * split_len
    tiles = dw_feature_blocks(nh, d) * -(-m // 128)
    assert splits == 1 or splits * tiles <= H100_SMS
    assert splits == 1 or split_len >= 4 * TOK


def test_main_path_split_and_the_cuda_core_counter():
    """gpt2-small's compact seam (12 heads of 64 x 8,192 tokens, m 768): 36
    blocks of 128 x 128, 3 splits of 43 chunks; on the CPU the wrappers run
    the plain versions and count no launch of either body."""
    assert tc_splits(8192, 12, 64, 768, H100_SMS) == (3, 43 * TOK)
    assert {"code_grad_dx_cuda_core", "code_grad_dw_cuda_core"} <= set(body_counts())
    rs = np.random.RandomState(4)
    vals, idx = _codes(rs, 2, 80, 64, 8, False)
    reset_launches()
    code_grad_dw(_bf16(rs.randn(80, 96)), vals, idx, d=64)
    code_grad_dx(vals, idx, torch.from_numpy(rs.randn(2, 96, 64).astype(np.float32)), d=64)
    assert launch_counts()["code_grad_dw"] == launch_counts()["code_grad_dx"] == 0
    assert body_counts()["code_grad_dw_cuda_core"] == body_counts()["code_grad_dx_cuda_core"] == 0


# --------------------------------------------------------------------------
# dx
# --------------------------------------------------------------------------

def dx_step(d):
    """Features of the dx body's step (csrc DxSteps): 64 where 64 divides d,
    else 32 (d 80: three steps, the last half zero)."""
    return 64 if d % 64 == 0 else 32


def split_w(w):
    """w -> (hi, lo) f32 values of bf16 hi = bf16(w) and lo = bf16(w − hi)."""
    wf = w.float()
    hi = wf.bfloat16().float()
    return hi, (wf - hi).bfloat16().float()


def emulate_dx(vals, idx, w, d, lo_products=True, w_lo_products=True):
    """The dx body: per head in order, per step of ``dx_step(d)`` features,
    acc += S_hi·W_hiᵀ (+ S_hi·W_loᵀ) (+ S_lo·W_hiᵀ), f32 -> (n, m)."""
    hi, lo = densify_hi_lo(vals, idx, d)
    whi, wlo = split_w(w)
    acc = torch.zeros(vals.shape[1], w.shape[1])
    step = dx_step(d)
    for h in range(vals.shape[0]):
        for f0 in range(0, d, step):
            f = slice(f0, f0 + step)
            acc = acc + hi[h][:, f] @ whi[h][:, f].T
            if w_lo_products:
                acc = acc + hi[h][:, f] @ wlo[h][:, f].T
            if lo_products:
                acc = acc + lo[h][:, f] @ whi[h][:, f].T
    return acc


def _weights(rs, nh, m, d, bf16):
    """A strided per-head view of a packed (m, 2·nh·d) weight (the second
    block of nh heads, as ``head_blocks`` takes the key heads), f32 or
    bf16."""
    w = torch.from_numpy((0.05 * rs.randn(m, 2 * nh * d)).astype(np.float32))
    return head_blocks(w.bfloat16() if bf16 else w, nh, nh, d)


DX_CASES = [(3, 300, 200, 64, 8, False, False), (3, 300, 200, 64, 8, True, False),
            (12, 130, 768, 64, 8, False, False), (5, 257, 136, 32, 8, True, True),
            (2, 190, 264, 128, 8, False, True), (2, 130, 128, 128, 8, True, False),
            (4, 64, 64, 32, 8, False, False), (3, 200, 136, 128, 16, True, False),
            (2, 190, 264, 64, 16, True, True), (3, 130, 136, 80, 8, False, False),
            (2, 130, 264, 256, 16, True, True)]


@pytest.mark.parametrize("nh,n,m,d,k,closure,bf16_w", DX_CASES)
def test_tensor_core_dx_emulation_matches_plain_and_pallas(nh, n, m, d, k, closure, bf16_w):
    rs = np.random.RandomState(nh * 100 + n + m + d)
    vals, idx = _codes(rs, nh, n, d, k, closure)
    w = _weights(rs, nh, m, d, bf16_w)
    kw = idx.shape[-1]
    assert tensor_core_body(torch.bfloat16, d, kw, m)
    plain = code_grad_dx(vals, idx, w, d=d)        # the wrapper's CPU path
    assert torch.equal(plain, code_grad_dx_ref(vals, idx, w, d=d))
    want = jax_code_grad_dx(jnp.asarray(vals.float().numpy()), jnp.asarray(idx.numpy()),
                            jnp.asarray(w.float().numpy()), d=d, interpret=True)
    _close(plain, want)
    got = emulate_dx(vals, idx, w, d, w_lo_products=not bf16_w)
    _close(got, plain)
    _close(got, want)


@pytest.mark.parametrize("d,kw,dups", [(64, 8, True), (64, 8, False), (32, 16, True),
                                       (128, 16, False), (128, 8, True), (128, 32, True),
                                       (64, 32, False)])
def test_tensor_core_dx_emulation_is_exact_on_exact_inputs(d, kw, dups):
    """Codes in {-1, 1} (with dups every 7th row repeats its first index
    with 2^-9: a summed duplicate 1 + 2^-9 through the lo tile) against w in
    multiples of 1/16 (no lo part) with duplicates, or of 2^-12 (a nonzero
    lo part) without: every product and sum exact, the emulation equals the
    plain version bit for bit."""
    rs = np.random.RandomState(d + kw)
    nh, n, m = 5, 200, 136
    idx = np.sort(np.argsort(rs.rand(nh, n, d), -1)[..., :kw], -1).astype(np.int32)
    vals = rs.choice([-1.0, 1.0], size=(nh, n, kw)).astype(np.float32)
    if dups:
        idx[:, 3::7, 1], vals[:, 3::7, 1] = idx[:, 3::7, 0], 2.0 ** -9
    idx[:, 9::11, -1] = d + 1
    vals, idx = _bf16(vals), torch.from_numpy(idx)
    grid = 16 if dups else 4096
    w = torch.from_numpy(rs.randint(-grid // 2, grid // 2 + 1, (m, 2 * nh * d))
                         .astype(np.float32) / grid)
    wh = head_blocks(w, 0, nh, d)
    whi, wlo = split_w(wh)
    assert bool((wlo == 0).all()) == dups
    plain = code_grad_dx_ref(vals, idx, wh, d=d)
    assert torch.equal(emulate_dx(vals, idx, wh, d), plain)


def test_dx_needs_the_w_lo_products():
    """On random f32 w, rounding w once to bf16 (W_hi alone) moves dx by
    more than the tolerance; hi + lo does not."""
    rs = np.random.RandomState(5)
    nh, n, m, d = 4, 256, 128, 64
    vals, idx = _codes(rs, nh, n, d, 8, False)
    w = _weights(rs, nh, m, d, False)
    want = code_grad_dx_ref(vals, idx, w, d=d)
    _close(emulate_dx(vals, idx, w, d), want)
    with pytest.raises(AssertionError):
        _close(emulate_dx(vals, idx, w, d, w_lo_products=False), want)


def test_dx_duplicates_need_the_s_lo_products():
    """On the pair closure with duplicates, dropping S_lo·W_hiᵀ moves dx by
    more than the tolerance; keeping it (and leaving out S_lo·W_loᵀ) does
    not."""
    rs = np.random.RandomState(6)
    nh, n, m, d = 2, 512, 128, 64
    idx = torch.from_numpy(np.sort(np.argsort(rs.rand(nh, n, d), -1)[..., :8], -1)
                           .astype(np.int32))
    idx[..., 1::2] = idx[..., 0::2]                # every code has a partner
    vals = torch.empty(nh, n, 8, dtype=torch.bfloat16)
    vals[..., 0::2] = _bf16(rs.randn(nh, n, 4))
    vals[..., 1::2] = _bf16(rs.randn(nh, n, 4) * 2 ** -5)   # sums need more than 8 bits
    w = _weights(rs, nh, m, d, False)
    want = code_grad_dx_ref(vals, idx, w, d=d)
    _close(emulate_dx(vals, idx, w, d), want)
    with pytest.raises(AssertionError):
        _close(emulate_dx(vals, idx, w, d, lo_products=False), want)


def test_dx_body_routing_by_dtype_and_shape():
    """dx takes the tensor cores on the same rule as dW — bf16 codes, d in
    {32, 64, 80, 128, 256}, kw in {8, 16, 32} (not 32 at d 32), m a
    multiple of 8 —
    whatever w's dtype; f32 codes and every other shape take the CUDA-core
    body. On the CPU the wrapper counts neither body."""
    assert tensor_core_body(torch.bfloat16, 64, 8, 768)       # the compact seam's dx
    assert tensor_core_body(torch.bfloat16, 64, 16, 768)      # the pair closure's
    assert tensor_core_body(torch.bfloat16, 128, 32, 3072)    # llama3.2-3b's, k 16
    assert tensor_core_body(torch.bfloat16, 64, 32, 768)
    assert tensor_core_body(torch.bfloat16, 80, 16, 1280)     # hubert-xlarge's
    assert tensor_core_body(torch.bfloat16, 256, 32, 2048)    # paligemma-3b's pair closure
    assert not tensor_core_body(torch.bfloat16, 32, 32, 64)   # the reduced llama's
    assert not tensor_core_body(torch.float32, 128, 32, 3072)
    assert not tensor_core_body(torch.float32, 64, 8, 768)
    assert not tensor_core_body(torch.bfloat16, 64, 8, 772)
    assert not tensor_core_body(torch.bfloat16, 48, 8, 768)
    assert not tensor_core_body(torch.bfloat16, 64, 12, 768)
    rs = np.random.RandomState(7)
    vals, idx = _codes(rs, 3, 70, 64, 8, False)
    for bf16_w in (False, True):
        reset_launches()
        got = code_grad_dx(vals, idx, _weights(rs, 3, 72, 64, bf16_w), d=64)
        assert got.shape == (70, 72) and got.dtype == torch.float32
        assert launch_counts()["code_grad_dx"] == body_counts()["code_grad_dx_cuda_core"] == 0
