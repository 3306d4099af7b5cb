"""The port's CUDA kernels against their plain versions, on the card.

Marked ``gpu``: each test decides in the ``cuda`` fixture, when it runs,
whether a card is present, and skips without one. This file imports nothing
of JAX, so it runs on a machine that has only the port's dependencies:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.kernels import (
    body_counts, code_grad_dw, code_grad_dx, flash_attention, flash_attention_bwd, flash_sfa,
    flash_sfa_bwd, flash_sfa_decode, flash_sfa_decode_fm, flash_sfa_decode_fm_paged,
    flash_sfa_decode_multi, flash_sfa_decode_paged, launch_counts, proj_rtopk,
    reset_launches, rtopk,
)
from repro_torch.kernels import ref
from repro_torch.kernels.code_grad import tensor_core_body as code_grad_tc
from repro_torch.models.layers import rope

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    """The card, or a skip: decided when the test runs, not at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _ties(seed, rows, d):
    rs = np.random.RandomState(seed)
    x = rs.randn(rows, d).astype(np.float32)
    x[::3, 1] = -x[::3, 0]
    x[1::3, 4:12] = x[1::3, 3:4]
    x[2::3, :] = np.round(x[2::3, :])
    x[::5, 2] = np.nan
    return x


def _codes(rs, bh, n, k, d):
    vals = rs.randn(bh, n, k).astype(np.float32)
    idx = np.sort(np.argsort(rs.rand(bh, n, d), axis=-1)[..., :k], axis=-1)
    return vals, idx.astype(np.int32)


def _special(seed, rows, d):
    """_ties' rows and the contract's edge values: a row of one magnitude
    (both signs), ±0 among subnormals, ±inf beside NaN."""
    rs = np.random.RandomState(seed + 1)
    x = _ties(seed, rows, d)
    x[3::7, :] = np.where(rs.rand(d) < 0.5, 1.5, -1.5)
    x[4::7, :] = np.where(rs.rand(d) < 0.5, 0.0, -0.0)
    x[4::7, ::5] = rs.randint(1, 4, size=(len(x[4::7]), len(range(0, d, 5)))) * 1e-39
    x[5::7, min(3, d - 1)] = np.inf
    x[5::7, min(7, d - 1)] = -np.inf
    return x


def _rtopk_exact(kv, ki, x, k):
    pv, pi = ref.rtopk_ref(x, k)
    assert torch.equal(ki.cpu(), pi)
    bits = torch.int16 if x.dtype == torch.bfloat16 else torch.int32
    assert torch.equal(kv.cpu().view(bits), pv.view(bits))


@pytest.mark.parametrize("d,k", [(32, 1), (32, 8), (32, 9), (32, 16), (64, 1), (64, 8),
                                 (64, 9), (64, 16), (128, 1), (128, 8), (128, 9), (128, 16),
                                 (20, 17), (256, 17), (20, 3), (256, 16), (256, 32),
                                 (64, 17), (64, 32), (128, 32)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rtopk_kernel_on_card(cuda, dtype, d, k):
    """Both bodies (the one-thread body at d 32/64/128 and k <= 16, on
    either side of its KL border 8 | 9; the warp body above k 16 and at d
    20 and 256) at 1 row, 96 (a decode step) and row counts that end in a
    part block, on either side of the one-lane threshold: indices equal to
    the plain version's, values bit-equal, and body_counts() shows the body."""
    rtopk_mod = __import__("sys").modules["repro_torch.kernels.rtopk"]
    one = rtopk_mod.one_thread_body(d, k)
    for rows in (1, 96, 1000, 40_001):
        x = torch.from_numpy(_special(7, rows, d)).to(dtype)
        reset_launches()
        kv, ki = rtopk(x.to(cuda), k)
        assert body_counts()["rtopk_warp"] == (0 if one else 1)
        assert launch_counts()["rtopk"] == 1
        _rtopk_exact(kv, ki, x, k)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("n,dv,dtype", [(1024, 64, torch.float32), (1000, 64, torch.float32),
                                        (333, 128, torch.float32), (1000, 64, torch.bfloat16),
                                        (333, 128, torch.bfloat16)])
def test_flash_sfa_kernel_on_card(cuda, n, dv, dtype, causal):
    rs = np.random.RandomState(8)
    qv, qi = _codes(rs, 12, n, 8, 64)
    kv, ki = _codes(rs, 12, n, 8, 64)
    kv[:, 3], ki[:, 3] = 0.0, 0                  # a padding row densifies to zero
    v = rs.randn(12, n, dv).astype(np.float32)
    args = [torch.from_numpy(a).to(cuda) for a in (qv, qi, kv, ki, v)]
    for i in (0, 2, 4):
        args[i] = args[i].to(dtype)
    ko, kl = flash_sfa(*args, d=64, causal=causal, return_residuals=True)
    po, pl = ref.flash_sfa_ref(*args, d=64, causal=causal, return_residuals=True)
    # f32: sums in another order, 1e-4; bf16 output: one bf16 ulp (2^-7 rel)
    rtol = 2 ** -7 if dtype == torch.bfloat16 else 0
    torch.testing.assert_close(ko.float(), po.float(), rtol=rtol, atol=1e-4)
    torch.testing.assert_close(kl, pl, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("h,hkv,idx_dtype,dtype", [
    (12, 12, torch.uint8, torch.bfloat16), (4, 2, torch.int32, torch.float32),
    (8, 8, torch.uint8, torch.float32)])
def test_flash_sfa_decode_kernel_on_card(cuda, h, hkv, idx_dtype, dtype):
    rs = np.random.RandomState(9)
    b, n, k, d, dv = 8, 2048, 8, 64, 64
    kv, ki = _codes(rs, b * n, hkv, k, d)
    lens = torch.from_numpy(np.repeat(rs.randint(0, n + 1, size=b), h).astype(np.int32))
    args = (torch.from_numpy(rs.randn(b * h, d).astype(np.float32)),
            torch.from_numpy(kv.reshape(b, n, hkv, k)).to(dtype),
            torch.from_numpy(ki.reshape(b, n, hkv, k)).to(idx_dtype),
            torch.from_numpy(rs.randn(b, n, hkv, dv).astype(np.float32)).to(dtype), lens)
    ko = flash_sfa_decode(*(a.to(cuda) for a in args), d=d)
    po = ref.flash_sfa_decode_ref(*args, d=d)
    live = (lens > 0)[:, None]                   # a zero-length row is 0 in the kernel
    torch.testing.assert_close(ko.cpu() * live, po * live, rtol=0, atol=1e-4)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("n,dv,k,dtype", [(1024, 64, 8, torch.float32), (1000, 64, 8, torch.float32),
                                          (333, 128, 32, torch.float32), (200, 32, 4, torch.float32),
                                          (1000, 64, 8, torch.bfloat16)])
def test_flash_sfa_bwd_kernel_on_card(cuda, n, dv, k, dtype, causal):
    rs = np.random.RandomState(10)
    d = 64
    qv, qi = _codes(rs, 12, n, k, d)
    kv, ki = _codes(rs, 12, n, k, d)
    kv[:, 3], ki[:, 3] = 0.0, 0                  # padding row: duplicates of index 0
    v, g = (rs.randn(12, n, dv).astype(np.float32) for _ in range(2))
    qv_, qi_, kv_, ki_, v_, g_ = (torch.from_numpy(a).to(cuda) for a in (qv, qi, kv, ki, v, g))
    qv_, kv_, v_, g_ = (t.to(dtype) for t in (qv_, kv_, v_, g_))
    o, lse = ref.flash_sfa_ref(qv_, qi_, kv_, ki_, v_, d=d, causal=causal, return_residuals=True)
    got = flash_sfa_bwd(qv_, qi_, kv_, ki_, v_, o, lse, g_, d=d, causal=causal)
    want = ref.flash_sfa_bwd_ref(qv_, qi_, kv_, ki_, v_, o, lse, g_, d=d, causal=causal)
    # f32: sums in another order, 1e-4; bf16 outputs: one bf16 ulp (2^-7 rel)
    rtol = 2 ** -7 if dtype == torch.bfloat16 else 0
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == b.dtype == dtype, name
        torch.testing.assert_close(a.float(), b.float(), rtol=rtol, atol=1e-4, msg=name)
    # dQ/dK exactly zero off the stored coordinates (Eq. 6's support)
    for grad, idx in ((got[0], qi_), (got[1], ki_)):
        off = ref._support(idx, d) == 0
        assert bool((grad[off] == 0).all())


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("n,d,dtype", [(1024, 64, torch.float32), (1000, 64, torch.float32),
                                       (333, 128, torch.float32), (200, 32, torch.float32),
                                       (1000, 64, torch.bfloat16), (1000, 32, torch.bfloat16),
                                       (333, 128, torch.bfloat16)])
def test_flash_attention_fwd_bwd_kernels_on_card(cuda, n, d, dtype, causal):
    rs = np.random.RandomState(11)
    q, k, v, g = (torch.from_numpy(rs.randn(12, n, d).astype(np.float32)).to(cuda).to(dtype)
                  for _ in range(4))
    ko, kl = flash_attention(q, k, v, causal=causal, return_residuals=True)
    po, pl = ref.flash_attention_ref(q, k, v, causal=causal, return_residuals=True)
    rtol = 2 ** -7 if dtype == torch.bfloat16 else 0
    torch.testing.assert_close(ko.float(), po.float(), rtol=rtol, atol=1e-4)
    torch.testing.assert_close(kl, pl, rtol=1e-5, atol=1e-4)
    got = flash_attention_bwd(q, k, v, po, pl, g, causal=causal)
    want = ref.flash_attention_bwd_ref(q, k, v, po, pl, g, causal=causal)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        torch.testing.assert_close(a.float(), b.float(), rtol=rtol, atol=1e-4, msg=name)


@pytest.mark.parametrize("d", [32, 64, 128])
def test_flash_attention_bwd_bf16_is_deterministic(cuda, d):
    # the tensor-core backward: one owner per output tile, no atomics
    rs = np.random.RandomState(12)
    q, k, v, g = (torch.from_numpy(rs.randn(12, 1000, d).astype(np.float32)).to(cuda)
                  .bfloat16() for _ in range(4))
    o, lse = flash_attention(q, k, v, return_residuals=True)
    first = flash_attention_bwd(q, k, v, o, lse, g)
    again = flash_attention_bwd(q, k, v, o, lse, g)
    assert all(torch.equal(a, b) for a, b in zip(first, again))


def test_wrappers_refuse_grad_outside_their_function(cuda):
    q = torch.randn(2, 64, 64, device=cuda, requires_grad=True)
    with pytest.raises(RuntimeError, match="not differentiable"):
        flash_attention(q, q, q)
    with pytest.raises(RuntimeError, match="not differentiable"):
        rtopk(q, 8)


@pytest.mark.parametrize("arch", ["gpt2-small-sfa8", "gpt2-small", "qwen3-0.6b-sfa8",
                                  "qwen3-0.6b", "llama3.2-3b", "paligemma-3b"])
def test_trainer_runs_the_backward_kernels(cuda, arch, tmp_path):
    """Three steps of reduced ``arch`` (qwen3 and llama with GQA, 2 kv
    heads; paligemma held at its head dim of 256, MQA): the forward and
    backward kernels launch as the layer count predicts, paligemma's bf16
    FlashSFA on the tensor-core bodies. llama takes the compact seam (RoPE,
    remat "codes") at its own sfa_k 16, so its codes are 2k = 32 wide; at
    the reduced head dim of 32 that width stays on code_grad's CUDA-core
    bodies (``code_grad.CUDA_CORE_SHAPES``; at d 128:
    ``test_llama_seam_at_its_own_head_dim_runs_no_cuda_core_body``)."""
    import dataclasses

    from repro_torch.configs.base import TrainPolicy
    from repro_torch.data import DataConfig
    from repro_torch.models.attention import clear_compact_seam_reports, compact_seam_reports
    from repro_torch.optim import OptimizerConfig
    from repro_torch.train import FTConfig, Trainer, TrainerConfig
    cfg, full = get_config(arch).reduced(), get_config(arch).attention
    if arch == "paligemma-3b":           # its own head dim (reduced() caps it at 32)
        cfg = dataclasses.replace(cfg, attention=dataclasses.replace(
            cfg.attention, head_dim=full.head_dim))
    elif full.rope:                      # GQA, and the model's own k
        cfg = dataclasses.replace(cfg, attention=dataclasses.replace(
            cfg.attention, num_kv_heads=2, sfa_k=full.sfa_k))
    seam = arch.startswith("llama")
    policy = (dict(remat="codes", bwd_emit="compact2", fwd_fuse=True) if seam
              else dict(remat="full"))
    tr = Trainer(cfg, OptimizerConfig(warmup_steps=2, total_steps=4),
                 DataConfig(vocab_size=cfg.vocab_size, seq_len=100, global_batch=2),
                 TrainerConfig(total_steps=3, policy=TrainPolicy.from_model(
                     cfg, backend="cuda", **policy), ft=FTConfig(ckpt_dir=str(tmp_path))),
                 device=cuda)
    clear_compact_seam_reports()
    reset_launches()
    hist = tr.train()
    assert all(np.isfinite(h["loss"]) for h in hist)
    counts, bodies, L = launch_counts(), body_counts(), 3 * cfg.num_layers
    if seam:
        assert [r.taken for r in compact_seam_reports()] == [True]
        assert cfg.attention.sfa_k == 16
        for name in ("proj_rtopk", "flash_sfa_block_skip", "code_grad_dx", "code_grad_dw"):
            assert counts[name] == 2 * L, (name, counts)
        assert counts["flash_sfa_bwd_compact"] == L and counts["rtopk"] == 0
        # width 2k = 32 at d 32 is the one (d, kw) of the tensor-core widths
        # and head dims that runs the CUDA-core bodies
        assert cfg.attention.head_dim == 32
        assert not code_grad_tc(torch.bfloat16, 32, 32, cfg.d_model)
        assert bodies["code_grad_dx_cuda_core"] == bodies["code_grad_dw_cuda_core"] == 2 * L
        assert bodies["rtopk_warp"] == 0
        return
    fwd, bwd = (("flash_sfa", "flash_sfa_bwd") if cfg.attention.sfa_k
                else ("flash_attention", "flash_attention_bwd"))
    # remat="full": each layer's forward runs twice per step, its backward once
    assert counts[fwd] == 2 * counts[bwd] == 2 * L
    if cfg.attention.sfa_k:
        # rtopk's one-thread body takes d <= 128; d 256 runs its warp body
        wide = cfg.attention.head_dim > 128
        assert counts["rtopk"] == 4 * L and bodies["rtopk_warp"] == (4 * L if wide else 0)
        assert bodies["flash_sfa_cuda_core"] == bodies["flash_sfa_bwd_cuda_core"] == 0


def test_engine_launches_every_kernel(cuda):
    from repro_torch.models.model import init
    from repro_torch.serve import DecodeEngine, EngineConfig
    cfg = get_config("gpt2-small-sfa8").reduced()
    model = init(cfg, device=cuda)
    eng = DecodeEngine(model, cfg, EngineConfig(max_slots=2, max_len=64))
    reset_launches()
    out = eng.generate(np.arange(1, 9), max_new_tokens=4)
    assert len(out) == 4
    serving = ("rtopk", "flash_sfa", "flash_sfa_decode")
    assert all(launch_counts()[name] > 0 for name in serving)


def test_qwen3_engine_launches_the_decode_kernels_with_gqa(cuda):
    """Reduced qwen3-0.6b-sfa8 with 2 kv heads (a group of 2) through the
    slot engine: one decode launch per layer and step, no fallback."""
    import dataclasses

    from repro_torch.models.backends import clear_fallback_reports, fallback_reports
    from repro_torch.models.model import init
    from repro_torch.serve import DecodeEngine, EngineConfig
    cfg = get_config("qwen3-0.6b-sfa8").reduced()
    cfg = dataclasses.replace(cfg, attention=dataclasses.replace(
        cfg.attention, num_kv_heads=2, backend="cuda", decode_backend="cuda"))
    model = init(cfg, device=cuda)
    eng = DecodeEngine(model, cfg, EngineConfig(max_slots=2, max_len=64))
    clear_fallback_reports()
    reset_launches()
    out = eng.generate(np.arange(1, 9), max_new_tokens=4)
    assert len(out) == 4 and not fallback_reports()
    counts = launch_counts()
    assert counts["flash_sfa"] == cfg.num_layers
    assert counts["flash_sfa_decode"] == 3 * cfg.num_layers
    assert counts["rtopk"] > 0 and body_counts()["rtopk_warp"] == 0


# --------------------------------------------------------------------------
# the compact training seam's kernels
# --------------------------------------------------------------------------

def near_tie_rows(y, idx_a, idx_b, k, rel):
    """Rows of y (..., d) whose top-k index sets differ between idx_a and
    idx_b, and whether each has its k-th and (k+1)-th magnitudes within
    ``rel`` of each other (relative to the k-th)."""
    diff = (idx_a.sort(-1).values != idx_b.sort(-1).values).any(-1)
    mags = y.float().abs().sort(-1, descending=True).values
    kth, nxt = mags[..., k - 1], mags[..., k]
    return diff, (kth - nxt) <= rel * kth


@pytest.mark.parametrize("d", [32, 64, 128])
@pytest.mark.parametrize("rope_on", [False, True])
def test_proj_rtopk_kernel_on_card_exact_inputs(cuda, d, rope_on):
    """Dyadic f32 inputs: every sum is exact in any order, so indices are
    equal and values bit-equal (ties planted by the small integer grid).
    With RoPE the angle pos·θ^(-2j/d) carries about one ulp of itself
    (pos·2^-24) from the frequency table's pow on the card against the
    CPU's (``ref.rope_freqs`` on each device), so rotated
    values may differ by about n·2^-23 relative, and rows may change index
    only at a near-tie of that size."""
    rs = np.random.RandomState(12)
    b, n, m, nh, k = 2, 200, 96, 3, 8
    x = torch.from_numpy(rs.randint(-4, 5, size=(b, n, m)).astype(np.float32) / 4)
    w = torch.from_numpy(rs.randint(-8, 9, size=(m, nh * d)).astype(np.float32) / 16)
    wh = w.reshape(m, nh, d).permute(1, 0, 2)          # strided per-head view
    pos = torch.arange(n)[None, :].expand(b, n)
    spec = (10_000.0, d) if rope_on else None
    kv, ki = proj_rtopk(x.to(cuda), wh.to(cuda), pos.to(cuda) if rope_on else None, k=k,
                        rope_spec=spec)
    pv, pi = ref.proj_rtopk_ref(x, wh, pos if rope_on else None, k=k, rope_spec=spec)
    if not rope_on:
        assert torch.equal(ki.cpu(), pi)
        assert torch.equal(kv.cpu(), pv)
    else:
        y = rope(torch.einsum("bnm,hmd->bnhd", x, wh), pos, theta=1e4,
                 rot_dim=d).transpose(1, 2)
        rel = n * 2.0 ** -22
        diff, tie = near_tie_rows(y, ki.cpu(), pi, k, rel)
        assert bool((tie | ~diff).all())
        same = ~diff
        torch.testing.assert_close(kv.cpu()[same], pv[same], rtol=rel,
                                   atol=rel * float(pv.abs().max()))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_proj_rtopk_kernel_on_card_random(cuda, dtype):
    """Random inputs: the f32 sum order differs from the plain einsum's, so
    a row may pick another index only where its k-th and (k+1)-th
    magnitudes are within two roundings (bf16: 2 ulps; f32: the sums' own
    error, up to sqrt(m) ulps — 64)."""
    rs = np.random.RandomState(13)
    b, n, m, nh, d, k = 2, 512, 768, 4, 64, 8
    x = torch.from_numpy(rs.randn(b, n, m).astype(np.float32)).to(dtype)
    w = torch.from_numpy((0.04 * rs.randn(nh, m, d)).astype(np.float32))
    kv, ki = proj_rtopk(x.to(cuda), w.to(cuda), k=k)
    pv, pi = ref.proj_rtopk_ref(x, w, k=k)
    y = torch.einsum("bnm,hmd->bhnd", x.float(), w.to(dtype).float()).to(dtype)
    rel = 2 * 2.0 ** -7 if dtype == torch.bfloat16 else 64 * 2.0 ** -23
    diff, tie = near_tie_rows(y, ki.cpu(), pi, k, rel)
    assert bool((tie | ~diff).all()), int(diff.sum())
    rtol = 2 ** -7 if dtype == torch.bfloat16 else 1e-5
    torch.testing.assert_close(kv.cpu()[~diff].float(), pv[~diff].float(), rtol=rtol, atol=1e-5)


@pytest.mark.parametrize("nh,n,m,d,kw,dtype", [
    (12, 8192 // 4, 768, 64, 8, torch.bfloat16), (3, 200, 96, 64, 16, torch.float32),
    (2, 70, 130, 32, 4, torch.float32), (4, 300, 256, 128, 64, torch.float32)])
def test_code_grad_kernels_on_card(cuda, nh, n, m, d, kw, dtype):
    rs = np.random.RandomState(14)
    vals, idx = _codes(rs, nh, n, kw, d)
    idx[:, 3::7, 1] = idx[:, 3::7, 0]                 # duplicates sum
    idx[:, 9::11, -1] = d                             # outside [0, d): nothing
    tv = torch.from_numpy(vals).to(dtype)
    ti = torch.from_numpy(idx)
    w = torch.from_numpy(rs.randn(m, nh * d).astype(np.float32))
    wh = w.reshape(m, nh, d).permute(1, 0, 2)
    x = torch.from_numpy(rs.randn(n, m).astype(np.float32)).to(dtype)
    dx = code_grad_dx(tv.to(cuda), ti.to(cuda), wh.to(cuda), d=d)
    dw = code_grad_dw(x.to(cuda), tv.to(cuda), ti.to(cuda), d=d)
    # f32 outputs, sums in another order: 1e-4 relative to the magnitude
    want_dx = ref.code_grad_dx_ref(tv, ti, wh, d=d)
    want_dw = ref.code_grad_dw_ref(x, tv, ti, d=d)
    torch.testing.assert_close(dx.cpu(), want_dx, rtol=1e-4, atol=1e-4 * want_dx.abs().max())
    torch.testing.assert_close(dw.cpu(), want_dw, rtol=1e-4, atol=1e-4 * want_dw.abs().max())


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("banded", [True, False])
def test_flash_sfa_block_skip_kernel_on_card(cuda, causal, banded):
    """Banded codes (tile t on features 8·(t mod 8)..+7) send most tile
    pairs down the closed form; random codes mostly compute."""
    from repro_torch.kernels import block_skip_stats
    rs = np.random.RandomState(15)
    bh, n, d, k = 12, 1000, 64, 8
    if banded:
        band = (np.arange(n) // 64) % 8
        qi = np.broadcast_to((band[:, None] * k + np.arange(k)).astype(np.int32), (bh, n, k))
        qv = rs.randn(bh, n, k).astype(np.float32)
        kv, ki = rs.randn(bh, n, k).astype(np.float32), qi.copy()
    else:
        qv, qi = _codes(rs, bh, n, k, d)
        kv, ki = _codes(rs, bh, n, k, d)
    v = rs.randn(bh, n, 64).astype(np.float32)
    args = [torch.from_numpy(np.ascontiguousarray(a)).to(cuda) for a in (qv, qi, kv, ki, v)]
    s0, s1, s2 = block_skip_stats(*args[:4], d=d, causal=causal)
    assert (s1 > 0.5 * (1 - s0)) == banded          # of the live tile pairs
    ko, kl = flash_sfa(*args, d=d, causal=causal, return_residuals=True, block_skip=True)
    po, pl = ref.flash_sfa_ref(*args, d=d, causal=causal, return_residuals=True)
    torch.testing.assert_close(ko, po, rtol=0, atol=1e-4)
    torch.testing.assert_close(kl, pl, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", [80, 256])
def test_flash_sfa_block_skip_closed_form_at_wide_dims_on_card(cuda, d, causal):
    """The block-skip schedule on the wide tensor-core bodies (d 80: the
    closed form leaves the padding columns 80-95 alone; d 256: both
    warpgroups of a block read the one level of their shared rows, each
    its column half of vsum) on banded bf16 codes, k 16, which send most
    live tile pairs down the closed form, against the plain version."""
    from repro_torch.kernels import block_skip_stats
    rs = np.random.RandomState(16)
    bh, n, k = 4, 1000, 16
    band = (np.arange(n) // 64) % (d // k)
    qi = np.broadcast_to((band[:, None] * k + np.arange(k)).astype(np.int32), (bh, n, k))
    qv, kv = rs.randn(bh, n, k).astype(np.float32), rs.randn(bh, n, k).astype(np.float32)
    v = rs.randn(bh, n, d).astype(np.float32)
    args = [torch.from_numpy(np.ascontiguousarray(a)).to(cuda) for a in (qv, qi, kv, qi, v)]
    for i in (0, 2, 4):
        args[i] = args[i].bfloat16()
    s0, s1, _ = block_skip_stats(*args[:4], d=d, causal=causal)
    assert s1 > 0.5 * (1 - s0)
    reset_launches()
    ko, kl = flash_sfa(*args, d=d, causal=causal, return_residuals=True, block_skip=True)
    assert body_counts()["flash_sfa_cuda_core"] == 0
    po, pl = ref.flash_sfa_ref(*args, d=d, causal=causal, return_residuals=True)
    torch.testing.assert_close(ko.float(), po.float(), rtol=2 ** -7, atol=1e-4)
    torch.testing.assert_close(kl, pl, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("emit,rot", [("compact", 64), ("compact2", 64), ("compact2", 32)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_sfa_bwd_compact_emits_on_card(cuda, emit, rot, dtype):
    rs = np.random.RandomState(16)
    n, d, k = 1000, 64, 8
    qv, qi = _codes(rs, 12, n, k, d)
    kv, ki = _codes(rs, 12, n, k, d)
    kv[:, 3], ki[:, 3] = 0.0, 0                  # padding row: duplicates of index 0
    v, g = (rs.randn(12, n, d).astype(np.float32) for _ in range(2))
    qv_, qi_, kv_, ki_, v_, g_ = (torch.from_numpy(a).to(cuda) for a in (qv, qi, kv, ki, v, g))
    qv_, kv_, v_, g_ = (t.to(dtype) for t in (qv_, kv_, v_, g_))
    o, lse = ref.flash_sfa_ref(qv_, qi_, kv_, ki_, v_, d=d, return_residuals=True)
    got = flash_sfa_bwd(qv_, qi_, kv_, ki_, v_, o, lse, g_, d=d, emit=emit, rot_dim=rot)
    want = ref.flash_sfa_bwd_ref(qv_, qi_, kv_, ki_, v_, o, lse, g_, d=d, emit=emit,
                                 rot_dim=rot)
    rtol = 2 ** -7 if dtype == torch.bfloat16 else 0
    width = k if emit == "compact" else 2 * k
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == b.dtype == dtype and a.shape == b.shape, name
        torch.testing.assert_close(a.float(), b.float(), rtol=rtol, atol=1e-4, msg=name)
    assert got[0].shape[-1] == width


@pytest.mark.parametrize("sfa_k", [4, 8])
def test_trainer_runs_the_compact_seam_kernels(cuda, sfa_k, tmp_path):
    """TrainPolicy(bwd_emit="compact", fwd_fuse=True, remat="codes"): per
    step and layer proj_rtopk 2 (q, k), block-skip FlashSFA 2 (forward and
    the backward's rerun), the compact backward 1, code_grad dx and dW 2
    each (q and k); no rtopk and no plain-schedule FlashSFA. At the full
    model's k 8 the bf16 seam runs no CUDA-core body; at the reduced
    config's k 4 (no tensor-core code width of dx and dW) every dx and dW
    launch runs its CUDA-core body, and proj_rtopk, routed by d and m
    alone, still runs none."""
    import dataclasses

    import repro_torch.kernels.code_grad as cg
    from repro_torch.configs.base import TrainPolicy
    from repro_torch.data import DataConfig
    from repro_torch.optim import OptimizerConfig
    from repro_torch.train import FTConfig, Trainer, TrainerConfig
    cfg = get_config("gpt2-small-sfa8").reduced()
    cfg = dataclasses.replace(cfg, attention=dataclasses.replace(cfg.attention, sfa_k=sfa_k))
    assert cfg.dtype == "bfloat16"
    steps = 3
    tr = Trainer(cfg, OptimizerConfig(warmup_steps=2, total_steps=4),
                 DataConfig(vocab_size=cfg.vocab_size, seq_len=100, global_batch=2),
                 TrainerConfig(total_steps=steps, policy=TrainPolicy.from_model(
                     cfg, remat="codes", bwd_emit="compact", fwd_fuse=True,
                     backend="cuda"), ft=FTConfig(ckpt_dir=str(tmp_path))), device=cuda)
    reset_launches()
    hist = tr.train()
    assert all(np.isfinite(h["loss"]) for h in hist)
    per = steps * cfg.num_layers
    want = dict.fromkeys(launch_counts(), 0)
    want.update(proj_rtopk=2 * per, flash_sfa_block_skip=2 * per,
                flash_sfa_bwd_compact=per, code_grad_dx=2 * per, code_grad_dw=2 * per)
    assert launch_counts() == want
    want_body = dict.fromkeys(body_counts(), 0)
    tc = cg.tensor_core_body(torch.bfloat16, cfg.attention.head_dim, sfa_k, cfg.d_model)
    assert tc == (sfa_k == 8)
    if not tc:
        want_body.update(code_grad_dx_cuda_core=2 * per, code_grad_dw_cuda_core=2 * per)
    assert body_counts() == want_body


def test_llama_seam_at_its_own_head_dim_runs_no_cuda_core_body(cuda, tmp_path):
    """llama3.2-3b's RoPE compact seam at its own head dim 128 and sfa_k
    16 (reduced otherwise: 2 layers, 4 query heads over 2 kv heads, d_model
    64; batch 2 x 100, bf16, remat "codes"): its 2k = 32 wide codes run
    code_grad dx and dW on their tensor-core bodies, launches as the layer
    count predicts, no CUDA-core body of any kernel."""
    import dataclasses

    from repro_torch.configs.base import TrainPolicy
    from repro_torch.data import DataConfig
    from repro_torch.models.attention import clear_compact_seam_reports, compact_seam_reports
    from repro_torch.optim import OptimizerConfig
    from repro_torch.train import FTConfig, Trainer, TrainerConfig
    full = get_config("llama3.2-3b")
    cfg = full.reduced()
    cfg = dataclasses.replace(cfg, attention=dataclasses.replace(
        cfg.attention, num_kv_heads=2, head_dim=full.attention.head_dim,
        sfa_k=full.attention.sfa_k))
    assert cfg.num_layers == 2 and cfg.dtype == "bfloat16"
    assert (cfg.attention.head_dim, cfg.attention.sfa_k) == (128, 16)
    assert code_grad_tc(torch.bfloat16, 128, 32, cfg.d_model)
    steps = 3
    tr = Trainer(cfg, OptimizerConfig(warmup_steps=2, total_steps=4),
                 DataConfig(vocab_size=cfg.vocab_size, seq_len=100, global_batch=2),
                 TrainerConfig(total_steps=steps, policy=TrainPolicy.from_model(
                     cfg, remat="codes", bwd_emit="compact2", fwd_fuse=True,
                     backend="cuda"), ft=FTConfig(ckpt_dir=str(tmp_path))), device=cuda)
    clear_compact_seam_reports()
    reset_launches()
    hist = tr.train()
    assert all(np.isfinite(h["loss"]) for h in hist)
    assert [r.taken for r in compact_seam_reports()] == [True]
    per = steps * cfg.num_layers
    want = dict.fromkeys(launch_counts(), 0)
    want.update(proj_rtopk=2 * per, flash_sfa_block_skip=2 * per,
                flash_sfa_bwd_compact=per, code_grad_dx=2 * per, code_grad_dw=2 * per)
    assert launch_counts() == want
    assert body_counts() == dict.fromkeys(body_counts(), 0)


# --------------------------------------------------------------------------
# the paged, multi-query and feature-major decode kernels (rows 11-14)
# --------------------------------------------------------------------------

def _paged_case(rs, dtype, slots=4, h=4, hkv=2, d=64, k=8, dv=64, page=16, mp=5):
    """Pools (hkv, P, page, F) with a shuffled block table and ragged
    lengths, slot 1 at the past-the-table sentinel."""
    pool = slots * mp + 1
    ki = np.sort(np.argsort(rs.rand(hkv, pool, page, d), -1)[..., :k], -1).astype(np.uint8)
    bt = rs.permutation(np.arange(1, pool))[:slots * mp].reshape(slots, mp).astype(np.int32)
    lens = rs.randint(1, mp * page + 1, size=slots).astype(np.int32)
    lens[1] = mp * page + 1
    t = {"kv": torch.from_numpy(rs.randn(hkv, pool, page, k).astype(np.float32)).to(dtype),
         "ki": torch.from_numpy(ki),
         "v": torch.from_numpy(rs.randn(hkv, pool, page, dv).astype(np.float32)).to(dtype),
         "kf": torch.from_numpy(rs.randn(hkv, pool, d, page).astype(np.float32)).to(dtype),
         "bt": torch.from_numpy(bt), "lens": torch.from_numpy(lens),
         "q": torch.from_numpy(rs.randn(slots * h, d).astype(np.float32)),
         "qv": torch.from_numpy(rs.randn(slots * h, k).astype(np.float32)),
         "qi": torch.from_numpy(np.sort(np.argsort(rs.rand(slots * h, d), -1)[..., :k],
                                        -1).astype(np.int32))}
    return t, dict(slots=slots, h=h, hkv=hkv, d=d, page=page, mp=mp)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_and_multi_decode_kernels_on_card(cuda, dtype):
    """Row 11 against its plain version and bit-equal to row 10 on the
    gathered view; each row of row 12 bit-equal to row 11 at its length."""
    t, c = _paged_case(np.random.RandomState(10), dtype)
    g = {n: x.to(cuda) for n, x in t.items()}
    h, d = c["h"], c["d"]
    ko = flash_sfa_decode_paged(g["q"], g["kv"], g["ki"], g["v"], g["bt"], g["lens"], d=d,
                                heads=h)
    po = ref.flash_sfa_decode_paged_ref(t["q"], t["kv"], t["ki"], t["v"], t["bt"], t["lens"],
                                        d=d, heads=h)
    torch.testing.assert_close(ko.cpu(), po, rtol=0, atol=1e-4)
    view = [ref._pool_view(g[n], g["bt"]).contiguous() for n in ("kv", "ki", "v")]
    assert torch.equal(ko, flash_sfa_decode(g["q"], *view, g["lens"].repeat_interleave(h), d=d))
    slot, C = 2, 3
    start = int(t["lens"][slot]) - C
    qm = g["q"][:C * h]
    lm = (start + torch.arange(C, device=cuda) + 1).repeat_interleave(h).int()
    mo = flash_sfa_decode_multi(qm, g["kv"], g["ki"], g["v"], lm, d=d, heads=h,
                                block_tables=g["bt"], slot=slot)
    for i in range(C):
        lens = g["lens"].clone()
        lens[slot] = start + i + 1
        q = g["q"].clone()
        q[slot * h:(slot + 1) * h] = qm[i * h:(i + 1) * h]
        one = flash_sfa_decode_paged(q, g["kv"], g["ki"], g["v"], g["bt"], lens, d=d, heads=h)
        assert torch.equal(mo[i * h:(i + 1) * h], one[slot * h:(slot + 1) * h])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_feature_major_decode_kernels_on_card(cuda, dtype):
    """Rows 13 and 14 against their plain versions; row 14 bit-equal to
    row 13 on the gathered image."""
    t, c = _paged_case(np.random.RandomState(11), dtype)
    g = {n: x.to(cuda) for n, x in t.items()}
    h, hkv, d = c["h"], c["hkv"], c["d"]
    ko = flash_sfa_decode_fm_paged(g["qv"], g["qi"], g["kf"], g["v"], g["bt"], g["lens"],
                                   heads=h)
    po = ref.flash_sfa_decode_fm_paged_ref(t["qv"], t["qi"], t["kf"], t["v"], t["bt"],
                                           t["lens"], heads=h)
    torch.testing.assert_close(ko.cpu(), po, rtol=0, atol=1e-4)
    bt = g["bt"].long()
    n = c["mp"] * c["page"]
    kf = g["kf"][:, bt].permute(1, 0, 3, 2, 4).reshape(-1, d, n).contiguous()
    v = g["v"][:, bt].transpose(0, 1).reshape(-1, n, g["v"].shape[-1]).contiguous()
    lens = g["lens"].repeat_interleave(h)
    fo = flash_sfa_decode_fm(g["qv"], g["qi"], kf, v, lens, group=h // hkv)
    assert torch.equal(fo, ko)
    fp = ref.flash_sfa_decode_fm_ref(t["qv"], t["qi"], kf.cpu(), v.cpu(), lens.cpu(),
                                     group=h // hkv)
    torch.testing.assert_close(fo.cpu(), fp, rtol=0, atol=1e-4)


def _misaligned(t):
    """The same content one element past an aligned base: the kernels take
    their scalar loads where the vector loads' alignment fails."""
    return torch.cat([torch.zeros_like(t[..., :1]), t], -1)[..., 1:]


@pytest.mark.parametrize("dv,kk,idx_dtype,dtype,page", [
    (32, 2, torch.uint16, torch.float32, 48), (128, 8, torch.int32, torch.float32, 128),
    (64, 8, torch.uint8, torch.bfloat16, 48), (128, 2, torch.uint16, torch.bfloat16, 128),
    (32, 8, torch.int32, torch.bfloat16, 128), (64, 8, torch.uint16, torch.float32, 48)])
def test_split_decode_kernels_at_run_boundaries_on_card(cuda, dv, kk, idx_dtype, dtype, page):
    """Rows 10-12's split body at lengths on and around its runs of SPLIT
    tokens, a zero-length row and the past-the-table sentinel, GQA group 2:
    each against its plain version; row 11 bit-equal to row 10 on the
    gathered view, to itself on misaligned copies (scalar loads) and across
    two calls; each row of row 12 bit-equal to row 11 at its length."""
    from repro_torch.kernels.flash_sfa_decode import SPLIT
    rs = np.random.RandomState(12)
    slots, h, hkv, d, n_cap = 8, 4, 2, 64, 384
    mp = n_cap // page
    pool = slots * mp + 1
    idx = np.sort(np.argsort(rs.rand(hkv, pool, page, d), -1)[..., :kk], -1)
    idx[:, ::7, ::5, 0] = d + 3                  # an index past d lands nowhere
    bt = rs.permutation(np.arange(1, pool))[:slots * mp].reshape(slots, mp).astype(np.int32)
    lens = np.array([0, 1, SPLIT - 1, SPLIT, SPLIT + 1, 2 * SPLIT + 1, n_cap, n_cap + 1],
                    np.int32)
    t = {"kv": torch.from_numpy(rs.randn(hkv, pool, page, kk).astype(np.float32)).to(dtype),
         "ki": torch.from_numpy(idx.astype(np.int32)).to(idx_dtype),
         "v": torch.from_numpy(rs.randn(hkv, pool, page, dv).astype(np.float32)).to(dtype),
         "bt": torch.from_numpy(bt), "lens": torch.from_numpy(lens),
         "q": torch.from_numpy(rs.randn(slots * h, d).astype(np.float32))}
    g = {n: x.to(cuda) for n, x in t.items()}
    pools = [g[n] for n in ("kv", "ki", "v")]
    ko = flash_sfa_decode_paged(g["q"], *pools, g["bt"], g["lens"], d=d, heads=h)
    po = ref.flash_sfa_decode_paged_ref(t["q"], t["kv"], t["ki"], t["v"], t["bt"], t["lens"],
                                        d=d, heads=h)
    torch.testing.assert_close(ko.cpu(), po, rtol=0, atol=1e-4)
    assert not ko[:h].any()                      # slot 0 has length 0
    assert torch.equal(ko, flash_sfa_decode_paged(g["q"], *pools, g["bt"], g["lens"], d=d,
                                                  heads=h))
    mis = [_misaligned(x) for x in pools]
    assert mis[0].data_ptr() % 16 and torch.equal(mis[2], pools[2])
    assert torch.equal(ko, flash_sfa_decode_paged(g["q"], *mis, g["bt"], g["lens"], d=d,
                                                  heads=h))
    # the gathered view, built on the host (CUDA indexing takes no uint16)
    view = [ref._pool_view(t[n], t["bt"]).contiguous().to(cuda) for n in ("kv", "ki", "v")]
    rlens = g["lens"].repeat_interleave(h)
    assert torch.equal(ko, flash_sfa_decode(g["q"], *view, rlens, d=d))
    # row 12: C = 8 verify queries of slot 5 at the same lengths
    slot = 5
    mo = flash_sfa_decode_multi(g["q"], *pools, rlens, d=d, heads=h, block_tables=g["bt"],
                                slot=slot)
    mp_ = ref.flash_sfa_decode_multi_ref(t["q"], t["kv"], t["ki"], t["v"], rlens.cpu(), d=d,
                                         heads=h, block_tables=t["bt"], slot=slot)
    torch.testing.assert_close(mo.cpu(), mp_, rtol=0, atol=1e-4)
    for i, length in enumerate(lens):
        li = g["lens"].clone()
        li[slot] = int(length)
        q = g["q"].clone()
        q[slot * h:(slot + 1) * h] = g["q"][i * h:(i + 1) * h]
        one = flash_sfa_decode_paged(q, *pools, g["bt"], li, d=d, heads=h)
        assert torch.equal(mo[i * h:(i + 1) * h], one[slot * h:(slot + 1) * h])


@pytest.mark.parametrize("backend", ["cuda", "cuda_fm"])
def test_paged_and_speculative_engines_launch_their_kernels(cuda, backend):
    from repro_torch.models.model import init
    from repro_torch.serve import (
        PagedDecodeEngine, PagedEngineConfig, SpeculativeDecodeEngine,
        SpeculativeEngineConfig,
    )
    import dataclasses
    # f32: the verify pass's C-row GEMMs round like the decode's only to
    # f32 precision, so a bf16 near-tie could part the two streams
    cfg = dataclasses.replace(get_config("gpt2-small-sfa8").reduced(), dtype="float32")
    model = init(cfg, device=cuda)
    prompt = np.arange(1, 20)
    kw = dict(max_slots=2, max_len=64, page_size=16, decode_backend=backend)
    reset_launches()
    ref_out = PagedDecodeEngine(model, cfg, PagedEngineConfig(**kw)).generate(prompt, 6)
    counts = launch_counts()
    paged = "flash_sfa_decode_paged" if backend == "cuda" else "flash_sfa_decode_fm_paged"
    assert counts[paged] > 0
    spec = SpeculativeDecodeEngine(model, cfg, SpeculativeEngineConfig(**kw, draft_len=3))
    reset_launches()
    assert spec.generate(prompt, 6) == ref_out
    if backend == "cuda":
        assert launch_counts()["flash_sfa_decode_multi"] > 0


# --------------------------------------------------------------------------
# the FlashSFA tensor-core bodies (bf16, d = dv in {32, 64, 128}, k <= 32)
# --------------------------------------------------------------------------

def _tc_case(rs, n, d, k=8, bh=12):
    qv, qi = _codes(rs, bh, n, k, d)
    kv, ki = _codes(rs, bh, n, k, d)
    kv[:, 3], ki[:, 3] = 0.0, 0                  # padding row: duplicates of index 0
    v, g = (rs.randn(bh, n, d).astype(np.float32) for _ in range(2))
    t = [torch.from_numpy(a).cuda() for a in (qv, qi, kv, ki, v, g)]
    for i in (0, 2, 4, 5):
        t[i] = t[i].bfloat16()
    return t


@pytest.mark.parametrize("block_skip", [False, True])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("n", [1024, 1000])
@pytest.mark.parametrize("d", [32, 64, 128])
def test_flash_sfa_tensor_core_body_on_card(cuda, d, n, causal, block_skip):
    qv, qi, kv, ki, v, _ = _tc_case(np.random.RandomState(17), n, d)
    reset_launches()
    ko, kl = flash_sfa(qv, qi, kv, ki, v, d=d, causal=causal, return_residuals=True,
                       block_skip=block_skip)
    assert body_counts()["flash_sfa_cuda_core"] == 0
    po, pl = ref.flash_sfa_ref(qv, qi, kv, ki, v, d=d, causal=causal, return_residuals=True)
    # bf16 output: one bf16 ulp (2^-7 rel) + 1e-4; the f32 LSE 1e-5 + 1e-4
    torch.testing.assert_close(ko.float(), po.float(), rtol=2 ** -7, atol=1e-4)
    torch.testing.assert_close(kl, pl, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("n", [1024, 1000])
@pytest.mark.parametrize("d", [32, 64, 128])
def test_flash_sfa_bwd_tensor_core_body_on_card(cuda, d, n, causal):
    qv, qi, kv, ki, v, g = _tc_case(np.random.RandomState(18), n, d)
    o, lse = ref.flash_sfa_ref(qv, qi, kv, ki, v, d=d, causal=causal, return_residuals=True)
    args = (qv, qi, kv, ki, v, o, lse, g)
    reset_launches()
    dense = flash_sfa_bwd(*args, d=d, causal=causal)
    for emit, rot in (("dense", d), ("compact", d), ("compact2", d), ("compact2", d // 2)):
        got = flash_sfa_bwd(*args, d=d, causal=causal, emit=emit, rot_dim=rot)
        want = ref.flash_sfa_bwd_ref(*args, d=d, causal=causal, emit=emit, rot_dim=rot)
        for name, a, b in zip(("dq", "dk", "dv"), got, want):
            assert a.dtype == b.dtype == torch.bfloat16 and a.shape == b.shape, name
            torch.testing.assert_close(a.float(), b.float(), rtol=2 ** -7, atol=1e-4,
                                       msg=f"{emit}/{rot} {name}")
        # one owner per output tile, no atomics: bit for bit the same again
        assert all(torch.equal(a, b) for a, b in zip(got, flash_sfa_bwd(
            *args, d=d, causal=causal, emit=emit, rot_dim=rot)))
        if emit == "compact":
            for a, b, idx in ((got[0], dense[0], qi), (got[1], dense[1], ki)):
                assert torch.equal(a, b.gather(-1, idx.long()))
    for grad, idx in ((dense[0], qi), (dense[1], ki)):
        assert bool((grad[ref._support(idx, d) == 0] == 0).all())
    assert body_counts()["flash_sfa_bwd_cuda_core"] == 0


def test_short_embedding_model_runs_on_the_card_under_auto(cuda):
    # head_dim 16: no CUDA kernel takes it, so "auto" routes every layer to
    # the torch oracle (nothing recorded) and an explicit "cuda" records why
    import dataclasses

    from repro_torch.models import forward_logits
    from repro_torch.models.backends import clear_fallback_reports, fallback_reports
    from repro_torch.models.model import init
    cfg = get_config("gpt2-small-short4")
    assert cfg.attention.backend == "auto" and cfg.attention.head_dim == 16
    model = init(cfg, device=cuda)
    tokens = torch.from_numpy(np.random.RandomState(19).randint(0, cfg.vocab_size, (1, 128)))
    clear_fallback_reports()
    reset_launches()
    logits = forward_logits(model, {"tokens": tokens.to(cuda)}, cfg)
    assert bool(torch.isfinite(logits).all()) and fallback_reports() == ()
    assert launch_counts()["flash_attention"] == 0
    explicit = dataclasses.replace(cfg, attention=dataclasses.replace(cfg.attention,
                                                                      backend="cuda"))
    again = forward_logits(model, {"tokens": tokens.to(cuda)}, explicit)
    assert torch.equal(again, logits)
    assert {r.reason for r in fallback_reports()} == {
        "v head dim 16: the CUDA attention kernels take dv in (32, 64, 128)"}
    clear_fallback_reports()


# --------------------------------------------------------------------------
# code_grad_dw's tensor-core body and the split feature-major decode
# --------------------------------------------------------------------------

@pytest.mark.parametrize("dups", [True, False])
@pytest.mark.parametrize("nh,n,m,d,kw", [
    (nh, n, m, d, kw) for nh, n, m, d in ((12, 2048, 768, 64), (5, 1000, 200, 32),
                                          (3, 777, 136, 128), (2, 70, 64, 64), (2, 30, 40, 64))
    for kw in (8, 16)] + [(8, 2048, 768, 128, 32), (3, 777, 136, 128, 32),
                          (3, 1000, 200, 64, 32), (2, 30, 40, 64, 32),
                          (16, 1000, 1280, 80, 16), (3, 777, 136, 80, 8), (2, 300, 200, 80, 32),
                          (1, 1000, 2048, 256, 32), (3, 777, 136, 256, 16), (2, 30, 40, 256, 8)])
def test_code_grad_dw_tensor_core_body_on_card(cuda, nh, n, m, d, kw, dups):
    """bf16 dW on the tensor cores against its plain version and against the
    CUDA-core body on the same inputs (rtol 1e-4, atol 1e-4 max|dW|: f32
    sums in another order, each summed duplicate kept to ~16 bits), with
    duplicates, padding rows and indices outside [0, d), n and m ragged to
    the 64-token chunks and 128-column blocks (also fewer tokens and
    columns than one x tile holds); then exact inputs (values in
    {-1, 1}, x in {-1, 0, 1}, a duplicate 1 + 2^-9 through the lo tile)
    equal to the plain version bit for bit; body_counts() shows the body.
    Without duplicates (as rtopk's codes: padding rows repeat a zero) the
    body runs no lo products. Widths 8 and 16 at d 32, 64, 80, 128 and 256,
    width 32 (a k-16 RoPE model's pair closure) at d 64, 80, 128 and 256
    (80 and 256 from code_grad_wide.cu: hubert-xlarge's and paligemma-3b's
    seams)."""
    import repro_torch.kernels.code_grad as cg
    rs = np.random.RandomState(17)
    vals, idx = _codes(rs, nh, n, kw, d)
    if dups:
        idx[:, 3::7, 1] = idx[:, 3::7, 0]             # duplicates sum
    idx[:, 9::11, -1] = d + 1                         # outside [0, d): nothing
    vals[:, 5], idx[:, 5] = 0.0, 0                    # a padding row
    tv = torch.from_numpy(vals).to(cuda).bfloat16()
    ti = torch.from_numpy(idx).to(cuda)
    x = torch.from_numpy(rs.randn(n, m).astype(np.float32)).to(cuda).bfloat16()
    assert cg.tensor_core_body(torch.bfloat16, d, kw, m)
    reset_launches()
    got = code_grad_dw(x, tv, ti, d=d)
    assert body_counts()["code_grad_dw_cuda_core"] == 0 and launch_counts()["code_grad_dw"] == 1
    want = ref.code_grad_dw_ref(x.cpu(), tv.cpu(), ti.cpu(), d=d)
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4 * want.abs().max())
    core = cg._dw_cuda_core(x, tv, ti, d)
    torch.testing.assert_close(got, core, rtol=1e-4, atol=1e-4 * want.abs().max().item())
    ev = rs.choice([-1.0, 1.0], size=vals.shape).astype(np.float32)
    ev[:, 3::7, 1] = 2.0 ** -9 if dups else 0.0
    ev = torch.from_numpy(ev).to(cuda).bfloat16()
    xe = torch.from_numpy(rs.randint(-1, 2, (n, m)).astype(np.float32)).to(cuda).bfloat16()
    exact = code_grad_dw(xe, ev, ti, d=d)
    assert torch.equal(exact.cpu(), ref.code_grad_dw_ref(xe.cpu(), ev.cpu(), ti.cpu(), d=d))
    assert torch.equal(exact, code_grad_dw(xe, ev, ti, d=d))   # deterministic
    reset_launches()
    code_grad_dw(x.float(), tv.float(), ti, d=d)               # f32: the CUDA-core body
    assert body_counts()["code_grad_dw_cuda_core"] == 1


def test_code_grad_dw_routes_other_shapes_to_cuda_cores(cuda):
    """bf16 at a code width or head dim the tensor-core body does not take
    (width 32 at d 32 among them) runs the CUDA-core body, against its plain
    version."""
    rs = np.random.RandomState(18)
    for nh, n, m, d, kw in ((3, 200, 96, 64, 4), (2, 130, 130, 64, 8), (2, 100, 64, 48, 8),
                            (2, 100, 64, 32, 32)):
        vals, idx = _codes(rs, nh, n, kw, d)
        tv = torch.from_numpy(vals).to(cuda).bfloat16()
        ti = torch.from_numpy(idx).to(cuda)
        x = torch.from_numpy(rs.randn(n, m).astype(np.float32)).to(cuda).bfloat16()
        reset_launches()
        got = code_grad_dw(x, tv, ti, d=d)
        assert body_counts()["code_grad_dw_cuda_core"] == 1
        want = ref.code_grad_dw_ref(x.cpu(), tv.cpu(), ti.cpu(), d=d)
        torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4 * want.abs().max())


# --------------------------------------------------------------------------
# the tensor-core bodies of proj_rtopk (row 2) and code_grad_dx (row 8)
# --------------------------------------------------------------------------

@pytest.mark.parametrize("b,n,m,nh,d", [(2, 1000, 200, 3, 64), (2, 300, 768, 12, 64),
                                        (1, 777, 200, 5, 32), (1, 260, 136, 3, 128),
                                        (2, 300, 1280, 16, 80), (1, 200, 136, 3, 80),
                                        (1, 260, 2048, 8, 256), (2, 200, 136, 1, 256)])
@pytest.mark.parametrize("rot", [None, "d", "half"])
@pytest.mark.parametrize("k", [8, 16, 24])
def test_proj_rtopk_tensor_core_body_on_card(cuda, b, n, m, nh, d, rot, k):
    """bf16 x on the tensor cores: on dyadic inputs (every f32 sum exact in
    any order) indices equal and values bit-equal to the plain version on
    the card, with and without RoPE, k 8 and 16 (one thread selects a row)
    and 24 (one warp a row), for the strided f32 view of a packed w (the
    pack kernel), its bf16 view (TMA in place; at d 80 and 256, whose
    blocks read wᵀ, packed too) and a contiguous bf16 w (packed); two calls
    equal; body_counts() 0, and 1 for f32 x (the CUDA-core body, also at
    80 and 256)."""
    from repro_torch.kernels.ops import head_blocks
    from repro_torch.kernels.rtopk import tensor_core_body, w_in_place
    rs = np.random.RandomState(20)
    x = torch.from_numpy(rs.randint(-4, 5, size=(b, n, m)).astype(np.float32) / 4).to(cuda)
    w = torch.from_numpy(rs.randint(-8, 9, size=(m, 2 * nh * d)).astype(np.float32) / 16).to(cuda)
    pos = torch.arange(n, device=cuda)[None, :].expand(b, n)
    spec = None if rot is None else (10_000.0, d if rot == "d" else d // 2)
    p = pos if spec else None
    xb = x.bfloat16()
    assert tensor_core_body(torch.bfloat16, d, m)
    views = (head_blocks(w, 1, nh, d), head_blocks(w.bfloat16(), 0, nh, d),
             head_blocks(w, 0, nh, d).bfloat16().contiguous())
    # a single head's contiguous copy has the in-place layout too
    assert [w_in_place(v) for v in views] == [False, True, nh == 1]
    for wh in views:
        reset_launches()
        kv, ki = proj_rtopk(xb, wh, p, k=k, rope_spec=spec)
        assert body_counts()["proj_rtopk_cuda_core"] == 0 and launch_counts()["proj_rtopk"] == 1
        pv, pi = ref.proj_rtopk_ref(xb, wh, p, k=k, rope_spec=spec)
        assert torch.equal(ki, pi)
        assert torch.equal(kv.view(torch.int16), pv.view(torch.int16))
        again = proj_rtopk(xb, wh, p, k=k, rope_spec=spec)
        assert torch.equal(again[1], ki) and torch.equal(again[0].view(torch.int16),
                                                         kv.view(torch.int16))
    reset_launches()
    proj_rtopk(x, views[0], p, k=k, rope_spec=spec)            # f32: the CUDA-core body
    assert body_counts()["proj_rtopk_cuda_core"] == 1


def test_proj_rtopk_tensor_core_body_random_on_card(cuda):
    """Random bf16 inputs at gpt2's width: a row may pick another index set
    than the plain version (or the CUDA-core body) only at a near-tie of two
    bf16 roundings (2^-6 relative); the other rows' values within a bf16
    ulp."""
    from repro_torch.kernels.ops import head_blocks
    rt = __import__("sys").modules["repro_torch.kernels.rtopk"]
    rs = np.random.RandomState(21)
    b, n, m, nh, d, k = 2, 1000, 768, 12, 64, 8
    x = torch.from_numpy(rs.randn(b, n, m).astype(np.float32)).to(cuda).bfloat16()
    w = torch.from_numpy((0.04 * rs.randn(m, 3 * nh * d)).astype(np.float32)).to(cuda)
    wh = head_blocks(w, 0, nh, d)
    kv, ki = proj_rtopk(x, wh, k=k)
    pv, pi = ref.proj_rtopk_ref(x, wh, k=k)
    cv = torch.empty_like(kv)
    ci = torch.empty_like(ki)
    rt._proj_cuda_core(x, wh, None, k, None, 0, cv, ci)
    y = torch.einsum("bnm,hmd->bhnd", x.float(), wh.bfloat16().float()).bfloat16()
    for vals, idx in ((pv, pi), (cv, ci)):
        diff, tie = near_tie_rows(y, ki, idx, k, 2.0 ** -6)
        assert bool((tie | ~diff).all()), int((diff & ~tie).sum())
        torch.testing.assert_close(kv[~diff].float(), vals[~diff].float(), rtol=2 ** -7,
                                   atol=1e-5)


@pytest.mark.parametrize("nh,n,m,d,kw", [(12, 2048, 768, 64, 8), (12, 1000, 768, 64, 16),
                                         (5, 1000, 200, 32, 8), (3, 777, 136, 128, 16),
                                         (4, 300, 72, 128, 8), (2, 30, 40, 32, 16),
                                         (8, 2048, 768, 128, 32), (3, 777, 136, 128, 32),
                                         (3, 1000, 200, 64, 32), (2, 30, 40, 64, 32),
                                         (16, 1000, 1280, 80, 16), (3, 300, 136, 80, 32),
                                         (1, 1000, 2048, 256, 32), (2, 300, 136, 256, 16)])
def test_code_grad_dx_tensor_core_body_on_card(cuda, nh, n, m, d, kw):
    """bf16 codes on the tensor cores: random codes (duplicates, padding
    rows, indices outside [0, d)) against the plain version and the
    CUDA-core body at rtol 1e-4, atol 1e-4 max|dx| (f32 sums in another
    order; w and each summed duplicate kept to ~16 bits as hi + lo), for an
    f32 and a bf16 w; exact inputs bit-equal to the plain version (values
    in {-1, 1} with a 1 + 2^-9 duplicate against w in multiples of 1/16, or
    no duplicate against w in multiples of 2^-12 with a nonzero lo part,
    or a bf16 w: the body leaves out S_lo.W_lo); two calls equal;
    body_counts() 0, and 1 for f32 codes. Widths 8 and 16 at d 32, 64 and
    128, width 32 at d 64 and 128; at d 80 (steps of 32 features, the last
    half zero) and 256 (four steps of 64), widths 16 and 32."""
    import repro_torch.kernels.code_grad as cg
    from repro_torch.kernels.ops import head_blocks
    rs = np.random.RandomState(22)
    vals, idx = _codes(rs, nh, n, kw, d)
    idx[:, 3::7, 1] = idx[:, 3::7, 0]                 # duplicates sum
    idx[:, 9::11, -1] = d + 1                         # outside [0, d): nothing
    vals[:, 5], idx[:, 5] = 0.0, 0                    # a padding row
    tv = torch.from_numpy(vals).to(cuda).bfloat16()
    ti = torch.from_numpy(idx).to(cuda)
    w = torch.from_numpy((0.05 * rs.randn(m, 2 * nh * d)).astype(np.float32)).to(cuda)
    assert cg.tensor_core_body(torch.bfloat16, d, kw, m)
    for wh in (head_blocks(w, 1, nh, d), head_blocks(w, 1, nh, d).bfloat16()):
        reset_launches()
        got = code_grad_dx(tv, ti, wh, d=d)
        assert body_counts()["code_grad_dx_cuda_core"] == 0 and launch_counts()["code_grad_dx"] == 1
        want = ref.code_grad_dx_ref(tv, ti, wh, d=d)
        tol = 1e-4 * want.abs().max().item()
        torch.testing.assert_close(got, want, rtol=1e-4, atol=tol)
        torch.testing.assert_close(got, cg._dx_cuda_core(tv, ti, wh, d), rtol=1e-4, atol=tol)
        assert torch.equal(got, code_grad_dx(tv, ti, wh, d=d))   # deterministic
    for dups, grid in ((True, 16), (False, 4096)):
        ev = rs.choice([-1.0, 1.0], size=vals.shape).astype(np.float32)
        ei = np.sort(np.argsort(rs.rand(nh, n, d), -1)[..., :kw], -1).astype(np.int32)
        if dups:
            ei[:, 3::7, 1], ev[:, 3::7, 1] = ei[:, 3::7, 0], 2.0 ** -9
        ei[:, 9::11, -1] = d + 1
        ev, ei = torch.from_numpy(ev).to(cuda).bfloat16(), torch.from_numpy(ei).to(cuda)
        we = torch.from_numpy(rs.randint(-grid // 2, grid // 2 + 1, (m, nh * d))
                              .astype(np.float32) / grid).to(cuda)
        for wh in (head_blocks(we, 0, nh, d),) + (() if dups else
                                                  (head_blocks(we.bfloat16(), 0, nh, d),)):
            exact = code_grad_dx(ev, ei, wh, d=d)
            assert torch.equal(exact, ref.code_grad_dx_ref(ev, ei, wh, d=d))
    reset_launches()
    code_grad_dx(tv.float(), ti, head_blocks(w, 1, nh, d), d=d)   # f32: the CUDA-core body
    assert body_counts()["code_grad_dx_cuda_core"] == 1


def test_code_grad_dx_routes_other_shapes_to_cuda_cores(cuda):
    """bf16 codes at a code width, head dim or m the tensor-core body does
    not take (width 32 at d 32 among them) run the CUDA-core body, against
    its plain version."""
    rs = np.random.RandomState(23)
    for nh, n, m, d, kw in ((3, 200, 96, 64, 4), (2, 130, 130, 64, 8), (2, 100, 64, 48, 8),
                            (2, 100, 64, 32, 32)):
        vals, idx = _codes(rs, nh, n, kw, d)
        tv = torch.from_numpy(vals).to(cuda).bfloat16()
        ti = torch.from_numpy(idx).to(cuda)
        w = torch.from_numpy(rs.randn(nh, m, d).astype(np.float32)).to(cuda)
        reset_launches()
        got = code_grad_dx(tv, ti, w, d=d)
        assert body_counts()["code_grad_dx_cuda_core"] == 1
        want = ref.code_grad_dx_ref(tv, ti, w, d=d)
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4 * want.abs().max().item())


@pytest.mark.parametrize("dv,kq,dtype,page", [
    (32, 4, torch.float32, 48), (64, 8, torch.bfloat16, 128), (128, 8, torch.float32, 128),
    (64, 8, torch.float32, 48), (128, 16, torch.bfloat16, 48)])
def test_split_fm_decode_kernels_at_run_boundaries_on_card(cuda, dv, kq, dtype, page):
    """Rows 13-14's split body at lengths on and around its runs of SPLIT
    tokens, a zero-length slot (0) and the past-the-table sentinel, GQA
    group 2: each against its plain version (1e-4); row 14 bit-equal to
    row 13 on the gathered image, to itself on misaligned pool copies (V
    by plain loads) and across two calls."""
    from repro_torch.kernels.flash_sfa_decode import SPLIT
    rs = np.random.RandomState(19)
    slots, h, hkv, d, n_cap = 8, 4, 2, 64, 384
    mp = n_cap // page
    pool = slots * mp + 1
    bt = rs.permutation(np.arange(1, pool))[:slots * mp].reshape(slots, mp).astype(np.int32)
    lens = np.array([0, 1, SPLIT - 1, SPLIT, SPLIT + 1, 2 * SPLIT + 1, n_cap, n_cap + 1],
                    np.int32)
    qi = np.sort(np.argsort(rs.rand(slots * h, d), -1)[..., :kq], -1).astype(np.int32)
    qi[::5, 0] = d + 2                               # an index past d adds nothing
    t = {"kf": torch.from_numpy(rs.randn(hkv, pool, d, page).astype(np.float32)).to(dtype),
         "v": torch.from_numpy(rs.randn(hkv, pool, page, dv).astype(np.float32)).to(dtype),
         "bt": torch.from_numpy(bt), "lens": torch.from_numpy(lens),
         "qv": torch.from_numpy(rs.randn(slots * h, kq).astype(np.float32)),
         "qi": torch.from_numpy(qi)}
    g = {n: x.to(cuda) for n, x in t.items()}
    ko = flash_sfa_decode_fm_paged(g["qv"], g["qi"], g["kf"], g["v"], g["bt"], g["lens"],
                                   heads=h)
    po = ref.flash_sfa_decode_fm_paged_ref(t["qv"], t["qi"], t["kf"], t["v"], t["bt"],
                                           t["lens"], heads=h)
    torch.testing.assert_close(ko.cpu(), po, rtol=0, atol=1e-4)
    assert not ko[:h].any()                          # slot 0 has length 0
    assert torch.equal(ko, flash_sfa_decode_fm_paged(g["qv"], g["qi"], g["kf"], g["v"],
                                                     g["bt"], g["lens"], heads=h))
    mis = [_misaligned(g[n]) for n in ("kf", "v")]
    assert mis[1].data_ptr() % 16 and torch.equal(mis[1], g["v"])
    assert torch.equal(ko, flash_sfa_decode_fm_paged(g["qv"], g["qi"], *mis, g["bt"],
                                                     g["lens"], heads=h))
    btl = g["bt"].long()
    kf = g["kf"][:, btl].permute(1, 0, 3, 2, 4).reshape(-1, d, n_cap).contiguous()
    v = g["v"][:, btl].transpose(0, 1).reshape(-1, n_cap, dv).contiguous()
    rlens = g["lens"].repeat_interleave(h)
    fo = flash_sfa_decode_fm(g["qv"], g["qi"], kf, v, rlens, group=h // hkv)
    assert torch.equal(fo, ko)
    fp = ref.flash_sfa_decode_fm_ref(t["qv"], t["qi"], kf.cpu(), v.cpu(), rlens.cpu(),
                                     group=h // hkv)
    torch.testing.assert_close(fo.cpu(), fp, rtol=0, atol=1e-4)


def test_moe_layer_on_card_gives_the_same_bits_twice_and_its_cpu_result(cuda):
    """moonshot's routing (64 experts top-6, 2 shared, capacity factor
    1.25) at d 512, expert width 352, 2 x 256 bf16 tokens: forward and
    backward (x and every leaf) equal bit for bit over two calls on the
    card; routing equal to the CPU run's on the same inputs (a flip fails
    the test, no tolerance covers it), output and gradients within bf16
    rounding of it (both sum in f32 and round once, in other orders)."""
    from repro_torch.configs.base import MoEConfig
    from repro_torch.models import moe
    mc = MoEConfig(num_experts=64, top_k=6, expert_dim=352, num_shared=2)
    d = 512
    p_cpu = moe.moe_init(torch.Generator().manual_seed(0), d, mc)
    x_cpu = torch.randn(2, 256, d, generator=torch.Generator().manual_seed(1)).bfloat16()
    w = torch.randn(2, 256, d, generator=torch.Generator().manual_seed(2))

    def leaves(tree, prefix=""):
        if isinstance(tree, dict):
            return {n: t for k, v in tree.items() for n, t in leaves(v, f"{prefix}{k}.").items()}
        return {prefix[:-1]: tree}

    def run(device):
        p = {k: ({kk: vv.to(device) for kk, vv in v.items()} if isinstance(v, dict)
                 else v.to(device)) for k, v in p_cpu.items()}
        flat = leaves(p)
        for t in flat.values():
            t.requires_grad_(True)
        x = x_cpu.to(device).requires_grad_(True)
        out, aux = moe.moe_apply(p, x, mc)
        ((out.float() * w.to(device)).sum() + aux).backward()
        r = moe.route(p["router"]["w"].detach(), x.detach().reshape(-1, d), mc, gs=512,
                      dtype=torch.bfloat16)
        return ([out.detach(), aux.detach(), x.grad] + [t.grad for t in flat.values()],
                r.sel.cpu(), r.keep.cpu())

    a, sel, keep = run(cuda)
    b, _, _ = run(cuda)
    assert all(torch.equal(u, v) for u, v in zip(a, b))
    c, csel, ckeep = run("cpu")
    flips = int((sel != csel).any(-1).sum())
    assert flips == 0, f"{flips} tokens routed to other experts on the card than on the CPU"
    assert torch.equal(keep, ckeep)
    for got, want in zip(a, c):
        got, want = got.float().cpu(), want.float()
        torch.testing.assert_close(got, want, rtol=2e-2, atol=2e-2 * want.abs().max().item())


# --------------------------------------------------------------------------
# the frontend families' head dims: d = dv 80 (hubert-xlarge, bidirectional)
# and 256 (paligemma-3b, 8 query heads over 1 kv head): bf16 on the
# tensor-core bodies (flash_sfa_tc_wide.cu), f32 on the CUDA-core ones
# --------------------------------------------------------------------------

@pytest.mark.parametrize("block_skip", [False, True])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("d,n,dtype", [(80, 1000, torch.float32), (80, 1000, torch.bfloat16),
                                       (256, 333, torch.float32), (256, 333, torch.bfloat16)])
def test_flash_sfa_at_frontend_head_dims_on_card(cuda, d, n, dtype, causal, block_skip):
    """Rows 3 (both schedules: row 4 is the block-skip one) and 5 at d = dv
    80 and 256 (k 16, ragged n, both masks) against the plain versions:
    bf16 on the tensor-core bodies (no CUDA-core launch), f32 on the
    CUDA-core ones (dv 256 on 32-row tiles), the backward with every
    emit."""
    rs = np.random.RandomState(12)
    bh, k = 6, 16
    qv, qi = _codes(rs, bh, n, k, d)
    kv, ki = _codes(rs, bh, n, k, d)
    v, g = (rs.randn(bh, n, d).astype(np.float32) for _ in range(2))
    qv_, qi_, kv_, ki_, v_, g_ = (torch.from_numpy(a).to(cuda) for a in (qv, qi, kv, ki, v, g))
    qv_, kv_, v_, g_ = (t.to(dtype) for t in (qv_, kv_, v_, g_))
    tc = dtype == torch.bfloat16
    reset_launches()
    ko, kl = flash_sfa(qv_, qi_, kv_, ki_, v_, d=d, causal=causal, return_residuals=True,
                       block_skip=block_skip)
    po, pl = ref.flash_sfa_ref(qv_, qi_, kv_, ki_, v_, d=d, causal=causal,
                               return_residuals=True)
    assert body_counts()["flash_sfa_cuda_core"] == (0 if tc else 1)
    assert launch_counts()["flash_sfa_block_skip"] == int(block_skip)
    # f32: sums in another order, 1e-4; bf16 output: one bf16 ulp (2^-7 rel)
    rtol = 2 ** -7 if tc else 0
    torch.testing.assert_close(ko.float(), po.float(), rtol=rtol, atol=1e-4)
    torch.testing.assert_close(kl, pl, rtol=1e-5, atol=1e-4)
    emits = ("dense", "compact", "compact2")
    for emit in emits:
        got = flash_sfa_bwd(qv_, qi_, kv_, ki_, v_, po, pl, g_, d=d, causal=causal, emit=emit)
        want = ref.flash_sfa_bwd_ref(qv_, qi_, kv_, ki_, v_, po, pl, g_, d=d, causal=causal,
                                     emit=emit)
        for name, a, b in zip(("dq", "dk", "dv"), got, want):
            torch.testing.assert_close(a.float(), b.float(), rtol=rtol, atol=1e-4,
                                       msg=f"{emit} {name}")
    assert body_counts()["flash_sfa_bwd_cuda_core"] == (0 if tc else len(emits))


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("n,k", [(1024, 16), (333, 32), (31, 16)])
def test_flash_sfa_bwd_f32_dv256_cuda_core_body_on_card(cuda, n, k, causal):
    """Row 5's CUDA-core body at d = dv 256 in f32 (paligemma-3b's head dim;
    32-row tiles, 8 threads a row), at the largest code width its shared
    memory is sized for (k 32) and a sequence shorter than one tile: every
    emit against the plain version to f32's 1e-4, the compact emit equal
    to the dense one gathered at the stored indices, two calls equal bit
    for bit; bf16 at dv 256 off the tensor-core body (d != dv) raises."""
    rs = np.random.RandomState(32 + k)
    bh, d = 8, 256
    qv, qi = _codes(rs, bh, n, k, d)
    kv, ki = _codes(rs, bh, n, k, d)
    qi[:, 3::7, 1] = qi[:, 3::7, 0]              # duplicates sum
    ki[:, 5::11, -1] = d + 3                     # outside [0, d): adds nothing
    v, g = (rs.randn(bh, n, d).astype(np.float32) for _ in range(2))
    args = [torch.from_numpy(a).to(cuda) for a in (qv, qi, kv, ki, v)]
    o, lse = ref.flash_sfa_ref(*args, d=d, causal=causal, return_residuals=True)
    args += [o, lse, torch.from_numpy(g).to(cuda)]
    reset_launches()
    got = {}
    for emit, rot in (("dense", d), ("compact", d), ("compact2", d), ("compact2", 64)):
        got[emit] = flash_sfa_bwd(*args, d=d, causal=causal, emit=emit, rot_dim=rot)
        want = ref.flash_sfa_bwd_ref(*args, d=d, causal=causal, emit=emit, rot_dim=rot)
        for name, a, b in zip(("dq", "dk", "dv"), got[emit], want):
            torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4, msg=f"{emit}/{rot} {name}")
    assert body_counts()["flash_sfa_bwd_cuda_core"] == 4
    for a, b, idx in ((got["compact"][0], got["dense"][0], args[1]),
                      (got["compact"][1], got["dense"][1], args[3])):
        assert torch.equal(a, ref.gather_support(b, idx))
    again = flash_sfa_bwd(*args, d=d, causal=causal)
    assert all(torch.equal(a, b) for a, b in zip(again, got["dense"]))
    bf = [t.bfloat16() if t.is_floating_point() and t is not args[6] else t for t in args]
    with pytest.raises(ValueError, match="dv 256 in f32 only"):
        flash_sfa_bwd(*bf, d=128, causal=causal)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_kernels_at_dv256_mqa_on_card(cuda, dtype):
    """Rows 10-14 at paligemma's geometry (8 query heads over 1 kv head, d
    = dv 256, k 16, pages of 128): each against its plain version with a
    zero-length slot (0) and the past-the-table sentinel; row 11 bit-equal
    to row 10 on the gathered view, each verify row of row 12 to row 11 at
    its length, row 14 to row 13 on the gathered image."""
    rs = np.random.RandomState(13)
    slots, h, hkv, d, k, page, mp = 4, 8, 1, 256, 16, 128, 4
    P, n = slots * mp + 1, mp * page
    bt = torch.from_numpy(rs.permutation(np.arange(1, P))[:slots * mp]
                          .reshape(slots, mp).astype(np.int32)).to(cuda)
    lens = torch.tensor([0, n + 1, 129, 300], dtype=torch.int32, device=cuda)
    kv, ki = _codes(rs, hkv * P, page, k, d)
    g = {"kv": torch.from_numpy(kv.reshape(hkv, P, page, k)).to(cuda, dtype),
         "ki": torch.from_numpy(ki.reshape(hkv, P, page, k)).to(cuda, torch.uint8),
         "v": torch.from_numpy(rs.randn(hkv, P, page, d).astype(np.float32)).to(cuda, dtype),
         "kf": torch.from_numpy(rs.randn(hkv, P, d, page).astype(np.float32)).to(cuda, dtype)}
    q = torch.from_numpy(rs.randn(slots * h, d).astype(np.float32)).to(cuda)
    rl = lens.repeat_interleave(h)
    live = (rl > 0)[:, None].cpu()
    ko = flash_sfa_decode_paged(q, g["kv"], g["ki"], g["v"], bt, lens, d=d, heads=h)
    po = ref.flash_sfa_decode_paged_ref(q, g["kv"], g["ki"], g["v"], bt, lens, d=d, heads=h)
    assert not ko[rl <= 0].any()
    torch.testing.assert_close(ko.cpu() * live, po.cpu() * live, rtol=0, atol=1e-4)
    view = [ref._pool_view(g[nm], bt).contiguous() for nm in ("kv", "ki", "v")]
    o10 = flash_sfa_decode(q, *view, rl, d=d)
    assert torch.equal(ko, o10)
    torch.testing.assert_close(o10.cpu() * live, ref.flash_sfa_decode_ref(q, *view, rl, d=d)
                               .cpu() * live, rtol=0, atol=1e-4)
    slot, C = 3, 3
    start = int(lens[slot]) - C
    qm = q[:C * h]
    lm = (start + torch.arange(C, device=cuda) + 1).repeat_interleave(h).int()
    mo = flash_sfa_decode_multi(qm, g["kv"], g["ki"], g["v"], lm, d=d, heads=h,
                                block_tables=bt, slot=slot)
    torch.testing.assert_close(mo, ref.flash_sfa_decode_multi_ref(
        qm, g["kv"], g["ki"], g["v"], lm, d=d, heads=h, block_tables=bt, slot=slot),
        rtol=0, atol=1e-4)
    for i in range(C):
        li = lens.clone()
        li[slot] = start + i + 1
        qi_ = q.clone()
        qi_[slot * h:(slot + 1) * h] = qm[i * h:(i + 1) * h]
        one = flash_sfa_decode_paged(qi_, g["kv"], g["ki"], g["v"], bt, li, d=d, heads=h)
        assert torch.equal(mo[i * h:(i + 1) * h], one[slot * h:(slot + 1) * h])
    qv, qi = rtopk(torch.from_numpy(rs.randn(slots * h, d).astype(np.float32)).to(cuda, dtype), k)
    fk = flash_sfa_decode_fm_paged(qv, qi, g["kf"], g["v"], bt, lens, heads=h)
    btl = bt.long()
    kf = g["kf"][:, btl].permute(1, 0, 3, 2, 4).reshape(-1, d, n).contiguous()
    vv = g["v"][:, btl].transpose(0, 1).reshape(-1, n, d).contiguous()
    fo = flash_sfa_decode_fm(qv, qi, kf, vv, rl, group=h // hkv)
    assert torch.equal(fo, fk) and not fo[rl <= 0].any()
    torch.testing.assert_close(fo, ref.flash_sfa_decode_fm_ref(qv, qi, kf, vv, rl, group=h // hkv),
                               rtol=0, atol=1e-4)
    torch.testing.assert_close(fk, ref.flash_sfa_decode_fm_paged_ref(
        qv, qi, g["kf"], g["v"], bt, lens, heads=h), rtol=0, atol=1e-4)


def test_ring_sfa_on_two_ranks_of_the_card(cuda):
    """Two gloo ranks on the card (NCCL refuses two ranks on one device):
    bf16 Ring-SFA of gpt2-small-sfa8's training shape (bh 24, n 1024, d 64,
    k 8) against flash_sfa of the same codes. Each hop's bf16 partial
    rounds once before the f32 merge: within 3 bf16 roundings of max|v|
    (2^-7 max|v|). Rank r launches r + 1 FlashSFA hops (plus its own
    reference call); the ring's hops go through pinned host memory (gloo's
    send refuses device memory), the all-gather takes the CUDA tensor."""
    from torch_dist_workers import ring_on_card

    from repro_torch.launch.mesh import spawn
    out = spawn(ring_on_card, 2, device="cuda", args=(0, 24, 1024, 64, 8), timeout_s=300)
    for rank, r in enumerate(out):
        assert r["device"].startswith("cuda"), r
        assert r["err"] <= 2 ** -7 * r["vmax"], r
        assert r["flash_sfa"] == rank + 1, r
        assert r["wire"] == {"ring": "gloo, pinned host", "all_gather": "gloo, device"}, r


def test_sharded_steps_on_two_ranks_of_the_card(cuda):
    """Two gloo ranks of the card on data 2: two f32 steps of the reduced
    gpt2-small-sfa8 with the parameters and moments sharded by the
    launcher's specs (each rank gathers at use, its gradients come back
    reduce-scattered) against the same two steps replicated: loss,
    grad_norm, the gathered parameters and both moments within 1e-6
    relative (the global norm sums in another order); every collective
    takes the CUDA tensors."""
    import dataclasses

    from torch_dist_workers import sharded_steps_on_card

    from repro_torch.launch.mesh import spawn
    cfg = dataclasses.replace(get_config("gpt2-small-sfa8").reduced(), dtype="float32")
    rs = np.random.RandomState(0)
    batches = [{k: rs.randint(0, cfg.vocab_size, (4, 64)) for k in ("tokens", "labels")}
               for _ in range(2)]
    out = spawn(sharded_steps_on_card, 2, device="cuda", args=(cfg, batches), timeout_s=300)
    for r in out:
        assert r["split"] >= 5
        assert set(r["sent"]) == {"all_gather", "reduce_scatter", "all_reduce"}
        assert set(r["wire"].values()) == {"gloo, device"}, r["wire"]
        got, want = r["sharded"], r["replicated"]
        for (lg, ng), (lw, nw) in zip(got["metrics"], want["metrics"]):
            assert abs(lg - lw) <= 1e-6 * abs(lw) and abs(ng - nw) <= 1e-6 * abs(nw)
        for key in ("params", "m", "v"):
            for name, t in want[key].items():
                g = got[key][name]
                assert g.device.type == "cpu" and g.shape == t.shape
                assert float((g - t).norm() / t.norm().clamp(min=1e-30)) <= 1e-6, (key, name)
