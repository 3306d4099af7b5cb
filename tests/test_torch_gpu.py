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
from repro_torch.kernels import flash_sfa, flash_sfa_decode, launch_counts, reset_launches, rtopk
from repro_torch.kernels import ref

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


@pytest.mark.parametrize("d,k", [(64, 8), (128, 8), (256, 16), (20, 3)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rtopk_kernel_on_card(cuda, dtype, d, k):
    x = torch.from_numpy(_ties(7, 1000, d)).to(dtype)
    kv, ki = rtopk(x.to(cuda), k)
    pv, pi = ref.rtopk_ref(x, k)
    assert torch.equal(ki.cpu(), pi)
    bits = torch.int16 if dtype == torch.bfloat16 else torch.int32
    assert torch.equal(kv.cpu().view(bits), pv.view(bits))


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("n,dv,dtype", [(1024, 64, torch.float32), (1000, 64, torch.float32),
                                        (333, 128, torch.float32), (1000, 64, torch.bfloat16)])
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


def test_engine_launches_every_kernel(cuda):
    from repro_torch.models.model import init
    from repro_torch.serve import DecodeEngine, EngineConfig
    cfg = get_config("gpt2-small-sfa8").reduced()
    model = init(cfg, device=cuda)
    eng = DecodeEngine(model, cfg, EngineConfig(max_slots=2, max_len=64))
    reset_launches()
    out = eng.generate(np.arange(1, 9), max_new_tokens=4)
    assert len(out) == 4
    assert all(c > 0 for c in launch_counts().values())
