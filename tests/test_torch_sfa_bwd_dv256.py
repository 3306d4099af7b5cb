"""The f32 FlashSFA backward at d = dv 256 (paligemma-3b's head dim), on the
CPU.

``csrc/flash_sfa_bwd.cu``'s CUDA-core body takes dv 256 in f32 on 32-row
tiles (the card holds it to its plain version: ``tests/test_torch_gpu.py``
and ``chip_smoke.py``). Here the wrapper's CPU path, the plain version, is
held to the reference's Pallas backward in interpret mode at d = dv 256, k
16, causal and bidirectional, every emit, to f32's 1e-4 (the forward's
output and LSE from the port's plain forward go into both).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_sfa_bwd import flash_sfa_bwd as jax_flash_sfa_bwd
from repro_torch.kernels import flash_sfa_bwd
from repro_torch.kernels.ref import flash_sfa_ref

TOL = 1e-4
BH, N, K, D = 2, 72, 16, 256


@pytest.fixture(scope="module")
def dv256_case():
    """Seeded codes at d 256 (a duplicate index in some rows, an index past
    d in others), v and dO as numpy, f32."""
    rs = np.random.RandomState(256)
    codes = []
    for _ in range(2):
        vals = rs.randn(BH, N, K).astype(np.float32)
        idx = np.sort(np.argsort(rs.rand(BH, N, D), -1)[..., :K], -1).astype(np.int32)
        codes += [vals, idx]
    codes[1][:, 3::7, 1] = codes[1][:, 3::7, 0]      # duplicates sum
    codes[3][:, 5::11, -1] = D + 1                   # outside [0, d): adds nothing
    v, g = (rs.randn(BH, N, D).astype(np.float32) for _ in range(2))
    return codes, v, g


@pytest.mark.parametrize("emit", ["dense", "compact", "compact2"])
@pytest.mark.parametrize("causal", [True, False])
def test_plain_f32_backward_at_dv256_matches_pallas(dv256_case, causal, emit):
    codes, v, g = dv256_case
    tin = [torch.from_numpy(a) for a in (*codes, v)]
    o, lse = flash_sfa_ref(*tin, d=D, causal=causal, return_residuals=True)
    got = flash_sfa_bwd(*tin, o, lse, torch.from_numpy(g), d=D, causal=causal, emit=emit)
    want = jax_flash_sfa_bwd(*(jnp.asarray(a) for a in (*codes, v, o.numpy(), lse.numpy(), g)),
                             d=D, causal=causal, interpret=True, emit=emit)
    width = {"dense": D, "compact": K, "compact2": 2 * K}[emit]
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == torch.float32
        assert a.shape == ((BH, N, D) if name == "dv" else (BH, N, width))
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=TOL, err_msg=name)
