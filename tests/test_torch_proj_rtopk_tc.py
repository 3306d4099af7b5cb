"""The tensor-core ``proj_rtopk`` body's arithmetic, emulated on the CPU.

``csrc/proj_rtopk.cu``'s tensor-core body computes Y = X·W for bf16 x as
one GEMM: w rounded to bf16 (exact for a bf16 w), every bf16 × bf16 product
exact in f32, the block's f32 accumulator fed one 64-wide chunk of m at a
time in order; then Y rounded to bf16, RoPE when asked (the op sequence of
``models.layers.rope``), and the exact top-k of ``rtopk_ref``. The
emulation below does the same in plain torch (the sum inside a chunk in
torch's order: the tensor cores' own order within a chunk is the card's)
and is held against the port's plain version (the wrapper on CPU tensors)
and the JAX package's Pallas ``proj_rtopk`` in interpret mode at the card's
tolerances: on dyadic inputs, where every f32 sum is exact in any order,
indices equal and values bit-equal; on random inputs a row may pick
another index set only at a near-tie of two bf16 roundings (2^-6 relative
between its k-th and (k+1)-th magnitudes), the other rows' values within
one bf16 ulp. n, m and the head count are ragged to the body's 128-token
and 128-column blocks and 64-wide chunks; d 80 and 256 (``csrc/
proj_rtopk_wide.cu``: blocks of whole heads, the same 64-wide chunks of m)
as well.

The routing (which body a dtype and shape take, whether TMA reads a bf16
w in place) is pure Python and checked here too; the bodies themselves run
on the card (tests/test_torch_gpu.py, chip_smoke.py).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.rtopk import proj_rtopk as jax_proj_rtopk
from repro_torch.kernels import body_counts, launch_counts, proj_rtopk, reset_launches
from repro_torch.kernels.ops import head_blocks
from repro_torch.kernels.ref import proj_rtopk_ref, rtopk_ref
from repro_torch.kernels.rtopk import (
    PROJ_HEAD_DIMS, WIDE_HEAD_DIMS, library, tensor_core_body, w_in_place,
)
from repro_torch.models.layers import rope

CHUNK = 64        # m of the body's chunk (csrc kTcK)
K = 8


def emulate_proj(x, w_heads, positions=None, *, k, rope_spec=None):
    """The body on bf16 x (b, n, m), w (H, m, d): per 64-wide chunk of m
    the f32 sum of the exact products, the chunks added in order; rounded
    to bf16, RoPE, then rtopk_ref -> (vals (b, H, n, k), idx)."""
    xf = x.float()
    wf = w_heads.to(torch.bfloat16).float()
    m = x.shape[-1]
    acc = torch.zeros(x.shape[0], x.shape[1], w_heads.shape[0], w_heads.shape[2])
    for m0 in range(0, m, CHUNK):
        acc = acc + torch.einsum("bnm,hmd->bnhd", xf[..., m0:m0 + CHUNK], wf[:, m0:m0 + CHUNK])
    y = acc.bfloat16()
    if rope_spec is not None:
        y = rope(y, positions, theta=rope_spec[0], rot_dim=rope_spec[1])
    return rtopk_ref(y.transpose(1, 2), k)


def _dyadic(rs, b, n, m, cols):
    x = torch.from_numpy(rs.randint(-4, 5, size=(b, n, m)).astype(np.float32) / 4)
    w = torch.from_numpy(rs.randint(-8, 9, size=(m, cols)).astype(np.float32) / 16)
    return x.bfloat16(), w


def _jax(x, wh, pos, spec):
    jv, ji = jax_proj_rtopk(jnp.asarray(x.float().numpy(), jnp.bfloat16),
                            jnp.asarray(wh.bfloat16().float().numpy(), jnp.bfloat16),
                            None if pos is None else jnp.asarray(pos.numpy()), k=K,
                            rope_spec=spec, interpret=True)
    return (torch.from_numpy(np.array(jv.astype(jnp.float32))).bfloat16(),
            torch.from_numpy(np.array(ji)))


def _bit_equal(a, b):
    assert torch.equal(a[1], b[1])
    assert torch.equal(a[0].view(torch.int16), b[0].view(torch.int16))


def _y(x, wh, pos, spec):
    y = torch.einsum("bnm,hmd->bnhd", x.float(), wh.bfloat16().float()).bfloat16()
    if spec is not None:
        y = rope(y, pos, theta=spec[0], rot_dim=spec[1])
    return y.transpose(1, 2)


def _near_ties_only(y, got, want, k):
    """Rows whose index sets differ have their k-th and (k+1)-th magnitudes
    within 2^-6 of the k-th; the other rows' values within a bf16 ulp."""
    diff = (got[1] != want[1]).any(-1)
    mags = y.float().abs().sort(-1, descending=True).values
    kth, nxt = mags[..., k - 1], mags[..., k]
    tie = (kth - nxt) <= 2.0 ** -6 * kth
    assert bool((tie | ~diff).all()), int((diff & ~tie).sum())
    torch.testing.assert_close(got[0][~diff].float(), want[0][~diff].float(), rtol=2 ** -7,
                               atol=1e-5)
    return int(diff.sum())


CASES = [(2, 200, 200, 3, 64), (1, 128, 128, 2, 64), (2, 130, 136, 5, 32),
         (1, 77, 256, 3, 128), (1, 300, 72, 2, 128), (1, 130, 136, 3, 80),
         (1, 96, 200, 1, 256)]


@pytest.mark.parametrize("b,n,m,nh,d", CASES)
@pytest.mark.parametrize("rot", [None, "d", "half"])
def test_emulation_is_bit_equal_on_dyadic_inputs(b, n, m, nh, d, rot):
    """Every sum exact: the emulation, the port's plain version and the
    JAX kernel (interpret mode) agree bit for bit, RoPE or not."""
    rs = np.random.RandomState(b * 1000 + n + m + d)
    x, w = _dyadic(rs, b, n, m, 2 * nh * d)
    wh = head_blocks(w, 1, nh, d)                  # a strided view of a packed w
    spec = None if rot is None else (10_000.0, d if rot == "d" else d // 2)
    pos = torch.from_numpy(np.broadcast_to(np.arange(n), (b, n)).astype(np.int32))
    p = pos if spec else None
    assert tensor_core_body(x.dtype, d, m)
    plain = proj_rtopk(x, wh, p, k=K, rope_spec=spec)   # the wrapper's CPU path
    _bit_equal(plain, proj_rtopk_ref(x, wh, p, k=K, rope_spec=spec))
    emu = emulate_proj(x, wh, p, k=K, rope_spec=spec)
    _bit_equal(emu, plain)
    _bit_equal(emu, _jax(x, wh, p, spec))


@pytest.mark.parametrize("b,n,m,nh,d", CASES)
@pytest.mark.parametrize("rope_on", [False, True])
def test_emulation_parts_only_at_near_ties_on_random_inputs(b, n, m, nh, d, rope_on):
    rs = np.random.RandomState(7 * n + m + d)
    x = torch.from_numpy(rs.randn(b, n, m).astype(np.float32)).bfloat16()
    w = torch.from_numpy((0.1 * rs.randn(nh, m, d)).astype(np.float32))
    spec = (10_000.0, d) if rope_on else None
    pos = torch.from_numpy(np.broadcast_to(np.arange(n), (b, n)).astype(np.int32))
    p = pos if spec else None
    emu = emulate_proj(x, w, p, k=K, rope_spec=spec)
    y = _y(x, w, p, spec)
    _near_ties_only(y, emu, proj_rtopk(x, w, p, k=K, rope_spec=spec), K)
    _near_ties_only(y, emu, _jax(x, w, p, spec), K)


def test_chunked_sum_changes_rows_only_at_near_ties_at_gpt2_width():
    """At m 768 (twelve chunks) the chunked f32 sum rounds differently from
    the plain einsum on some rows; each that changes its index set is at a
    near-tie."""
    rs = np.random.RandomState(11)
    b, n, m, nh, d = 1, 256, 768, 4, 64
    x = torch.from_numpy(rs.randn(b, n, m).astype(np.float32)).bfloat16()
    w = torch.from_numpy((0.04 * rs.randn(m, 3 * nh * d)).astype(np.float32))
    wh = head_blocks(w, 0, nh, d)
    emu = emulate_proj(x, wh, k=K)
    _near_ties_only(_y(x, wh, None, None), emu, proj_rtopk_ref(x, wh, k=K), K)


def test_body_routing_by_dtype_and_shape():
    """bf16 x with d in {32, 64, 80, 128, 256} and m a multiple of 8 takes
    the tensor cores (80 and 256 from the wide source); f32 and every other
    shape the CUDA-core body."""
    assert PROJ_HEAD_DIMS == (32, 64, 80, 128, 256) and WIDE_HEAD_DIMS == (80, 256)
    for d in PROJ_HEAD_DIMS:
        assert library(d) == ("proj_rtopk_wide" if d in (80, 256) else "proj_rtopk")
    assert tensor_core_body(torch.bfloat16, 64, 768)          # gpt2's compact seam
    for d in PROJ_HEAD_DIMS:
        assert tensor_core_body(torch.bfloat16, d, 200)
        assert tensor_core_body(torch.bfloat16, d, 8)
        assert not tensor_core_body(torch.float32, d, 768)
        assert not tensor_core_body(torch.bfloat16, d, 196)
        assert not tensor_core_body(torch.float16, d, 768)
    assert tensor_core_body(torch.bfloat16, 80, 1280)         # hubert-xlarge's seam
    assert tensor_core_body(torch.bfloat16, 256, 2048)        # paligemma-3b's
    for d in (16, 48, 96, 192):
        assert not tensor_core_body(torch.bfloat16, d, 768)


def test_w_read_in_place_only_where_tma_can():
    """A bf16 per-head view of a packed weight (heads side by side, rows on
    16 bytes) goes to TMA as it lies; an f32 one, a contiguous (H, m, d)
    block, or rows off 16 bytes go through the pack kernel."""
    m, nh, d = 96, 3, 64
    w = torch.zeros(m, 3 * nh * d)
    assert not w_in_place(head_blocks(w, 0, nh, d))
    wb = w.bfloat16()
    assert w_in_place(head_blocks(wb, 0, nh, d))
    assert w_in_place(head_blocks(wb, nh, nh, d))             # the key heads' view
    assert not w_in_place(head_blocks(wb, 0, nh, d).contiguous())
    assert not w_in_place(head_blocks(torch.zeros(m, 3 * nh * d + 4).bfloat16(), 0, nh, d))
    assert not w_in_place(head_blocks(wb, 0, nh, d)[:, :, :32])
    assert not w_in_place(head_blocks(torch.zeros(m, 3 * nh * d + 1).bfloat16()[:, 1:], 0, nh,
                                      d))


def test_cpu_calls_count_no_body():
    """On the CPU the wrapper runs the plain version and counts no launch of
    either body; the CUDA-core counter is registered."""
    assert "proj_rtopk_cuda_core" in body_counts()
    rs = np.random.RandomState(4)
    x, w = _dyadic(rs, 1, 40, 64, 2 * 64)
    reset_launches()
    proj_rtopk(x, head_blocks(w, 0, 2, 64), k=K)
    assert launch_counts()["proj_rtopk"] == 0 and body_counts()["proj_rtopk_cuda_core"] == 0
