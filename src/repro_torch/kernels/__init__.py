"""Hand-written CUDA kernels for Hopper (sm_90a) and their plain versions.

rtopk            — exact row top-|k| (one thread a row over rows staged in
                   shared memory; a warp-ballot bisection for k > 16 and
                   other widths; both from csrc/topk_select.cuh);
                   proj_rtopk: the fused head projection -> [RoPE] -> top-k,
                   bf16 on the tensor cores (x and w by TMA, wgmma), f32 on
                   CUDA cores
flash_sfa        — FlashSFA forward (prefill attention over top-k codes),
                   with or without the block-skip level map: bf16 on the
                   tensor cores (csrc/flash_sfa_tc.cu, codes densified into
                   swizzled shared memory), f32 on CUDA cores
flash_sfa_decode — one query against the KV cache: token-major sparse
                   (contiguous, paged, and the multi-query verify pass)
                   and the feature-major image (contiguous and paged)
flash_sfa_bwd    — FlashSFA backward (dense, compact and compact2 emits)
                   and the dense FlashAttention backward: f32 on
                   flash_sfa_bwd.cu's CUDA cores, bf16 on the tensor-core
                   kernels of flash_sfa_tc.cu and flash_attention.cu
flash_attention  — dense FlashAttention forward (the paper's baseline):
                   bf16 on the tensor cores (TMA + wgmma, csrc/hopper.cuh),
                   f32 on CUDA cores
code_grad        — dx and dW of the Q/K projection from compact code
                   gradients: bf16 on the tensor cores (codes densified in
                   shared memory, x or the split w by TMA), f32 on CUDA
                   cores
ops              — head folding, the SFA and dense attention autograd
                   Functions, the fused q/k codes, top-k helpers
ref              — the plain PyTorch versions of the kernels (and RoPE's
                   frequency table, which proj_rtopk's kernels read)
_build           — nvcc build of csrc/*.cu and ctypes binding

Each kernel wrapper runs its CUDA kernel for a CUDA tensor and its plain
version for a CPU tensor, and counts its kernel launches in
``<wrapper>.launches`` (``flash_sfa.block_skip_launches`` for the block-skip
schedule, ``flash_sfa_bwd.compact_launches`` for the compact emits).
``launch_counts()`` reads them all under one name per kernel (one per
PERF.md row, whichever body ran); ``body_counts()`` reads the launches of
the CUDA-core bodies alone of the kernels that also have a tensor-core one
(proj_rtopk, FlashSFA forward and backward, code_grad_dx and code_grad_dw:
``<wrapper>.cuda_core_launches``) and of rtopk's warp body
(``rtopk.warp_body_launches``), so a run shows which body its path took. A wrapper's
output has no ``grad_fn``: it refuses inputs that require grad, and
gradients go through the autograd Functions of ``ops`` and of
``models/attention.py`` on either device.
"""
from repro_torch.kernels.code_grad import code_grad_dw, code_grad_dx, scatter_code_grads
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.flash_sfa import block_skip_stats, flash_sfa
from repro_torch.kernels.flash_sfa_bwd import (
    flash_attention_bwd, flash_sfa_bwd, pair_closure_indices,
)
from repro_torch.kernels.flash_sfa_decode import (
    feature_major_prefill, flash_sfa_decode, flash_sfa_decode_fm,
    flash_sfa_decode_fm_paged, flash_sfa_decode_multi, flash_sfa_decode_paged,
)
from repro_torch.kernels.ops import (
    dense_attention_op, fold_heads, fused_qk_codes, sfa_attention_op, sfa_code,
    topk_dense, unfold_heads,
)
from repro_torch.kernels.rtopk import proj_rtopk, rtopk

# name -> (wrapper, counter attribute): one launch count per kernel of the
# PERF.md table, row 5's dense and compact emits apart
COUNTERS = {
    "rtopk": (rtopk, "launches"),
    "proj_rtopk": (proj_rtopk, "launches"),
    "flash_sfa": (flash_sfa, "launches"),
    "flash_sfa_block_skip": (flash_sfa, "block_skip_launches"),
    "flash_sfa_decode": (flash_sfa_decode, "launches"),
    "flash_sfa_decode_paged": (flash_sfa_decode_paged, "launches"),
    "flash_sfa_decode_multi": (flash_sfa_decode_multi, "launches"),
    "flash_sfa_decode_fm": (flash_sfa_decode_fm, "launches"),
    "flash_sfa_decode_fm_paged": (flash_sfa_decode_fm_paged, "launches"),
    "flash_sfa_bwd": (flash_sfa_bwd, "launches"),
    "flash_sfa_bwd_compact": (flash_sfa_bwd, "compact_launches"),
    "flash_attention": (flash_attention, "launches"),
    "flash_attention_bwd": (flash_attention_bwd, "launches"),
    "code_grad_dx": (code_grad_dx, "launches"),
    "code_grad_dw": (code_grad_dw, "launches"),
}


# the bodies that a dtype or shape can send a call to instead of the main
# ones: the CUDA-core bodies beside the tensor-core ones, rtopk's warp body
# beside its one-thread body
BODY_COUNTERS = {
    "rtopk_warp": (rtopk, "warp_body_launches"),
    "proj_rtopk_cuda_core": (proj_rtopk, "cuda_core_launches"),
    "flash_sfa_cuda_core": (flash_sfa, "cuda_core_launches"),
    "flash_sfa_bwd_cuda_core": (flash_sfa_bwd, "cuda_core_launches"),
    "code_grad_dx_cuda_core": (code_grad_dx, "cuda_core_launches"),
    "code_grad_dw_cuda_core": (code_grad_dw, "cuda_core_launches"),
}


def reset_launches() -> None:
    for fn, attr in (*COUNTERS.values(), *BODY_COUNTERS.values()):
        setattr(fn, attr, 0)


def body_counts() -> dict:
    return {name: getattr(fn, attr) for name, (fn, attr) in BODY_COUNTERS.items()}


def launch_counts() -> dict:
    return {name: getattr(fn, attr) for name, (fn, attr) in COUNTERS.items()}


__all__ = ["BODY_COUNTERS", "COUNTERS", "block_skip_stats", "body_counts",
           "code_grad_dw", "code_grad_dx",
           "dense_attention_op", "feature_major_prefill", "flash_attention",
           "flash_attention_bwd", "flash_sfa", "flash_sfa_bwd", "flash_sfa_decode",
           "flash_sfa_decode_fm", "flash_sfa_decode_fm_paged",
           "flash_sfa_decode_multi", "flash_sfa_decode_paged", "fold_heads",
           "fused_qk_codes", "launch_counts", "pair_closure_indices",
           "proj_rtopk", "reset_launches", "rtopk", "scatter_code_grads",
           "sfa_attention_op", "sfa_code", "topk_dense", "unfold_heads"]
