"""Hand-written CUDA kernels for Hopper (sm_90a) and their plain versions.

rtopk            — exact row top-|k| (warp ballot bisection on bit patterns)
flash_sfa        — FlashSFA forward (prefill attention over top-k codes)
flash_sfa_decode — one query against the token-major sparse KV cache
flash_sfa_bwd    — FlashSFA backward (dense emit) and the dense
                   FlashAttention backward, one templated source
flash_attention  — dense FlashAttention forward (the paper's baseline)
ops              — head folding, the SFA and dense attention autograd
                   Functions, top-k helpers
ref              — the plain PyTorch versions of the kernels
_build           — nvcc build of csrc/*.cu and ctypes binding

Each kernel wrapper runs its CUDA kernel for a CUDA tensor and its plain
version for a CPU tensor, and counts its kernel launches in
``<wrapper>.launches``. A wrapper's output has no ``grad_fn``: it refuses
inputs that require grad, and gradients go through the autograd Functions
of ``ops`` on either device.
"""
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.flash_sfa import flash_sfa
from repro_torch.kernels.flash_sfa_bwd import flash_attention_bwd, flash_sfa_bwd
from repro_torch.kernels.flash_sfa_decode import flash_sfa_decode
from repro_torch.kernels.ops import (
    dense_attention_op, fold_heads, sfa_attention_op, sfa_code, topk_dense,
    unfold_heads,
)
from repro_torch.kernels.rtopk import rtopk

KERNELS = {"rtopk": rtopk, "flash_sfa": flash_sfa,
           "flash_sfa_decode": flash_sfa_decode, "flash_sfa_bwd": flash_sfa_bwd,
           "flash_attention": flash_attention,
           "flash_attention_bwd": flash_attention_bwd}


def reset_launches() -> None:
    for fn in KERNELS.values():
        fn.launches = 0


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in KERNELS.items()}


__all__ = ["KERNELS", "dense_attention_op", "flash_attention",
           "flash_attention_bwd", "flash_sfa", "flash_sfa_bwd",
           "flash_sfa_decode", "fold_heads", "launch_counts", "reset_launches",
           "rtopk", "sfa_attention_op", "sfa_code", "topk_dense",
           "unfold_heads"]
