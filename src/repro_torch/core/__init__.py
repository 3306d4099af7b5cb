"""Core: the paper's Sparse Feature Attention in plain PyTorch."""
from repro_torch.core.attention import (
    chunked_attention, decode_attention, dense_attention_ref, sfa_attention,
)
from repro_torch.core.sparse import SparseCode, densify, sparsify, topk_mask, topk_st

__all__ = ["SparseCode", "chunked_attention", "decode_attention",
           "dense_attention_ref", "densify", "sfa_attention", "sparsify",
           "topk_mask", "topk_st"]
