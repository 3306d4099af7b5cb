"""rwkv6-3b [ssm]: 32L d_model=2560 (attention-free) d_ff=8960 vocab=65536 —
Finch, data-dependent decay [arXiv:2404.05892; hf].

SFA is inapplicable: RWKV has no QKᵀ score matrix. The arch runs without
the technique; decode is an O(1) state update per token.
"""
from repro_torch.configs.base import ModelConfig, RWKVConfig

CONFIG = ModelConfig(
    name="rwkv6-3b",
    family="ssm",
    num_layers=32,
    d_model=2560,
    d_ff=8960,
    vocab_size=65_536,
    attention=None,
    rwkv=RWKVConfig(head_dim=64, decay_lora=64, gate_lora=64),
    norm="layernorm",
    act="relu",                    # rwkv channel-mix uses squared relu
    glu=False,
    tie_embeddings=False,
    pos_embedding="none",
    max_seq_len=1_048_576,
)
