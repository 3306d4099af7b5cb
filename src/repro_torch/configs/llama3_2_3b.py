"""llama3.2-3b [dense]: 28L d_model=3072 24H (GQA kv=8) d_ff=8192 vocab=128256.

Small llama3 [hf:meta-llama/Llama-3.2-1B; unverified]. head_dim = 3072/24 = 128.
"""
from repro_torch.configs.base import AttentionConfig, ModelConfig

CONFIG = ModelConfig(
    name="llama3.2-3b",
    family="dense",
    num_layers=28,
    d_model=3072,
    d_ff=8192,
    vocab_size=128_256,
    attention=AttentionConfig(
        num_heads=24,
        num_kv_heads=8,
        head_dim=128,
        sfa_k=16,
        rope=True,
        rope_theta=500_000.0,
    ),
    act="silu",
    glu=True,
    tie_embeddings=True,
    max_seq_len=131_072,
)
