"""llama3-8b [dense]: 32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=128256.

GQA, 128k vocab [arXiv:2407.21783; unverified]. head_dim = 128.
"""
from repro_torch.configs.base import AttentionConfig, ModelConfig

CONFIG = ModelConfig(
    name="llama3-8b",
    family="dense",
    num_layers=32,
    d_model=4096,
    d_ff=14336,
    vocab_size=128_256,
    attention=AttentionConfig(
        num_heads=32,
        num_kv_heads=8,
        head_dim=128,
        sfa_k=16,
        rope=True,
        rope_theta=500_000.0,
    ),
    act="silu",
    glu=True,
    tie_embeddings=False,
    max_seq_len=131_072,
)
