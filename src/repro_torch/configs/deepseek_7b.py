"""deepseek-7b [dense]: 30L d_model=4096 32H (kv=32, i.e. MHA) d_ff=11008
vocab=102400 — llama-arch [arXiv:2401.02954; hf]. head_dim = 128.
"""
from repro_torch.configs.base import AttentionConfig, ModelConfig

CONFIG = ModelConfig(
    name="deepseek-7b",
    family="dense",
    num_layers=30,
    d_model=4096,
    d_ff=11008,
    vocab_size=102_400,
    attention=AttentionConfig(
        num_heads=32,
        num_kv_heads=32,
        head_dim=128,
        sfa_k=16,
        rope=True,
        rope_theta=10_000.0,
    ),
    act="silu",
    glu=True,
    tie_embeddings=False,
    max_seq_len=131_072,
)
