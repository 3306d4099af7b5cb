"""gemma3-4b [dense]: 34L d_model=2560 8H (GQA kv=4) d_ff=10240 vocab=262144.

5:1 local:global attention interleave (window 1024), 128k context.
[hf:google/gemma-3-1b-pt; unverified]. head_dim follows the published gemma3
config (256; q/kv projections are decoupled from d_model).
SFA (k=16, d=256) applies to both local and global layers; the global layers
carry ``models.model.GLOBAL_WINDOW``, so every layer requests a window and
runs on the ``torch`` backend, as the reference runs it on XLA.
"""
from repro_torch.configs.base import AttentionConfig, ModelConfig

CONFIG = ModelConfig(
    name="gemma3-4b",
    family="dense",
    num_layers=34,
    d_model=2560,
    d_ff=10240,
    vocab_size=262_144,
    attention=AttentionConfig(
        num_heads=8,
        num_kv_heads=4,
        head_dim=256,
        sfa_k=16,
        window=1024,
        local_global_pattern=5,      # 5 local then 1 global
        rope=True,
        rope_theta=1_000_000.0,
        qk_norm=True,
    ),
    act="gelu",
    glu=True,
    tie_embeddings=True,
    max_seq_len=131_072,
)
