"""paligemma-3b [vlm]: 18L d_model=2048 8H (MQA kv=1) d_ff=16384 vocab=257216
— SigLIP + gemma [arXiv:2407.07726; hf]. head_dim = 256.

The SigLIP frontend is a stub: a request carries precomputed patch
embeddings (prefix_len patches of input_dim=1152), which a linear connector
projects into the gemma backbone in front of the text tokens.
"""
from repro_torch.configs.base import AttentionConfig, FrontendConfig, ModelConfig

CONFIG = ModelConfig(
    name="paligemma-3b",
    family="vlm",
    num_layers=18,
    d_model=2048,
    d_ff=16384,
    vocab_size=257_216,
    attention=AttentionConfig(
        num_heads=8,
        num_kv_heads=1,
        head_dim=256,
        sfa_k=16,
        rope=True,
        rope_theta=10_000.0,
    ),
    frontend=FrontendConfig(kind="patch", input_dim=1152, prefix_len=256),
    act="gelu",
    glu=True,
    tie_embeddings=True,
    max_seq_len=131_072,
)
