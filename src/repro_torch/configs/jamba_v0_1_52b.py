"""jamba-v0.1-52b [hybrid]: 32L d_model=4096 32H (kv=8) d_ff=14336 vocab=65536,
Mamba+attention 1:7 interleave, MoE 16e top-2 every other layer
[arXiv:2403.19887; hf].

Layout: super-blocks of 8 layers, attention at index 4 (rest Mamba); MoE
replaces the MLP on every second layer. SFA applies to the 4 attention
layers; Mamba layers have no QKᵀ.
"""
from repro_torch.configs.base import AttentionConfig, MoEConfig, ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="jamba-v0.1-52b",
    family="hybrid",
    num_layers=32,
    d_model=4096,
    d_ff=14336,
    vocab_size=65_536,
    attention=AttentionConfig(
        num_heads=32,
        num_kv_heads=8,
        head_dim=128,
        sfa_k=16,
        rope=False,                # jamba uses no positional encoding
    ),
    moe=MoEConfig(
        num_experts=16,
        top_k=2,
        expert_dim=14336,
        num_shared=0,
        every=2,
    ),
    ssm=SSMConfig(state_dim=16, conv_dim=4, expand=2),
    hybrid_period=8,
    hybrid_attn_index=4,
    act="silu",
    glu=True,
    tie_embeddings=False,
    pos_embedding="none",
    max_seq_len=262_144,
)
