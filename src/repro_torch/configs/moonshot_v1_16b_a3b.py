"""moonshot-v1-16b-a3b [moe]: 48L d_model=2048 16H (kv=16) expert d_ff=1408
vocab=163840, MoE 64 routed top-6 (+2 shared, first layer dense) — kimi/
moonlight [hf:moonshotai/Moonlight-16B-A3B; hf]. head_dim = 128.
"""
from repro_torch.configs.base import AttentionConfig, MoEConfig, ModelConfig

CONFIG = ModelConfig(
    name="moonshot-v1-16b-a3b",
    family="moe",
    num_layers=48,
    d_model=2048,
    d_ff=1408,                     # routed-expert hidden (d_ff doubles as expert_dim)
    vocab_size=163_840,
    attention=AttentionConfig(
        num_heads=16,
        num_kv_heads=16,
        head_dim=128,
        sfa_k=16,
        rope=True,
        rope_theta=50_000.0,
    ),
    moe=MoEConfig(
        num_experts=64,
        top_k=6,
        expert_dim=1408,
        num_shared=2,
        every=1,
        first_dense=1,
    ),
    act="silu",
    glu=True,
    tie_embeddings=False,
    max_seq_len=131_072,
)
