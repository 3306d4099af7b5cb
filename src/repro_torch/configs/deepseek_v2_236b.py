"""deepseek-v2-236b [moe]: 60L d_model=5120 128H expert d_ff=1536 vocab=102400,
MLA kv_lora=512, MoE 2 shared + 160 routed top-6 [arXiv:2405.04434; hf].

SFA composes with MLA in the absorbed latent space (paper Table 10
"MLA + SFA"): the latent cache stays MLA-compressed, with the top-k code of
each token's latent packed beside it for scoring.
"""
from repro_torch.configs.base import AttentionConfig, MLAConfig, MoEConfig, ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v2-236b",
    family="moe",
    num_layers=60,
    d_model=5120,
    d_ff=1536,                     # routed-expert hidden
    vocab_size=102_400,
    attention=AttentionConfig(
        num_heads=128,
        num_kv_heads=128,
        head_dim=192,              # nope 128 + rope 64
        sfa_k=16,
        mla=MLAConfig(
            kv_lora_rank=512,
            q_lora_rank=1536,
            nope_head_dim=128,
            rope_head_dim=64,
            v_head_dim=128,
        ),
        rope=True,
        rope_theta=10_000.0,
        sfa_rope_protect=64,       # keep RoPE dims dense (paper A.1)
    ),
    moe=MoEConfig(
        num_experts=160,
        top_k=6,
        expert_dim=1536,
        num_shared=2,
        every=1,
        first_dense=1,
    ),
    act="silu",
    glu=True,
    tie_embeddings=False,
    max_seq_len=131_072,
)
