"""The paper's own pretraining models (Table 1 / Table 4) as configs.

GPT-2 Small/Medium (APE, LayerNorm, GELU) and a Qwen3-0.6B-class model
(RoPE, RMSNorm, qk-norm, GQA). Variants: dense baseline, short-embedding
baseline (halved Q/K hidden — Table 4 "short_hidden"), and SFA k∈{8,16}.
Same values as the JAX package's ``repro/configs/paper_models.py``.
"""
from dataclasses import replace

from repro_torch.configs.base import AttentionConfig, ModelConfig


def gpt2(size: str = "small", *, sfa_k=None, head_dim=None) -> ModelConfig:
    dims = {
        "small": dict(num_layers=12, d_model=768, heads=12),
        "medium": dict(num_layers=24, d_model=1024, heads=16),
    }[size]
    hd = head_dim or dims["d_model"] // dims["heads"]
    return ModelConfig(
        name=f"gpt2-{size}" + (f"-sfa{sfa_k}" if sfa_k else ""),
        family="dense",
        num_layers=dims["num_layers"],
        d_model=dims["d_model"],
        d_ff=4 * dims["d_model"],
        vocab_size=50_257,
        attention=AttentionConfig(
            num_heads=dims["heads"],
            num_kv_heads=dims["heads"],
            head_dim=hd,
            sfa_k=sfa_k,
            rope=False,
        ),
        norm="layernorm",
        act="gelu",
        glu=False,
        tie_embeddings=True,
        pos_embedding="learned",
        max_seq_len=131_072,
    )


def qwen3_06b(*, sfa_k=None, head_dim=128) -> ModelConfig:
    return ModelConfig(
        name="qwen3-0.6b" + (f"-sfa{sfa_k}" if sfa_k else ""),
        family="dense",
        num_layers=28,
        d_model=1024,
        d_ff=3072,
        vocab_size=151_936,
        attention=AttentionConfig(
            num_heads=16,
            num_kv_heads=8,
            head_dim=head_dim,
            sfa_k=sfa_k,
            rope=True,
            rope_theta=1_000_000.0,
            qk_norm=True,
            sfa_rope_protect=0,
        ),
        act="silu",
        glu=True,
        tie_embeddings=True,
        max_seq_len=131_072,
    )


def short_embedding(cfg: ModelConfig, factor: int = 2) -> ModelConfig:
    """Paper's 'short embedding' baseline: halve the Q/K head dim (Table 4)."""
    att = replace(cfg.attention, head_dim=cfg.attention.head_dim // factor,
                  sfa_k=None)
    return replace(cfg, name=cfg.name + f"-short{factor}", attention=att)
