"""hubert-xlarge [audio]: 48L d_model=1280 16H (kv=16) d_ff=5120 vocab=504 —
encoder-only, same arch as wav2vec2 [arXiv:2106.07447; unverified].

The conv waveform frontend is a stub: a batch carries precomputed frame
embeddings (input_dim=512 conv features), which a dense layer projects to
d_model. Encoder-only: bidirectional SFA, no decode. The training target is
HuBERT-style per-frame cluster prediction over 504 units.
"""
from repro_torch.configs.base import AttentionConfig, FrontendConfig, ModelConfig

CONFIG = ModelConfig(
    name="hubert-xlarge",
    family="audio",
    num_layers=48,
    d_model=1280,
    d_ff=5120,
    vocab_size=504,
    attention=AttentionConfig(
        num_heads=16,
        num_kv_heads=16,
        head_dim=80,
        sfa_k=16,
        rope=False,
        causal=False,
    ),
    frontend=FrontendConfig(kind="frame", input_dim=512, prefix_len=0),
    norm="layernorm",
    act="gelu",
    glu=False,
    tie_embeddings=False,
    causal=False,
    pos_embedding="learned",
    max_seq_len=65_536,
)
