"""Arch registry: ``get_config(name)`` / ``--arch <id>`` resolution.

The port serves the paper's own models so far (``gpt2-*``, ``qwen3-0.6b*``);
every other arch of the JAX package's registry raises ``KeyError`` naming it
as not yet ported.
"""
from __future__ import annotations

from repro_torch.configs.base import (
    AttentionConfig, FrontendConfig, MLAConfig, MoEConfig, ModelConfig,
    REMAT_POLICIES, RWKVConfig, SSMConfig, TrainPolicy,
)
from repro_torch.configs import paper_models

# archs the JAX package registers whose model families the port has not
# reached yet (MoE, hybrid, SSM, MLA, windows, frontends)
NOT_YET_PORTED = (
    "gemma3-4b", "llama3.2-3b", "llama3-8b", "deepseek-7b",
    "moonshot-v1-16b-a3b", "deepseek-v2-236b", "jamba-v0.1-52b",
    "paligemma-3b", "rwkv6-3b", "hubert-xlarge",
)


def get_config(name: str) -> ModelConfig:
    """Resolve a paper-model arch id to its config."""
    if name in NOT_YET_PORTED:
        raise KeyError(f"arch {name!r} is not yet ported to repro_torch; "
                       f"ported: gpt2-*, qwen3-0.6b*")
    if name.startswith("gpt2-"):
        parts = name.split("-")          # gpt2-small[-sfa8|-short2]
        size = parts[1]
        if len(parts) == 2:
            return paper_models.gpt2(size)
        if parts[2].startswith("sfa"):
            return paper_models.gpt2(size, sfa_k=int(parts[2][3:]))
        if parts[2].startswith("short"):
            return paper_models.short_embedding(paper_models.gpt2(size),
                                                int(parts[2][5:]))
    if name.startswith("qwen3-0.6b"):
        suffix = name[len("qwen3-0.6b"):]
        if not suffix:
            return paper_models.qwen3_06b()
        if suffix.startswith("-sfa"):
            return paper_models.qwen3_06b(sfa_k=int(suffix[4:]))
        if suffix.startswith("-short"):
            return paper_models.short_embedding(paper_models.qwen3_06b(),
                                                int(suffix[6:]))
    raise KeyError(f"unknown arch: {name!r}; ported: gpt2-*, qwen3-0.6b*")


__all__ = [
    "AttentionConfig", "FrontendConfig", "MLAConfig", "MoEConfig",
    "ModelConfig", "NOT_YET_PORTED", "REMAT_POLICIES", "RWKVConfig",
    "SSMConfig", "TrainPolicy", "get_config", "paper_models",
]
