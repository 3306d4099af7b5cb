"""Arch registry: ``get_config(name)`` / ``--arch <id>`` resolution.

The port takes the paper's own models (``gpt2-*``, ``qwen3-0.6b*``) and
every arch of the JAX package's registry (``_ARCH_MODULES``, one module
each): the dense llama-family archs, gemma3-4b (local/global windows), the
MoE archs moonshot-v1-16b-a3b and deepseek-v2-236b (MLA), the frontend
archs paligemma-3b (vlm) and hubert-xlarge (audio), and the recurrent
families jamba-v0.1-52b (hybrid: Mamba + attention + MoE) and rwkv6-3b
(ssm). ``NOT_YET_PORTED`` lists registered archs the port lacks; it is
empty.
"""
from __future__ import annotations

import importlib

from repro_torch.configs.base import (
    LM_SHAPES, AttentionConfig, FrontendConfig, MLAConfig, MoEConfig, ModelConfig,
    REMAT_POLICIES, RWKVConfig, ShapeConfig, SSMConfig, TrainPolicy, shape_by_name,
    skip_reason,
)
from repro_torch.configs import paper_models

# archs the JAX package registers whose model families the port has not
# reached yet
NOT_YET_PORTED = ()

# registered archs the port takes: id -> module of this package
_ARCH_MODULES = {
    "llama3.2-3b": "llama3_2_3b",
    "llama3-8b": "llama3_8b",
    "deepseek-7b": "deepseek_7b",
    "gemma3-4b": "gemma3_4b",
    "deepseek-v2-236b": "deepseek_v2_236b",
    "moonshot-v1-16b-a3b": "moonshot_v1_16b_a3b",
    "paligemma-3b": "paligemma_3b",
    "hubert-xlarge": "hubert_xlarge",
    "jamba-v0.1-52b": "jamba_v0_1_52b",
    "rwkv6-3b": "rwkv6_3b",
}

# the reference's assigned archs, in its order: the dry run's cells
ASSIGNED_ARCHS = ("gemma3-4b", "llama3.2-3b", "llama3-8b", "deepseek-7b",
                  "moonshot-v1-16b-a3b", "deepseek-v2-236b", "jamba-v0.1-52b",
                  "paligemma-3b", "rwkv6-3b", "hubert-xlarge")

_PORTED = "gpt2-*, qwen3-0.6b*, " + ", ".join(_ARCH_MODULES)


def get_config(name: str) -> ModelConfig:
    """Resolve a paper-model arch id to its config."""
    if name in NOT_YET_PORTED:
        raise KeyError(f"arch {name!r} is not yet ported to repro_torch; "
                       f"ported: {_PORTED}")
    if name in _ARCH_MODULES:
        return importlib.import_module(f"repro_torch.configs.{_ARCH_MODULES[name]}").CONFIG
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
    raise KeyError(f"unknown arch: {name!r}; ported: {_PORTED}")


__all__ = [
    "ASSIGNED_ARCHS", "AttentionConfig", "FrontendConfig", "LM_SHAPES", "MLAConfig", "MoEConfig",
    "ModelConfig", "NOT_YET_PORTED", "REMAT_POLICIES", "RWKVConfig",
    "SSMConfig", "ShapeConfig", "TrainPolicy", "get_config", "paper_models",
    "shape_by_name", "skip_reason",
]
