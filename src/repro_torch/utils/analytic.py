"""Analytic FLOP, parameter and HBM-byte models per (arch × shape).

The port's own copy of the JAX package's ``repro/utils/analytic.py``, over
the port's configs, ``core.remat.normalize_remat``, ``models.model.segments``
and ``serve.kv_cache.cache_bytes_per_token``: the same config and shape
give the same numbers. It takes the families ``segments`` takes (dense
blocks); for any other family ``segments`` raises, and so does this.

Conventions: a (m, k) × (k, n) matmul is 2mkn FLOPs; causal attention
halves the score and PV terms; the backward is 2× the forward; remat adds
one forward recompute. Attention compute is counted dense, as the kernels'
densified tensor-core bodies run it; SFA's savings show in the byte model
(the sparse KV cache).
"""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.core.remat import normalize_remat
from repro_torch.models.model import segments
from repro_torch.serve.kv_cache import cache_bytes_per_token


def _attn_params(cfg: ModelConfig) -> int:
    a = cfg.attention
    return cfg.d_model * a.head_dim * (a.num_heads * 2 + a.num_kv_heads * 2)


def _mlp_params(cfg: ModelConfig) -> int:
    return cfg.d_model * cfg.d_ff * (3 if cfg.glu else 2)


def param_count(cfg: ModelConfig) -> dict:
    """{'total': N, 'active': N} (the two differ only for MoE, which the
    port does not take yet)."""
    d = cfg.d_model
    emb = cfg.vocab_size * d
    head = 0 if cfg.tie_embeddings else cfg.vocab_size * d
    total = emb + head
    for _, count in segments(cfg):
        total += count * (_attn_params(cfg) + _mlp_params(cfg))
    return {"total": total, "active": total}


def _attn_flops_per_token(cfg: ModelConfig, ctx: int, layer: int) -> float:
    """Projections + scores + PV for one token of layer ``layer`` against
    ``ctx`` context (a local layer of a local/global pattern sees its
    window)."""
    a = cfg.attention
    eff = ctx / 2 if cfg.causal else ctx
    pat = a.local_global_pattern
    if a.window is not None and not (pat is not None and layer % (pat + 1) == pat):
        eff = min(eff, a.window)
    return 2 * _attn_params(cfg) + 4 * eff * a.num_heads * a.head_dim


def step_flops(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    """Whole-step FLOPs (``total_flops``, ``forward_flops``) and the 6N
    (train) or 2N (otherwise) ``model_flops`` per token reference."""
    b, n = shape.global_batch, shape.seq_len
    pc = param_count(cfg)
    tokens = b if shape.kind == "decode" else b * n     # decode: one new token each
    layers = sum(count for _, count in segments(cfg))
    fwd = sum(_attn_flops_per_token(cfg, n, i) + 2 * _mlp_params(cfg)
              for i in range(layers)) * tokens
    fwd += 2 * cfg.d_model * cfg.vocab_size * tokens      # logits
    if shape.kind == "train":
        # forward + backward (2x) + one recompute under any remat policy
        mult = 3 + (1 if normalize_remat(cfg.remat) != "none" else 0)
        total = fwd * mult
        model = 6.0 * pc["active"] * tokens
    else:
        total = fwd
        model = 2.0 * pc["active"] * tokens
    return {"total_flops": total, "forward_flops": fwd,
            "model_flops": model, "useful_ratio": model / max(total, 1)}


def step_hbm_bytes(cfg: ModelConfig, shape: ShapeConfig, ndev: int) -> dict:
    """Per-device HBM bytes of one step: f32 parameter shards, the KV cache
    (decode: sparse K + dense V from ``cache_bytes_per_token``, with the
    dense cache's total beside it), activations, and for training the
    AdamW moments and gradients."""
    b, n = shape.global_batch, shape.seq_len
    pc = param_count(cfg)
    pbytes = pc["total"] * 4 / ndev
    per_tok = cache_bytes_per_token(cfg)
    if shape.kind == "decode":
        cache = per_tok["sfa"] * n * b / ndev
        act = b * cfg.d_model * cfg.num_layers * 4 * 2 / ndev
        dense_cache = per_tok["dense"] * n * b / ndev
        return {"bytes_per_dev": pbytes + cache + act, "params": pbytes, "cache": cache,
                "dense_cache_alt": pbytes + dense_cache + act}
    act_io = b * n * cfg.d_model * 2 * 2 * cfg.num_layers / ndev
    if shape.kind == "train":
        opt = pc["total"] * (4 * 2 * 2) / ndev            # m, v read + write
        grads = pc["total"] * 4 * 2 / ndev
        total = 3 * pbytes + opt + grads + 3 * act_io
    else:
        total = pbytes + 2 * act_io
    return {"bytes_per_dev": total, "params": pbytes, "act_io": act_io}
