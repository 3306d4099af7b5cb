"""Analytic FLOP, parameter and HBM-byte models per (arch × shape).

The port's own copy of the JAX package's ``repro/utils/analytic.py``, over
the port's configs, ``core.remat.normalize_remat``, ``models.model.segments``
and ``serve.kv_cache.cache_bytes_per_token``: the same config and shape
give the same numbers. It takes the families ``segments`` takes (dense
and MoE blocks, MLA attention, and the vlm and audio frontends: no token embedding for
audio, the frontend's input_dim × d_model for both); for any other family
``segments`` raises, and so does this.

Conventions: a (m, k) × (k, n) matmul is 2mkn FLOPs; causal attention
halves the score and PV terms; the backward is 2× the forward; remat adds
one forward recompute. Attention compute is counted dense, as the kernels'
densified tensor-core bodies run it; SFA's savings show in the byte model
(the sparse KV cache). An MoE layer counts its active experts (top-k
routed + shared + router) and the reference's one-hot dispatch and combine
einsums over groups of ``models.moe.GROUP`` tokens (4 · cf · top_k · gs · d a
token), which the port's index dispatch does not run.
"""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.core.remat import normalize_remat
from repro_torch.models.model import dense_ff, segments
from repro_torch.models.moe import GROUP
from repro_torch.serve.kv_cache import cache_bytes_per_token


def _attn_params(cfg: ModelConfig) -> int:
    a = cfg.attention
    d = cfg.d_model
    if a.mla is not None:
        m, h = a.mla, a.num_heads
        return (d * m.q_lora_rank + m.q_lora_rank * h * m.nope_head_dim
                + m.q_lora_rank * h * m.rope_head_dim + d * m.kv_lora_rank
                + m.kv_lora_rank * h * m.nope_head_dim + d * m.rope_head_dim
                + m.kv_lora_rank * h * m.v_head_dim + h * m.v_head_dim * d)
    return d * a.head_dim * (a.num_heads * 2 + a.num_kv_heads * 2)


def _mlp_params(cfg: ModelConfig, ff: int) -> int:
    return cfg.d_model * ff * (3 if cfg.glu else 2)


def _moe_params(cfg: ModelConfig) -> tuple[int, int]:
    """(total, active) parameters of one MoE layer."""
    m = cfg.moe
    per_exp = cfg.d_model * m.expert_dim * (3 if cfg.glu else 2)
    shared = m.num_shared * per_exp
    router = cfg.d_model * m.num_experts
    return (m.num_experts * per_exp + shared + router,
            m.top_k * per_exp + shared + router)


def param_count(cfg: ModelConfig) -> dict:
    """{'total': N, 'active': N_active} (they differ only for MoE)."""
    d = cfg.d_model
    emb = cfg.vocab_size * d if cfg.family != "audio" else 0
    head = 0 if cfg.tie_embeddings else cfg.vocab_size * d
    fe = cfg.frontend.input_dim * d if cfg.frontend else 0
    total = active = emb + head + fe
    for kind, count in segments(cfg):
        if kind == "block_moe":
            tt, aa = _moe_params(cfg)
        else:
            tt = aa = _mlp_params(cfg, dense_ff(cfg))
        total += count * (_attn_params(cfg) + tt)
        active += count * (_attn_params(cfg) + aa)
    return {"total": total, "active": active}


def _attn_flops_per_token(cfg: ModelConfig, ctx: int, layer: int) -> float:
    """Projections + scores + PV for one token of layer ``layer`` against
    ``ctx`` context (a local layer of a local/global pattern sees its
    window; MLA scores over r + dr latent dims and aggregates r)."""
    a = cfg.attention
    eff = ctx / 2 if cfg.causal else ctx
    pat = a.local_global_pattern
    if a.window is not None and not (pat is not None and layer % (pat + 1) == pat):
        eff = min(eff, a.window)
    if a.mla is not None:
        m = a.mla
        att = 2 * eff * a.num_heads * ((m.kv_lora_rank + m.rope_head_dim) + m.kv_lora_rank)
    else:
        att = 4 * eff * a.num_heads * a.head_dim
    return 2 * _attn_params(cfg) + att


def step_flops(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    """Whole-step FLOPs (``total_flops``, ``forward_flops``) and the 6N
    (train) or 2N (otherwise) ``model_flops`` per token reference."""
    b, n = shape.global_batch, shape.seq_len
    pc = param_count(cfg)
    tokens = b if shape.kind == "decode" else b * n     # decode: one new token each
    fwd, li = 0.0, 0
    for kind, count in segments(cfg):
        if kind == "block_moe":
            m = cfg.moe
            dispatch = 4 * m.capacity_factor * m.top_k * min(GROUP, n) * cfg.d_model
            mlp = 2 * _moe_params(cfg)[1] + dispatch
        else:
            mlp = 2 * _mlp_params(cfg, dense_ff(cfg))
        for i in range(li, li + count):
            fwd += (_attn_flops_per_token(cfg, n, i) + mlp) * tokens
        li += count
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
