"""Analytic FLOP, parameter and HBM-byte models per (arch × shape).

The port's own copy of the JAX package's ``repro/utils/analytic.py``, over
the port's configs, ``core.remat.normalize_remat``, ``models.model.segments``
and ``serve.kv_cache.cache_bytes_per_token``: the same config and shape
give the same numbers, for every family ``segments`` takes: dense and MoE
blocks, MLA attention, the vlm and audio frontends (no token embedding for
audio, the frontend's input_dim × d_model for both), jamba's super-blocks
(Mamba or attention, then MoE or an MLP of width ``d_ff``; a Mamba sublayer
adds 8 · d_inner · d_state FLOPs a token for its scan) and rwkv layers
(3 · d · head_dim FLOPs a token for the WKV recurrence).

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


def _mamba_params(cfg: ModelConfig) -> int:
    s = cfg.ssm
    d = cfg.d_model
    di = s.expand * d
    dtr = s.dt_rank or -(-d // 16)
    return (d * 2 * di + s.conv_dim * di + di * (dtr + 2 * s.state_dim)
            + dtr * di + di * s.state_dim + di * d + 2 * di)


def _rwkv_params(cfg: ModelConfig) -> int:
    d = cfg.d_model
    r = cfg.rwkv
    tm = 5 * d * d + d * r.decay_lora * 2 + d    # r, k, v, g, o + decay LoRA + w0
    cm = 2 * d * cfg.d_ff + d * d
    return tm + cm


def _jamba_moe(cfg: ModelConfig, i: int) -> bool:
    """Whether sublayer i of a jamba super-block has MoE (else an MLP)."""
    return i % cfg.moe.every == cfg.moe.every - 1


def _jamba_sub(cfg: ModelConfig, i: int) -> tuple[int, int, int]:
    """Sublayer i of a super-block: (mixer params, feed-forward total
    params, feed-forward active params)."""
    mixer = _attn_params(cfg) if i == cfg.hybrid_attn_index else _mamba_params(cfg)
    if _jamba_moe(cfg, i):
        return (mixer,) + _moe_params(cfg)
    ff = _mlp_params(cfg, cfg.d_ff)
    return mixer, ff, ff


def param_count(cfg: ModelConfig) -> dict:
    """{'total': N, 'active': N_active} (they differ only for MoE)."""
    d = cfg.d_model
    emb = cfg.vocab_size * d if cfg.family != "audio" else 0
    head = 0 if cfg.tie_embeddings else cfg.vocab_size * d
    fe = cfg.frontend.input_dim * d if cfg.frontend else 0
    total = active = emb + head + fe
    for kind, count in segments(cfg):
        if kind == "rwkv":
            total += count * _rwkv_params(cfg)
            active += count * _rwkv_params(cfg)
            continue
        if kind == "jamba":
            for i in range(cfg.hybrid_period):
                mixer, tt, aa = _jamba_sub(cfg, i)
                total += count * (mixer + tt)
                active += count * (mixer + aa)
            continue
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
    m = cfg.moe
    dispatch = (4 * m.capacity_factor * m.top_k * min(GROUP, n) * cfg.d_model
                if m is not None else 0)
    fwd, li = 0.0, 0
    for kind, count in segments(cfg):
        if kind == "rwkv":
            for _ in range(count):
                fwd += (2 * _rwkv_params(cfg) + 3 * cfg.d_model * cfg.rwkv.head_dim) * tokens
            li += count
            continue
        if kind == "jamba":
            scan = 8 * cfg.ssm.expand * cfg.d_model * cfg.ssm.state_dim
            for _ in range(count):
                for i in range(cfg.hybrid_period):
                    f = (_attn_flops_per_token(cfg, n, li + i) if i == cfg.hybrid_attn_index
                         else 2 * _mamba_params(cfg) + scan)
                    f += (2 * _jamba_sub(cfg, i)[2] + dispatch if _jamba_moe(cfg, i)
                          else 2 * _mlp_params(cfg, cfg.d_ff))
                    fwd += f * tokens
                li += cfg.hybrid_period
            continue
        if kind == "block_moe":
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
