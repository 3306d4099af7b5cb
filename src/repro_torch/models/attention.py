"""Model-level attention: GQA, qk-norm, RoPE, SFA, KV caches.

Ported from the JAX package's ``repro/models/attention.py`` (non-MLA).
Call modes sharing the parameters:

  * ``mode="train"`` / ``"eval"`` — full-sequence attention, differentiable
                         through the selected backend (the ``cuda``
                         backend's kernels backward included);
  * ``mode="prefill"`` — the same, additionally returning the layer's KV
                         cache (a typed ``KVCache``, sparse for SFA layers);
  * ``mode="decode"``  — one new token: its K code and V are written into
                         the cache at ``cache_len`` (in place), then the
                         query is scored against the cache.

``cfg.attention.backend`` selects the full-sequence path (train, eval and
prefill) and
``cfg.attention.decode_backend`` the decode path through the registry
(``repro_torch/models/backends.py``); the cache codes come from the
selected backend's own top-k (the rtopk kernel on the card).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.configs.base import AttentionConfig, ModelConfig
from repro_torch.core.kv_cache import DenseKV, KVCache, SparseKV, idx_dtype, pack_indices
from repro_torch.models.backends import AttentionRequest, DecodeQuery, select_backend
from repro_torch.models.layers import apply_norm, dense, dense_init, norm_init, rope


def attention_init(gen, cfg: ModelConfig, device="cpu"):
    a = cfg.attention
    if a.mla is not None:
        raise NotImplementedError("MLA attention comes with a later slice")
    d = cfg.d_model
    p = {
        "w_qkv": dense_init(gen, d, (a.num_heads + 2 * a.num_kv_heads) * a.head_dim,
                            device=device),
        "w_o": dense_init(gen, a.num_heads * a.head_dim, d, device=device),
    }
    if a.qk_norm:
        p["q_norm"] = norm_init(a.head_dim, device=device)
        p["k_norm"] = norm_init(a.head_dim, device=device)
    return p


def _request(a: AttentionConfig, *, mode: str, window) -> AttentionRequest:
    """Static backend request for this layer."""
    return AttentionRequest(
        mode=mode,
        causal=a.causal if mode == "full" else True,
        window=(window is not None) or (a.window is not None),
        mla=a.mla is not None,
        sparse=a.sfa_k is not None,
    )


def split_qkv(qkv, h: int, hkv: int, hd: int):
    """Packed (b, n, (h + 2·hkv)·hd) projection -> q (b, n, h, hd), k and v
    (b, n, hkv, hd): the column order of the JAX package's ``w_qkv``."""
    b, n, _ = qkv.shape
    q, k, v = torch.split(qkv, [h * hd, hkv * hd, hkv * hd], dim=-1)
    return q.reshape(b, n, h, hd), k.reshape(b, n, hkv, hd), v.reshape(b, n, hkv, hd)


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, device="cpu") -> KVCache:
    """Per-layer typed decode cache (the caller stacks across layers)."""
    a = cfg.attention
    if a.mla is not None:
        raise NotImplementedError("MLA caches come with a later slice")
    hkv, hd = a.num_kv_heads, a.head_dim

    def zeros(*shape, dt=dtype):
        return torch.zeros(shape, dtype=dt, device=device)

    if a.sfa_k is not None:
        kk = min(a.sfa_k, hd)
        return SparseKV(k_vals=zeros(batch, max_len, hkv, kk),
                        k_idx=zeros(batch, max_len, hkv, kk, dt=idx_dtype(hd)),
                        v=zeros(batch, max_len, hkv, hd))
    return DenseKV(k=zeros(batch, max_len, hkv, hd), v=zeros(batch, max_len, hkv, hd))


class AttentionOut(NamedTuple):
    out: torch.Tensor
    cache: Optional[KVCache]


def attention_apply(params, x, *, cfg: ModelConfig, positions=None,
                    window=None, mode: str = "train", cache=None,
                    cache_len=None) -> AttentionOut:
    a = cfg.attention
    if a.mla is not None:
        raise NotImplementedError("MLA attention comes with a later slice")
    if mode not in ("train", "eval", "prefill", "decode"):
        raise NotImplementedError(f"attention mode {mode!r} comes with a later slice")
    if a.sfa_rope_protect or a.sfa_draft_k:
        raise NotImplementedError("sfa_rope_protect / sfa_draft_k come with a later slice")
    if a.ring and mode in ("train", "eval"):
        raise NotImplementedError("Ring-SFA context parallelism is ROADMAP A.6")
    b, n, _ = x.shape
    h, hkv, hd = a.num_heads, a.num_kv_heads, a.head_dim
    dt = x.dtype
    q, k, v = split_qkv(dense(params["w_qkv"], x, dt), h, hkv, hd)
    if a.qk_norm:
        q = apply_norm(params["q_norm"], q)
        k = apply_norm(params["k_norm"], k)
    if a.rope:
        if positions is None:
            positions = torch.arange(n, device=x.device)[None, :]
        q = rope(q, positions, theta=a.rope_theta)
        k = rope(k, positions, theta=a.rope_theta)
    scale = hd ** -0.5

    if mode == "decode":
        if cache is None or cache_len is None:
            raise ValueError("decode mode needs a cache and cache_len")
        sel = select_backend(a.decode_backend, _request(a, mode="decode", window=window),
                             where=f"{cfg.name}/attention")
        # write the new token's K code and V at cache_len, then score
        if a.sfa_k is not None:
            k_vals, k_idx = sel.backend.code(k, a.sfa_k)             # (b, 1, hkv, k)
            cache.write(cache_len, k_vals=k_vals, k_idx=k_idx, v=v)
        else:
            cache.write(cache_len, k=k, v=v)
        ctx = sel.backend.decode(DecodeQuery(q=q), cache, cache_len,
                                 scale=scale, window=window, sfa_k=a.sfa_k)
        o = ctx.to(dt).reshape(b, 1, h * hd)
        return AttentionOut(dense(params["w_o"], o, dt), cache)

    sel = select_backend(a.backend, _request(a, mode="full", window=window),
                         where=f"{cfg.name}/attention")
    o = sel.backend.full(q, k, v, num_heads=h, sfa_k=a.sfa_k, causal=a.causal,
                         window=window, scale=scale, bwd_emit=a.bwd_emit)
    out = dense(params["w_o"], o.reshape(b, n, h * hd), dt)
    new_cache = None
    if mode == "prefill":
        if a.sfa_k is not None:
            k_vals, k_idx = sel.backend.code(k, a.sfa_k)
            new_cache = SparseKV(k_vals=k_vals.to(dt), k_idx=pack_indices(k_idx, hd), v=v)
        else:
            new_cache = DenseKV(k=k, v=v)
    return AttentionOut(out, new_cache)
