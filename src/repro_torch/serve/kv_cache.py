"""KV-cache byte accounting: the analytic per-token model and the measured
bytes of the caches a config allocates.

Ported from the JAX package's ``repro/serve/kv_cache.py``:
``cache_bytes_per_token`` is the paper's Figure-5 model (``dense``, packed
``sfa`` — uint8 indices for d <= 256 give Appendix J's 2d/(3k+4) on the K
half, with ``sfa_rope_protect`` p leading dims dense beside a code over the
d - p others — and the feature-major ``fm`` image, which stores K dense;
for MLA, the latent and its RoPE part, plus the packed latent code);
``realized_cache_bytes_per_token`` and ``paged_page_bytes`` measure the
typed caches the port allocates. The JAX package measures shapes with
``jax.eval_shape``; the port builds the caches on the ``meta`` device, so
nothing is allocated either.
"""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig
from repro_torch.core.kv_cache import cache_nbytes, idx_bytes


def cache_bytes_per_token(cfg: ModelConfig) -> dict:
    """Per-token KV bytes by layout, all ``num_layers`` layers (as the
    reference counts them: for jamba, whose attention is one sublayer in
    ``hybrid_period``, that is ``hybrid_period`` x what its caches hold; an
    attention-free model has {"dense": 0, "sfa": 0}), bf16 at rest: ``dense``,
    ``sfa`` (top-k values + packed indices for K, dense V) and, for SFA
    configs other than MLA, ``fm`` (the dense feature-major K image + V).
    MLA: ``dense`` is the latent + its RoPE part, ``sfa`` adds the packed
    top-k code of the latent."""
    a = cfg.attention
    if a is None:
        return {"dense": 0, "sfa": 0}
    if a.mla is not None:
        m = a.mla
        base = (m.kv_lora_rank + m.rope_head_dim) * 2
        sfa = base if a.sfa_k is None else (
            base + min(a.sfa_k, m.kv_lora_rank) * (2 + idx_bytes(m.kv_lora_rank)))
        return {"dense": base * cfg.num_layers, "sfa": sfa * cfg.num_layers}
    hkv, hd = a.num_kv_heads, a.head_dim
    dense = 2 * hkv * hd * 2                     # K + V bf16
    if a.sfa_k is None:
        sfa = dense
    else:
        p = a.sfa_rope_protect
        k_part = hkv * (min(a.sfa_k, hd - p) * (2 + idx_bytes(hd - p)) + p * 2)
        sfa = k_part + hkv * hd * 2              # sparse K + dense V
    return {"dense": dense * cfg.num_layers, "sfa": sfa * cfg.num_layers,
            "fm": dense * cfg.num_layers}


def realized_cache_bytes_per_token(cfg: ModelConfig, *, max_len: int = 128,
                                   batch: int = 1) -> float:
    """Measured per-token bytes of the typed decode caches a config
    allocates (on the meta device; KV caches only, a recurrent state is
    not KV): ``cache_bytes_per_token(cfg)["sfa"]``
    for a token-major SFA cache (protected dims and the MLA latent
    included), ``["fm"]`` when the decode backend keeps the feature-major
    image."""
    from repro_torch.models.model import init_decode_caches
    caches = init_decode_caches(cfg, batch, max_len, device="meta")
    return cache_nbytes(caches) / (batch * max_len)


def paged_page_bytes(cfg: ModelConfig, *, page_size: int = 128) -> int:
    """Bytes one pool page costs across all layers of a config's paged
    decode cache, measured as the difference of the caches at 2 and 1 pool
    pages (the block table cancels). The paged engine divides its memory
    budget by this to size the pool."""
    from repro_torch.models.model import init_paged_decode_caches

    def total(pages):
        return cache_nbytes(init_paged_decode_caches(
            cfg, slots=1, num_pages=pages, page_size=page_size, max_pages=1,
            device="meta"))

    return total(2) - total(1)
