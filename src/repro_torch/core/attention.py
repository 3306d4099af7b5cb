"""Plain attention paths: dense / SFA / sliding-window / decode.

The ``"torch"`` oracle backend's arithmetic, ported from the JAX package's
``repro/core/attention.py``. Activations are ``(batch, seq, heads,
head_dim)`` ("BTHD"); GQA is handled by the caller repeating KV heads.
"""
from __future__ import annotations

import torch

from repro_torch.core.sparse import topk_st

NEG_INF = -1e30


def _mask_ok(q_pos, k_pos, causal: bool, window):
    ok = torch.ones((q_pos.shape[0], k_pos.shape[0]), dtype=torch.bool,
                    device=q_pos.device)
    if causal:
        ok &= k_pos[None, :] <= q_pos[:, None]
    if window is not None:
        ok &= k_pos[None, :] > (q_pos[:, None] - window)
    return ok


def dense_attention_ref(q, k, v, *, causal=True, window=None, scale=None):
    """Materializing reference — small shapes / oracles only."""
    b, nq, h, d = q.shape
    nk = k.shape[1]
    scale = scale if scale is not None else d ** -0.5
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    ok = _mask_ok(torch.arange(nq, device=q.device),
                  torch.arange(nk, device=q.device), causal, window)
    s = torch.where(ok[None, None], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v.float()).to(q.dtype)


def chunked_attention(q, k, v, *, causal=True, window=None, scale=None,
                      chunk_size=1024, q_chunk=4096, kv_seg_offset=0):
    """Double-chunked online-softmax attention (flash-style, plain torch).

    Outer loop over q-chunks, inner loop over kv-chunks with the
    online-softmax carry (m, l, acc) in f32 — the JAX package's
    ``chunked_attention`` written as Python loops.
    """
    b, nq, h, d = q.shape
    if q_chunk is not None and nq > q_chunk:
        outs = [chunked_attention(
            q[:, s:s + q_chunk], k, v, causal=causal, window=window,
            scale=scale, chunk_size=chunk_size, q_chunk=None,
            kv_seg_offset=kv_seg_offset + s) for s in range(0, nq, q_chunk)]
        return torch.cat(outs, dim=1)
    nk = k.shape[1]
    dv = v.shape[-1]
    scale = scale if scale is not None else d ** -0.5
    dev = q.device
    qf = q.float().permute(0, 2, 1, 3) * scale                 # (b, h, nq, d)
    q_pos = torch.arange(nq, device=dev) + kv_seg_offset
    m = torch.full((b, h, nq), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((b, h, nq), dtype=torch.float32, device=dev)
    acc = torch.zeros((b, h, nq, dv), dtype=torch.float32, device=dev)
    for start in range(0, nk, chunk_size):
        kc = k[:, start:start + chunk_size].float().permute(0, 2, 1, 3)
        vc = v[:, start:start + chunk_size].float().permute(0, 2, 1, 3)
        k_pos = torch.arange(start, start + kc.shape[2], device=dev)
        s = torch.einsum("bhqd,bhcd->bhqc", qf, kc)
        ok = _mask_ok(q_pos, k_pos, causal, window)
        s = torch.where(ok[None, None], s, torch.full_like(s, NEG_INF))
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None] + torch.einsum("bhqc,bhcd->bhqd", p, vc)
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.permute(0, 2, 1, 3).to(q.dtype)


def sfa_attention(q, k, v, *, sfa_k: int, causal=True, window=None, scale=None,
                  chunk_size=1024, materialize=False):
    """Sparse Feature Attention (paper §3): Topk_k(Q), Topk_k(K), then exact
    softmax attention over the sparse codes. ``scale`` defaults to 1/sqrt(d)
    of the original head dim (paper Eq. 5)."""
    d = q.shape[-1]
    scale = scale if scale is not None else d ** -0.5
    qs = topk_st(q, sfa_k)
    ks = topk_st(k, sfa_k)
    if materialize:
        return dense_attention_ref(qs, ks, v, causal=causal, window=window,
                                   scale=scale)
    return chunked_attention(qs, ks, v, causal=causal, window=window,
                             scale=scale, chunk_size=chunk_size)


def decode_attention(q1, k_cache, v_cache, cache_len, *, window=None,
                     scale=None):
    """One-token decode vs a (possibly longer, pre-allocated) KV cache.

    q1: (b, 1, h, d); k_cache/v_cache: (b, n_max, h, d); cache_len: int or
    (b,) — number of valid cache entries (the new token's K/V already
    written at position cache_len-1 by the caller).
    """
    b, nmax, h, d = k_cache.shape
    scale = scale if scale is not None else q1.shape[-1] ** -0.5
    pos = torch.arange(nmax, device=q1.device)
    length = torch.as_tensor(cache_len, device=q1.device)
    length = length[:, None] if length.ndim == 1 else length.reshape(1, 1)
    ok = pos[None, :] < length
    if window is not None:
        ok = ok & (pos[None, :] > (length - 1 - window))
    s = torch.einsum("bqhd,bkhd->bhqk", q1.float(), k_cache.float()) * scale
    s = torch.where(ok[:, None, None, :], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", p, v_cache.float())
    return out.to(q1.dtype)
