"""Typed attention-backend registry: capability-based kernel selection.

Ported from the JAX package's ``repro/models/backends.py``. A backend has a
``Capabilities`` record and three entry points:

  * ``full(q, k, v, ...)`` — full-sequence attention (prefill) on
                             ``(b, n, h, d)`` q and ``(b, n, hkv, d)`` k/v;
  * ``decode(query, cache, lengths, ...)`` — one new token against a typed
                             ``KVCache``, returning ``(b, h, dv)``;
  * ``code(x, k)``         — the top-k code the backend stores in the cache.

Registered backends:

  * ``torch`` — the plain oracle (chunked online softmax, gather-scoring
                decode, bisection top-k); runs on either device and
                supports every layer this port serves.
  * ``cuda``  — the hand-written kernels: rtopk -> FlashSFA forward and
                backward for SFA layers and FlashAttention forward and
                backward for dense ones (train and prefill, differentiable
                through the autograd Functions of ``kernels/ops.py``), the
                token-major sparse-cache decode kernel, rtopk for every
                top-k. Dense decode has no kernel (as in the JAX package)
                and goes to ``torch``. On CPU tensors the kernel wrappers
                run their plain versions, so the same routing and the same
                backward seam are testable without a card.
  * ``auto``  — not a backend but a policy: ``cuda`` where it can serve
                the request, else ``torch``, with nothing recorded.

An explicitly requested backend that cannot serve a layer (window, MLA,
dense decode) falls back to ``torch`` with a structured
``FallbackReport``, recorded once per (backend, request, site) and queryable
through ``fallback_reports()``.
"""
from __future__ import annotations

import dataclasses
import logging
from typing import NamedTuple, Optional

import torch

from repro_torch.core.attention import NEG_INF, chunked_attention
from repro_torch.core.kv_cache import KVCache, SparseKV, unpack_indices
from repro_torch.core.sparse import sparsify, topk_st
from repro_torch.kernels.flash_sfa_decode import flash_sfa_decode
from repro_torch.kernels.ops import (
    dense_attention_op, sfa_attention_op, sfa_code, topk_dense,
)

_LOG = logging.getLogger(__name__)


# --------------------------------------------------------------------------
# request / capabilities
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class AttentionRequest:
    """Static description of what a layer needs from a backend."""
    mode: str                    # "full" (prefill) | "decode"
    causal: bool = True
    window: bool = False         # sliding-window mask required
    mla: bool = False            # latent (MLA) attention
    sparse: bool = False         # sfa_k is set


@dataclasses.dataclass(frozen=True)
class Capabilities:
    full: bool = False
    decode: bool = False
    causal: bool = True
    bidirectional: bool = False
    window: bool = False
    mla: bool = False
    sparse: bool = True
    dense: bool = True


class DecodeQuery(NamedTuple):
    """Query pieces for one decode step: q (b, 1, h, d) dense post-RoPE
    query (MLA's RoPE part joins with the MLA slice)."""
    q: torch.Tensor


class AttentionBackend:
    name: str = "?"
    caps: Capabilities = Capabilities()

    def unsupported_reason(self, req: AttentionRequest) -> Optional[str]:
        """None if this backend can serve ``req``, else a human reason."""
        c = self.caps
        if req.mode == "full" and not c.full:
            return "no full-sequence path"
        if req.mode == "decode" and not c.decode:
            return "no decode path"
        if req.causal and not c.causal:
            return "causal masking not supported"
        if not req.causal and not c.bidirectional:
            return "bidirectional attention not supported"
        if req.window and not c.window:
            return "windowed attention not supported"
        if req.mla and not c.mla:
            return "MLA latent attention not supported"
        if req.sparse and not c.sparse:
            return "SFA sparse attention not supported"
        if not req.sparse and not c.dense:
            return "dense attention not supported"
        return None

    def full(self, q, k, v, *, num_heads, sfa_k, causal, window, scale,
             bwd_emit="dense"):
        """q: (b, n, h, d); k/v: (b, n, hkv, d) — the backend expands KV
        heads itself. Differentiable in q, k and v."""
        raise NotImplementedError(self.name)

    def decode(self, query: DecodeQuery, cache: KVCache, lengths, *,
               scale, window, sfa_k):
        raise NotImplementedError(self.name)

    def code(self, x, k: int):
        """(values (..., k) in x.dtype, indices (..., k)) of x's top-k."""
        raise NotImplementedError(self.name)


# --------------------------------------------------------------------------
# shared helpers
# --------------------------------------------------------------------------

def expand_kv(t, h):
    """(b, n, hkv, ...) -> (b, n, h, ...) GQA head repeat."""
    hkv = t.shape[2]
    if hkv == h:
        return t
    return t.repeat_interleave(h // hkv, dim=2)


def _prefix_mask(nmax, lengths, window):
    """(b, n) validity: the cache prefix including the just-written token,
    optionally restricted to a sliding window."""
    posn = torch.arange(nmax, device=lengths.device)[None, :]
    limit = (lengths + 1)[:, None]
    ok = posn < limit
    if window is not None:
        ok = ok & (posn > limit - 1 - window)
    return ok


def _gather_score(q, k_vals, k_idx, scale):
    """Sparse decode scoring: s[b,n,h] = Σ_t k_vals[b,n,h,t]·q[b,h,idx].
    q: (b, h, d); k_vals/k_idx: (b, n, h, k)."""
    b, n, h, _ = k_vals.shape
    qb = q[:, None].float().expand(b, n, h, q.shape[-1])
    qg = qb.gather(-1, k_idx.long())
    return (qg * k_vals.float()).sum(-1) * scale


def _lengths(lengths, device):
    return torch.as_tensor(lengths, device=device).to(torch.int64).reshape(-1)


# --------------------------------------------------------------------------
# torch backend — the plain oracle
# --------------------------------------------------------------------------

class TorchBackend(AttentionBackend):
    name = "torch"
    caps = Capabilities(full=True, decode=True, causal=True,
                        bidirectional=True, window=True, mla=False,
                        sparse=True, dense=True)

    def full(self, q, k, v, *, num_heads, sfa_k, causal, window, scale,
             bwd_emit="dense"):
        if sfa_k is not None:
            q = topk_st(q, sfa_k)
            k = topk_st(k, sfa_k)
        k = expand_kv(k, num_heads)
        v = expand_kv(v, num_heads)
        n = q.shape[1]
        return chunked_attention(q, k, v, causal=causal, window=window,
                                 scale=scale, chunk_size=min(1024, max(n, 128)))

    def decode(self, query: DecodeQuery, cache: KVCache, lengths, *,
               scale, window, sfa_k):
        h = query.q.shape[2]
        lengths = _lengths(lengths, query.q.device)
        if isinstance(cache, SparseKV):
            qs = topk_st(query.q, sfa_k)[:, 0]                     # (b, h, d)
            kv_r = expand_kv(cache.k_vals, h)
            ki_r = expand_kv(unpack_indices(cache.k_idx), h)
            s = _gather_score(qs, kv_r, ki_r, scale)
            nmax = cache.v.shape[1]
        else:
            kr = expand_kv(cache.k, h)
            s = torch.einsum("bqhd,bnhd->bnh", query.q.float(),
                             kr.float()) * scale
            nmax = cache.k.shape[1]
        ok = _prefix_mask(nmax, lengths, window)
        s = torch.where(ok[..., None], s, torch.full_like(s, NEG_INF))
        pr = torch.softmax(s, dim=1)                                # over n
        vr = expand_kv(cache.v, h)
        return torch.einsum("bnh,bnhd->bhd", pr, vr.float())

    def code(self, x, k: int):
        c = sparsify(x, k)
        return c.values, c.indices


# --------------------------------------------------------------------------
# cuda backend — the hand-written kernels
# --------------------------------------------------------------------------

class CudaBackend(AttentionBackend):
    """rtopk -> FlashSFA (or FlashAttention) forward and backward for full
    sequences, the sparse-cache decode kernel."""
    name = "cuda"
    caps = Capabilities(full=True, decode=True, causal=True,
                        bidirectional=True, window=False, mla=False,
                        sparse=True, dense=True)

    def unsupported_reason(self, req):
        r = super().unsupported_reason(req)
        if r is None and req.mode == "decode" and not req.sparse:
            return "dense KV cache: no CUDA dense-decode kernel"
        return r

    def full(self, q, k, v, *, num_heads, sfa_k, causal, window, scale,
             bwd_emit="dense"):
        # GQA expands before rtopk, so group members carry identical codes
        k = expand_kv(k, num_heads)
        v = expand_kv(v, num_heads)
        if sfa_k is None:
            return dense_attention_op(q, k, v, causal=causal, scale=scale)
        return sfa_attention_op(q, k, v, sfa_k=sfa_k, causal=causal,
                                scale=scale, bwd_emit=bwd_emit)

    def decode(self, query: DecodeQuery, cache: SparseKV, lengths, *,
               scale, window, sfa_k):
        b, _, h, d = query.q.shape
        qs = topk_dense(query.q[:, 0], sfa_k)                     # (b, h, d)
        # lengths + 1: the new token is already written at cache_len
        lens = (_lengths(lengths, query.q.device) + 1).repeat_interleave(h)
        # the cache leaves go in as they are (strided, packed, hkv heads)
        o = flash_sfa_decode(qs.reshape(b * h, d), cache.k_vals, cache.k_idx,
                             cache.v, lens, d=d, scale=scale)
        return o.reshape(b, h, -1)

    def code(self, x, k: int):
        return sfa_code(x, k)


# --------------------------------------------------------------------------
# registry + selection
# --------------------------------------------------------------------------

_REGISTRY: dict[str, AttentionBackend] = {}


def register_backend(backend: AttentionBackend) -> AttentionBackend:
    _REGISTRY[backend.name] = backend
    return backend


def backend_names() -> tuple:
    return tuple(_REGISTRY)


def get_backend(name: str) -> AttentionBackend:
    if name not in _REGISTRY:
        raise ValueError(f"unknown attention backend {name!r}; "
                         f"registered: {backend_names()}")
    return _REGISTRY[name]


register_backend(TorchBackend())
register_backend(CudaBackend())

# "auto": the kernels wherever they can serve the layer
_AUTO_ORDER = ("cuda", "torch")


@dataclasses.dataclass(frozen=True)
class BackendSelection:
    backend: AttentionBackend
    requested: str
    reason: Optional[str] = None     # set when the request fell back


@dataclasses.dataclass(frozen=True)
class FallbackReport:
    """Structured record of a capability-driven backend fallback."""
    requested: str
    selected: str
    reason: str
    request: AttentionRequest
    where: str = ""


_FALLBACKS: dict = {}


def fallback_reports() -> tuple:
    """All deduped fallbacks observed since the last clear."""
    return tuple(_FALLBACKS.values())


def clear_fallback_reports() -> None:
    _FALLBACKS.clear()


def resolve_backend_name(name: str, req: AttentionRequest) -> str:
    """Which backend ``select_backend`` would pick for ``req`` under
    ``name``, with nothing recorded or logged (for eligibility probes)."""
    if name == "auto":
        for nm in _AUTO_ORDER:
            if _REGISTRY[nm].unsupported_reason(req) is None:
                return nm
        return "torch"
    return name if get_backend(name).unsupported_reason(req) is None else "torch"


def select_backend(name: str, req: AttentionRequest, *,
                   where: str = "") -> BackendSelection:
    """Resolve a backend name (or "auto") against a request. An explicitly
    requested backend that cannot serve the request falls back to the
    ``torch`` oracle, and the reason is recorded once per (name, request,
    site)."""
    if name == "auto":
        for nm in _AUTO_ORDER:
            if _REGISTRY[nm].unsupported_reason(req) is None:
                return BackendSelection(_REGISTRY[nm], "auto")
        return BackendSelection(get_backend("torch"), "auto")
    backend = get_backend(name)
    reason = backend.unsupported_reason(req)
    if reason is None:
        return BackendSelection(backend, name)
    fallback = get_backend("torch")
    key = (name, req, where)
    if key not in _FALLBACKS:
        _FALLBACKS[key] = FallbackReport(requested=name, selected=fallback.name,
                                         reason=reason, request=req,
                                         where=where)
        _LOG.warning("attention backend fallback: requested=%r -> %r (%s) "
                     "[mode=%s%s]", name, fallback.name, reason, req.mode,
                     f", at {where}" if where else "")
    return BackendSelection(fallback, name, reason)
