"""Typed attention-backend registry: capability-based kernel selection.

Ported from the JAX package's ``repro/models/backends.py``. A backend has a
``Capabilities`` record and four entry points:

  * ``full(q, k, v, ...)`` — full-sequence attention (prefill) on
                             ``(b, n, h, d)`` q and ``(b, n, hkv, d)`` k/v;
  * ``decode(query, cache, lengths, ...)`` — one new token against a typed
                             ``KVCache`` (contiguous or paged), returning
                             ``(b, h, dv)``; ``draft_k`` reads the top-k'
                             sub-code (the speculative draft pass);
  * ``verify(query, cache, lengths, ...)`` — C queries of one slot of a
                             paged cache, each at its own causal length
                             (the speculative verify pass), ``(C, h, dv)``;
  * ``code(x, k)``         — the top-k code the backend stores in the cache.

Registered backends:

  * ``torch`` — the plain oracle (chunked online softmax, gather-scoring
                decode, bisection top-k); runs on either device and
                supports every layer this port serves: windows, the
                protected RoPE dims of ``sfa_rope_protect`` (paper A.1) and
                MLA's latent decode among them. Paged caches are read
                through ``gather()``; the verify pass is one per-query
                decode over the C queries at once.
  * ``cuda``  — the hand-written kernels: rtopk -> FlashSFA forward and
                backward for SFA layers and FlashAttention forward and
                backward for dense ones (train and prefill, differentiable
                through the autograd Functions of ``kernels/ops.py``), the
                token-major sparse-cache decode kernels (contiguous, paged
                through the block table, and the multi-query verify pass),
                rtopk for every top-k. The draft pass narrows the pools to
                their top-k' sub-codes (``sub_k``, a torch op) before the
                paged kernel. Dense decode has no kernel (as in the JAX
                package) and goes to ``torch``. On CPU tensors the kernel
                wrappers run their plain versions, so the same routing and
                the same backward seam are testable without a card.
  * ``cuda_fm`` — decode only: the feature-major kernels on the persistent
                ``FeatureMajorKV`` image (contiguous or paged); its
                ``persistent_cache`` capability makes the cache allocator
                pick that layout. A draft narrows the query to k'. It has
                no verify pass: verify falls back to ``torch`` with a
                report, as the JAX ``pallas_fm`` does.
  * ``auto``  — not a backend but a policy: ``cuda`` where it can serve
                the request, else ``torch``, with nothing recorded.

An explicitly requested backend that cannot serve a layer (window,
protected RoPE dims, MLA, dense decode, verify on ``cuda_fm``, head dims or
a code width that the CUDA kernels do not take; the first three as the
JAX ``pallas`` backends decline them) falls back to ``torch`` with a
structured ``FallbackReport``, recorded once per (backend, request, site)
and queryable through ``fallback_reports()``. ``set_fm_debug`` turns on the
``cuda_fm`` image integrity check (``--fm-debug``).
"""
from __future__ import annotations

import dataclasses
import logging
from typing import NamedTuple, Optional

import torch

from repro_torch.core import reports as _reports
from repro_torch.core.attention import NEG_INF, chunked_attention
from repro_torch.core.kv_cache import (
    FeatureMajorKV, KVCache, MLAKV, MLASparseKV, PagedFeatureMajorKV, PagedKV,
    PagedSparseKV, SparseKV, pack_indices, unpack_indices,
)
from repro_torch.core.sparse import sparsify, sub_k, to_feature_major, topk_st
# the kernels' shape limits, as their wrappers state them
from repro_torch.kernels.flash_attention import HEAD_DIMS as _DENSE_DIMS
from repro_torch.kernels.flash_sfa import MAX_D as _SFA_MAX_D
from repro_torch.kernels.flash_sfa import V_HEAD_DIMS as _SFA_DV
from repro_torch.kernels.flash_sfa_bwd import MAX_K as _SFA_BWD_MAX_K
from repro_torch.kernels.flash_sfa_decode import V_HEAD_DIMS as _DECODE_DV
from repro_torch.kernels.rtopk import MAX_D as _RTOPK_MAX_D
from repro_torch.kernels.flash_sfa_decode import (
    flash_sfa_decode, flash_sfa_decode_fm, flash_sfa_decode_fm_paged,
    flash_sfa_decode_multi, flash_sfa_decode_paged,
)
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
    rope_protect: bool = False   # SFA with protected leading RoPE dims
    mla: bool = False            # latent (MLA) attention
    sparse: bool = False         # sfa_k is set
    paged: bool = False          # the cache is a paged (block-table) PagedKV
    speculative: bool = False    # the multi-token verify pass is required
    # the layer's shapes, for backends whose kernels take only some; None
    # where the caller did not say (nothing is checked then)
    head_dim: Optional[int] = None     # q/k width d
    v_head_dim: Optional[int] = None   # v width dv (None: = head_dim)
    sfa_k: Optional[int] = None        # code width k of an SFA layer
    backward: bool = True              # a "full" call may be differentiated


@dataclasses.dataclass(frozen=True)
class Capabilities:
    full: bool = False
    decode: bool = False
    causal: bool = True
    bidirectional: bool = False
    window: bool = False
    rope_protect: bool = False
    mla: bool = False
    sparse: bool = True
    dense: bool = True
    # the backend keeps its decode layout resident in the cache itself
    # (FeatureMajorKV): the allocator picks the cache type from the backend
    persistent_cache: bool = False
    paged: bool = False          # decodes against a PagedKV block table
    speculative: bool = False    # has the multi-token ``verify`` pass


class DecodeQuery(NamedTuple):
    """Query pieces for one decode step.

    q    (b, 1, h, d)  dense post-RoPE query (for MLA: the latent q_eff)
    q_pe (b, 1, h, dr) MLA's RoPE query part (None outside MLA)
    """
    q: torch.Tensor
    q_pe: Optional[torch.Tensor] = None


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
        if req.rope_protect and not c.rope_protect:
            return "sfa_rope_protect dims not supported"
        if req.mla and not c.mla:
            return "MLA latent attention not supported"
        if req.sparse and not c.sparse:
            return "SFA sparse attention not supported"
        if not req.sparse and not c.dense:
            return "dense attention not supported"
        if req.paged and not c.paged:
            return "paged KV cache (block-table reads) not supported"
        if req.speculative and not c.speculative:
            return "no multi-token speculative verify path"
        return None

    def full(self, q, k, v, *, num_heads, sfa_k, causal, window, scale,
             rope_protect=0, bwd_emit="dense"):
        """q: (b, n, h, d); k/v: (b, n, hkv, d) — the backend expands KV
        heads itself. Differentiable in q, k and v. ``rope_protect`` p > 0
        keeps the p leading dims of q and k dense beside their top-k."""
        raise NotImplementedError(self.name)

    def decode(self, query: DecodeQuery, cache: KVCache, lengths, *,
               scale, window, sfa_k, rope_protect=0, draft_k=None):
        raise NotImplementedError(self.name)

    def verify(self, query: DecodeQuery, cache: PagedKV, lengths, *, slot,
               scale, window, sfa_k, rope_protect=0):
        """Speculative verify: C queries ``query.q (1, C, h, d)`` of slot
        ``slot`` of a paged cache, query c at cache length ``lengths[c]``
        (it sees positions ``< lengths[c] + 1``, as in ``decode``). Returns
        ``(C, h, dv)``."""
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


def _st_protect(x, sfa_k, p):
    """Straight-through top-k keeping the p leading dims dense (paper A.1)."""
    if sfa_k is None:
        return x
    if p:
        return torch.cat([x[..., :p], topk_st(x[..., p:], sfa_k)], -1)
    return topk_st(x, sfa_k)


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


def _per_query(cache: KVCache, c: int) -> KVCache:
    """A batch-1 contiguous cache seen as a batch of ``c`` (views, no copy),
    so C queries of one slot score as one batched decode."""
    return dataclasses.replace(cache, **{n: t.expand(c, *t.shape[1:])
                                         for n, t in cache._tensors()})


# --------------------------------------------------------------------------
# torch backend — the plain oracle
# --------------------------------------------------------------------------

class TorchBackend(AttentionBackend):
    name = "torch"
    caps = Capabilities(full=True, decode=True, causal=True,
                        bidirectional=True, window=True, rope_protect=True, mla=True,
                        sparse=True, dense=True, paged=True, speculative=True)

    def full(self, q, k, v, *, num_heads, sfa_k, causal, window, scale,
             rope_protect=0, bwd_emit="dense"):
        # sparsify at hkv heads, before the GQA repeat
        q = _st_protect(q, sfa_k, rope_protect)
        k = _st_protect(k, sfa_k, rope_protect)
        k = expand_kv(k, num_heads)
        v = expand_kv(v, num_heads)
        n = q.shape[1]
        return chunked_attention(q, k, v, causal=causal, window=window,
                                 scale=scale, chunk_size=min(1024, max(n, 128)))

    def decode(self, query: DecodeQuery, cache: KVCache, lengths, *,
               scale, window, sfa_k, rope_protect=0, draft_k=None):
        if isinstance(cache, PagedKV):
            # the oracle reads a paged cache through its contiguous view
            cache = cache.gather()
        h = query.q.shape[2]
        lengths = _lengths(lengths, query.q.device)
        if isinstance(cache, (MLAKV, MLASparseKV)):
            return self._decode_mla(query, cache, lengths, scale=scale, sfa_k=sfa_k)
        if isinstance(cache, FeatureMajorKV):
            # the image is dense: a draft narrows the query support to k'
            return self._decode_feature_major(query, cache, lengths, scale=scale,
                                              window=window, sfa_k=draft_k or sfa_k)
        if isinstance(cache, SparseKV):
            p = rope_protect
            qs = _st_protect(query.q, draft_k or sfa_k, p)[:, 0]   # (b, h, d)
            kv_c, ki_c = cache.k_vals, unpack_indices(cache.k_idx)
            if draft_k:
                # nested-k draft: the stored codes re-thresholded to k'
                kv_c, ki_c = sub_k(kv_c, ki_c, draft_k)
            # the codes index the d - p trailing dims; the p leading ones
            # score densely against the cache's k_protect
            s = _gather_score(qs[..., p:], expand_kv(kv_c, h), expand_kv(ki_c, h), scale)
            if p:
                s = s + torch.einsum("bhp,bnhp->bnh", query.q[:, 0, :, :p].float(),
                                     expand_kv(cache.k_protect, h).float()) * scale
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

    def verify(self, query: DecodeQuery, cache: PagedKV, lengths, *, slot,
               scale, window, sfa_k, rope_protect=0):
        # each query is a single-token decode at its own causal length: the
        # slot's contiguous view, seen as a batch of C, in one batched pass
        g = _per_query(cache.gather_slot(slot), query.q.shape[1])
        return self.decode(DecodeQuery(q=query.q[0][:, None]), g, lengths,
                           scale=scale, window=window, sfa_k=sfa_k,
                           rope_protect=rope_protect)

    def _decode_feature_major(self, query, cache, lengths, *, scale, window, sfa_k):
        """Sparse q against the dense (d, n) feature-major image and the
        heads-major V: the function the cuda_fm kernels compute."""
        h = query.q.shape[2]
        group = h // cache.k_feat.shape[1]
        nmax = cache.k_feat.shape[-1]
        qs = topk_st(query.q, sfa_k)[:, 0]                          # (b, h, d)
        kf = cache.k_feat.repeat_interleave(group, dim=1)           # (b, h, d, n)
        s = torch.einsum("bhd,bhdn->bnh", qs.float(), kf.float()) * scale
        ok = _prefix_mask(nmax, lengths, window)
        s = torch.where(ok[..., None], s, torch.full_like(s, NEG_INF))
        pr = torch.softmax(s, dim=1)
        vr = cache.v.repeat_interleave(group, dim=1)                # (b, h, n, dv)
        return torch.einsum("bnh,bhnd->bhd", pr, vr.float())

    def _decode_mla(self, query, cache, lengths, *, scale, sfa_k):
        """Latent decode: q_eff (b, 1, h, r) against the shared latent and
        q_pe against the RoPE part; the value is the dense latent. With the
        packed code (MLASparseKV), the top-k query is read at each token's
        k coordinates: one code a token serves every head, so the gather
        reads an expanded view of the query, (b, n, h, k) out, never a
        (b, n, h, r) copy."""
        nmax = cache.ckv.shape[1]
        if isinstance(cache, MLASparseKV):
            qlat = topk_st(query.q, sfa_k)[:, 0].float()              # (b, h, r)
            idx = unpack_indices(cache.ckv_sp_idx)                    # (b, n, k)
            b, h, r = qlat.shape
            kk = idx.shape[-1]
            qg = qlat[:, None].expand(b, nmax, h, r).gather(
                -1, idx[:, :, None].expand(b, nmax, h, kk))           # (b, n, h, k)
            s = (qg * cache.ckv_sp_vals[:, :, None].float()).sum(-1) * scale
        else:
            s = torch.einsum("bqhr,bnr->bnh", query.q.float(), cache.ckv.float()) * scale
        s = s + torch.einsum("bqhp,bnp->bnh", query.q_pe.float(),
                             cache.kpe.float()) * scale
        ok = _prefix_mask(nmax, lengths, None)
        s = torch.where(ok[..., None], s, torch.full_like(s, NEG_INF))
        pr = torch.softmax(s, dim=1)
        return torch.einsum("bnh,bnr->bhr", pr, cache.ckv.float())

    def code(self, x, k: int):
        c = sparsify(x, k)
        return c.values, c.indices


# --------------------------------------------------------------------------
# cuda backend — the hand-written kernels
# --------------------------------------------------------------------------

def kernel_shape_reason(req: AttentionRequest) -> Optional[str]:
    """None if the CUDA kernels take the layer's head dims and code width
    (``req.head_dim`` unset: nothing to check), else why not. The limits
    are the wrappers' own constants, each path against its own list:
    full-sequence dense d = dv in ``flash_attention.HEAD_DIMS``;
    full-sequence SFA dv in ``flash_sfa.V_HEAD_DIMS``, d <=
    ``flash_sfa.MAX_D`` (and rtopk's ``MAX_D``), and where a backward can
    run (``req.backward``) also k <= ``flash_sfa_bwd.MAX_K`` (the forward's
    bodies take any k; the backward's dv are the forward's); decode dv in
    ``flash_sfa_decode.V_HEAD_DIMS`` and d <= rtopk's ``MAX_D``. Which
    FlashSFA body runs (tensor or CUDA cores) is the wrappers' choice."""
    d = req.head_dim
    if d is None:
        return None
    dv = d if req.v_head_dim is None else req.v_head_dim
    if req.mode == "decode":
        dvs = _DECODE_DV
    elif req.sparse:
        dvs = _SFA_DV
    else:
        dvs = _DENSE_DIMS
    if dv not in dvs:
        return f"v head dim {dv}: the CUDA attention kernels take dv in {dvs}"
    if req.sparse or req.mode == "decode":
        max_d = min(_RTOPK_MAX_D, _SFA_MAX_D)
        if d > max_d:
            return f"head dim {d}: the CUDA top-k and FlashSFA kernels take d <= {max_d}"
        if (req.mode == "full" and req.backward and req.sfa_k is not None
                and min(req.sfa_k, d) > _SFA_BWD_MAX_K):
            return (f"sfa_k {req.sfa_k}: the CUDA FlashSFA backward takes k <= "
                    f"{_SFA_BWD_MAX_K}")
        return None
    if d != dv:
        return (f"head dims d={d}, dv={dv}: the CUDA FlashAttention kernels take "
                f"d = dv in {dvs}")
    return None


class CudaBackend(AttentionBackend):
    """rtopk -> FlashSFA (or FlashAttention) forward and backward for full
    sequences; the sparse-cache decode kernels, contiguous and paged, and
    the multi-query verify kernel. ``unsupported_reason`` declines the
    shapes the kernels do not take (``kernel_shape_reason``)."""
    name = "cuda"
    caps = Capabilities(full=True, decode=True, causal=True,
                        bidirectional=True, window=False, rope_protect=False, mla=False,
                        sparse=True, dense=True, paged=True, speculative=True)

    def unsupported_reason(self, req):
        r = super().unsupported_reason(req)
        if r is None and req.mode == "decode" and not req.sparse:
            return "dense KV cache: no CUDA dense-decode kernel"
        return r or kernel_shape_reason(req)

    def full(self, q, k, v, *, num_heads, sfa_k, causal, window, scale,
             rope_protect=0, bwd_emit="dense"):
        # GQA expands before rtopk, so group members carry identical codes
        k = expand_kv(k, num_heads)
        v = expand_kv(v, num_heads)
        if sfa_k is None:
            return dense_attention_op(q, k, v, causal=causal, scale=scale)
        return sfa_attention_op(q, k, v, sfa_k=sfa_k, causal=causal,
                                scale=scale, bwd_emit=bwd_emit)

    def decode(self, query: DecodeQuery, cache: SparseKV, lengths, *,
               scale, window, sfa_k, rope_protect=0, draft_k=None):
        b, _, h, d = query.q.shape
        qs = topk_dense(query.q[:, 0], draft_k or sfa_k)          # (b, h, d)
        # lengths + 1: the new token is already written at cache_len
        lens = _lengths(lengths, query.q.device) + 1
        kv, ki = cache.k_vals, cache.k_idx
        if draft_k:
            # nested-k draft: the codes narrowed to their top-k' sub-codes (a
            # torch op over the whole cache; the kernel then reads k' wide)
            kv, ki = sub_k(kv, unpack_indices(ki), draft_k)
            ki = pack_indices(ki, d)
        if isinstance(cache, PagedSparseKV):
            # the pools in place through the block table: no gather, no
            # head repeat, the packed indices read as they are
            o = flash_sfa_decode_paged(qs.reshape(b * h, d), kv, ki, cache.v,
                                       cache.block_table, lens, d=d, scale=scale,
                                       heads=h)
        else:
            # the cache leaves go in as they are (strided, packed, hkv heads)
            o = flash_sfa_decode(qs.reshape(b * h, d), kv, ki, cache.v,
                                 lens.repeat_interleave(h), d=d, scale=scale)
        return o.reshape(b, h, -1)

    def verify(self, query: DecodeQuery, cache: PagedSparseKV, lengths, *, slot,
               scale, window, sfa_k, rope_protect=0):
        # C queries of one slot in one launch, each at its own length, row c
        # bit-equal to the paged decode kernel at that length
        _, c, h, d = query.q.shape
        qs = topk_dense(query.q[0], sfa_k).reshape(c * h, d)
        lens = (_lengths(lengths, query.q.device) + 1).repeat_interleave(h)
        o = flash_sfa_decode_multi(qs, cache.k_vals, cache.k_idx, cache.v, lens, d=d,
                                   scale=scale, heads=h, block_tables=cache.block_table,
                                   slot=int(slot))
        return o.reshape(c, h, -1)

    def code(self, x, k: int):
        return sfa_code(x, k)


# Debug switch for the cuda_fm image integrity check (``set_fm_debug``,
# ``--fm-debug``). Off by default: the check re-derives the image from its
# own columns every step, the re-materialization the persistent layout
# exists to avoid.
_FM_DEBUG = False


def set_fm_debug(enabled: bool) -> None:
    """Turn the ``cuda_fm`` persistent-image integrity check on or off. The
    backend reads the flag at every decode call, so running engines pick
    the new setting up at their next step."""
    global _FM_DEBUG
    _FM_DEBUG = bool(enabled)


def _check_fm_image(kfeat, sfa_k: int) -> None:
    """Assert the (rows, d, n) image equals the image recomputed from its
    own columns (sparsify -> to_feature_major). Incremental maintenance can
    only corrupt the image by leaving stale entries, which makes a column
    more than k-sparse; the recomputed image drops them."""
    tm = kfeat.transpose(-1, -2)
    recomputed = to_feature_major(sparsify(tm, min(sfa_k, tm.shape[-1])))
    bad = int((kfeat.float() != recomputed.float()).sum())
    if bad:
        raise AssertionError(
            f"FeatureMajorKV image diverged from its recomputed form on {bad} "
            f"entries: a stale column survived an incremental write or insert "
            f"(image columns must stay <= k-sparse)")


class CudaFMBackend(AttentionBackend):
    """Feature-major decode: the sparse query selects which k of the d
    feature rows of the persistent image to read (the JAX ``pallas_fm``)."""
    name = "cuda_fm"
    caps = Capabilities(full=False, decode=True, causal=True,
                        bidirectional=True, window=False, rope_protect=False, mla=False,
                        sparse=True, dense=False, persistent_cache=True,
                        paged=True)

    def unsupported_reason(self, req):
        return super().unsupported_reason(req) or kernel_shape_reason(req)

    def decode(self, query: DecodeQuery, cache: FeatureMajorKV, lengths, *,
               scale, window, sfa_k, rope_protect=0, draft_k=None):
        if not isinstance(cache, (FeatureMajorKV, PagedFeatureMajorKV)):
            raise TypeError(
                f"cuda_fm serves the persistent FeatureMajorKV cache, got "
                f"{type(cache).__name__}: allocate caches through init_cache / "
                f"init_decode_caches so the layout follows the selected backend")
        b, _, h, d = query.q.shape
        # a draft narrows the QUERY to k' feature rows: the dense image has
        # no stored code to re-threshold
        qv, qi = sfa_code(query.q[:, 0], min(draft_k or sfa_k, d))  # (b, h, kq)
        qv, qi = qv.reshape(b * h, -1), qi.reshape(b * h, -1)
        lens = _lengths(lengths, query.q.device) + 1
        if isinstance(cache, PagedFeatureMajorKV):
            if _FM_DEBUG:
                g = cache.gather().k_feat
                _check_fm_image(g.reshape(-1, *g.shape[2:]), sfa_k)
            o = flash_sfa_decode_fm_paged(qv, qi, cache.k_feat, cache.v,
                                          cache.block_table, lens, scale=scale,
                                          heads=h)
            return o.reshape(b, h, -1)
        hkv, nmax = cache.k_feat.shape[1], cache.k_feat.shape[-1]
        # both leaves are kernel-native (heads-major): the flat (b·hkv, ...)
        # views are reshapes, and GQA is the kernel's row // group
        kfeat = cache.k_feat.reshape(b * hkv, d, nmax)
        if _FM_DEBUG:
            _check_fm_image(kfeat, sfa_k)
        o = flash_sfa_decode_fm(qv, qi, kfeat, cache.v.reshape(b * hkv, nmax, -1),
                                lens.repeat_interleave(h), scale=scale,
                                group=h // hkv)
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
register_backend(CudaFMBackend())

# "auto": the token-major kernels wherever they can serve the layer (the
# feature-major layout is chosen only by name, as in the JAX package)
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


# the "backend" component of core/reports.py: every FallbackReport is a
# not-eligible routing decision (a read-only view)
def _collect_backend_reports():
    return tuple(
        _reports.make_report("backend", f.where, eligible=False, reason=f.reason,
                             details={"requested": f.requested, "selected": f.selected,
                                      "mode": f.request.mode})
        for f in fallback_reports())


_reports.register_provider("backend", _collect_backend_reports, clear_fallback_reports)
