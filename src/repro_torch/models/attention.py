"""Model-level attention: GQA / MLA, qk-norm, RoPE, SFA, windows, KV caches.

Ported from the JAX package's ``repro/models/attention.py``. Call modes
sharing the parameters:

  * ``mode="train"`` / ``"eval"`` — full-sequence attention, differentiable
                         through the selected backend (the ``cuda``
                         backend's kernels backward included);
  * ``mode="prefill"`` — the same, additionally returning the layer's KV
                         cache (a typed ``KVCache``, sparse for SFA layers);
  * ``mode="decode"``  — one new token: its K code and V are written into
                         the cache at ``cache_len`` (in place), then the
                         query is scored against the cache (contiguous or
                         paged; ``sfa_draft_k`` reads the top-k' sub-code);
  * ``mode="chunk"``   — chunked prefill into a paged cache: C prompt tokens
                         of slot ``slot`` land at ``cache_len..``, and each
                         query is scored as a single-token oracle decode at
                         its own prefix length (all C at once);
  * ``mode="verify"``  — the speculative verify pass: the same chunk write
                         (full-k codes over the draft pass's writes), then
                         the decode backend's multi-token ``verify``.

``cfg.attention.backend`` selects the full-sequence path (train, eval and
prefill) and
``cfg.attention.decode_backend`` the decode path through the registry
(``repro_torch/models/backends.py``); the cache codes come from the
selected backend's own top-k (the rtopk kernel on the card).

SFA-with-RoPE (paper A.1): ``sfa_rope_protect`` p > 0 keeps the p leading
head dims of q and k dense beside the top-k of the d - p others; the cache
stores them dense in ``k_protect`` and the codes over the trailing dims.
MLA (deepseek-v2) attends in the absorbed latent space (q_eff = q_nope ·
W_ukᵀ against the shared latent c_kv, plus the RoPE parts); SFA sparsifies
the latent query and keys, and the cache keeps c_kv dense for the values
beside its packed top-k code for scoring. The window, protected and MLA
layers run on the ``torch`` backend: the ``cuda`` backends decline them,
as the JAX ``pallas`` ones do. MLA has no chunk or verify mode: chunked
prefill and the speculative engine refuse it, as in the JAX package.

The compact training seam: a train/eval-mode SFA layer with
``bwd_emit="compact"|"compact2"`` that ``compact_seam_ineligible_reason``
admits, on the ``cuda`` backend, runs its QKV projection [+ RoPE] and
attention as one autograd Function (``_SFAProjAttendCompact``, the JAX
custom_vjp ``_sfa_proj_attend_compact``). Its backward takes the FlashSFA
backward's compact code gradients through [the pair closure and
``rope_code_vjp``] into ``sparse_proj_bwd`` (the code_grad kernels): no
dense dQ/dK exists anywhere on it. Each routing decision is recorded once
as a ``CompactSeamReport``. The port's ``cuda`` backend is the counterpart
of the JAX ``pallas`` one, on either device: on CPU tensors the kernel
wrappers run their plain versions. Under a mesh (``distributed/``) the
seam's kernels run as tensor-parallel regions over the "model" axis, and a
train/eval SFA layer with ``ring=True`` that ``ring_ineligible_reason``
admits runs Ring-SFA over the "seq" axis (``ring_sfa_op``); each ring
routing decision is recorded once as a ``RingReport``.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from repro_torch.configs.base import AttentionConfig, ModelConfig
from repro_torch.core import reports as _reports
from repro_torch.core.attention import chunked_attention
from repro_torch.core.kv_cache import (
    MLAKV, DenseKV, FeatureMajorKV, KVCache, MLASparseKV, PagedDenseKV, PagedFeatureMajorKV,
    PagedKV, PagedMLAKV, PagedMLASparseKV, PagedSparseKV, SparseKV, idx_dtype, pack_indices,
)
from repro_torch.core.remat import active_stash
from repro_torch.core.sparse import sparsify, topk_st
from repro_torch.distributed.ring import ring_degree, ring_sfa_op
from repro_torch.distributed.shard import tp_flash_sfa, tp_flash_sfa_bwd
from repro_torch.distributed.sharding import axis_size, current_mesh
from repro_torch.kernels.flash_sfa_bwd import MAX_K as _SEAM_MAX_K
from repro_torch.kernels.flash_sfa_bwd import pair_closure_indices
from repro_torch.kernels.flash_sfa_decode import feature_major_prefill
from repro_torch.kernels.rtopk import PROJ_HEAD_DIMS as _SEAM_HEAD_DIMS
from repro_torch.kernels.ops import (
    fold_heads, fused_qk_codes, head_blocks, repeat_heads, tp_sfa_code, unfold_heads,
)
from repro_torch.models.backends import (
    AttentionRequest, DecodeQuery, expand_kv, get_backend, resolve_backend_name,
    select_backend,
)
from repro_torch.models.layers import (
    apply_norm, dense, dense_init, norm_init, rope, rope_code_vjp, sparse_proj_bwd,
)


def attention_init(gen, cfg: ModelConfig, device="cpu"):
    a = cfg.attention
    d = cfg.d_model
    if a.mla is not None:
        m, h = a.mla, a.num_heads
        return {
            "w_dq": dense_init(gen, d, m.q_lora_rank, device=device),
            "q_norm": norm_init(m.q_lora_rank, device=device),
            "w_uq_nope": dense_init(gen, m.q_lora_rank, h * m.nope_head_dim, device=device),
            "w_uq_pe": dense_init(gen, m.q_lora_rank, h * m.rope_head_dim, device=device),
            "w_dkv": dense_init(gen, d, m.kv_lora_rank, device=device),
            "kv_norm": norm_init(m.kv_lora_rank, device=device),
            "w_uk": dense_init(gen, m.kv_lora_rank, h * m.nope_head_dim, device=device),
            "w_kpe": dense_init(gen, d, m.rope_head_dim, device=device),
            "w_uv": dense_init(gen, m.kv_lora_rank, h * m.v_head_dim, device=device),
            "w_o": dense_init(gen, h * m.v_head_dim, d, device=device),
        }
    p = {
        "w_qkv": dense_init(gen, d, (a.num_heads + 2 * a.num_kv_heads) * a.head_dim,
                            device=device),
        "w_o": dense_init(gen, a.num_heads * a.head_dim, d, device=device),
    }
    if a.qk_norm:
        p["q_norm"] = norm_init(a.head_dim, device=device)
        p["k_norm"] = norm_init(a.head_dim, device=device)
    return p


def _request(a: AttentionConfig, *, mode: str, window, paged: bool = False,
             speculative: bool = False, backward: bool = True) -> AttentionRequest:
    """Static backend request for this layer (``backward``: whether the
    "full" call may be differentiated)."""
    return AttentionRequest(
        mode=mode,
        causal=a.causal if mode == "full" else True,
        window=(window is not None) or (a.window is not None),
        rope_protect=a.sfa_k is not None and a.sfa_rope_protect > 0,
        mla=a.mla is not None,
        sparse=a.sfa_k is not None,
        paged=paged,
        speculative=speculative,
        head_dim=a.head_dim,
        v_head_dim=a.head_dim,
        sfa_k=a.sfa_k,
        backward=backward,
    )


def _sfa_code(backend, k, a: AttentionConfig):
    """The cache's code of k's non-protected dims: (values, indices
    relative to the d - p trailing dims) from the backend's top-k."""
    return backend.code(k[..., a.sfa_rope_protect:], a.sfa_k)


def _protected(k, a: AttentionConfig):
    """The p leading dims the cache keeps dense (None without them)."""
    p = a.sfa_rope_protect
    return k[..., :p] if p else None


def split_qkv(qkv, h: int, hkv: int, hd: int):
    """Packed (b, n, (h + 2·hkv)·hd) projection -> q (b, n, h, hd), k and v
    (b, n, hkv, hd): the column order of the JAX package's ``w_qkv``."""
    b, n, _ = qkv.shape
    q, k, v = torch.split(qkv, [h * hd, hkv * hd, hkv * hd], dim=-1)
    return q.reshape(b, n, h, hd), k.reshape(b, n, hkv, hd), v.reshape(b, n, hkv, hd)


# the JAX kernel's token tile for the persistent image: the JAX engine
# allocates the token axis in whole tiles, and the port does the same so
# that the two engines' caches have the same length
_FM_TILE = 128


def _decode_uses_persistent_cache(cfg: ModelConfig) -> bool:
    """The cache layout follows the selected decode backend: a backend with
    the ``persistent_cache`` capability (cuda_fm) keeps its feature-major
    image in the cache. A request that backend cannot serve resolves to the
    oracle here exactly as it would at decode time."""
    a = cfg.attention
    sel = select_backend(a.decode_backend, _request(a, mode="decode", window=None),
                         where=f"{cfg.name}/cache")
    return sel.backend.caps.persistent_cache


def decode_cache_token_multiple(cfg: ModelConfig) -> int:
    """Allocation granularity of the decode cache's token axis: the JAX
    persistent image is streamed in 128-token tiles, so the engine rounds
    ``max_len`` up to a multiple of this (1 for every other layout)."""
    if cfg.attention is None or cfg.attention.sfa_k is None:
        return 1
    return _FM_TILE if _decode_uses_persistent_cache(cfg) else 1


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, device="cpu") -> KVCache:
    """Per-layer typed decode cache (the caller stacks across layers)."""
    a = cfg.attention

    def zeros(*shape, dt=dtype):
        return torch.zeros(shape, dtype=dt, device=device)

    if a.mla is not None:
        m = a.mla
        ckv, kpe = zeros(batch, max_len, m.kv_lora_rank), zeros(batch, max_len, m.rope_head_dim)
        if a.sfa_k is None:
            return MLAKV(ckv=ckv, kpe=kpe)
        kk = min(a.sfa_k, m.kv_lora_rank)
        return MLASparseKV(ckv=ckv, kpe=kpe, ckv_sp_vals=zeros(batch, max_len, kk),
                           ckv_sp_idx=zeros(batch, max_len, kk, dt=idx_dtype(m.kv_lora_rank)))
    hkv, hd = a.num_kv_heads, a.head_dim
    if a.sfa_k is not None:
        if _decode_uses_persistent_cache(cfg):
            return FeatureMajorKV(k_feat=zeros(batch, hkv, hd, max_len),
                                  v=zeros(batch, hkv, max_len, hd))
        p = a.sfa_rope_protect
        kk = min(a.sfa_k, hd - p)
        return SparseKV(k_vals=zeros(batch, max_len, hkv, kk),
                        k_idx=zeros(batch, max_len, hkv, kk, dt=idx_dtype(hd - p)),
                        v=zeros(batch, max_len, hkv, hd),
                        k_protect=zeros(batch, max_len, hkv, p) if p else None)
    return DenseKV(k=zeros(batch, max_len, hkv, hd), v=zeros(batch, max_len, hkv, hd))


def init_paged_cache(cfg: ModelConfig, *, num_pages: int, page_size: int,
                     block_table: torch.Tensor, dtype=torch.bfloat16,
                     device="cpu") -> PagedKV:
    """Per-layer paged decode cache: a page pool and the shared block table
    ``(slots, max_pages)``. ``num_pages`` includes the reserved trash page
    0; the layout follows the decode backend as in ``init_cache`` (MLA's
    pools are headless: (pages, page_size, F))."""
    a = cfg.attention

    def zeros(*shape, dt=dtype):
        return torch.zeros(shape, dtype=dt, device=device)

    if a.mla is not None:
        m = a.mla
        ckv = zeros(num_pages, page_size, m.kv_lora_rank)
        kpe = zeros(num_pages, page_size, m.rope_head_dim)
        if a.sfa_k is None:
            return PagedMLAKV(ckv=ckv, kpe=kpe, block_table=block_table)
        kk = min(a.sfa_k, m.kv_lora_rank)
        return PagedMLASparseKV(
            ckv=ckv, kpe=kpe, ckv_sp_vals=zeros(num_pages, page_size, kk),
            ckv_sp_idx=zeros(num_pages, page_size, kk, dt=idx_dtype(m.kv_lora_rank)),
            block_table=block_table)
    hkv, hd = a.num_kv_heads, a.head_dim
    if a.sfa_k is not None:
        if _decode_uses_persistent_cache(cfg):
            return PagedFeatureMajorKV(k_feat=zeros(hkv, num_pages, hd, page_size),
                                       v=zeros(hkv, num_pages, page_size, hd),
                                       block_table=block_table)
        p = a.sfa_rope_protect
        kk = min(a.sfa_k, hd - p)
        return PagedSparseKV(
            k_vals=zeros(hkv, num_pages, page_size, kk),
            k_idx=zeros(hkv, num_pages, page_size, kk, dt=idx_dtype(hd - p)),
            v=zeros(hkv, num_pages, page_size, hd), block_table=block_table,
            k_protect=zeros(hkv, num_pages, page_size, p) if p else None)
    return PagedDenseKV(k=zeros(hkv, num_pages, page_size, hd),
                        v=zeros(hkv, num_pages, page_size, hd), block_table=block_table)


# --------------------------------------------------------------------------
# the fused projection + attention seam for compact code gradients
# --------------------------------------------------------------------------


def compact_seam_ineligible_reason(cfg: ModelConfig, window=None) -> Optional[str]:
    """None when a train-mode layer can take the compact seam, else why
    not. RoPE is admitted (the pair-closure emit and ``rope_code_vjp`` keep
    the backward compact); everything else between the projection and the
    kernels must be the identity: qk-norm rescales the cotangent by per-row
    statistics off the stored support, and windows, rope-protect, MLA and
    distillation need the dense q/k/v outside the seam. Under a ring the
    layer goes to Ring-SFA instead; under tensor parallelism both head
    counts must divide the degree, so each rank runs whole heads."""
    a = cfg.attention
    if a is None or a.sfa_k is None:
        return "not an SFA layer (sfa_k unset)"
    if a.bwd_emit not in ("compact", "compact2"):
        return "bwd_emit is dense"
    if a.mla is not None:
        return "MLA projects through the latent space outside the seam"
    if a.qk_norm:
        return ("qk-norm rescales the cotangent by per-row statistics, "
                "off the stored support")
    if window is not None or a.window is not None:
        return "windowed layers need the dense q/k for the mask fallback"
    if a.sfa_rope_protect > 0:
        return "sfa_rope_protect keeps leading dims dense outside the codes"
    if cfg.sfa_distill > 0:
        return "distill needs the dense q/k/v for the stop-grad teacher"
    if a.ring and ring_degree() > 1:
        return ("ring context parallelism routes through the op-level ring "
                "path (distributed/ring.py), not the projection seam")
    tp = axis_size("model")
    if tp > 1 and (a.num_heads % tp or a.num_kv_heads % tp):
        return (f"heads {a.num_heads}/{a.num_kv_heads} do not divide the TP "
                f"degree {tp}: the shard_map'd seam needs whole per-device "
                f"head slices to keep dQ/dK code grads reduction-free")
    # the port's own limits, after the reference's reasons: the shapes the
    # seam's kernels take (reduced configs only go below them)
    if a.head_dim not in _SEAM_HEAD_DIMS:
        return (f"head_dim {a.head_dim}: the fused projection kernel proj_rtopk takes "
                f"{_SEAM_HEAD_DIMS}")
    if a.sfa_k > _SEAM_MAX_K:
        return f"sfa_k {a.sfa_k}: the compact backward emits take k <= {_SEAM_MAX_K}"
    return None


def _seam_backend(cfg: ModelConfig, window, *, where: Optional[str] = None) -> str:
    """The backend a seam layer's forward resolves to (the seam wraps the
    ``cuda`` kernels). Its backward is the seam's own (the compact emits and
    code_grad), whose limits ``compact_seam_ineligible_reason`` holds, so
    the request asks for the forward alone. With ``where`` the choice is
    made by ``select_backend``, which records a declined explicit request."""
    req = _request(cfg.attention, mode="full", window=window, backward=False)
    if where is None:
        return resolve_backend_name(cfg.attention.backend, req)
    return select_backend(cfg.attention.backend, req, where=where).backend.name


def compact_train_eligible(cfg: ModelConfig, window=None) -> bool:
    """True when a train-mode layer takes the compact seam."""
    return compact_seam_ineligible_reason(cfg, window) is None


def remat_codes_ineligible_reason(cfg: ModelConfig) -> Optional[str]:
    """None when the stack can honour ``remat="codes"``, else why not:
    only the kernels' autograd Functions (the seam's and
    ``kernels/ops.py::_SFAAttention``) record codes, so a stack whose
    forward goes elsewhere would keep nothing, and the layer loop degrades
    it to "full" explicitly (``core.remat.record_remat``). A layer that
    takes the seam keeps its codes (as in the reference)."""
    a = cfg.attention
    if a is None or a.sfa_k is None:
        return "not an SFA stack (sfa_k unset): no codes to keep"
    if a.mla is not None:
        return "MLA latent attention bypasses the code-keeping q/k paths"
    if compact_seam_ineligible_reason(cfg) is None and _seam_backend(cfg, None) == "cuda":
        return None
    resolved = resolve_backend_name(a.backend, _request(a, mode="full", window=None))
    if resolved != "cuda":
        return (f"backend {a.backend!r} resolves to {resolved!r} for train "
                f"forwards: only the cuda kernel paths keep the codes")
    return None


@dataclasses.dataclass(frozen=True)
class CompactSeamReport:
    """One compact-seam routing decision of a train-mode layer that asked
    for a compact emit: whether it took the seam, and if not, why."""
    where: str
    taken: bool
    reason: Optional[str] = None
    fused_fwd: bool = False          # a taken seam ran the fused forward


_SEAM_REPORTS: dict = {}


def compact_seam_reports() -> tuple:
    return tuple(_SEAM_REPORTS.values())


def clear_compact_seam_reports() -> None:
    _SEAM_REPORTS.clear()


def ring_ineligible_reason(cfg: ModelConfig, window=None,
                           n: Optional[int] = None) -> Optional[str]:
    """None when a train-mode layer with ``ring=True`` can take Ring-SFA
    (``distributed/ring.py``), else why not. The ring shards the sequence,
    so whatever is row-wise (projection, qk-norm, RoPE) is free; the hop
    schedule asks for causal SFA with fully sparse codes and a sequence the
    ring degree divides."""
    a = cfg.attention
    if a is None or a.sfa_k is None:
        return "not an SFA layer (sfa_k unset)"
    if not a.causal:
        return "ring hop schedule is the causal triangle"
    if a.mla is not None:
        return "MLA latent attention has no ring path"
    if window is not None or a.window is not None:
        return "windowed layers mask outside the ring hop schedule"
    if a.sfa_rope_protect > 0:
        return "rope-protected dims make the hop payload dense"
    p = ring_degree()
    if p <= 1:
        return "no seq mesh axis of size > 1 in the active context"
    if n is not None and n % p:
        return f"sequence {n} does not divide the ring degree {p}"
    return None


@dataclasses.dataclass(frozen=True)
class RingReport:
    """One Ring-SFA routing decision: taken or not, why not, and how the
    ring's hops reach the wire (``launch.mesh.transport``)."""
    where: str
    taken: bool
    reason: Optional[str] = None
    transport: Optional[str] = None


_RING_REPORTS: dict = {}


def ring_reports() -> tuple:
    return tuple(_RING_REPORTS.values())


def clear_ring_reports() -> None:
    _RING_REPORTS.clear()


def _record_ring(where: str, taken: bool, reason: Optional[str],
                 wire: Optional[str] = None) -> None:
    key = (where, taken, reason, wire)
    if key not in _RING_REPORTS:
        _RING_REPORTS[key] = RingReport(where, taken, reason, wire)


# the "compact_seam" and "ring" components of core/reports.py (read-only
# views)
def _collect_seam_reports():
    return tuple(_reports.make_report("compact_seam", r.where, eligible=r.taken,
                                      reason=r.reason, details={"fused_fwd": r.fused_fwd})
                 for r in compact_seam_reports())


def _collect_ring_reports():
    return tuple(_reports.make_report("ring", r.where, eligible=r.taken, reason=r.reason,
                                      details={"transport": r.transport} if r.taken else None)
                 for r in ring_reports())


_reports.register_provider("compact_seam", _collect_seam_reports, clear_compact_seam_reports)
_reports.register_provider("ring", _collect_ring_reports, clear_ring_reports)


def _record_seam(where: str, taken: bool, reason: Optional[str],
                 fused_fwd: bool = False) -> None:
    key = (where, taken, reason, fused_fwd)
    if key not in _SEAM_REPORTS:
        _SEAM_REPORTS[key] = CompactSeamReport(where, taken, reason, fused_fwd)


def _sfa_proj_attend_fwd_impl(w, x, positions, h, hkv, hd, sfa_k, causal,
                              scale, rope_spec, fwd_fuse):
    """The seam's forward: -> (out (b·h, n, hd), residuals). Codes come
    from ``fused_qk_codes`` (projection -> RoPE -> top-k inside proj_rtopk,
    then block-skip FlashSFA) or from the unfused projection -> RoPE ->
    GQA expand -> rtopk -> FlashSFA; the residuals are the same either way:
    the codes (keys repeated to h heads), folded V, out and LSE. Under
    remat="codes" the codes (keys at their narrowest head count) and the
    LSE are recorded in the active stash on the first pass and taken from
    it on the backward's rerun."""
    b, n, _ = x.shape
    dt = x.dtype
    stash = active_stash()
    wv = w[:, (h + hkv) * hd:].to(dt)
    vf = fold_heads(expand_kv((x @ wv).reshape(b, n, hkv, hd), h)).contiguous()
    if stash is not None and stash.replay:
        qv, qi, kv, ki = stash.take("sfa_q_code_vals", "sfa_q_code_idx",
                                    "sfa_k_code_vals", "sfa_k_code_idx")
    elif fwd_fuse:
        qv, qi, kv, ki = fused_qk_codes(x, w, positions, h=h, hkv=hkv, hd=hd,
                                        sfa_k=sfa_k, rope_spec=rope_spec)
    else:
        q, k = (x @ w[:, :(h + hkv) * hd].to(dt)).split([h * hd, hkv * hd], dim=-1)
        q, k = q.reshape(b, n, h, hd), k.reshape(b, n, hkv, hd)
        if rope_spec is not None:
            theta, rot = rope_spec
            q = rope(q, positions, theta=theta, rot_dim=rot)
            k = rope(k, positions, theta=theta, rot_dim=rot)
        qv, qi = tp_sfa_code(fold_heads(q), sfa_k)
        kv, ki = tp_sfa_code(fold_heads(expand_kv(k, h)), sfa_k)
    kv_h, ki_h = repeat_heads(kv, b, h), repeat_heads(ki, b, h)
    if stash is not None and stash.replay:
        out = tp_flash_sfa(qv, qi, kv_h, ki_h, vf, d=hd, causal=causal, scale=scale,
                           block_skip=fwd_fuse)
        lse, = stash.take("sfa_lse")
    else:
        out, lse = tp_flash_sfa(qv, qi, kv_h, ki_h, vf, d=hd, causal=causal,
                                scale=scale, return_residuals=True, block_skip=fwd_fuse)
        if stash is not None:
            stash.put(sfa_q_code_vals=qv, sfa_q_code_idx=qi, sfa_k_code_vals=kv,
                      sfa_k_code_idx=ki, sfa_lse=lse)
    return out, (qv, qi, kv_h, ki_h, vf, out, lse)


class _SFAProjAttendCompact(torch.autograd.Function):
    """QKV projection [+ RoPE] + SFA attention with the compact-code
    backward (the JAX custom_vjp ``_sfa_proj_attend_compact``).

    Backward: the FlashSFA backward emits "compact" (n, k) codes on
    RoPE-free layers, or "compact2" (n, 2k) pair closures on RoPE'd ones
    (and where "compact2" is asked for), which ``rope_code_vjp`` turns back
    through RoPE in place; ``sparse_proj_bwd`` (the code_grad kernels)
    takes them to dx and the q/k blocks of dW; V's part is a dense product.
    GQA: group members carry identical key indices, so their code
    gradients sum slot by slot. dW and dx come back in w's and x's dtypes.
    """

    @staticmethod
    def forward(ctx, w, x, positions, h, hkv, hd, sfa_k, causal, scale,
                rope_spec, req_emit, fwd_fuse):
        out, res = _sfa_proj_attend_fwd_impl(w, x, positions, h, hkv, hd, sfa_k,
                                             causal, scale, rope_spec, fwd_fuse)
        ctx.save_for_backward(x, w, positions, *res)
        ctx.meta = (h, hkv, hd, causal, scale, rope_spec, req_emit)
        return unfold_heads(out, x.shape[0], h)

    @staticmethod
    def backward(ctx, g):
        x, w, positions, qv, qi, kv, ki, vf, out, lse = ctx.saved_tensors
        h, hkv, hd, causal, scale, rope_spec, req_emit = ctx.meta
        b, n, m = x.shape
        group = h // hkv
        pair_widen = rope_spec is not None or req_emit == "compact2"
        rot = hd if rope_spec is None else rope_spec[1]
        dqc, dkc, dvf = tp_flash_sfa_bwd(
            qv, qi, kv, ki, vf, out, lse, fold_heads(g.to(vf.dtype)).contiguous(),
            d=hd, causal=causal, scale=scale,
            emit="compact2" if pair_widen else "compact", rot_dim=rot)
        if pair_widen:
            qi, ki = pair_closure_indices(qi, rot), pair_closure_indices(ki, rot)
            if rope_spec is not None:
                posf = positions.expand(b, n)[:, None, :].expand(b, h, n).reshape(b * h, n)
                dqc = rope_code_vjp(dqc, qi, posf, theta=rope_spec[0], rot_dim=rot)
                dkc = rope_code_vjp(dkc, ki, posf, theta=rope_spec[0], rot_dim=rot)
        kw = dqc.shape[-1]

        def by_head(t, heads):                   # (b·heads, n, kw) -> (heads, b·n, kw)
            return t.reshape(b, heads, n, kw).transpose(0, 1).reshape(heads, b * n, kw)

        dk_vals = dkc.reshape(b, hkv, group, n, kw).sum(2).reshape(b * hkv, n, kw)
        dk_idx = ki.reshape(b, hkv, group, n, kw)[:, :, 0].reshape(b * hkv, n, kw)
        x_flat = x.reshape(b * n, m)
        dx_q, dwq = sparse_proj_bwd(x_flat, head_blocks(w, 0, h, hd), by_head(dqc, h),
                                    by_head(qi, h), d=hd)
        dx_k, dwk = sparse_proj_bwd(x_flat, head_blocks(w, h, hkv, hd),
                                    by_head(dk_vals, hkv), by_head(dk_idx, hkv), d=hd)
        dv = dvf.reshape(b, hkv, group, n, hd).sum(2)
        dv_flat = dv.permute(0, 2, 1, 3).reshape(b * n, hkv * hd).float()
        dx_v = dv_flat @ w[:, (h + hkv) * hd:].float().T
        dwv = x_flat.float().T @ dv_flat
        dw = torch.cat([dwq.permute(1, 0, 2).reshape(m, h * hd),
                        dwk.permute(1, 0, 2).reshape(m, hkv * hd), dwv], dim=1)
        dx = (dx_q + dx_k + dx_v).reshape(b, n, m)
        return (dw.to(w.dtype), dx.to(x.dtype)) + (None,) * 10


def sfa_proj_attend_compact(w, x, positions, *, h, hkv, hd, sfa_k, causal, scale,
                            rope_spec=None, req_emit="compact", fwd_fuse=True):
    """The compact seam on x (b, n, m) and the packed qkv weight w
    (m, (h + 2·hkv)·hd): -> attention output (b, n, h, hd)."""
    return _SFAProjAttendCompact.apply(w, x, positions, h, hkv, hd, sfa_k, causal,
                                       scale, rope_spec, req_emit, fwd_fuse)


class AttentionOut(NamedTuple):
    out: torch.Tensor
    cache: Optional[KVCache]
    # the layer's paper Eq. 8 term (train mode, ``cfg.sfa_distill > 0``)
    distill: Optional[torch.Tensor] = None


def attention_apply(params, x, *, cfg: ModelConfig, positions=None,
                    window=None, mode: str = "train", cache=None,
                    cache_len=None, slot=None) -> AttentionOut:
    a = cfg.attention
    if mode not in ("train", "eval", "prefill", "decode", "chunk", "verify"):
        raise ValueError(f"unknown attention mode {mode!r}")
    if mode in ("chunk", "verify") and a.mla is not None:
        raise NotImplementedError(
            f"{mode} mode does not cover MLA caches — serve MLA configs "
            f"through whole-prompt prefill (insert_pages), non-speculative")
    wants_seam = (mode in ("train", "eval") and a.sfa_k is not None
                  and a.bwd_emit in ("compact", "compact2"))
    if a.mla is not None:
        if wants_seam:
            _record_seam(f"{cfg.name}/attention", False,
                         compact_seam_ineligible_reason(cfg, window))
        return _mla_apply(params, x, cfg=cfg, positions=positions, mode=mode,
                          cache=cache, cache_len=cache_len)
    b, n, _ = x.shape
    h, hkv, hd = a.num_heads, a.num_kv_heads, a.head_dim
    dt = x.dtype
    if wants_seam:
        where = f"{cfg.name}/attention"
        reason = compact_seam_ineligible_reason(cfg, window)
        if reason is None:
            name = _seam_backend(cfg, window, where=where)
            if name != "cuda":
                reason = f"backend resolved to {name!r}; the seam wraps the cuda kernels"
        if reason is None:
            _record_seam(where, True, None, fused_fwd=a.fwd_fuse)
            if a.rope:
                pos = (positions if positions is not None
                       else torch.arange(n, device=x.device)[None, :])
                rope_spec = (a.rope_theta, hd)
            else:
                pos = torch.zeros((1, 1), dtype=torch.long, device=x.device)
                rope_spec = None
            o = sfa_proj_attend_compact(
                params["w_qkv"]["w"], x, pos, h=h, hkv=hkv, hd=hd, sfa_k=a.sfa_k,
                causal=a.causal, scale=hd ** -0.5, rope_spec=rope_spec,
                req_emit=a.bwd_emit, fwd_fuse=a.fwd_fuse)
            out = dense(params["w_o"], o.reshape(b, n, h * hd).to(dt), dt)
            return AttentionOut(out, None)
        _record_seam(where, False, reason)
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
        sel = select_backend(a.decode_backend,
                             _request(a, mode="decode", window=window,
                                      paged=isinstance(cache, PagedKV)),
                             where=f"{cfg.name}/attention")
        # write the new token's K code and V at cache_len, then score
        if a.sfa_k is not None:
            k_vals, k_idx = _sfa_code(sel.backend, k, a)             # (b, 1, hkv, k)
            cache.write(cache_len, k_vals=k_vals, k_idx=k_idx, v=v,
                        k_protect=_protected(k, a))
        else:
            cache.write(cache_len, k=k, v=v)
        ctx = sel.backend.decode(DecodeQuery(q=q), cache, cache_len, scale=scale,
                                 window=window, sfa_k=a.sfa_k,
                                 rope_protect=a.sfa_rope_protect, draft_k=a.sfa_draft_k)
        o = ctx.to(dt).reshape(b, 1, h * hd)
        return AttentionOut(dense(params["w_o"], o, dt), cache)

    if mode in ("chunk", "verify"):
        # land the C tokens of one slot at cache_len.. (the verify pass's
        # full-k codes overwrite the draft pass's writes), then score query
        # c at its own causal length cache_len + c: the oracle for a chunk
        # of a prefill, the backend's verify pass for a speculative check
        if cache is None or cache_len is None or slot is None:
            raise ValueError(f"{mode} mode needs a cache, cache_len and slot")
        sel = select_backend(a.decode_backend,
                             _request(a, mode="decode", window=window,
                                      paged=isinstance(cache, PagedKV),
                                      speculative=mode == "verify"),
                             where=f"{cfg.name}/attention")
        if a.sfa_k is not None:
            k_vals, k_idx = _sfa_code(sel.backend, k, a)             # (1, C, hkv, k)
            cache.write_chunk(slot, cache_len, k_vals=k_vals, k_idx=k_idx, v=v,
                              k_protect=_protected(k, a))
        else:
            cache.write_chunk(slot, cache_len, k=k, v=v)
        lens = int(cache_len) + torch.arange(n, device=x.device)      # (C,)
        scorer = sel.backend if mode == "verify" else get_backend("torch")
        ctx = scorer.verify(DecodeQuery(q=q), cache, lens, slot=slot, scale=scale,
                            window=window, sfa_k=a.sfa_k,
                            rope_protect=a.sfa_rope_protect)          # (C, h, dv)
        o = ctx.to(dt).reshape(1, n, h * hd)
        return AttentionOut(dense(params["w_o"], o, dt), cache)

    o = None
    if mode in ("train", "eval") and a.sfa_k is not None and a.ring:
        # Ring-SFA (distributed/ring.py): the RoPE'd dense q/k fold and
        # shard over the seq axis; rtopk and the hop loop run per shard,
        # rotating (n/P, k) K codes. GQA expands before rtopk, so group
        # members carry identical codes, as the single-device composition
        reason = ring_ineligible_reason(cfg, window, n=n)
        wire = None if reason is not None else current_mesh().wire("send", x.device)
        _record_ring(f"{cfg.name}/attention", reason is None, reason, wire)
        if reason is None:
            o = unfold_heads(ring_sfa_op(fold_heads(q), fold_heads(expand_kv(k, h)),
                                         fold_heads(expand_kv(v, h)), sfa_k=a.sfa_k,
                                         scale=scale), b, h)
    if o is None:
        # a prefill or eval under no_grad runs the forward alone
        backward = mode == "train" or torch.is_grad_enabled()
        sel = select_backend(a.backend, _request(a, mode="full", window=window,
                                                 backward=backward),
                             where=f"{cfg.name}/attention")
        o = sel.backend.full(q, k, v, num_heads=h, sfa_k=a.sfa_k, causal=a.causal,
                             window=window, scale=scale, rope_protect=a.sfa_rope_protect,
                             bwd_emit=a.bwd_emit)
    distill = None
    if mode == "train" and a.sfa_k is not None and cfg.sfa_distill > 0:
        # paper Eq. 8: pull the SFA head outputs toward stop-grad dense ones
        with torch.no_grad():
            o_dense = chunked_attention(q, expand_kv(k, h), expand_kv(v, h), causal=a.causal,
                                        window=window, scale=scale,
                                        chunk_size=min(1024, max(n, 128)))
        distill = (o.float() - o_dense.float()).square().mean()
    out = dense(params["w_o"], o.reshape(b, n, h * hd), dt)
    new_cache = None
    if mode == "prefill":
        if a.sfa_k is not None:
            k_vals, k_idx = _sfa_code(sel.backend, k, a)
            if _decode_uses_persistent_cache(cfg):
                # the persistent image (and heads-major V), built once here;
                # decode steps extend both a column at a time
                new_cache = FeatureMajorKV(
                    k_feat=feature_major_prefill(k_vals.to(dt), k_idx, hd),
                    v=v.movedim(1, 2))
            else:
                new_cache = SparseKV(k_vals=k_vals.to(dt),
                                     k_idx=pack_indices(k_idx, hd - a.sfa_rope_protect),
                                     v=v, k_protect=_protected(k, a))
        else:
            new_cache = DenseKV(k=k, v=v)
    return AttentionOut(out, new_cache, distill)


# --------------------------------------------------------------------------
# MLA (+ SFA on the latent), the absorbed formulation
# --------------------------------------------------------------------------

def _mla_project(params, x, *, cfg: ModelConfig, positions):
    """-> q_eff (b, n, h, r), the latent-space query q_nope · W_ukᵀ; q_pe
    (b, n, h, dr) and kpe (b, n, 1, dr) after RoPE; the latent ckv (b, n,
    r)."""
    a, m = cfg.attention, cfg.attention.mla
    b, n, _ = x.shape
    h = a.num_heads
    dt = x.dtype
    cq = apply_norm(params["q_norm"], dense(params["w_dq"], x, dt))
    q_nope = dense(params["w_uq_nope"], cq, dt).reshape(b, n, h, m.nope_head_dim)
    q_pe = dense(params["w_uq_pe"], cq, dt).reshape(b, n, h, m.rope_head_dim)
    ckv = apply_norm(params["kv_norm"], dense(params["w_dkv"], x, dt))
    kpe = dense(params["w_kpe"], x, dt).reshape(b, n, 1, m.rope_head_dim)
    if positions is None:
        positions = torch.arange(n, device=x.device)[None, :]
    q_pe = rope(q_pe, positions, theta=a.rope_theta)
    kpe = rope(kpe, positions, theta=a.rope_theta)
    w_uk = params["w_uk"]["w"].reshape(m.kv_lora_rank, h, m.nope_head_dim)
    q_eff = torch.einsum("bnhd,rhd->bnhr", q_nope, w_uk.to(dt))
    return q_eff, q_pe, ckv, kpe


def _mla_out(params, o_lat, *, cfg: ModelConfig):
    """The latent output (b, n, h, r) through W_uv per head, then w_o."""
    m = cfg.attention.mla
    b, n, h, _ = o_lat.shape
    dt = o_lat.dtype
    w_uv = params["w_uv"]["w"].reshape(m.kv_lora_rank, h, m.v_head_dim)
    o = torch.einsum("bnhr,rhd->bnhd", o_lat, w_uv.to(dt))
    return dense(params["w_o"], o.reshape(b, n, h * m.v_head_dim), dt)


def _mla_apply(params, x, *, cfg: ModelConfig, positions, mode, cache,
               cache_len) -> AttentionOut:
    a, m = cfg.attention, cfg.attention.mla
    b, n, _ = x.shape
    h = a.num_heads
    dt = x.dtype
    scale = (m.nope_head_dim + m.rope_head_dim) ** -0.5
    q_eff, q_pe, ckv, kpe = _mla_project(params, x, cfg=cfg, positions=positions)

    if mode == "decode":
        if cache is None or cache_len is None:
            raise ValueError("decode mode needs a cache and cache_len")
        code = sparsify(ckv, a.sfa_k) if a.sfa_k is not None else None
        cache.write(cache_len, ckv=ckv, kpe=kpe[:, :, 0],
                    ckv_sp_vals=None if code is None else code.values,
                    ckv_sp_idx=None if code is None else code.indices)
        sel = select_backend(a.decode_backend, _request(a, mode="decode", window=None),
                             where=f"{cfg.name}/mla")
        o_lat = sel.backend.decode(DecodeQuery(q=q_eff, q_pe=q_pe), cache, cache_len,
                                   scale=scale, window=None, sfa_k=a.sfa_k)
        return AttentionOut(_mla_out(params, o_lat[:, None].to(dt), cfg=cfg), cache)

    # train / eval / prefill: dense attention over the latents, sparsified
    # here (the top-k of q_eff and of the shared latent), one latent "head"
    # repeated to h as views: d = r + dr, dv = r
    backward = mode == "train" or torch.is_grad_enabled()
    sel = select_backend(a.backend, _request(a, mode="full", window=None, backward=backward),
                         where=f"{cfg.name}/mla")
    if a.sfa_k is not None:
        q_eff = topk_st(q_eff, a.sfa_k)
        ckv_s = topk_st(ckv, a.sfa_k)
    else:
        ckv_s = ckv
    qcat = torch.cat([q_eff, q_pe], dim=-1)                        # (b, n, h, r + dr)
    kcat = torch.cat([ckv_s[:, :, None], kpe], dim=-1)             # (b, n, 1, r + dr)
    kcat = kcat.expand(b, n, h, kcat.shape[-1])
    vlat = ckv[:, :, None].expand(b, n, h, m.kv_lora_rank)
    o_lat = sel.backend.full(qcat, kcat, vlat, num_heads=h, sfa_k=None, causal=a.causal,
                             window=None, scale=scale)
    out = _mla_out(params, o_lat, cfg=cfg)
    new_cache = None
    if mode == "prefill":
        if a.sfa_k is not None:
            code = sparsify(ckv, a.sfa_k)
            new_cache = MLASparseKV(ckv=ckv, kpe=kpe[:, :, 0], ckv_sp_vals=code.values.to(dt),
                                    ckv_sp_idx=pack_indices(code.indices, m.kv_lora_rank))
        else:
            new_cache = MLAKV(ckv=ckv, kpe=kpe[:, :, 0])
    return AttentionOut(out, new_cache)
