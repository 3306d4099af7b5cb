"""Ring-SFA: causal ring attention over the ``seq`` mesh axis with
code-payload hops, as in the JAX package's ``repro/distributed/ring.py``.

A dense ring rotates (n/P, d) K blocks (and V) around the ring. SFA's
top-k codes shrink the K payload to (n/P, k) values + indices: a per-hop K
byte ratio of d·val_bytes / (k·(val_bytes + idx_bytes)). The port's codes
are bf16 values and int32 indices beside bf16 V (f32 in an f32 model), and
its accumulators f32, so its wire bytes are the byte model's at
``val_bytes = v_bytes = 2, idx_bytes = 4, grad_bytes = 4``; ``RingStats``
counts the bytes each call passes to its sends.

Mechanics (held to the single-device FlashSFA kernels):

  * Each rank owns one contiguous sequence shard of the folded (b·h, n, *)
    tensors. The payload ``(k_vals, k_idx, v)`` goes rank i -> i+1 along the
    ring after every hop but the last (``Mesh.shift``); after hop t, rank
    ``idx`` holds the shard of ``src = (idx - t) % P``.
  * Per hop, by a host-side branch that only this rank's data decides:
    the diagonal hop runs FlashSFA causal; a fully-past hop whose K shard
    shares a feature with this rank's Q shard runs it non-causal; a
    fully-past hop with disjoint occupancy has all-zero scores and the
    closed form ``o = mean(v)``, ``lse = log(n_local)`` (no launch); a
    future hop is skipped (rank i is complete after i + 1 hops). The
    (o, lse) partials fold through ``_merge`` in f32.
  * The backward runs the compact-emit FlashSFA backward per hop against
    the final (o, lse). The dK-code and dV accumulators travel with the
    payload and come home with one extra hop: P sends in all.
  * Every rank posts every hop's send and receive whatever it computes, and
    no collective sits inside a branch, so the collectives match on every
    rank; a rerun of the forward (remat) repeats them in the same order.

``ring_sfa`` (codes in, code gradients out) and ``ring_sfa_op`` (dense
folded q/k/v in, rtopk inside the region, dense gradients out) are each one
``torch.autograd.Function``. They take the global tensors every rank of a
seq line holds (``distributed/sharding.py``), run on this rank's shard and
all-gather the output (and the gradients) over the line, as the
reference's ``shard_map`` out_specs reassemble them. Outside a seq mesh, or
when the sequence does not divide the ring, they are the single-device
composition.

NOTE tests/test_torch_ring.py greps the hop-loop bodies (``_ring_fwd_local``
/ ``_ring_bwd_local``): no ``scatter_code_grads`` / ``densify`` /
``one_hot`` / ``index_put`` may appear there, the K payload stays (n/P, k)
codes end to end.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from repro_torch.distributed.sharding import current_mesh

# the kernels are imported inside the functions (kernels/ops.py ->
# distributed/shard.py, and models/attention.py imports this module)


def ring_degree(axis_name: str = "seq") -> int:
    """Size of the ring mesh axis under the active rules context (1 if
    none)."""
    mesh = current_mesh()
    return 1 if mesh is None else mesh.size(axis_name)


# --------------------------------------------------------------------------
# analytic byte model (the reference's; held to the bytes each ring call
# passes to its sends)
# --------------------------------------------------------------------------

def ring_bytes_per_hop(bh: int, n_local: int, k: int, dv: int, *,
                       val_bytes: int = 4, idx_bytes: int = 4,
                       v_bytes: int = 4) -> int:
    """Per-rank payload bytes of ONE code-ring hop: (n/P, k) K-code values
    + indices plus the (n/P, dv) V block."""
    return bh * n_local * (k * (val_bytes + idx_bytes) + dv * v_bytes)


def ring_dense_bytes_per_hop(bh: int, n_local: int, d: int, dv: int, *,
                             val_bytes: int = 4, v_bytes: int = 4) -> int:
    """Per-rank payload bytes of one DENSE ring hop (the full (n/P, d) K
    block)."""
    return bh * n_local * (d * val_bytes + dv * v_bytes)


def ring_byte_ratio(d: int, k: int, *, val_bytes: int = 4,
                    idx_bytes: int = 4) -> float:
    """Dense-K / code-K payload ratio per hop, K payload only:
    d·val / (k·(val+idx))."""
    return (d * val_bytes) / (k * (val_bytes + idx_bytes))


def ring_fwd_wire_bytes(nshards: int, bh: int, n_local: int, k: int,
                        dv: int, *, val_bytes: int = 4, idx_bytes: int = 4,
                        v_bytes: int = 4) -> int:
    """Per-rank wire bytes of the forward ring: P-1 hops of the payload."""
    return (nshards - 1) * ring_bytes_per_hop(
        bh, n_local, k, dv, val_bytes=val_bytes, idx_bytes=idx_bytes,
        v_bytes=v_bytes)


def ring_bwd_wire_bytes(nshards: int, bh: int, n_local: int, k: int,
                        dv: int, *, val_bytes: int = 4, idx_bytes: int = 4,
                        v_bytes: int = 4, grad_bytes: int = 4) -> int:
    """Per-rank wire bytes of the backward ring: P-1 payload hops (K codes
    + V + the travelling dK-code / dV accumulators) plus the accumulators'
    return hop."""
    payload = ring_bytes_per_hop(bh, n_local, k, dv, val_bytes=val_bytes,
                                 idx_bytes=idx_bytes, v_bytes=v_bytes)
    acc = bh * n_local * (k + dv) * grad_bytes
    return (nshards - 1) * (payload + acc) + acc


def ring_hop_stats(q_idx, k_idx, nshards: int, *, d: int) -> dict:
    """Which of the P x P (q-shard, k-shard) hops of GLOBAL (bh, n, k) code
    indices launch a kernel: ``causal_skipped`` future hops (P(P-1)/2),
    ``overlap_skipped`` fully-past hops with disjoint shard occupancy (the
    closed form), ``computed`` the rest. Python ints."""
    q_idx, k_idx = (np.asarray(t.cpu() if torch.is_tensor(t) else t) for t in (q_idx, k_idx))
    n = q_idx.shape[1]
    nl = n // nshards
    occ = np.zeros((2, nshards, d), dtype=bool)
    for which, arr in enumerate((q_idx, k_idx)):
        for s in range(nshards):
            occ[which, s, np.unique(arr[:, s * nl:(s + 1) * nl])] = True
    causal_skipped = nshards * (nshards - 1) // 2
    overlap_skipped = sum(1 for r in range(nshards) for s in range(r)
                          if not np.any(occ[0, r] & occ[1, s]))
    total = nshards * nshards
    return {"total_hops": total, "causal_skipped": causal_skipped,
            "overlap_skipped": overlap_skipped,
            "computed": total - causal_skipped - overlap_skipped}


@dataclasses.dataclass
class RingStats:
    """What this rank's ring calls did since the last ``reset``: bytes
    passed to the forward and backward sends, and the hops computed by a
    kernel, closed in form and skipped (future), forward and backward."""
    fwd_bytes: int = 0
    bwd_bytes: int = 0
    calls: int = 0
    fwd_computed: int = 0
    fwd_closed: int = 0
    fwd_skipped: int = 0
    bwd_computed: int = 0
    bwd_closed: int = 0
    bwd_skipped: int = 0

    def reset(self) -> None:
        for f in dataclasses.fields(self):
            setattr(self, f.name, 0)


STATS = RingStats()


# --------------------------------------------------------------------------
# hop-loop bodies (this rank's (bh, n/P, ...) shard)
# --------------------------------------------------------------------------

def _merge(o, lse, o_t, lse_t):
    """Online-softmax merge of two (o, lse) partials; f32 arithmetic."""
    m = torch.maximum(lse, lse_t)
    wa = torch.exp(lse - m)
    wb = torch.exp(lse_t - m)
    return ((o * wa[..., None] + o_t * wb[..., None]) / (wa + wb)[..., None],
            m + torch.log(wa + wb))


def _occupancy(idx, d):
    """d-bit feature-occupancy bitmap of a code-index shard (any row)."""
    occ = torch.zeros((d,), dtype=torch.bool, device=idx.device)
    occ[idx.reshape(-1).long()] = True
    return occ


def _hop_branch(t, idx, nshards, q_occ, pki, d):
    """"diag" | "full" | "closed" | "skip" for hop t on rank ``idx``: a host
    read of this rank's own occupancy test, never a collective."""
    src = (idx - t) % nshards
    if src == idx:
        return "diag"
    if src > idx:
        return "skip"
    return "full" if bool((q_occ & _occupancy(pki, d)).any()) else "closed"


def _ring_fwd_local(qv, qi, kv, ki, v, *, d, scale, mesh, axis_name):
    """One rank's forward ring. NO dense K anywhere: the travelling payload
    is (k_vals, k_idx, v) and every hop feeds the codes straight into
    FlashSFA (grep-banned contract, module docstring)."""
    from repro_torch.kernels.flash_sfa import flash_sfa

    bh, nl, dv = v.shape
    nshards, idx = mesh.size(axis_name), mesh.index(axis_name)
    o = torch.zeros((bh, nl, dv), dtype=torch.float32, device=v.device)
    lse = torch.full((bh, nl), -1e30, dtype=torch.float32, device=v.device)
    q_occ = _occupancy(qi, d)
    payload = (kv, ki, v)
    for t in range(nshards):
        pkv, pki, pv = payload
        branch = _hop_branch(t, idx, nshards, q_occ, pki, d)
        if branch in ("diag", "full"):
            o_t, lse_t = flash_sfa(qv, qi, pkv, pki, pv, d=d, causal=branch == "diag",
                                   scale=scale, return_residuals=True)
            o, lse = _merge(o, lse, o_t.float(), lse_t)
            STATS.fwd_computed += 1
        elif branch == "closed":
            # disjoint feature occupancy -> all scores 0 -> uniform attention
            o_t = pv.float().mean(dim=1, keepdim=True).expand(bh, nl, dv)
            o, lse = _merge(o, lse, o_t, torch.full_like(lse, math.log(nl)))
            STATS.fwd_closed += 1
        else:
            STATS.fwd_skipped += 1
        if t < nshards - 1:
            before = mesh.sent.get("ring", 0)
            payload = mesh.shift(payload, axis_name)
            STATS.fwd_bytes += mesh.sent["ring"] - before
    return o, lse


def _ring_bwd_local(qv, qi, kv, ki, v, o, lse, g, *, d, scale, mesh, axis_name):
    """One rank's backward ring (compact emit: dQ/dK as code values aligned
    to the stored indices). dQ accumulates here; the dK-code and dV
    accumulators TRAVEL with the payload and come home with one return hop,
    P sends in all."""
    from repro_torch.kernels.flash_sfa_bwd import flash_sfa_bwd

    bh, nl, dv = v.shape
    k = ki.shape[-1]
    nshards, idx = mesh.size(axis_name), mesh.index(axis_name)
    dqc = torch.zeros((bh, nl, k), dtype=torch.float32, device=v.device)
    q_occ = _occupancy(qi, d)
    payload = (kv, ki, v, torch.zeros((bh, nl, k), dtype=torch.float32, device=v.device),
               torch.zeros((bh, nl, dv), dtype=torch.float32, device=v.device))
    before = mesh.sent.get("ring", 0)
    for t in range(nshards):
        pkv, pki, pv, dkc_acc, dv_acc = payload
        branch = _hop_branch(t, idx, nshards, q_occ, pki, d)
        if branch in ("diag", "full"):
            dq_t, dkc_t, dv_t = flash_sfa_bwd(qv, qi, pkv, pki, pv, o, lse, g, d=d,
                                              causal=branch == "diag", scale=scale,
                                              emit="compact")
            dqc += dq_t.float()
            dkc_acc += dkc_t.float()
            dv_acc += dv_t.float()
            STATS.bwd_computed += 1
        elif branch == "closed":
            # zero scores: the code gradients gather at disjoint features
            # -> 0; the uniform attention still carries dV = sum_i e^-lse_i g_i
            coef = torch.exp(-lse)                                  # (bh, nl)
            dv_acc += torch.einsum("bi,bid->bd", coef, g.float())[:, None, :]
            STATS.bwd_closed += 1
        else:
            STATS.bwd_skipped += 1
        if t < nshards - 1:
            payload = mesh.shift(payload, axis_name)
    # after P-1 rotations shard j's accumulators sit on rank j-1: one return
    # hop brings them home
    dkc_acc, dv_acc = mesh.shift(payload[3:], axis_name)
    STATS.bwd_bytes += mesh.sent["ring"] - before
    return dqc, dkc_acc, dv_acc


# --------------------------------------------------------------------------
# the regions: this rank's shard of global tensors, outputs all-gathered
# --------------------------------------------------------------------------

def _ring_mesh(n, axis_name):
    """The mesh when the ring applies to a sequence of n, else None."""
    mesh = current_mesh()
    if mesh is None:
        return None
    p = mesh.size(axis_name)
    return None if p <= 1 or n % p else mesh


def _shard(mesh, axis_name, n, *tensors):
    p, r = mesh.size(axis_name), mesh.index(axis_name)
    nl = n // p
    return tuple(t[:, r * nl:(r + 1) * nl].contiguous() for t in tensors)


class _RingSFA(torch.autograd.Function):
    """Code-level Ring-SFA: (b·h, n, k) codes and (b·h, n, dv) v -> the
    output, and compact code gradients in the backward."""

    @staticmethod
    def forward(ctx, qv, qi, kv, ki, v, d, scale, axis_name):
        mesh = _ring_mesh(qv.shape[1], axis_name)
        local = _shard(mesh, axis_name, qv.shape[1], qv, qi, kv, ki, v)
        o, lse = _ring_fwd_local(*local, d=d, scale=scale, mesh=mesh, axis_name=axis_name)
        o = o.to(v.dtype)
        STATS.calls += 1
        ctx.save_for_backward(*local, o, lse)
        ctx.meta = (mesh, d, scale, axis_name, qv.dtype, kv.dtype)
        return mesh.all_gather(o, axis_name, dim=1)

    @staticmethod
    def backward(ctx, g):
        qv, qi, kv, ki, v, o, lse = ctx.saved_tensors
        mesh, d, scale, axis_name, qdt, kdt = ctx.meta
        gl, = _shard(mesh, axis_name, g.shape[1], g.to(v.dtype))
        dqc, dkc, dv = _ring_bwd_local(qv, qi, kv, ki, v, o, lse, gl, d=d, scale=scale,
                                       mesh=mesh, axis_name=axis_name)
        dqc, dkc, dv = (mesh.all_gather(t.to(dt), axis_name, dim=1)
                        for t, dt in ((dqc, qdt), (dkc, kdt), (dv, v.dtype)))
        return dqc, None, dkc, None, dv, None, None, None


def ring_sfa(q_vals, q_idx, k_vals, k_idx, v, *, d: int, causal: bool = True,
             scale: float | None = None, axis_name: str = "seq"):
    """Code-level Ring-SFA on global (b·h, n, *) tensors over the ``seq``
    mesh axis. Differentiable in the code values and v: the backward gives
    compact code-value gradients aligned to the stored indices (as
    ``flash_sfa_bwd(emit="compact")``). Outside a ring, the single-device
    ``flash_sfa``."""
    if not causal:
        raise NotImplementedError(
            "ring_sfa is causal-only: the hop skip schedule (rank i "
            "finishes after i+1 hops) is the causal triangle")
    scale = d ** -0.5 if scale is None else scale
    if _ring_mesh(q_vals.shape[1], axis_name) is None:
        from repro_torch.kernels.flash_sfa import flash_sfa
        return flash_sfa(q_vals, q_idx, k_vals, k_idx, v, d=d, causal=True, scale=scale)
    return _RingSFA.apply(q_vals, q_idx, k_vals, k_idx, v, d, scale, axis_name)


class _RingSFAOp(torch.autograd.Function):
    """Dense folded-level Ring-SFA: rtopk of this rank's q/k shard inside
    the region, the ring, and the code gradients scattered to dense dQ/dK
    per shard in the backward."""

    @staticmethod
    def forward(ctx, q, k, v, sfa_k, scale, axis_name):
        from repro_torch.kernels.rtopk import rtopk
        n, d = q.shape[1], q.shape[-1]
        mesh = _ring_mesh(n, axis_name)
        ql, kl, vl = _shard(mesh, axis_name, n, q, k, v)
        qv, qi = rtopk(ql, sfa_k)
        kv, ki = rtopk(kl, sfa_k)
        o, lse = _ring_fwd_local(qv, qi, kv, ki, vl, d=d, scale=scale, mesh=mesh,
                                 axis_name=axis_name)
        o = o.to(v.dtype)
        STATS.calls += 1
        ctx.save_for_backward(qv, qi, kv, ki, vl, o, lse)
        ctx.meta = (mesh, d, scale, axis_name, q.dtype, k.dtype)
        return mesh.all_gather(o, axis_name, dim=1)

    @staticmethod
    def backward(ctx, g):
        from repro_torch.kernels.code_grad import scatter_code_grads
        qv, qi, kv, ki, v, o, lse = ctx.saved_tensors
        mesh, d, scale, axis_name, qdt, kdt = ctx.meta
        gl, = _shard(mesh, axis_name, g.shape[1], g.to(v.dtype))
        dqc, dkc, dv = _ring_bwd_local(qv, qi, kv, ki, v, o, lse, gl, d=d, scale=scale,
                                       mesh=mesh, axis_name=axis_name)
        # the dense (n/P, d) dQ/dK exist only here, per shard, never inside
        # a hop (top-k is straight-through on the stored coordinates)
        dq, dk = scatter_code_grads(dqc, qi, d), scatter_code_grads(dkc, ki, d)
        dq, dk, dv = (mesh.all_gather(t.to(dt), axis_name, dim=1)
                      for t, dt in ((dq, qdt), (dk, kdt), (dv, v.dtype)))
        return dq, dk, dv, None, None, None


def ring_sfa_op(q, k, v, *, sfa_k: int, causal: bool = True,
                scale: float | None = None, axis_name: str = "seq"):
    """Dense folded-level Ring-SFA: (b·h, n, d) q/k and (b·h, n, dv) v, the
    sequence sharded over the ``seq`` mesh axis. Outside a ring, the
    single-device rtopk -> flash_sfa composition."""
    if not causal:
        raise NotImplementedError("ring_sfa_op is causal-only")
    d = q.shape[-1]
    scale = d ** -0.5 if scale is None else scale
    if _ring_mesh(q.shape[1], axis_name) is None:
        from repro_torch.kernels.flash_sfa import flash_sfa
        from repro_torch.kernels.rtopk import rtopk
        qv, qi = rtopk(q, sfa_k)
        kv, ki = rtopk(k, sfa_k)
        return flash_sfa(qv, qi, kv, ki, v, d=d, causal=True, scale=scale)
    return _RingSFAOp.apply(q, k, v, sfa_k, scale, axis_name)
