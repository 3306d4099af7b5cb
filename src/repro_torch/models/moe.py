"""Mixture-of-Experts layer: token-choice top-k routing with gates
renormalised over the selected experts, GShard capacity drops, the Switch
load-balance loss and optional shared experts.

Ported from the JAX package's ``repro/models/moe.py``. The function is the
same, the program is not: the reference dispatches and combines with
one-hot einsums over (groups, tokens, experts, capacity), which cost
g·gs·e·cap·d·2 FLOPs each; here tokens move by index. Routing
(``route``) gives every token its selected experts in ascending order and,
for each one it keeps, a row of the (experts, groups · capacity) expert
buffer; the experts run as batched products over that buffer
(``torch.bmm``; these are plain products, outside any kernel of the
reference). Dispatch writes each kept token to its row (a permutation: the
rows are unique) and combine sums a token's expert outputs in ascending
expert order, in f32, rounding once, as the einsum over experts does. Both
are autograd Functions whose backward is a gather and an ordered sum as
well, so nothing accumulates through atomics: a remat rerun gives the
forward's bits, and so routes the next layer the same way.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.configs.base import MoEConfig
from repro_torch.core.sparse import topk_select
from repro_torch.models.layers import _ACTS, dense_init, normal

GROUP = 1024  # tokens are routed in groups of at most this many


def moe_init(gen, d_model: int, moe: MoEConfig, *, glu: bool = True, device="cpu"):
    """Router (d, e) at scale 0.02, experts (e, d, f) / (e, f, d), shared
    experts as one MLP of width f · num_shared (the JAX tree's leaves)."""
    e, dff = moe.num_experts, moe.expert_dim
    p = {"router": dense_init(gen, d_model, e, scale=0.02, device=device),
         "up": normal(gen, (e, d_model, dff), d_model ** -0.5, device),
         "down": normal(gen, (e, dff, d_model), dff ** -0.5, device)}
    if glu:
        p["gate"] = normal(gen, (e, d_model, dff), d_model ** -0.5, device)
    if moe.num_shared:
        width = dff * moe.num_shared
        p["shared_up"] = dense_init(gen, d_model, width, device=device)
        p["shared_down"] = dense_init(gen, width, d_model, device=device)
        if glu:
            p["shared_gate"] = dense_init(gen, d_model, width, device=device)
    return p


def group_size(t: int) -> int:
    """The largest size <= ``GROUP`` that divides the t tokens."""
    gs = min(GROUP, t)
    while t % gs:
        gs -= 1
    return gs


class Routing(NamedTuple):
    """One call's routing. ``probs`` (g, gs, e) f32 carries the gradient;
    ``sel`` and ``keep`` (g, gs, e) are the selected and the kept (not
    dropped) experts; ``gates`` (t, k) are the renormalised gates of each
    token's experts in ascending order, 0 where dropped, in the activation
    dtype; ``rows`` (t, k) their rows in the (e · g · cap) expert buffer,
    ``e · g · cap`` where dropped; ``src`` (e · g · cap,) the (token · k +
    j) entry each buffer row holds, t · k where it is empty."""
    probs: torch.Tensor
    sel: torch.Tensor
    keep: torch.Tensor
    gates: torch.Tensor
    rows: torch.Tensor
    src: torch.Tensor


def route(router_w, tokens, moe: MoEConfig, *, gs: int, dtype) -> Routing:
    """Route ``tokens`` (t, d) in groups of ``gs`` consecutive tokens, as
    the reference does: f32 router, ``topk_mask``'s selection over the
    probs (ties to the lower expert; ``core.sparse.topk_select``), gates
    renormalised over the selected experts before any drop, capacity
    ``max(8, ceil8(int(moe.capacity_factor · k · gs / e)))`` a group,
    and a token's place in an expert's queue the count of earlier tokens
    of its group that chose it."""
    t, d = tokens.shape
    e, topk = moe.num_experts, moe.top_k
    g = t // gs
    logits = tokens.float().reshape(g, gs, d) @ router_w
    probs = torch.softmax(logits, dim=-1)
    sel, eidx = topk_select(probs.detach(), topk)        # eidx: ascending
    gate_all = torch.where(sel, probs, 0.0)
    gate_all = gate_all / gate_all.sum(-1, keepdim=True).clamp(min=1e-9)
    cap = int(moe.capacity_factor * topk * gs / e)
    cap = max(8, -(-cap // 8) * 8)
    pos = torch.cumsum(sel.to(torch.int32), dim=1) - 1
    keep = sel & (pos < cap)
    dev = tokens.device
    kept = keep.gather(-1, eidx)
    slot = pos.gather(-1, eidx).long()
    grp = torch.arange(g, device=dev)[:, None, None]
    size = e * g * cap
    rows = torch.where(kept, (eidx * g + grp) * cap + slot, size).reshape(t, topk)
    gates = torch.where(kept, gate_all.gather(-1, eidx).to(dtype), 0).reshape(t, topk)
    # the inverse map; dropped entries all land on the spare row, cut off
    src = torch.full((size + 1,), t * topk, dtype=torch.long, device=dev)
    src.scatter_(0, rows.reshape(-1), torch.arange(t * topk, device=dev))
    return Routing(probs, sel, keep, gates, rows, src[:size])


def _pad(x):
    return torch.cat([x, x.new_zeros((1,) + x.shape[1:])])


def _ordered_sum(x_pad, rows, weights=None):
    """Σ_j weights[:, j] · x_pad[rows[:, j]] over j in order, in f32."""
    acc = None
    for j in range(rows.shape[1]):
        term = x_pad[rows[:, j]].float()
        if weights is not None:
            term = weights[:, j, None].float() * term
        acc = term if acc is None else acc + term
    return acc


class _Dispatch(torch.autograd.Function):
    """tokens (t, d) -> expert buffer (e · g · cap, d): row r holds token
    src[r] // k, or zeros. Backward: each token's rows summed in ascending
    expert order."""

    @staticmethod
    def forward(ctx, tokens, rows, src):
        ctx.save_for_backward(rows)
        return _pad(tokens)[torch.div(src, rows.shape[1], rounding_mode="floor")]

    @staticmethod
    def backward(ctx, g):
        (rows,) = ctx.saved_tensors
        return _ordered_sum(_pad(g), rows).to(g.dtype), None, None


class _Combine(torch.autograd.Function):
    """expert buffer (e · g · cap, d), gates (t, k) -> (t, d): each
    token's gated expert outputs summed in ascending expert order in f32,
    rounded once. Backward: the buffer's gradient gathered per row (each
    row has one token), the gates' as the f32 dot with their rows."""

    @staticmethod
    def forward(ctx, xout, gates, rows, src):
        ctx.save_for_backward(xout, gates, rows, src)
        return _ordered_sum(_pad(xout), rows, gates).to(xout.dtype)

    @staticmethod
    def backward(ctx, gy):
        xout, gates, rows, src = ctx.saved_tensors
        k = rows.shape[1]
        gy32 = _pad(gy).float()
        gate_of_row = _pad(gates.reshape(-1))[src].float()
        gx = (gy32[torch.div(src, k, rounding_mode="floor")] * gate_of_row[:, None])
        xo = _pad(xout)
        gg = torch.stack([(gy32[:-1] * xo[rows[:, j]].float()).sum(-1) for j in range(k)], 1)
        return gx.to(xout.dtype), gg.to(gates.dtype), None, None


def moe_apply(params, x, moe: MoEConfig, *, act: str = "silu", glu: bool = True,
              with_aux: bool = True):
    """x (b, n, d) -> (out (b, n, d), aux loss f32 scalar, or None without
    ``with_aux``: serving skips it). Tokens are
    flattened and cut into groups of ``group_size(b · n)``; each
    group routes and fills its experts' capacity on its own. Dropped
    tokens get no routed output (the caller's residual carries them);
    shared experts see every token. The aux loss is Switch's
    e · Σ_e f_e · p_e over the selected (not the kept) experts."""
    b, n, d = x.shape
    e = moe.num_experts
    dt = x.dtype
    tokens = x.reshape(b * n, d)
    t = tokens.shape[0]
    r = route(params["router"]["w"], tokens, moe, gs=group_size(t), dtype=dt)
    xin = _Dispatch.apply(tokens, r.rows, r.src).reshape(e, -1, d)
    hu = torch.bmm(xin, params["up"].to(dt))
    if glu:
        hu = hu * _ACTS[act](torch.bmm(xin, params["gate"].to(dt)))
    else:
        hu = _ACTS[act](hu)
    xout = torch.bmm(hu, params["down"].to(dt)).reshape(-1, d)
    out = _Combine.apply(xout, r.gates, r.rows, r.src)
    if moe.num_shared:
        su = tokens @ params["shared_up"]["w"].to(dt)
        if glu:
            su = su * _ACTS[act](tokens @ params["shared_gate"]["w"].to(dt))
        else:
            su = _ACTS[act](su)
        out = out + su @ params["shared_down"]["w"].to(dt)
    aux = None
    if with_aux:
        aux = e * (r.sel.float().mean((0, 1)) * r.probs.mean((0, 1))).sum()
    return out.reshape(b, n, d), aux
