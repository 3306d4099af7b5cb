"""RWKV-6 "Finch" block: time-mix with data-dependent decay + channel-mix.

Ported from the JAX package's ``repro/models/rwkv.py``, in plain PyTorch
(the reference runs the WKV recurrence as a ``lax.scan`` on XLA, not in a
Pallas kernel). Attention-free: the per-head state S ∈ R^{dh×dh} evolves as

    S_t = diag(w_t) S_{t-1} + k_tᵀ v_t,   y_t = r_t (S_{t-1} + diag(u) k_tᵀ v_t)

with w_t = exp(-exp(w0 + LoRA(x_t))) a data-dependent per-channel decay,
computed in f32. No QKᵀ score matrix exists, so SFA is inapplicable.

Training and prefill run the recurrence in chunks of ``CHUNK`` tokens,
sequentially inside each (one state update a token, ``_wkv_chunk``), the
state carried across chunks; padded positions get w = 1 and k = v = 0, so
the final state is the state at n. With gradients on, each chunk is one
checkpointed autograd node (``_WKVChunk``: its backward reruns the chunk,
as the reference wraps its chunk body in ``jax.checkpoint``, then runs the
adjoint recurrence backward in time). Decode carries (x_prev, S): O(1) per
token.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import RWKVConfig
from repro_torch.models.layers import apply_norm, dense, dense_init, norm_init, normal

CHUNK = 128


def rwkv_tm_init(gen, d_model: int, cfg: RWKVConfig, device="cpu"):
    h = d_model // cfg.head_dim

    def lora(rank):
        return {"a": dense_init(gen, d_model, rank, scale=0.01, device=device),
                "b": dense_init(gen, rank, d_model, scale=0.01, device=device)}

    return {
        "mix_x": torch.full((5, d_model), 0.5, device=device),  # r,k,v,w,g token-shift mixes
        "w_r": dense_init(gen, d_model, d_model, device=device),
        "w_k": dense_init(gen, d_model, d_model, device=device),
        "w_v": dense_init(gen, d_model, d_model, device=device),
        "w_g": dense_init(gen, d_model, d_model, device=device),
        "w_o": dense_init(gen, d_model, d_model, device=device),
        "w0": torch.full((d_model,), -6.0, device=device),      # decay base (slow)
        "w_lora": lora(cfg.decay_lora),
        "u": normal(gen, (h, cfg.head_dim), 0.1, device),       # bonus
        "ln_out": norm_init(d_model, "layernorm", device),
    }


def rwkv_cm_init(gen, d_model: int, d_ff: int, device="cpu"):
    return {"mix_k": torch.full((d_model,), 0.5, device=device),
            "mix_r": torch.full((d_model,), 0.5, device=device),
            "w_k": dense_init(gen, d_model, d_ff, device=device),
            "w_v": dense_init(gen, d_ff, d_model, device=device),
            "w_r": dense_init(gen, d_model, d_model, device=device)}


def _token_shift(x, x_prev):
    """x_{t-1} with x_prev seeding position 0. x: (b, n, d)."""
    return torch.cat([x_prev[:, None], x[:, :-1]], dim=1)


def _wkv_chunk(s, r, k, v, w, u):
    """The recurrence over one chunk: (y (b, c, h, dh), the state after it,
    the state before each token, stacked (b, c, h, dh, dh)). The state
    update runs a token at a time, one fused multiply-add each (S_t = kᵀv_t
    + w_t ⊙ S_{t-1}); the readout of every token then comes in one product
    over the chunk, y_t = r_t S_{t-1} + (r_t · (u ⊙ k_t)) v_t, which is
    r_t (S_{t-1} + diag(u) k_tᵀ v_t) summed in another order."""
    kv = k[..., :, None] * v[..., None, :]                          # (b, c, h, dh, dh)
    wx = w[..., None]
    prev = []
    for t in range(r.shape[1]):
        prev.append(s)
        s = torch.addcmul(kv[:, t], wx[:, t], s)
    prev = torch.stack(prev, 1)
    y = torch.einsum("bchd,bchde->bche", r, prev) + (r * u * k).sum(-1, keepdim=True) * v
    return y, s, prev


class _WKVChunk(torch.autograd.Function):
    """One chunk as one autograd node, checkpointed: the forward keeps only
    its inputs, the backward reruns the state updates and then the adjoint
    recurrence backward in time, G_{t-1} = w_t ⊙ G_t + r_tᵀ ∂y_t, one fused
    multiply-add a token (recording each token's ops on the autograd tape
    would cost more host time than the card spends on them)."""

    @staticmethod
    def forward(ctx, s0, r, k, v, w, u):
        y, s, _ = _wkv_chunk(s0, r, k, v, w, u)
        ctx.save_for_backward(s0, r, k, v, w, u)
        return y, s

    @staticmethod
    def backward(ctx, gy, gs):
        s0, r, k, v, w, u = ctx.saved_tensors
        _, _, prev = _wkv_chunk(s0, r, k, v, w, u)
        gy = torch.zeros_like(r) if gy is None else gy
        g = torch.zeros_like(s0) if gs is None else gs
        dprev = r[..., :, None] * gy[..., None, :]                  # ∂L/∂S_{t-1} via y_t
        da = (gy * v).sum(-1, keepdim=True)                         # the bonus term's weight
        dr = torch.einsum("bchde,bche->bchd", prev, gy) + da * u * k
        dk = da * u * r
        dv = (r * u * k).sum(-1, keepdim=True) * gy
        du = (da * r * k).sum((0, 1))
        wx = w[..., None]
        gstate = [None] * r.shape[1]
        for t in reversed(range(r.shape[1])):
            gstate[t] = g                                           # ∂L/∂S_t
            g = torch.addcmul(dprev[:, t], wx[:, t], g)             # ∂L/∂S_{t-1}
        gstate = torch.stack(gstate, 1)                             # = ∂L/∂(kᵀv)_t
        dw = (gstate * prev).sum(-1)
        dk = dk + (gstate * v[..., None, :]).sum(-1)
        dv = dv + (gstate * k[..., :, None]).sum(-2)
        return g, dr, dk, dv, dw, du


def _wkv_chunked(r, k, v, w, u, s0, chunk: int):
    """r, k, v, w: (b, n, h, dh) f32, n a multiple of ``chunk``; u: (h, dh);
    s0: (b, h, dh, dh). Returns (y (b, n, h, dh), s_n). With gradients on,
    each chunk is a checkpointed ``_WKVChunk``."""
    grad = torch.is_grad_enabled()
    ys, s = [], s0
    for c0 in range(0, r.shape[1], chunk):
        args = (s, r[:, c0:c0 + chunk], k[:, c0:c0 + chunk], v[:, c0:c0 + chunk],
                w[:, c0:c0 + chunk], u)
        y, s = _WKVChunk.apply(*args) if grad else _wkv_chunk(*args)[:2]
        ys.append(y)
    return torch.cat(ys, 1), s


def rwkv_time_mix(params, x, cfg: RWKVConfig, *, mode="train", state=None,
                  chunk: int = CHUNK):
    """state: {"x_prev": (b, d), "s": (b, h, dh, dh)}. Returns (out, the new
    state in "decode" and "prefill", else None)."""
    p = params
    b, n, d = x.shape
    h, dh = d // cfg.head_dim, cfg.head_dim
    dt = x.dtype
    x_prev = state["x_prev"] if state is not None else x.new_zeros((b, d))
    xs = _token_shift(x, x_prev)
    mix = p["mix_x"].to(dt)                                          # (5, d)
    xr, xk, xv, xw, xg = (x * mix[i] + xs * (1 - mix[i]) for i in range(5))
    r = dense(p["w_r"], xr, dt).reshape(b, n, h, dh)
    k = dense(p["w_k"], xk, dt).reshape(b, n, h, dh)
    v = dense(p["w_v"], xv, dt).reshape(b, n, h, dh)
    g = F.silu(dense(p["w_g"], xg, dt))
    # the data-dependent decay (the Finch novelty), in (0, 1)
    wl = dense(p["w_lora"]["b"], torch.tanh(dense(p["w_lora"]["a"], xw, dt)), dt)
    w = torch.exp(-torch.exp(p["w0"] + wl.float())).reshape(b, n, h, dh)

    rf, kf, vf = r.float(), k.float(), v.float()
    u = p["u"]
    if mode == "decode":
        s = state["s"]
        kv = kf[:, 0, :, :, None] * vf[:, 0, :, None, :]
        y = torch.einsum("bhd,bhde->bhe", rf[:, 0], s + u[..., None] * kv)[:, None]
        s_n = w[:, 0, ..., None] * s + kv
    else:
        s0 = state["s"] if state is not None else x.new_zeros((b, h, dh, dh),
                                                              dtype=torch.float32)
        c = min(chunk, n)
        pad = (-n) % c
        if pad:
            rf, kf, vf = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (rf, kf, vf))
            w = F.pad(w, (0, 0, 0, 0, 0, pad), value=1.0)
        y, s_n = _wkv_chunked(rf, kf, vf, w, u, s0, c)
        y = y[:, :n]
    y = apply_norm(p["ln_out"], y.reshape(b, n, d).to(dt), "layernorm")
    out = dense(p["w_o"], y * g, dt)
    new_state = {"x_prev": x[:, -1], "s": s_n} if mode in ("decode", "prefill") else None
    return out, new_state


def rwkv_channel_mix(params, x, *, mode="train", state=None):
    """Squared-ReLU channel mix with token shift. state: {"x_prev": (b, d)}."""
    b, n, d = x.shape
    dt = x.dtype
    x_prev = state["x_prev"] if state is not None else x.new_zeros((b, d))
    xs = _token_shift(x, x_prev)
    mk = params["mix_k"].to(dt)
    mr = params["mix_r"].to(dt)
    xk = x * mk + xs * (1 - mk)
    xr = x * mr + xs * (1 - mr)
    kk = torch.square(F.relu(dense(params["w_k"], xk, dt)))
    out = torch.sigmoid(dense(params["w_r"], xr, dt)) * dense(params["w_v"], kk, dt)
    new_state = {"x_prev": x[:, -1]} if mode in ("decode", "prefill") else None
    return out, new_state


def rwkv_init_state(b: int, d_model: int, cfg: RWKVConfig, dtype=torch.bfloat16,
                    device="cpu"):
    """The decode state: the token-shift rows in the cache dtype, S in f32."""
    h, dh = d_model // cfg.head_dim, cfg.head_dim
    return {"tm": {"x_prev": torch.zeros((b, d_model), dtype=dtype, device=device),
                   "s": torch.zeros((b, h, dh, dh), dtype=torch.float32, device=device)},
            "cm": {"x_prev": torch.zeros((b, d_model), dtype=dtype, device=device)}}
