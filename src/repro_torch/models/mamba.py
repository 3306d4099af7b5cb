"""Mamba-1 selective SSM block (jamba's recurrent layer).

Ported from the JAX package's ``repro/models/mamba.py``, in plain PyTorch:
the reference runs the scan on XLA (``lax.associative_scan`` inside
``lax.scan``), not in a Pallas kernel, so no hand-written kernel stands
behind it here either.

Training and prefill split the sequence into chunks of ``CHUNK`` tokens
and carry the boundary state across them. Inside a chunk the recurrence
h_t = a_t ⊙ h_{t-1} + b_t runs as a log-step doubling scan (Hillis-Steele:
log2(chunk) steps of whole-chunk products, the prefix composition of the
reference's ``associative_scan`` in another tree order); torch has no
``associative_scan`` outside ``torch.compile``. Each chunk forms its own
discretised (a, b) and its outputs y = h · C, so the (b, n, d_inner,
d_state) working set is one chunk's; padded positions get delta 0, hence a
= 1 and b = 0, and the final state is the state at n. With gradients on,
each chunk runs under ``torch.utils.checkpoint``, as the reference wraps
its chunk body in ``jax.checkpoint``. Decode is the O(1) single-step
recurrence on a carried (conv window, ssm state).

The causal depthwise conv is the f32 sum of shifted scales in both paths
(a prompt's and the decode step's window), so the two agree bit for bit.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import SSMConfig
from repro_torch.models.layers import dense, dense_init, normal

CHUNK = 256


def _uniform(gen, shape, lo, hi, device):
    if torch.device(device).type == "meta":
        return torch.empty(shape, dtype=torch.float32, device="meta")
    return lo + (hi - lo) * torch.rand(shape, generator=gen, dtype=torch.float32,
                                       device=device)


def mamba_init(gen, d_model: int, ssm: SSMConfig, device="cpu"):
    """The JAX tree's leaves and scales: dt_bias the inverse softplus of a
    log-uniform step in [1e-3, 1e-1], a_log = log(1..state_dim)."""
    di = ssm.expand * d_model
    dtr = ssm.dt_rank or -(-d_model // 16)
    dt0 = torch.exp(_uniform(gen, (di,), math.log(1e-3), math.log(1e-1), device))
    a = torch.arange(1, ssm.state_dim + 1, dtype=torch.float32, device=device)
    return {
        "in_proj": dense_init(gen, d_model, 2 * di, device=device),
        "conv_w": normal(gen, (ssm.conv_dim, di), 0.2, device),
        "conv_b": torch.zeros((di,), dtype=torch.float32, device=device),
        "x_proj": dense_init(gen, di, dtr + 2 * ssm.state_dim, device=device),
        "dt_proj": dense_init(gen, dtr, di, device=device),
        "dt_bias": torch.log(torch.exp(dt0) - 1.0 + 1e-9),
        "a_log": torch.log(a).expand(di, ssm.state_dim).clone(),
        "d_skip": torch.ones((di,), dtype=torch.float32, device=device),
        "out_proj": dense_init(gen, di, d_model, device=device),
    }


def _conv(win, w, bias):
    """Σ_i win[:, i : i + n] · w[i] + bias in f32, i ascending: ``win`` (b,
    n + cw - 1, di) f32 holds the cw - 1 positions before each output."""
    cw = w.shape[0]
    n = win.shape[1] - cw + 1
    return sum(win[:, i:i + n] * w[i] for i in range(cw)) + bias


def _doubling_scan(a, bx):
    """Inclusive scan of h_t = a_t h_{t-1} + bx_t from h = 0 along dim 1,
    with the running products of a: log2(c) steps, each composing every
    position with the one ``off`` before it."""
    c, off = a.shape[1], 1
    while off < c:
        bx = torch.cat([bx[:, :off], a[:, off:] * bx[:, :-off] + bx[:, off:]], 1)
        a = torch.cat([a[:, :off], a[:, off:] * a[:, :-off]], 1)
        off *= 2
    return a, bx


def _chunk(h, delta, xc, bmat, cmat, a_cont):
    """One chunk: (y (b, c, di) = Σ_s h_t · C_t, the state after it)."""
    a = torch.exp(delta[..., None] * a_cont)                        # (b, c, di, s)
    bx = (delta * xc)[..., None] * bmat[:, :, None, :]
    a_sc, b_sc = _doubling_scan(a, bx)
    hs = a_sc * h[:, None] + b_sc
    return torch.einsum("bnds,bns->bnd", hs, cmat), hs[:, -1]


def _ssm_scan_chunked(delta, xc, bmat, cmat, a_cont, h0, chunk: int, remat: bool):
    """y (b, n, di) and the final state over chunks of ``chunk`` (n a
    multiple of it), the boundary state carried."""
    ys, h = [], h0
    for c0 in range(0, delta.shape[1], chunk):
        args = (h, delta[:, c0:c0 + chunk], xc[:, c0:c0 + chunk],
                bmat[:, c0:c0 + chunk], cmat[:, c0:c0 + chunk], a_cont)
        y, h = checkpoint(_chunk, *args, use_reentrant=False) if remat else _chunk(*args)
        ys.append(y)
    return torch.cat(ys, 1), h


def mamba_apply(params, x, ssm: SSMConfig, *, mode: str = "train", state=None,
                chunk: int = CHUNK):
    """x: (b, n, d). mode "decode": n == 1, state = {"conv": (b, cw, di),
    "h": (b, di, s)}; returns (out, new_state). Other modes return (out,
    the state after the prompt in "prefill", else None); a given state's
    ``h`` seeds the scan."""
    b, n, d = x.shape
    s = ssm.state_dim
    dt = x.dtype
    xi, z = dense(params["in_proj"], x, dt).chunk(2, dim=-1)        # (b, n, di)
    cw = ssm.conv_dim
    if mode == "decode":
        conv_win = torch.cat([state["conv"][:, 1:], xi], dim=1)
        xc = F.silu(_conv(conv_win.float(), params["conv_w"], params["conv_b"])).to(dt)
    else:
        xpad = F.pad(xi.float(), (0, 0, cw - 1, 0))
        xc = F.silu(_conv(xpad, params["conv_w"], params["conv_b"])).to(dt)
        conv_tail = F.pad(xi, (0, 0, cw - n, 0)) if n < cw else xi[:, -cw:]

    proj = dense(params["x_proj"], xc, dt)
    dtr = params["dt_proj"]["w"].shape[0]
    dt_raw, bmat, cmat = proj.split([dtr, s, s], dim=-1)
    delta = F.softplus(dense(params["dt_proj"], dt_raw, dt).float() + params["dt_bias"])
    a_cont = -torch.exp(params["a_log"])                            # (di, s)
    xcf, bmat, cmat = xc.float(), bmat.float(), cmat.float()

    if mode == "decode":
        a_disc = torch.exp(delta[:, 0, :, None] * a_cont)
        h = state["h"] * a_disc + (delta[:, 0] * xcf[:, 0])[..., None] * bmat[:, 0, None, :]
        y = torch.einsum("bds,bs->bd", h, cmat[:, 0])[:, None]
        new_state = {"conv": conv_win, "h": h}
    else:
        c = min(chunk, n)
        pad = (-n) % c
        seq = [F.pad(t, (0, 0, 0, pad)) for t in (delta, xcf, bmat, cmat)]
        h0 = state["h"] if state is not None else x.new_zeros((b, xi.shape[-1], s),
                                                              dtype=torch.float32)
        y, h_n = _ssm_scan_chunked(*seq, a_cont, h0, c, torch.is_grad_enabled())
        y = y[:, :n]
        new_state = {"conv": conv_tail, "h": h_n} if mode == "prefill" else None

    y = y + xcf * params["d_skip"]
    y = y.to(dt) * F.silu(z)
    return dense(params["out_proj"], y, dt), new_state


def mamba_init_state(b: int, d_model: int, ssm: SSMConfig, dtype=torch.bfloat16,
                     device="cpu"):
    """The decode state: the conv window in the cache dtype, h in f32."""
    di = ssm.expand * d_model
    return {"conv": torch.zeros((b, ssm.conv_dim, di), dtype=dtype, device=device),
            "h": torch.zeros((b, di, ssm.state_dim), dtype=torch.float32, device=device)}
