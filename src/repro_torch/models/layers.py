"""Shared model layers: dense, norms, MLPs, RoPE, embeddings.

Ported from the JAX package's ``repro/models/layers.py``. Parameters live in
``ParamTree`` modules that mirror the JAX param tree name for name (so a
state-dict key such as ``segments.0.attn.w_qkv.w`` is the JAX path
``["segments"][0]["attn"]["w_qkv"]["w"]``); the layer functions take the
plain nested dict of tensors (``ParamTree.tree()``) and an activation. Each
layer is a pair ``<layer>_init(gen, ...) -> dict`` / ``<layer>(p, x, ...)``.
Parameters are f32 and cast to the activation dtype at use. The
training loss ``chunked_cross_entropy`` is here too, and the two compact
backward pieces of the SFA seam: ``sparse_proj_bwd`` (the projection
backward from code gradients) and ``rope_code_vjp`` (RoPE's vjp on
pair-closure codes).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.distributed.shard import run_tp
from repro_torch.kernels.code_grad import code_grad_dw, code_grad_dx
from repro_torch.kernels.ref import rope_freqs


class ParamTree(nn.Module):
    """An ``nn.Module`` holding a nested dict/list of tensors as parameters,
    under the same names as the JAX param tree. The parameters are frozen,
    as serving needs them; ``requires_grad_(True)`` makes them trainable,
    as the trainer does."""

    def __init__(self, tree):
        super().__init__()
        items = tree.items() if isinstance(tree, dict) else enumerate(tree)
        self._keys = []
        for key, sub in items:
            name = str(key)
            self._keys.append(key)
            if isinstance(sub, (dict, list)):
                self.add_module(name, ParamTree(sub))
            else:
                self.register_parameter(name, nn.Parameter(sub, requires_grad=False))
        self._is_list = isinstance(tree, list)

    def __getitem__(self, key):
        return getattr(self, str(key))

    def tree(self):
        """The nested dict (or list) of parameter tensors."""
        out = {}
        for key in self._keys:
            name = str(key)
            sub = self._modules.get(name)
            out[key] = sub.tree() if sub is not None else self._parameters[name]
        return list(out.values()) if self._is_list else out


def tree_index(tree, i):
    """Slice every leaf of a nested dict / list of stacked tensors at index
    i (a jamba super-block's ``{"subs": [8 dicts]}``)."""
    if isinstance(tree, dict):
        return {k: tree_index(v, i) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_index(v, i) for v in tree]
    return tree[i]


def normal(gen, shape, std, device):
    """N(0, std²) f32 tensor from ``gen`` (empty on the meta device)."""
    if torch.device(device).type == "meta":
        return torch.empty(shape, dtype=torch.float32, device="meta")
    return torch.randn(shape, generator=gen, dtype=torch.float32,
                       device=device) * std


def dense_init(gen, in_dim: int, out_dim: int, *, scale=None, device="cpu"):
    scale = scale if scale is not None else in_dim ** -0.5
    return {"w": normal(gen, (in_dim, out_dim), scale, device)}


def dense(params, x, dtype=None):
    w = params["w"]
    if dtype is not None:
        w = w.to(dtype)
    return x @ w


def sparse_proj_bwd(x, w_heads, g_vals, g_idx, *, d: int):
    """Backward of the head-blocked projection y_h = x @ w_h whose upstream
    cotangent arrives as compact code gradients: x (n, m), w_heads
    (H, m, d), g_vals/g_idx (H, n, kw) -> dx = Σ_h scatter(g_h) @ w_hᵀ
    (n, m) and dw_h = xᵀ @ scatter(g_h) (H, m, d), both f32, through the
    code_grad kernels: the dense (n, d) gradient is never formed.

    Under tensor parallelism the head axis splits over the model mesh axis
    (``distributed/shard.py``): dW stays per head slice (column-parallel)
    and dx, the one reduction of the seam's backward, sums its per-rank
    partials over the axis."""
    def fn(xx, ww, gv, gi):
        return code_grad_dx(gv, gi, ww, d=d), code_grad_dw(xx, gv, gi, d=d)

    return run_tp(fn, (x, w_heads, g_vals, g_idx), in_axes=(None, 0, 0, 0),
                  out_axes=(None, 0), reduce_out=(0,))


def norm_init(dim: int, kind: str = "rmsnorm", device="cpu"):
    p = {"scale": torch.ones((dim,), dtype=torch.float32, device=device)}
    if kind == "layernorm":
        p["bias"] = torch.zeros((dim,), dtype=torch.float32, device=device)
    return p


def apply_norm(params, x, kind: str = "rmsnorm", eps: float = 1e-6):
    """Norms with f32 statistics and activation-dtype elementwise math, in
    the JAX package's op order (not ``nn.LayerNorm``'s)."""
    dt = x.dtype
    xf = x.float()
    if kind == "rmsnorm":
        r = torch.rsqrt((xf * xf).mean(-1, keepdim=True) + eps)
        return x * r.to(dt) * params["scale"].to(dt)
    mu = xf.mean(-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(-1, keepdim=True)
    r = torch.rsqrt(var + eps)
    return ((x - mu.to(dt)) * r.to(dt) * params["scale"].to(dt)
            + params["bias"].to(dt))


_ACTS = {
    "silu": F.silu,
    # jax.nn.gelu's default is the tanh approximation
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "relu": F.relu,
    "relu2": lambda x: torch.square(F.relu(x)),
}


def mlp_init(gen, d_model: int, d_ff: int, *, glu: bool = True, device="cpu"):
    if glu:
        return {"up_gate": dense_init(gen, d_model, 2 * d_ff, device=device),
                "down": dense_init(gen, d_ff, d_model, device=device)}
    return {"up": dense_init(gen, d_model, d_ff, device=device),
            "down": dense_init(gen, d_ff, d_model, device=device)}


def mlp(params, x, *, act: str = "silu", glu: bool = True):
    dt = x.dtype
    if glu:
        h, g = dense(params["up_gate"], x, dt).chunk(2, dim=-1)
        h = h * _ACTS[act](g)
    else:
        h = _ACTS[act](dense(params["up"], x, dt))
    return dense(params["down"], h, dt)


def embed_init(gen, vocab: int, d_model: int, device="cpu"):
    return {"w": normal(gen, (vocab, d_model), 0.02, device)}


def embed(params, tokens, dtype=torch.bfloat16):
    return params["w"][tokens].to(dtype)


def _cos_sin(ang):
    """cos and sin of f32 angles, evaluated in f64 and rounded to f32: the
    correctly rounded table, the same bits on every CPU. torch's f32 cos
    and sin give other bits under AVX2 than under AVX-512 kernels."""
    a = ang.double()
    return torch.cos(a).float(), torch.sin(a).float()


def rope(x, positions, *, theta: float = 10_000.0, rot_dim: int | None = None):
    """Rotary embedding on (..., seq, heads, head_dim); positions (..., seq).
    If rot_dim < head_dim only the leading rot_dim dims rotate."""
    d = x.shape[-1]
    rot = rot_dim or d
    freqs = rope_freqs(theta, rot, x.device)
    ang = positions[..., None].float() * freqs                 # (..., s, rot/2)
    cos, sin = _cos_sin(ang)
    cos, sin = cos[..., None, :], sin[..., None, :]             # (..., s, 1, rot/2)
    x1 = x[..., 0:rot:2].float()
    x2 = x[..., 1:rot:2].float()
    r1 = x1 * cos - x2 * sin
    r2 = x2 * cos + x1 * sin
    rotated = torch.stack([r1, r2], dim=-1).reshape(*x.shape[:-1], rot)
    if rot < d:
        rotated = torch.cat([rotated, x[..., rot:].float()], dim=-1)
    return rotated.to(x.dtype)


def rope_code_vjp(vals, idx, positions, *, theta: float = 10_000.0, rot_dim: int):
    """RoPE's vjp on (…, 2k) pair-closure code cotangents (the
    ``emit="compact2"`` layout: the even members' half, then the odd
    members'; ``pair_closure_indices``). RoPE turns each (2j, 2j + 1) pair,
    so a k-sparse cotangent after RoPE is 2k-sparse before it, on the known
    closure; per closure entry the inverse rotation of the pair's angle
    mixes the two halves in place:

        d_even = cos·g_even + sin·g_odd      d_odd = cos·g_odd − sin·g_even

    Entries whose index is at or beyond ``rot_dim`` never turned and pass
    through. vals/idx (…, 2k); positions broadcast to vals.shape[:-1].
    Returns the pre-RoPE code cotangents, same indices and dtype."""
    kw = vals.shape[-1] // 2
    ge = vals[..., :kw].float()
    go = vals[..., kw:].float()
    base = idx[..., :kw]
    rotated = base < rot_dim
    # pair j's frequency theta^(-2j/rot_dim): rope()'s table
    freqs = theta ** (-(torch.div(base, 2, rounding_mode="floor") * 2).float() / rot_dim)
    ang = positions[..., None].float() * freqs
    c, s = _cos_sin(ang)
    de = torch.where(rotated, c * ge + s * go, ge)
    do = torch.where(rotated, c * go - s * ge, go)
    return torch.cat([de, do], dim=-1).to(vals.dtype)


def _chunk_nll(h, emb_w, labels, mask):
    """Summed masked NLL of one sequence chunk: f32 logits (b, chunk,
    vocab) against the tied head, logsumexp minus the gold logit."""
    logits = h.float() @ emb_w.float().T
    lse = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, labels.clamp(min=0).long()[..., None])[..., 0]
    return ((lse - gold) * mask).sum()


def chunked_cross_entropy(hidden, emb_w, labels, *, chunk: int = 512):
    """Sequence-chunked CE loss, the JAX package's ``chunked_cross_entropy``.

    hidden: (b, n, d); emb_w: (vocab, d) (the tied LM head); labels (b, n),
    -1 where there is no target. Logits exist only per chunk: each chunk
    runs under ``torch.utils.checkpoint``, so the backward recomputes its
    (b, chunk, vocab) logits instead of keeping all of them (1.65 GB in f32
    at batch 8 × 1024 × 50,257). A last chunk shorter than ``chunk`` equals
    the JAX package's padded one: padding carries label -1. Returns (mean
    loss over the labelled tokens, token count) as f32 scalars.
    """
    mask = (labels >= 0).float()
    loss_sum = hidden.new_zeros((), dtype=torch.float32)
    for s in range(0, hidden.shape[1], chunk):
        loss_sum = loss_sum + checkpoint(
            _chunk_nll, hidden[:, s:s + chunk], emb_w, labels[:, s:s + chunk],
            mask[:, s:s + chunk], use_reentrant=False)
    cnt = mask.sum()
    return loss_sum / cnt.clamp(min=1.0), cnt
