"""Carry the JAX package's weights into the port.

``from_jax(tree, cfg, device=...)`` turns a JAX parameter tree — nested
dicts and lists of NumPy arrays, e.g. ``jax.tree.map(np.asarray, params)``
— into the port's ``Model``. The layout is the JAX one, unchanged: the
stacked per-segment layer axis of ``params["segments"][si]``, the packed
``w_qkv`` (d_model, (h + 2·hkv)·hd) that attention splits in column order
q | k | v, dense weights as (in, out) without bias, norms with ``scale``
(and ``bias`` for LayerNorm), the tied ``embed.w`` (vocab, d) and ``pos.w``
with min(max_seq_len, 65536) rows; a frontend model's dense
``frontend.w`` (input_dim, d), with no ``embed`` for audio (hubert, whose
``pos.w`` and untied ``lm_head.w`` are carried as well, the former never
read); an MoE layer's ``moe`` holds
``router.w`` (d, e), the stacked experts ``up`` / ``gate`` (e, d, f) and
``down`` (e, f, d), and ``shared_{up,gate,down}.w``; an MLA layer's ``attn``
holds ``w_dq``, ``q_norm``, ``w_uq_nope``, ``w_uq_pe``, ``w_dkv``,
``kv_norm``, ``w_kpe``, ``w_uk``, ``w_uv`` and ``w_o`` (the per-head
up-projections packed head-major in their columns, as in JAX); a jamba
super-block's ``subs`` list (a dict per sublayer, list index as the key)
holds ``ln1``, ``ln2``, ``attn`` or ``mamba`` (``in_proj``, ``conv_w``,
``conv_b``, ``x_proj``, ``dt_proj``, ``dt_bias``, ``a_log``, ``d_skip``,
``out_proj``) and ``moe`` or ``mlp``; an rwkv layer holds LayerNorms
``ln1`` and ``ln2``, the time mix ``tm`` (``mix_x``, ``w_r``, ``w_k``,
``w_v``, ``w_g``, ``w_o``, ``w0``, ``w_lora.{a,b}``, ``u``, ``ln_out``)
and the channel mix ``cm`` (``mix_k``, ``mix_r``, ``w_k``, ``w_v``,
``w_r``). Every JAX leaf must be consumed and every port parameter filled with a leaf of its
shape, or this raises.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.model import Model, default_device, param_tree


def _flatten(tree, prefix=""):
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix[:-1]: tree}
    out = {}
    for key, sub in items:
        out.update(_flatten(sub, f"{prefix}{key}."))
    return out


def fill_tree(spec, flat, prefix=""):
    """``spec``'s nested dicts and lists with each leaf replaced by
    ``flat[<its dotted name>]`` (the names of ``Model.named_parameters``)."""
    if isinstance(spec, dict):
        return {k: fill_tree(v, flat, f"{prefix}{k}.") for k, v in spec.items()}
    if isinstance(spec, list):
        return [fill_tree(v, flat, f"{prefix}{i}.") for i, v in enumerate(spec)]
    return flat[prefix[:-1]]


def from_jax(tree, cfg: ModelConfig, *, device=None) -> Model:
    """The port's ``Model`` holding the weights of a JAX param tree."""
    device = default_device(device)
    spec = param_tree(cfg, device="meta")
    want = {name: tuple(t.shape) for name, t in _flatten(spec).items()}
    have = _flatten(tree)
    missing = sorted(set(want) - set(have))
    extra = sorted(set(have) - set(want))
    if missing or extra:
        raise ValueError(f"JAX tree does not match {cfg.name}: missing "
                         f"{missing}, unconsumed {extra}")
    flat = {}
    for name, shape in want.items():
        arr = np.asarray(have[name])
        if tuple(arr.shape) != shape:
            raise ValueError(f"{name}: JAX leaf has shape {arr.shape}, the "
                             f"port expects {shape}")
        flat[name] = torch.as_tensor(np.array(arr, dtype=np.float32),
                                     device=device)
    return Model(fill_tree(spec, flat), cfg)
