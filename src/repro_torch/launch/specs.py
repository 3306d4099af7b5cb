"""Sharding specs of the training state, the caches and the inputs, as in
the JAX package's ``repro/launch/specs.py``.

``param_specs`` maps the parameter tree to specs by path rules (TP on the
fused head / ffn / vocab dims over ``model``, FSDP on the d_model dim over
``data``, EP on the expert dim), dropping any proposed axis that does not
divide its dim, so the same rules serve every arch (hubert's vocab of 504
stays whole). ``cache_specs`` places the stacked decode caches,
``input_specs`` and ``abstract_state`` give a cell's step inputs and its
training state as tensors on the ``meta`` device (no allocation, as
``ShapeDtypeStruct`` / ``eval_shape``).

A spec is a tuple with one entry a dim: a mesh axis name, a tuple of axis
names (the dim split over their product, the first axis major), or None
(whole). The functions read only a mesh's ``shape`` (axis -> size), so a
``launch.mesh.ShapeMesh`` of the production meshes needs no process
group. Trees are the port's nested dicts and lists; a spec tree has the
same containers with a spec at each leaf. ``shardings_of`` gives each
leaf's shard shape on a mesh; ``distributed/shard.py`` slices and gathers
by these specs.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.core.kv_cache import HybridCache, KVCache, RecurrentState
from repro_torch.distributed.shard import map_tree, named_leaves

# FSDP splits over "data" alone (in-pod; "pod" stays pure DP), TP and EP
# over "model"
MODEL_AXIS = "model"


# --------------------------------------------------------------------------
# parameter specs
# --------------------------------------------------------------------------

_COL_KEYS = ("w_q", "w_k", "w_v", "w_g", "w_qkv", "up", "gate", "up_gate",
             "w_uq_nope", "w_uq_pe", "w_uk", "w_uv", "in_proj", "dt_proj",
             "w_kpe", "frontend", "shared_up", "shared_gate", "w_r")
_ROW_KEYS = ("w_o", "down", "out_proj", "x_proj", "shared_down")


def _axis_ok(mesh, axis, dim_size: int) -> bool:
    if axis is None:
        return True
    sizes = mesh.shape
    if isinstance(axis, tuple):
        total = 1
        for a in sizes:
            if a in axis:
                total *= sizes[a]
        return dim_size % total == 0 and all(a in sizes for a in axis)
    return axis in sizes and dim_size % sizes[axis] == 0


def _clean(mesh, spec: tuple, shape) -> tuple:
    out = []
    for i, ax in enumerate(spec):
        ax2 = ax
        if isinstance(ax, tuple):
            ax2 = tuple(a for a in ax if a in mesh.shape)
            ax2 = ax2 or None
        elif ax is not None and ax not in mesh.shape:
            ax2 = None
        out.append(ax2 if _axis_ok(mesh, ax2, shape[i]) else None)
    return tuple(out)


def _leaf_spec(path: str, leaf, cfg: ModelConfig, stacked: bool) -> tuple:
    nd = leaf.ndim
    lead = (None,) if stacked else ()
    dims = nd - len(lead)
    name = path.split("/")[-2] if path.endswith("/w") else path.split("/")[-1]

    if dims == 1:
        return (*lead, None)
    # MoE expert tensors: (E, din, dout) -> EP on E, FSDP on din
    if name in ("up", "down", "gate") and dims == 3:
        return (*lead, MODEL_AXIS, "data", None)
    if path.endswith("embed/w") or "pos/w" in path:
        return (*lead, MODEL_AXIS, "data")            # vocab-TP + FSDP
    if "lm_head" in path:
        return (*lead, "data", MODEL_AXIS)
    if name in _COL_KEYS and dims == 2:
        return (*lead, "data", MODEL_AXIS)            # column parallel + FSDP
    if name in _ROW_KEYS and dims == 2:
        return (*lead, MODEL_AXIS, "data")            # row parallel + FSDP
    if name == "conv_w":
        return (*lead, None, MODEL_AXIS)
    if name in ("a_log", "u") and dims == 2:
        return (*lead, MODEL_AXIS, None)
    if name in ("dt_bias", "d_skip", "w0") and dims == 1:
        return (*lead, MODEL_AXIS)
    if dims == 2:
        return (*lead, "data", None)                  # default: FSDP dim0
    return (*lead, *([None] * dims))


def param_specs(params, cfg: ModelConfig, mesh, *, mode: str = "tp"):
    """The spec tree of ``params`` (a nested dict / list of tensors, e.g.
    ``param_tree(cfg, device="meta")``).

    mode="tp": TP on fused head / ffn / vocab dims + FSDP over data (the
    default). mode="zero3": no tensor parallelism: every leaf of two or
    more dims split over (data, model) on its first dim (the dry run's
    choice for attention-free training, ``launch/dryrun.py``)."""
    if mode not in ("tp", "zero3"):
        raise ValueError(f"mode={mode!r}; expected 'tp' or 'zero3'")

    def spec_for(parts, leaf):
        path = "/".join(parts)
        stacked = "segments" in path
        if mode == "zero3":
            lead = (None,) if stacked else ()
            dims = leaf.ndim - len(lead)
            if dims >= 2:
                s = (*lead, ("data", MODEL_AXIS), *([None] * (dims - 1)))
            elif dims == 1:
                s = (*lead, ("data", MODEL_AXIS))
            else:
                s = lead
        else:
            s = _leaf_spec(path, leaf, cfg, stacked)
        return _clean(mesh, s, leaf.shape)

    specs = iter([spec_for(parts, leaf) for parts, leaf in named_leaves(params)])
    return map_tree(lambda _: next(specs), params)


def axis_size(mesh, axis) -> int:
    """The number of shards along a spec entry (an axis, a tuple of axes or
    None) on ``mesh``."""
    if axis is None:
        return 1
    axes = axis if isinstance(axis, tuple) else (axis,)
    return math.prod(mesh.shape.get(a, 1) for a in axes)


def shard_shape(shape, spec, mesh) -> tuple:
    """The shape of one shard of a leaf of ``shape`` placed by ``spec``."""
    return tuple(n // axis_size(mesh, ax) for n, ax in zip(shape, spec))


def shardings_of(params, spec_tree, mesh):
    """Each leaf's shard shape on ``mesh`` (the tree of ``params``)."""
    return map_tree(lambda leaf, spec: shard_shape(leaf.shape, spec, mesh), params, spec_tree)


# --------------------------------------------------------------------------
# cache / batch / input specs
# --------------------------------------------------------------------------

def cache_specs(caches_shape, cfg: ModelConfig, mesh, *, batch: int, max_len: int):
    """Specs of the stacked decode caches (``init_decode_caches``), in
    their structure: each ``KVCache`` with a spec in each tensor field,
    each ``RecurrentState`` with a spec tree, a ``HybridCache`` both.

    Layout per leaf: axis 0 = layers (replicated), axis 1 = batch.
    Priority:
      1. batch over (pod, data) when divisible;
      2. KV heads over model when divisible; otherwise the cache *length*
         axis takes the model axis (flash-decode sequence parallelism);
      3. when batch itself is too small (long_500k b=1), the length axis
         additionally takes the data axis;
      4. MLA latent dim / SSM channel dims shard over model when divisible.

    A KVCache carries its token axis per field (``KVCache.token_axis``:
    the feature-major K image keeps tokens last); SSM states have none."""
    a = cfg.attention
    batch_ax = ("pod", "data") if "pod" in mesh.shape else ("data",)
    bsz = 1
    for ax in batch_ax:
        bsz *= mesh.shape.get(ax, 1)
    batch_ok = batch % bsz == 0
    msize = mesh.shape.get(MODEL_AXIS, 1)
    heads_ok = a is not None and a.mla is None and a.num_kv_heads % msize == 0
    latent = a.mla.kv_lora_rank if (a is not None and a.mla) else -1

    len_axes = []
    if not batch_ok:
        len_axes.append("data")
    if not heads_ok:
        len_axes.append(MODEL_AXIS)
    len_ax = tuple(len_axes) if len_axes else None

    def leaf_spec(leaf, token_axis, kv=False):
        dims = [None] * leaf.ndim
        if leaf.ndim >= 2 and batch_ok:
            dims[1] = batch_ax
        used_model = False
        for i in range(2, leaf.ndim):
            sz = leaf.shape[i]
            if i == token_axis:
                dims[i] = len_ax
                used_model = used_model or (len_ax and MODEL_AXIS in len_ax)
            elif kv and a is not None and a.mla is None and i in (2, 3) and \
                    sz == a.num_kv_heads and heads_ok and not used_model:
                # KVCache leaves only (SSM states must not trip on size
                # coincidences): token-major layouts carry hkv at axis 3,
                # the feature-major K image (L, B, hkv, d, n) at axis 2
                dims[i] = MODEL_AXIS
                used_model = True
            elif sz == latent and not used_model:
                dims[i] = MODEL_AXIS
                used_model = True
        if not used_model:
            # SSM channel dims (mamba d_inner, rwkv head_dim): first large
            # divisible trailing dim takes the model axis
            for i in range(2, leaf.ndim):
                if dims[i] is None and leaf.shape[i] >= 64 and leaf.shape[i] % msize == 0:
                    dims[i] = MODEL_AXIS
                    break
        return _clean(mesh, tuple(dims), leaf.shape)

    def one(node):
        if isinstance(node, KVCache):
            changes = {}
            for f in dataclasses.fields(node):
                leaf = getattr(node, f.name)
                if not torch.is_tensor(leaf):
                    continue
                changes[f.name] = leaf_spec(leaf, type(node).token_axis(f.name, stacked=True),
                                            kv=True)
            return dataclasses.replace(node, **changes)
        if isinstance(node, HybridCache):
            return HybridCache(one(node.attn), one(node.mamba))
        if isinstance(node, RecurrentState):
            return RecurrentState(map_tree(lambda t: leaf_spec(t, -1), node.tree))
        if isinstance(node, list):
            return [one(n) for n in node]
        return leaf_spec(node, -1)

    return one(caches_shape)


def batch_axes(mesh) -> tuple:
    return ("pod", "data") if "pod" in mesh.shape else ("data",)


def _meta(shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    """The cell's step inputs as ``meta`` tensors (no allocation): int32
    tokens and labels, bf16 frames or patches, and for a decode cell the
    token, the stacked caches of ``init_decode_caches`` and the lengths."""
    from repro_torch.models.model import init_decode_caches
    b, n = shape.global_batch, shape.seq_len
    i32 = torch.int32
    if shape.kind in ("train", "prefill"):
        if cfg.family == "audio":
            batch = {"frames": _meta((b, n, cfg.frontend.input_dim), torch.bfloat16)}
        elif cfg.family == "vlm":
            pl_ = cfg.frontend.prefix_len
            batch = {"tokens": _meta((b, n - pl_), i32),
                     "patches": _meta((b, pl_, cfg.frontend.input_dim), torch.bfloat16)}
        else:
            batch = {"tokens": _meta((b, n), i32)}
        if shape.kind == "train":
            lab_n = n - (cfg.frontend.prefix_len if cfg.family == "vlm" else 0)
            batch["labels"] = _meta((b, lab_n), i32)
        return batch
    # decode: one new token against a cache of length n
    return {"token": _meta((b,), i32),
            "caches": init_decode_caches(cfg, b, n, device="meta"),
            "cache_len": _meta((b,), i32)}


def abstract_state(cfg: ModelConfig):
    """(the parameter tree, ``OptState(0, m, v)`` with the f32 moments
    nested as the parameters), every leaf on the ``meta`` device."""
    from repro_torch.models.model import param_tree
    from repro_torch.optim import OptState
    params = param_tree(cfg, device="meta")

    def zeros():
        return map_tree(lambda p: torch.empty(p.shape, dtype=torch.float32, device="meta"),
                        params)
    return params, OptState(step=0, m=zeros(), v=zeros())
