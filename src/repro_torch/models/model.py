"""Model assembly for the dense family: init, loss, prefill, decode, logits.

Ported from the JAX package's ``repro/models/model.py``. Parameters keep the
JAX tree's layout, including the stacked per-segment layer axis
(``params.segments[si]`` leaves are ``(count, ...)``); the JAX layer scan
becomes a Python loop over that axis. Decode caches are lists (one per
segment) of layer-stacked typed ``KVCache``s, updated in place; the paged
ones share one block table (``init_paged_decode_caches``). Serving entry
points: ``prefill``, ``decode_step``, and for the paged engines
``prefill_chunk`` (chunked prefill) and ``verify_step`` (the speculative
verify pass). In ``train``
and ``eval`` mode, ``cfg.remat="full"`` wraps each layer in
``torch.utils.checkpoint`` (the JAX ``jax.checkpoint`` of the scan body):
its activations are recomputed in the backward, kernels included.
``cfg.remat="codes"`` wraps it in ``core.remat.checkpoint_codes``, which
keeps the layer input and the SFA codes + LSE and reruns the rest; a stack
whose forward keeps no codes runs "full" instead, and the loop records why
(``core.remat.remat_reports``).

Entry points take the ``Model`` (a ``ParamTree``) where the JAX functions
take the param pytree. The dense, MoE, vlm and audio families are ported:
an MoE model is two segments, its ``first_dense`` dense layers (MLP widened
to ``max(d_ff, expert_dim · top_k)``) and then MoE layers
(``models/moe.py``), whose load-balance loss, weighted by
``MOE_AUX_WEIGHT``, joins the aux term. The frontend families are one dense
segment behind a dense ``frontend`` layer: vlm (paligemma) puts
``dense(frontend, batch["patches"])`` in front of the scaled token
embeddings, unscaled, and the loss gives that prefix no labels; audio
(hubert) has no token embedding, its hidden is ``dense(frontend,
batch["frames"])`` with no learned positions added, as in the reference
(its ``pos.w`` is carried but never read), and an encoder-only config
(``causal=False``) has no decode. A config with ``attention.window`` set
(gemma3) gives each layer its window (``_window_array``): ``window``, or
``GLOBAL_WINDOW`` on every ``local_global_pattern + 1``-th layer counted
across segments; every such layer requests a window, as in the reference.
MLA (deepseek-v2) and protected RoPE dims live in ``models/attention.py``.
A model built with ``specs`` (``launch.specs.param_specs`` on the active
mesh) holds this rank's shard of each leaf (``distributed/shard.py``) and
gathers a leaf where it reads it: a layer's leaves inside the function that
remat checkpoints, so the recompute gathers again and no layer's whole
weights outlive its use; the embedding, positions, frontend, final norm
and LM head once an entry point (``_outer``).
The recurrent families: hybrid (jamba) is one segment of super-blocks of
``hybrid_period`` sublayers (``params.segments[0]["subs"]``, a list),
attention at ``hybrid_attn_index`` and Mamba (``models/mamba.py``)
elsewhere, MoE in place of the MLP (of width ``d_ff``) on every
``moe.every``-th; ssm (rwkv) is one segment of RWKV-6 layers
(``models/rwkv.py``). Remat wraps a whole super-block, as the reference's
scan body. Their decode caches carry recurrent state
(``core.kv_cache.RecurrentState``, no token axis): an rwkv segment's is
one ``RecurrentState``, a jamba segment's a ``HybridCache`` (its KVCache
beside the super-block's list of Mamba states). A layer updates its
state in place, as attention does its KV; the paged caches refuse both,
as the reference does.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.core.kv_cache import HybridCache, KVCache, RecurrentState
from repro_torch.core.remat import checkpoint_codes, normalize_remat, record_remat
from repro_torch.distributed.shard import (
    gather_tree, layer_specs, map_tree, mark_specs, shard_leaf, spec_of,
)
from repro_torch.models import attention as attn
from repro_torch.models import layers as L
from repro_torch.models import mamba as mb
from repro_torch.models import moe as moe_lib
from repro_torch.models import rwkv as rk

MOE_AUX_WEIGHT = 0.01
GLOBAL_WINDOW = 1 << 30  # "window" value meaning unrestricted (a global layer)


def segments(cfg: ModelConfig):
    """[(kind, count)]: the JAX package's segments. hybrid -> one segment
    of super-blocks, ssm -> one of rwkv layers, else keyed on ``cfg.moe``
    (the frontend families are one dense segment)."""
    if cfg.family == "hybrid":
        return [("jamba", cfg.num_layers // cfg.hybrid_period)]
    if cfg.family == "ssm":
        return [("rwkv", cfg.num_layers)]
    if cfg.moe is not None:
        fd = cfg.moe.first_dense
        return ([("block_dense", fd)] if fd else []) + [("block_moe", cfg.num_layers - fd)]
    return [("block_dense", cfg.num_layers)]


def _window_array(cfg: ModelConfig, count: int, offset: int = 0):
    """Per-layer windows of layers ``offset .. offset + count - 1`` (the
    gemma3 local/global interleave: every ``(pattern + 1)``-th layer is
    global), or None for a config without windows."""
    a = cfg.attention
    if a is None or a.window is None:
        return None
    pat = a.local_global_pattern
    return [GLOBAL_WINDOW if pat is not None and i % (pat + 1) == pat else a.window
            for i in range(offset, offset + count)]


def dense_ff(cfg: ModelConfig) -> int:
    """A dense layer's MLP width: ``d_ff``, widened to ``expert_dim ·
    top_k`` inside an MoE model."""
    if cfg.moe is None:
        return cfg.d_ff
    return max(cfg.d_ff, cfg.moe.expert_dim * cfg.moe.top_k)


def _dtype(cfg: ModelConfig):
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def _refuse_encoder_only(cfg: ModelConfig):
    """Decode entry points and caches need a causal model (the reference's
    ``skip_reason`` for an encoder-only config)."""
    if not cfg.causal:
        raise ValueError(f"{cfg.name}: encoder-only: no autoregressive decode step")


def default_device(device):
    """Entry points run on the card unless the caller asks for the CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("repro_torch runs on a CUDA device by default and "
                               "none is available; pass device='cpu' to run on the CPU")
        return torch.device("cuda")
    return torch.device(device)


class Model(L.ParamTree):
    """The model's parameters, under the JAX param tree's names."""

    def __init__(self, tree: dict, cfg: ModelConfig):
        super().__init__(tree)
        self.cfg = cfg

    @property
    def device(self):
        return self.final_norm.scale.device

    def shard(self, specs) -> "Model":
        """Keep this rank's shard of every leaf placed by ``specs`` (a spec
        tree of ``tree()``, on the active mesh), in place."""
        def one(p, spec):
            p.data = shard_leaf(p.data, spec)
        map_tree(one, self.tree(), specs)
        mark_specs(self.tree(), specs)
        return self


def param_tree(cfg: ModelConfig, *, generator=None, device="cpu", place=None) -> dict:
    """The parameter tree with fresh values (shapes and scales of the JAX
    ``init``; its RNG's values are not reproduced). ``place(path, sub)``
    takes each top-level entry (path ``(key,)``) and each layer's tree
    (path ``("segments", si)``) as it is made and returns what to keep of
    it (``init`` keeps this rank's shards)."""
    place = place or (lambda path, sub: sub)

    def block(kind):
        if kind == "rwkv":
            return {"ln1": L.norm_init(cfg.d_model, "layernorm", device),
                    "tm": rk.rwkv_tm_init(generator, cfg.d_model, cfg.rwkv, device),
                    "ln2": L.norm_init(cfg.d_model, "layernorm", device),
                    "cm": rk.rwkv_cm_init(generator, cfg.d_model, cfg.d_ff, device)}
        if kind == "jamba":
            return {"subs": [jamba_sub(i) for i in range(cfg.hybrid_period)]}
        p = {"ln1": L.norm_init(cfg.d_model, cfg.norm, device),
             "attn": attn.attention_init(generator, cfg, device),
             "ln2": L.norm_init(cfg.d_model, cfg.norm, device)}
        if kind == "block_moe":
            p["moe"] = moe_lib.moe_init(generator, cfg.d_model, cfg.moe, glu=cfg.glu,
                                        device=device)
        else:
            p["mlp"] = L.mlp_init(generator, cfg.d_model, dense_ff(cfg), glu=cfg.glu,
                                  device=device)
        return p

    def jamba_sub(i):
        """Sublayer i of a super-block: attention or Mamba, then MoE or an
        MLP of width ``d_ff`` (not ``dense_ff``: the reference does not
        widen it)."""
        sub = {"ln1": L.norm_init(cfg.d_model, cfg.norm, device),
               "ln2": L.norm_init(cfg.d_model, cfg.norm, device)}
        if i == cfg.hybrid_attn_index:
            sub["attn"] = attn.attention_init(generator, cfg, device)
        else:
            sub["mamba"] = mb.mamba_init(generator, cfg.d_model, cfg.ssm, device)
        if i % cfg.moe.every == cfg.moe.every - 1:
            sub["moe"] = moe_lib.moe_init(generator, cfg.d_model, cfg.moe, glu=cfg.glu,
                                          device=device)
        else:
            sub["mlp"] = L.mlp_init(generator, cfg.d_model, cfg.d_ff, glu=cfg.glu,
                                    device=device)
        return sub

    def stack(trees):
        if isinstance(trees[0], dict):
            return {k: stack([t[k] for t in trees]) for k in trees[0]}
        if isinstance(trees[0], list):
            return [stack([t[j] for t in trees]) for j in range(len(trees[0]))]
        # one layer: a view, so a segment of one jamba super-block (53 GB
        # f32) is not held twice while it is stacked
        return trees[0][None] if len(trees) == 1 else torch.stack(trees)

    params = {}
    if cfg.frontend is None or cfg.frontend.kind == "patch":
        params["embed"] = place(("embed",), L.embed_init(generator, cfg.vocab_size,
                                                         cfg.d_model, device))
    if cfg.frontend is not None:
        params["frontend"] = place(("frontend",), L.dense_init(
            generator, cfg.frontend.input_dim, cfg.d_model, device=device))
    if cfg.pos_embedding == "learned":
        params["pos"] = place(("pos",), {"w": L.normal(
            generator, (min(cfg.max_seq_len, 65536), cfg.d_model), 0.01, device)})
    params["final_norm"] = place(("final_norm",), L.norm_init(cfg.d_model, cfg.norm, device))
    if not cfg.tie_embeddings:
        params["lm_head"] = place(("lm_head",), L.dense_init(
            generator, cfg.d_model, cfg.vocab_size, device=device))
    params["segments"] = [stack([place(("segments", si), block(kind)) for _ in range(count)])
                          for si, (kind, count) in enumerate(segments(cfg))]
    return params


def init(cfg: ModelConfig, *, generator=None, device=None, seed: int = 0,
         specs=None) -> Model:
    """Random weights from ``generator`` (or a new one seeded with ``seed``)
    on ``device`` (default: the card). With ``specs`` (a spec tree of the
    parameters on the active mesh) each leaf is cut to this rank's shard as
    it is made, so no rank holds the whole tree; the values are those of
    the unsharded ``init``."""
    device = default_device(device)
    if generator is None and device.type != "meta":
        generator = torch.Generator(device=device).manual_seed(seed)
    if specs is None:
        return Model(param_tree(cfg, generator=generator, device=device), cfg)

    def place(path, sub):
        spec = specs
        for key in path:
            spec = spec[key]
        if path[0] == "segments":          # one layer of a stacked segment
            spec = map_tree(lambda s: s[1:], spec)
        return map_tree(shard_leaf, sub, spec)

    model = Model(param_tree(cfg, generator=generator, device=device, place=place), cfg)
    mark_specs(model.tree(), specs)
    return model


# ==========================================================================
# block + stack
# ==========================================================================

def _moe_or_mlp(p, h, cfg: ModelConfig, mode: str):
    """The feed-forward half: (out, the MoE aux term x ``MOE_AUX_WEIGHT``
    in train and eval, else None)."""
    if "moe" in p:
        mo, aux = moe_lib.moe_apply(p["moe"], h, cfg.moe, act=cfg.act, glu=cfg.glu,
                                    with_aux=mode in ("train", "eval"))
        return mo, None if aux is None else MOE_AUX_WEIGHT * aux
    return L.mlp(p["mlp"], h, act=cfg.act, glu=cfg.glu), None


def _tx_block(p, x, cfg: ModelConfig, kind: str = "block_dense", *, window=None,
              positions=None, mode="train", cache=None, cache_len=None, slot=None):
    """One layer: (x, its cache, its aux term or None). The aux term is the
    MoE load-balance loss x ``MOE_AUX_WEIGHT`` plus the SFA distillation
    term x ``cfg.sfa_distill`` (paper Eq. 8), each where there is one."""
    h = L.apply_norm(p["ln1"], x, cfg.norm)
    ao = attn.attention_apply(p["attn"], h, cfg=cfg, positions=positions,
                              window=window, mode=mode, cache=cache,
                              cache_len=cache_len, slot=slot)
    x = x + ao.out
    h = L.apply_norm(p["ln2"], x, cfg.norm)
    mo, aux = _moe_or_mlp(p, h, cfg, mode)
    if ao.distill is not None:
        distill = cfg.sfa_distill * ao.distill
        aux = distill if aux is None else aux + distill
    return x + mo, ao.cache, aux


def _rwkv_block(p, x, cfg: ModelConfig, *, mode="train", state=None):
    """One RWKV-6 layer: (x, its state: ``state`` updated in place in
    decode, a new one in prefill, else None). ``state``: a
    ``RecurrentState`` of {"tm": {"x_prev", "s"}, "cm": {"x_prev"}}."""
    tree = None if state is None else state.tree
    h = L.apply_norm(p["ln1"], x, "layernorm")
    o, st_tm = rk.rwkv_time_mix(p["tm"], h, cfg.rwkv, mode=mode,
                                state=None if tree is None else tree["tm"])
    x = x + o
    h = L.apply_norm(p["ln2"], x, "layernorm")
    o, st_cm = rk.rwkv_channel_mix(p["cm"], h, mode=mode,
                                   state=None if tree is None else tree["cm"])
    if st_tm is None:
        return x + o, None
    new = {"tm": st_tm, "cm": st_cm}
    return x + o, (RecurrentState(new) if state is None else state.write(new))


def _jamba_super(p, x, cfg: ModelConfig, *, positions=None, mode="train", cache=None,
                 cache_len=None):
    """One jamba super-block of ``hybrid_period`` sublayers. ``cache``: a
    ``HybridCache`` of the attention layer's KVCache and a state per Mamba
    sublayer. Returns (x, the cache: ``cache`` updated in place in decode,
    a new one in prefill, None in train and eval; the summed MoE aux term
    or None)."""
    kv, states = None, []
    aux_total = None
    for i, sub in enumerate(p["subs"]):
        h = L.apply_norm(sub["ln1"], x, cfg.norm)
        if i == cfg.hybrid_attn_index:
            ao = attn.attention_apply(sub["attn"], h, cfg=cfg, positions=positions, mode=mode,
                                      cache=None if cache is None else cache.attn,
                                      cache_len=cache_len)
            x = x + ao.out
            kv = ao.cache
        else:
            o, st = mb.mamba_apply(sub["mamba"], h, cfg.ssm, mode=mode,
                                   state=None if cache is None else cache.mamba.tree[len(states)])
            x = x + o
            states.append(st)
        h = L.apply_norm(sub["ln2"], x, cfg.norm)
        mo, aux = _moe_or_mlp(sub, h, cfg, mode)
        if aux is not None:
            aux_total = aux if aux_total is None else aux_total + aux
        x = x + mo
    if mode in ("train", "eval"):
        return x, None, aux_total
    new = HybridCache(kv, RecurrentState(states))
    return x, (new if cache is None else cache.write(new)), aux_total


def _block(p, x, cfg: ModelConfig, kind: str, *, window, positions, mode, cache=None,
           cache_len=None, slot=None):
    """One layer of segment kind ``kind`` (a super-block for jamba): (x,
    its new cache or state, its aux term or None)."""
    if kind == "rwkv":
        x, st = _rwkv_block(p, x, cfg, mode=mode, state=cache)
        return x, st, None
    if kind == "jamba":
        return _jamba_super(p, x, cfg, positions=positions, mode=mode, cache=cache,
                            cache_len=cache_len)
    return _tx_block(p, x, cfg, kind, window=window, positions=positions, mode=mode,
                     cache=cache, cache_len=cache_len, slot=slot)


def _remat(cfg: ModelConfig, mode: str, kind: str) -> str:
    """The policy the layer loop applies to a segment of ``kind``:
    ``cfg.remat`` on the train and eval forwards ("none" in the serving
    modes). A "codes" request is recorded at the segment, as the reference's
    scan records it; on a stack that keeps no codes it is applied as
    "full", with the reason."""
    rm = normalize_remat(cfg.remat)
    if mode not in ("train", "eval") or rm == "none":
        return "none"
    if rm == "codes":
        reason = attn.remat_codes_ineligible_reason(cfg)
        applied = "full" if reason is not None else "codes"
        record_remat(f"{cfg.name}/scan[{kind}]", rm, applied, reason)
        return applied
    return rm


def _apply_stack(params: Model, x, cfg: ModelConfig, *, positions, mode,
                 caches=None, cache_len=None, slot=None):
    """The layer loop over each segment's stacked axis (the JAX scan), each
    layer with its window (``_window_array``, the layer offset carried
    across segments). Returns (x, the summed aux loss or None, caches)."""
    tree = params.tree()
    aux_total = None
    new_caches = []
    offset = 0
    for si, (kind, count) in enumerate(segments(cfg)):
        windows = _window_array(cfg, count, offset) or [None] * count
        offset += count
        remat = _remat(cfg, mode, kind)

        seg = tree["segments"][si]
        specs = layer_specs(seg)
        layer_caches = []
        for i in range(count):
            p = L.tree_index(seg, i)
            w = windows[i]

            def layer(x, p, kind=kind, window=w):
                # gathered here, so remat's rerun gathers again
                x, _, aux = _block(gather_tree(p, specs), x, cfg, kind, window=window,
                                   positions=positions, mode=mode)
                return x, aux

            if remat == "full":
                x, aux = checkpoint(layer, x, p, use_reentrant=False)
            elif remat == "codes":
                x, aux = checkpoint_codes(layer, x, p)
            else:
                c = caches[si].layer(i) if caches is not None else None
                x, nc, aux = _block(gather_tree(p, specs), x, cfg, kind, window=w,
                                    positions=positions, mode=mode, cache=c,
                                    cache_len=cache_len, slot=slot)
                layer_caches.append(nc)
            if aux is not None:
                aux_total = aux if aux_total is None else aux_total + aux
        if mode == "prefill":
            new_caches.append(type(layer_caches[0]).stack(layer_caches))
        elif caches is not None:
            new_caches.append(caches[si])        # written in place
    return x, aux_total, (new_caches if mode not in ("train", "eval") else None)


# ==========================================================================
# embedding / head
# ==========================================================================

def _outer(params: Model) -> dict:
    """The leaves outside the layer stack (``{"embed": {"w": ...}, ...}``),
    each gathered whole where this rank holds a shard of it."""
    return {k: gather_tree(v, map_tree(spec_of, v))
            for k, v in params.tree().items() if k != "segments"}


def _embed_tokens(top: dict, tokens, cfg: ModelConfig, dtype):
    h = L.embed(top["embed"], tokens, dtype)
    if cfg.norm == "rmsnorm":
        h = h * cfg.d_model ** 0.5
    return h


def _embed_inputs(top: dict, batch: dict, cfg: ModelConfig, dtype):
    """The batch -> (b, n, d) hidden: audio ``dense(frontend, frames)``,
    returned without learned positions, as the reference does; else the
    (b, n) tokens embedded, a vlm's ``dense(frontend, patches)`` (b, p,
    input_dim) in front where given, and learned positions 0..n-1."""
    if cfg.family == "audio":
        return L.dense(top["frontend"], batch["frames"].to(dtype), dtype)
    h = _embed_tokens(top, batch["tokens"], cfg, dtype)
    if cfg.family == "vlm" and "patches" in batch:
        pre = L.dense(top["frontend"], batch["patches"].to(dtype), dtype)
        h = torch.cat([pre, h], dim=1)
    if cfg.pos_embedding == "learned":
        h = h + top["pos"]["w"][:h.shape[1]].to(dtype)[None]
    return h


def _head_weights(top: dict, cfg: ModelConfig):
    """(vocab, d): the tied embedding, or the LM head transposed."""
    return top["embed"]["w"] if cfg.tie_embeddings else top["lm_head"]["w"].T


def _head(top: dict, h, cfg: ModelConfig):
    """Final norm, then f32 logits against the tied embedding (or the LM
    head)."""
    h = L.apply_norm(top["final_norm"], h, cfg.norm)
    return h.float() @ _head_weights(top, cfg).float().T


# ==========================================================================
# public API
# ==========================================================================

def loss_fn(params: Model, batch, cfg: ModelConfig, *, aux_weight: float = 1.0):
    """Training loss: sequence-chunked CE over ``batch["labels"]`` (-1 = no
    target; a vlm's patch prefix gets -1), as the JAX package's
    ``loss_fn``. Returns (loss, {"ce", "aux",
    "tokens"}). The aux term sums over the layers the MoE load-balance loss
    weighted by ``MOE_AUX_WEIGHT`` and the SFA distillation term weighted
    by ``cfg.sfa_distill`` (paper Eq. 8); it is zero without either."""
    top = _outer(params)
    h = _embed_inputs(top, batch, cfg, _dtype(cfg))
    positions = torch.arange(h.shape[1], device=h.device)[None, :]
    h, aux, _ = _apply_stack(params, h, cfg, positions=positions, mode="train")
    h = L.apply_norm(top["final_norm"], h, cfg.norm)
    labels = batch["labels"]
    if labels.shape[1] < h.shape[1]:     # vlm: no labels on the patch prefix
        labels = F.pad(labels, (h.shape[1] - labels.shape[1], 0), value=-1)
    ce, cnt = L.chunked_cross_entropy(h, _head_weights(top, cfg), labels,
                                      chunk=cfg.loss_chunk)
    if aux is None:
        aux = torch.zeros((), dtype=torch.float32, device=h.device)
    return ce + aux_weight * aux, {"ce": ce, "aux": aux, "tokens": cnt}


def forward_logits(params: Model, batch, cfg: ModelConfig, *, mode="train"):
    """Full-sequence logits (b, n, vocab) f32 of the batch: ``{"tokens"}``,
    with ``"patches"`` for a vlm, or ``{"frames"}`` for audio."""
    top = _outer(params)
    h = _embed_inputs(top, batch, cfg, _dtype(cfg))
    positions = torch.arange(h.shape[1], device=h.device)[None, :]
    h, _, _ = _apply_stack(params, h, cfg, positions=positions, mode=mode)
    return _head(top, h, cfg)


@torch.no_grad()
def prefill(params: Model, batch, cfg: ModelConfig):
    """Prefill: last-position logits (b, vocab) + layer-stacked caches of
    the batch (``"tokens"``, and a vlm's ``"patches"`` prefix)."""
    top = _outer(params)
    h = _embed_inputs(top, batch, cfg, _dtype(cfg))
    positions = torch.arange(h.shape[1], device=h.device)[None, :]
    h, _, caches = _apply_stack(params, h, cfg, positions=positions, mode="prefill")
    return _head(top, h[:, -1], cfg), caches


@torch.no_grad()
def decode_step(params: Model, token, caches, cache_len, cfg: ModelConfig):
    """One decode step. token: (b,) int; cache_len: (b,) int — tokens
    already in the cache. Writes the caches in place and returns
    (logits (b, vocab) f32, caches)."""
    _refuse_encoder_only(cfg)
    dtype = _dtype(cfg)
    dev = params.device
    token = torch.as_tensor(token, device=dev).long()
    cache_len = torch.as_tensor(cache_len, device=dev).long()
    top = _outer(params)
    h = _embed_tokens(top, token[:, None], cfg, dtype)
    if cfg.pos_embedding == "learned":
        # JAX clamps an out-of-range gather; clamp explicitly here
        pos = top["pos"]["w"]
        h = h + pos[cache_len.clamp(0, pos.shape[0] - 1)].to(dtype)[:, None]
    h, _, caches = _apply_stack(params, h, cfg, positions=cache_len[:, None],
                             mode="decode", caches=caches, cache_len=cache_len)
    return _head(top, h[:, 0], cfg), caches


def _chunk_hidden(params: Model, top: dict, tokens, offset: int, cfg: ModelConfig):
    """(1, C) tokens at positions offset.. -> hidden (1, C, d) and positions.
    Learned positions clamp past the table, where the JAX package uses
    ``mode="clip"`` to match decode_step's clamped indexing."""
    _refuse_encoder_only(cfg)
    dtype = _dtype(cfg)
    dev = params.device
    tokens = torch.as_tensor(tokens, device=dev).long()
    positions = int(offset) + torch.arange(tokens.shape[1], device=dev)[None, :]
    h = _embed_tokens(top, tokens, cfg, dtype)
    if cfg.pos_embedding == "learned":
        pos = top["pos"]["w"]
        h = h + pos[positions[0].clamp(0, pos.shape[0] - 1)].to(dtype)[None]
    return h, positions


@torch.no_grad()
def prefill_chunk(params: Model, tokens, caches, offset: int, valid: int, slot: int,
                  cfg: ModelConfig):
    """One chunk of a paged prefill: land ``tokens (1, C)`` of ``slot`` at
    positions ``offset..offset+C-1`` of the paged caches (in place) and
    return the logits (vocab,) at the last valid chunk position (``valid <=
    C``; trailing pad tokens are written but masked or overwritten before
    any read). Each query is scored as a single-token oracle decode at its
    own prefix length, so chunk boundaries never change what it sees."""
    top = _outer(params)
    h, positions = _chunk_hidden(params, top, tokens, offset, cfg)
    h, _, caches = _apply_stack(params, h, cfg, positions=positions, mode="chunk",
                             caches=caches, cache_len=int(offset), slot=int(slot))
    return _head(top, h[0, int(valid) - 1], cfg), caches


@torch.no_grad()
def verify_step(params: Model, tokens, caches, offset: int, slot: int,
                cfg: ModelConfig):
    """Speculative verify: score ``tokens (1, C)`` of ``slot`` (the pending
    token and C-1 drafted ones) at positions ``offset..offset+C-1`` in one
    full-k pass through the decode backend's ``verify``, writing their full-k
    codes over the draft pass's. Returns logits (C, vocab) at every
    position and the caches."""
    top = _outer(params)
    h, positions = _chunk_hidden(params, top, tokens, offset, cfg)
    h, _, caches = _apply_stack(params, h, cfg, positions=positions, mode="verify",
                             caches=caches, cache_len=int(offset), slot=int(slot))
    return _head(top, h[0], cfg), caches


def init_decode_caches(cfg: ModelConfig, batch: int, max_len: int,
                       dtype=torch.bfloat16, device=None) -> list:
    """Layer-stacked decode caches, one per segment. bf16 by default, also
    for a float32 model, as in the JAX package."""
    _refuse_encoder_only(cfg)
    device = default_device(device)
    out = []
    for kind, count in segments(cfg):
        if kind == "rwkv":
            out.append(RecurrentState.stack(
                [rk.rwkv_init_state(batch, cfg.d_model, cfg.rwkv, dtype, device)] * count))
            continue
        one = attn.init_cache(cfg, batch, max_len, dtype, device)
        kv = type(one).stack([one] * count)
        if kind == "jamba":
            mamba = [mb.mamba_init_state(batch, cfg.d_model, cfg.ssm, dtype, device)
                     for _ in range(cfg.hybrid_period - 1)]
            kv = HybridCache(kv, RecurrentState.stack([mamba] * count))
        out.append(kv)
    return out


def init_paged_decode_caches(cfg: ModelConfig, *, slots: int, num_pages: int,
                             page_size: int, max_pages: int, dtype=torch.bfloat16,
                             device=None) -> list:
    """Layer-stacked paged decode caches, one per segment: a page pool per
    layer and ONE ``(slots, max_pages)`` int32 block table shared by every
    layer and segment (the engine updates it in place). The recurrent
    families raise, as in the reference: pages hold attention KV only."""
    if any(kind in ("rwkv", "jamba") for kind, _ in segments(cfg)):
        raise NotImplementedError(
            f"paged decode caches cover attention KV caches only; "
            f"family={cfg.family!r} carries recurrent state")
    _refuse_encoder_only(cfg)
    device = default_device(device)
    bt = torch.zeros((slots, max_pages), dtype=torch.int32, device=device)
    out = []
    for _, count in segments(cfg):
        one = attn.init_paged_cache(cfg, num_pages=num_pages, page_size=page_size,
                                    block_table=bt, dtype=dtype, device=device)
        out.append(type(one).stack([one] * count))
    return out


def insert_slot(caches: list, one_caches: list, *, slot: int, max_len: int):
    """Land batch-1 prefill caches in ``slot`` of the batched caches (any
    KV layout: head-major, feature-major or MLA's headless latents; a
    recurrent state, which has no token axis, by a plain slot update cast to
    the destination's dtype; a ``HybridCache`` both)."""
    for dst, src in zip(caches, one_caches):
        if not isinstance(dst, (KVCache, RecurrentState, HybridCache)):
            raise TypeError(f"expected a KVCache, RecurrentState or HybridCache, got "
                            f"{type(dst).__name__}")
        dst.insert_slot(src, slot=slot, max_len=max_len)
    return caches
