"""Gradient compression: top-k with error feedback, as in the JAX package's
``repro/distributed/compression.py``.

Each gradient leaf of at least ``min_size`` elements keeps its largest
``fraction`` of entries by magnitude (``core.sparse.topk_mask``, the
reference's bisection, so the same entries) after adding the residual the
last step left; what it drops is the next residual (Stich et al.: the
compression is unbiased over time). Smaller leaves pass through. The train
step compresses the data-summed gradient, as the reference compresses the
global one, so every rank keeps the same residual. A leaf held as this
rank's shard (``specs``) is gathered with its residual, selected whole, as
the reference selects on the logical leaf under pjit, and cut back to the
shard.

    comp, new_err = compress_tree(grads, err, fraction=0.05)

Trees are the port's parameter dicts (``{name: tensor}``; None leaves pass
through) or any nesting of dicts, lists and tuples of tensors.
"""
from __future__ import annotations

import torch

from repro_torch.core.sparse import topk_mask
from repro_torch.distributed.shard import gather_full, shard_leaf


def compress_leaf(g, err, fraction: float):
    """(g + err) with all but its top-|fraction·size| magnitudes zeroed, in
    g's dtype, and the f32 residual of what was zeroed."""
    acc = g.float() + (err if err is not None else 0.0)
    flat = acc.reshape(-1)
    k = max(1, int(flat.shape[0] * fraction))
    mask = topk_mask(flat[None, :], k)[0]
    zero = torch.zeros_like(flat)
    comp = torch.where(mask, flat, zero).reshape(g.shape)
    # the reference's flat * ~mask, which XLA folds into this select: +0
    # where kept (a product would give -0 for a negative entry)
    new_err = torch.where(mask, zero, flat).reshape(g.shape)
    return comp.to(g.dtype), new_err


def _map(fn, *trees):
    first = trees[0]
    if isinstance(first, dict):
        return {k: _map(fn, *(t[k] for t in trees)) for k in first}
    if isinstance(first, (list, tuple)):
        items = [_map(fn, *sub) for sub in zip(*trees)]
        return type(first)(items) if isinstance(first, list) else tuple(items)
    return fn(*trees)


def init_error_state(params):
    """An f32 zero residual per leaf (``params`` a tree of tensors, or a
    ``Model``, whose named parameters it takes)."""
    if hasattr(params, "named_parameters"):
        params = dict(params.named_parameters())
    return _map(lambda p: torch.zeros_like(p, dtype=torch.float32), params)


class _Pair(tuple):
    """One leaf's (comp, err): a tuple the split can tell from the grad
    tree's own tuples (the reference splits on the tree structure)."""


def _split(pairs, i):
    """Element ``i`` of every leaf's pair, in ``pairs``' containers."""
    if isinstance(pairs, _Pair):
        return pairs[i]
    if isinstance(pairs, dict):
        return {k: _split(v, i) for k, v in pairs.items()}
    if isinstance(pairs, list):
        return [_split(v, i) for v in pairs]
    return tuple(_split(v, i) for v in pairs)


def compress_tree(grads, err_state, fraction: float = 0.05, min_size: int = 4096,
                  specs=None):
    """-> (compressed grads, new residuals), both shaped as ``grads``;
    leaves below ``min_size`` elements (or None) pass through with their
    residual. ``specs`` (a tree of specs or None, shaped as ``grads``):
    the leaves are shards on the active mesh; the size and the selection
    are the whole leaf's."""
    def one(g, e, spec=None):
        if g is None:
            return _Pair((g, e))
        full = gather_full(g, spec)
        if full.numel() < min_size:
            return _Pair((g, e))
        comp, err = compress_leaf(full, None if e is None else gather_full(e, spec), fraction)
        return _Pair((shard_leaf(comp, spec), shard_leaf(err, spec)))
    pairs = _map(one, grads, err_state) if specs is None else _map(one, grads, err_state, specs)
    return _split(pairs, 0), _split(pairs, 1)
