"""Typed KV caches — the serving-side data structures.

Ported from the JAX package's ``repro/core/kv_cache.py`` for the layouts the
token-major serving path uses:

  * ``DenseKV``  — dense K/V, the baseline layout.
  * ``SparseKV`` — SFA layout: top-k K values + *packed* indices (uint8 for
                   d ≤ 256, uint16 for d ≤ 65536 — the paper's Appendix-J
                   ratio ≈ 2d/(3k+4) on the K half) and dense V.

The paged, feature-major and MLA layouts, and the dense protected RoPE dims
of SFA-on-RoPE (paper A.1), come with later slices.

Leaves keep the JAX layout: unstacked (per-layer) leaves are
``(batch, tokens, hkv, F)`` with the token axis at 1, and the engine's
layer-stacked caches add a leading layer axis. Unlike the JAX pytrees these
caches are updated **in place** (``write`` and ``insert_slot`` return
``self``): a decode step touches one token per slot, and copying the whole
cache per step, as a functional update does outside ``jit``, would cost the
cache's size in memory traffic. ``layer(i)`` returns views of one layer, so
a write through it lands in the stacked storage.
"""
from __future__ import annotations

import dataclasses

import torch

TOKEN_AXIS = 1  # unstacked token axis: (batch, tokens, ...)


# --------------------------------------------------------------------------
# index packing (at-rest storage; compute stays integer-wide)
# --------------------------------------------------------------------------

def idx_dtype(d: int) -> torch.dtype:
    """Smallest dtype that can address d feature coordinates."""
    if d <= 256:
        return torch.uint8
    if d <= 65_536:
        return torch.uint16
    return torch.int32


def pack_indices(idx: torch.Tensor, d: int) -> torch.Tensor:
    return idx.to(idx_dtype(d))


def unpack_indices(idx: torch.Tensor) -> torch.Tensor:
    return idx.to(torch.int64)


# --------------------------------------------------------------------------
# base
# --------------------------------------------------------------------------

class KVCache:
    """Base for the typed caches (every field is a tensor)."""

    def _tensors(self):
        for f in dataclasses.fields(self):
            yield f.name, getattr(self, f.name)

    def layer(self, i: int) -> "KVCache":
        """Views of layer ``i`` of a layer-stacked cache."""
        return dataclasses.replace(self, **{n: t[i] for n, t in self._tensors()})

    @classmethod
    def stack(cls, caches: list) -> "KVCache":
        """Stack per-layer caches along a new leading layer axis."""
        first = caches[0]
        return dataclasses.replace(first, **{
            n: torch.stack([getattr(c, n) for c in caches])
            for n, _ in first._tensors()})

    def write(self, pos, **updates) -> "KVCache":
        """Insert one token's entries at position ``pos``, in place.

        ``pos`` is an int or a (b,)-ragged integer tensor; each update
        carries a singleton token axis (one new token) and is cast to the
        stored dtype (indices pack down to uint8/uint16 here). Positions are
        clamped to the last token like ``jax.lax.dynamic_update_slice``, so
        a full, dead slot writes on its last row exactly as the JAX engine's
        does.
        """
        for name, val in updates.items():
            arr = getattr(self, name)
            b, n = arr.shape[0], arr.shape[TOKEN_AXIS]
            p = torch.as_tensor(pos, device=arr.device).long().clamp(0, n - 1).expand(b)
            arr[torch.arange(b, device=arr.device), p] = val[:, 0].to(arr.dtype)
        return self

    def insert_slot(self, src: "KVCache", *, slot: int,
                    max_len: int) -> "KVCache":
        """Land a layer-stacked batch-1 prefill cache in ``slot``, in place.

        ``self`` leaves are ``(L, B, max_len, ...)``; ``src`` leaves are
        ``(L, 1, n, ...)``. The whole token axis of the slot is written
        (zero tail), so reusing a freed slot overwrites the previous
        request's entries.
        """
        for name, dst in self._tensors():
            s = getattr(src, name)
            n = s.shape[TOKEN_AXIS + 1]
            if n > max_len:
                raise ValueError(f"prefill cache holds {n} tokens, more than "
                                 f"the slot's {max_len}")
            dst[:, slot, n:].zero_()
            dst[:, slot, :n] = s[:, 0].to(dst.dtype)
        return self


# --------------------------------------------------------------------------
# concrete layouts
# --------------------------------------------------------------------------

@dataclasses.dataclass
class DenseKV(KVCache):
    """Dense cache: k/v are (b, n, hkv, head_dim)."""
    k: torch.Tensor
    v: torch.Tensor


@dataclasses.dataclass
class SparseKV(KVCache):
    """SFA cache: sparse K codes + dense V.

    k_vals (b, n, hkv, k)   top-k K entries (cache dtype)
    k_idx  (b, n, hkv, k)   packed coordinate ids (uint8/uint16 at rest)
    v      (b, n, hkv, dv)  dense values
    """
    k_vals: torch.Tensor
    k_idx: torch.Tensor
    v: torch.Tensor


def kv_cache_nodes(tree) -> list:
    """All KVCache nodes of a (nested list/tuple/dict) cache tree, in order."""
    if isinstance(tree, KVCache):
        return [tree]
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return [n for t in tree for n in kv_cache_nodes(t)]
    return []


def cache_nbytes(cache) -> int:
    """Total at-rest bytes of the KVCache nodes of a cache tree."""
    return sum(t.numel() * t.element_size()
               for node in kv_cache_nodes(cache) for _, t in node._tensors())
