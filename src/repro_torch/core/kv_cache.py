"""Typed KV caches — the serving-side data structures.

Ported from the JAX package's ``repro/core/kv_cache.py``:

  * ``DenseKV``        — dense K/V, the baseline layout.
  * ``SparseKV``       — SFA layout: top-k K values + *packed* indices
                         (uint8 for d ≤ 256, uint16 for d ≤ 65536 — the
                         paper's Appendix-J ratio ≈ 2d/(3k+4) on the K
                         half), dense V, and with ``sfa_rope_protect`` p > 0
                         the p leading (RoPE) dims of K stored dense in
                         ``k_protect`` (paper A.1; the codes then cover the
                         d - p trailing dims, indices relative to them).
  * ``FeatureMajorKV`` — the ``cuda_fm`` serving layout: a persistent dense
                         ``(b, hkv, d, n)`` feature-major K image and
                         heads-major V ``(b, hkv, n, dv)``, extended one
                         column per decoded token, so the decode kernel
                         reads the k feature rows its sparse query
                         addresses straight from the cache.
  * ``MLAKV``          — the MLA latent cache (deepseek-v2): the shared
                         latent ``ckv`` and the RoPE key part ``kpe``,
                         headless ``(b, n, F)``.
  * ``MLASparseKV``    — MLA + SFA: ``MLAKV`` plus each token's top-k code
                         of the latent, indices packed over the
                         ``kv_lora_rank`` dims (uint16 at r = 512).

``RecurrentState`` is not a KV cache: it holds the recurrent state of the
SSM layers (mamba's conv window and ssm state, rwkv's token-shift rows and
WKV state), stacked over layers, with no token axis. ``HybridCache`` holds
a jamba segment's KV cache beside its Mamba states. The byte counts of KV
(``kv_cache_nodes``, ``cache_nbytes``) skip recurrent state, as the
reference counts KVCache leaves only; ``state_nbytes`` counts it.

and their paged counterparts (``PagedDenseKV``, ``PagedSparseKV``,
``PagedFeatureMajorKV``, ``PagedMLAKV``, ``PagedMLASparseKV``): the same
field layouts pooled into pages behind a block table, serving
``PagedDecodeEngine``. The MLA caches have no chunk write: chunked prefill
and the speculative engine refuse MLA, as in the JAX package.

Unstacked (per-layer) leaves are ``(batch, tokens, ...)`` with the token
axis at 1 unless the class lists the field in ``_TOKEN_AXES``
(``FeatureMajorKV`` keeps tokens last in ``k_feat`` and at 2 in ``v``); the
engine's layer-stacked caches add a leading layer axis. An optional field
(``k_protect`` without protected dims) is None and is skipped everywhere. Unlike the JAX
pytrees these caches are updated **in place** (``write``, ``write_chunk``,
``insert_slot`` and ``insert_pages`` return ``self``): a decode step touches
one token per slot, and copying the whole cache per step, as a functional
update does outside ``jit``, would cost the cache's size in memory traffic.
``layer(i)`` returns views of one layer, so a write through it lands in the
stacked storage.

The block table of a paged cache is one ``(slots, max_pages)`` int32 tensor
on the cache's device, shared by every layer and every segment: it is not
a per-layer leaf (the JAX package copies it into each layer of its pytree,
``repro/serve/engine.py:346-357``). ``layer(i)`` and ``stack`` pass it
through as it is, and the engine updates it in place when a slot's pages
change.
"""
from __future__ import annotations

import dataclasses
from typing import ClassVar, Optional

import torch

from repro_torch.core.sparse import SparseCode, densify

TOKEN_AXIS = 1  # default unstacked token axis: (batch, tokens, ...)
PAGE_TRASH = 0  # pool page 0 is never allocated to a request: a freed
                # slot's block-table row is zeroed, so writes for dead
                # slots land here and reads of it are always masked out


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


def idx_bytes(d: int) -> int:
    return torch.empty((), dtype=idx_dtype(d)).element_size()


def unpack_indices(idx: torch.Tensor) -> torch.Tensor:
    return idx.to(torch.int64)


def _bits(t: torch.Tensor) -> torch.Tensor:
    """``t`` for indexing: a uint16 tensor (MLA's latent indices at r =
    512) as its int16 view, the same bits; CUDA has no indexed read or
    write for uint16."""
    return t.view(torch.int16) if t.dtype == torch.uint16 else t


def _stored(val: torch.Tensor, leaf: torch.Tensor) -> torch.Tensor:
    """``val`` cast to ``leaf``'s dtype, viewed as ``_bits`` views the leaf."""
    return _bits(val.to(leaf.dtype))


# --------------------------------------------------------------------------
# base
# --------------------------------------------------------------------------

class KVCache:
    """Base for the typed caches (every field is a tensor)."""

    # per-field UNstacked token axis; fields not listed sit at TOKEN_AXIS
    _TOKEN_AXES: ClassVar[dict] = {}

    @classmethod
    def token_axis(cls, field: str, *, stacked: bool = False) -> int:
        ax = cls._TOKEN_AXES.get(field, TOKEN_AXIS)
        return ax + 1 if stacked else ax

    def _tensors(self):
        """(name, tensor) of every field that holds one."""
        for f in dataclasses.fields(self):
            t = getattr(self, f.name)
            if t is not None:
                yield f.name, t

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
        carries a singleton token axis (one new token, at the field's token
        axis) and is cast to the stored dtype (indices pack down to
        uint8/uint16 here). Positions are clamped to the last token like
        ``jax.lax.dynamic_update_slice``, so a full, dead slot writes on its
        last row exactly as the JAX engine's does.
        """
        for name, val in updates.items():
            if val is None:
                continue
            arr = getattr(self, name)
            ax = self.token_axis(name)
            b, n = arr.shape[0], arr.shape[ax]
            p = torch.as_tensor(pos, device=arr.device).long().clamp(0, n - 1).expand(b)
            view = _bits(arr).movedim(ax, 1)
            view[torch.arange(b, device=arr.device), p] = _stored(val.movedim(ax, 1)[:, 0], arr)
        return self

    def insert_slot(self, src: "KVCache", *, slot: int,
                    max_len: int) -> "KVCache":
        """Land a layer-stacked batch-1 prefill cache in ``slot``, in place.

        ``self`` leaves are ``(L, B, ...)`` with ``max_len`` tokens on each
        field's token axis; ``src`` leaves are ``(L, 1, ...)`` with the
        prompt's n tokens there. The whole token axis of the slot is written
        (zero tail), so reusing a freed slot overwrites the previous
        request's entries.
        """
        for name, dst in self._tensors():
            s = getattr(src, name)
            ax = self.token_axis(name)       # of dst[:, slot] and s[:, 0]
            n = s.shape[ax + 1]
            if n > max_len:
                raise ValueError(f"prefill cache holds {n} tokens, more than "
                                 f"the slot's {max_len}")
            d = dst[:, slot]
            d.narrow(ax, n, d.shape[ax] - n).zero_()
            d.narrow(ax, 0, n).copy_(s[:, 0])
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

    k_vals    (b, n, hkv, k)   top-k K entries (cache dtype)
    k_idx     (b, n, hkv, k)   packed coordinate ids over the non-protected
                               dims (uint8/uint16 at rest)
    v         (b, n, hkv, dv)  dense values
    k_protect (b, n, hkv, p)   the protected leading RoPE dims, dense (or
                               None)
    """
    k_vals: torch.Tensor
    k_idx: torch.Tensor
    v: torch.Tensor
    k_protect: Optional[torch.Tensor] = None


@dataclasses.dataclass
class FeatureMajorKV(KVCache):
    """Persistent feature-major SFA cache (the ``cuda_fm`` serving layout).

    k_feat (b, hkv, d, n)   dense feature-major K image, token axis LAST:
                            the layout ``flash_sfa_decode_fm`` reads
    v      (b, hkv, n, dv)  dense values, heads-major (token axis 2)

    ``write`` scatters one dense (hkv, d) column per decoded token: the
    densified top-k code, so every column stays <= k-sparse.
    """
    k_feat: torch.Tensor
    v: torch.Tensor

    _TOKEN_AXES: ClassVar[dict] = {"k_feat": 3, "v": 2}

    def write(self, pos, *, k_vals, k_idx, v=None, **_ignored) -> "FeatureMajorKV":
        """Densify the token's (k_vals, k_idx) code (b, 1, hkv, k) into a
        feature column and land it at ``pos``, with the V row moved from
        the model's (b, 1, hkv, dv) into the heads-major layout."""
        col = densify(SparseCode(values=k_vals[:, 0], indices=unpack_indices(k_idx[:, 0]),
                                 dim=self.k_feat.shape[-2]))       # (b, hkv, d)
        updates = {"k_feat": col[..., None]}
        if v is not None:
            updates["v"] = v.movedim(1, 2)
        return super().write(pos, **updates)


@dataclasses.dataclass
class MLAKV(KVCache):
    """MLA latent cache: ckv (b, n, r), kpe (b, n, rope_head_dim)."""
    ckv: torch.Tensor
    kpe: torch.Tensor


@dataclasses.dataclass
class MLASparseKV(KVCache):
    """MLA + SFA with the latent's top-k code packed on the latent axis.

    ckv         (b, n, r)  dense latent (the value aggregation reads it)
    kpe         (b, n, dr) dense RoPE part
    ckv_sp_vals (b, n, k)  top-k latent entries (cache dtype)
    ckv_sp_idx  (b, n, k)  packed latent coordinate ids (uint16 at r = 512)

    Codes are head-independent (one a token), so scoring gathers the query
    at each token's k coordinates; the at-rest bytes are MLAKV's plus
    k·(2 + idx_bytes(r)) a token, the byte model's.
    """
    ckv: torch.Tensor
    kpe: torch.Tensor
    ckv_sp_vals: torch.Tensor
    ckv_sp_idx: torch.Tensor


# --------------------------------------------------------------------------
# paged layouts (block tables over the same field layouts)
# --------------------------------------------------------------------------

class PagedKV(KVCache):
    """Base for the paged layouts: a shared page pool + the block table.

    Pool leaves keep each inner layout's kernel-major field layout but
    trade the per-slot token axis for ``(pages, page_size)``: a token-major
    field ``(b, n, hkv, F)`` pools as ``(hkv, pages, page_size, F)``, the
    feature-major image ``(b, hkv, d, n)`` as ``(hkv, pages, d,
    page_size)``, and a headless MLA field ``(b, n, F)`` as ``(pages,
    page_size, F)``. Logical page j of a slot holds its tokens ``[j·page,
    (j+1)·page)``, so the paged kernels visit tokens in the contiguous
    kernels' order and give the same bits on the same content.

    ``block_table`` is the ``(slots, max_pages)`` int32 tensor of pool page
    ids shared by all layers (not one of ``_tensors``). ``write`` lands one
    decoded token per block-table row, ``write_chunk`` a chunk of one
    slot's tokens, ``insert_pages`` a whole layer-stacked batch-1 prefill
    cache into a slot's pages, and ``gather``/``gather_slot`` build the
    contiguous inner-layout view the ``torch`` oracle reads.
    """

    def _tensors(self):
        for name, t in super()._tensors():
            if name != "block_table":
                yield name, t

    # ---- coordinates ---------------------------------------------------
    def _decode_coords(self, pos):
        """Per-row (pool page id, in-page offset) for a (slots,) position
        vector. Positions past the table go to the trash page: the engine
        parks dead slots at a past-the-table sentinel, so their writes never
        land in pages another request holds."""
        page = self.page_size
        bt = self.block_table
        mp = bt.shape[-1]
        pos = torch.as_tensor(pos, device=bt.device).long().expand(bt.shape[0])
        pidx = (pos // page).clamp(0, mp - 1)
        pids = bt.gather(1, pidx[:, None])[:, 0].long()
        pids = torch.where(pos >= page * mp, PAGE_TRASH, pids)
        return pids, pos % page

    def _chunk_coords(self, slot, start, count: int):
        """(pool page ids, offsets) of ``count`` consecutive tokens of one
        slot from ``start``. Positions past the table go to the trash page
        like ``_decode_coords`` (the verify pass writes draft lookahead past
        a slot's last page near ``max_len``; clamping would overwrite the
        slot's own final page)."""
        page = self.page_size
        bt = self.block_table
        mp = bt.shape[-1]
        pos = int(start) + torch.arange(count, device=bt.device)
        pids = bt[int(slot)].long()[(pos // page).clamp(0, mp - 1)]
        pids = torch.where(pos >= page * mp, PAGE_TRASH, pids)
        return pids, pos % page

    def _slot_table(self, slot):
        """(1, max_pages) block-table view of one slot."""
        return self.block_table[int(slot)][None]

    # ---- pooled token-major (hkv, P, page, F) leaves --------------------
    @staticmethod
    def _scatter_tok(leaf, pids, offs, val):
        """Write T tokens ``val (T, hkv, F)`` at (pids, offs) of a pooled
        leaf (adjacent advanced indices: the indexed block is (hkv, T, F))."""
        _bits(leaf)[:, pids, offs] = _stored(val.transpose(0, 1), leaf)

    @staticmethod
    def _gather_tok(leaf, bt):
        """(hkv, P, page, F) pooled leaf -> (s, n, hkv, F) contiguous
        token-major view for the block tables ``bt (s, mp)``."""
        g = _bits(leaf)[:, bt.long()].view(leaf.dtype)     # (hkv, s, mp, page, F)
        hkv, s, mp, page = g.shape[:4]
        return g.reshape((hkv, s, mp * page) + g.shape[4:]).movedim(0, 2)

    @staticmethod
    def _insert_tok(dst, src, pids, page: int):
        """Land a stacked token-major prefill leaf ``src (L, 1, n, hkv, F)``
        into whole pages ``pids (npg,)`` of the stacked pool ``dst (L, hkv,
        P, page, F)``, the last partial page zero-padded."""
        L, _, n, hkv = src.shape[:4]
        npg = pids.shape[0]
        s = src[:, 0]
        if npg * page > n:
            s = torch.cat([s, s.new_zeros((L, npg * page - n) + s.shape[2:])], 1)
        s = s.reshape((L, npg, page, hkv) + s.shape[3:]).movedim(3, 1)
        _bits(dst)[:, :, pids] = _stored(s, dst)

    # ---- pooled headless (P, page, F) MLA leaves ------------------------
    @staticmethod
    def _scatter_flat(leaf, pids, offs, val):
        """Write T tokens ``val (T, F)`` at (pids, offs) of a headless pool."""
        _bits(leaf)[pids, offs] = _stored(val, leaf)

    @staticmethod
    def _gather_flat(leaf, bt):
        """(P, page, F) headless pool -> (s, n, F) contiguous view."""
        g = _bits(leaf)[bt.long()].view(leaf.dtype)  # (s, mp, page, F)
        s, mp, page = g.shape[:3]
        return g.reshape((s, mp * page) + g.shape[3:])

    @staticmethod
    def _insert_flat(dst, src, pids, page: int):
        """Land a stacked headless prefill leaf ``src (L, 1, n, F)`` into
        whole pages ``pids`` of the stacked pool ``dst (L, P, page, F)``,
        the last partial page zero-padded."""
        L, _, n = src.shape[:3]
        npg = pids.shape[0]
        s = src[:, 0]
        if npg * page > n:
            s = torch.cat([s, s.new_zeros((L, npg * page - n) + s.shape[2:])], 1)
        _bits(dst)[:, pids] = _stored(s.reshape((L, npg, page) + s.shape[2:]), dst)

    # ---- interface -----------------------------------------------------
    def write_chunk(self, slot, start, **updates) -> "PagedKV":
        raise NotImplementedError(type(self).__name__)

    def gather(self) -> KVCache:
        """Contiguous inner-layout view of every slot (the oracle's input)."""
        return self._view(self.block_table)

    def gather_slot(self, slot) -> KVCache:
        """Batch-1 contiguous view of one slot."""
        return self._view(self._slot_table(slot))

    def _view(self, bt) -> KVCache:
        raise NotImplementedError(type(self).__name__)

    def insert_pages(self, src: KVCache, page_ids) -> "PagedKV":
        """Land a layer-stacked batch-1 prefill cache (inner layout) into
        the pages ``page_ids`` of the stacked pool leaves, in place."""
        raise NotImplementedError(type(self).__name__)

    def insert_slot(self, src, *, slot, max_len):
        raise NotImplementedError(
            "paged caches land prompts with insert_pages, not insert_slot")


@dataclasses.dataclass
class PagedDenseKV(PagedKV):
    """Paged dense cache: k/v pools are (hkv, pages, page_size, head_dim)."""
    k: torch.Tensor
    v: torch.Tensor
    block_table: torch.Tensor

    @property
    def page_size(self) -> int:
        return self.k.shape[-2]

    def write(self, pos, *, k, v, **_ignored) -> "PagedDenseKV":
        pids, offs = self._decode_coords(pos)
        self._scatter_tok(self.k, pids, offs, k[:, 0])
        self._scatter_tok(self.v, pids, offs, v[:, 0])
        return self

    def write_chunk(self, slot, start, *, k, v, **_ignored) -> "PagedDenseKV":
        pids, offs = self._chunk_coords(slot, start, k.shape[1])
        self._scatter_tok(self.k, pids, offs, k[0])
        self._scatter_tok(self.v, pids, offs, v[0])
        return self

    def _view(self, bt) -> DenseKV:
        return DenseKV(k=self._gather_tok(self.k, bt), v=self._gather_tok(self.v, bt))

    def insert_pages(self, src: DenseKV, page_ids) -> "PagedDenseKV":
        page = self.page_size
        self._insert_tok(self.k, src.k, page_ids, page)
        self._insert_tok(self.v, src.v, page_ids, page)
        return self


@dataclasses.dataclass
class PagedSparseKV(PagedKV):
    """Paged SFA cache: token-major pools, indices packed at rest.

    k_vals/k_idx (hkv, pages, page_size, k); v (hkv, pages, page_size, dv);
    k_protect (hkv, pages, page_size, p) or None.
    """
    k_vals: torch.Tensor
    k_idx: torch.Tensor
    v: torch.Tensor
    block_table: torch.Tensor
    k_protect: Optional[torch.Tensor] = None

    @property
    def page_size(self) -> int:
        return self.v.shape[-2]

    def _put(self, pids, offs, k_vals, k_idx, v, k_protect):
        self._scatter_tok(self.k_vals, pids, offs, k_vals)
        self._scatter_tok(self.k_idx, pids, offs, k_idx)
        self._scatter_tok(self.v, pids, offs, v)
        if self.k_protect is not None and k_protect is not None:
            self._scatter_tok(self.k_protect, pids, offs, k_protect)
        return self

    def write(self, pos, *, k_vals, k_idx, v, k_protect=None,
              **_ignored) -> "PagedSparseKV":
        pids, offs = self._decode_coords(pos)
        return self._put(pids, offs, k_vals[:, 0], k_idx[:, 0], v[:, 0],
                         None if k_protect is None else k_protect[:, 0])

    def write_chunk(self, slot, start, *, k_vals, k_idx, v, k_protect=None,
                    **_ignored) -> "PagedSparseKV":
        pids, offs = self._chunk_coords(slot, start, k_vals.shape[1])
        return self._put(pids, offs, k_vals[0], k_idx[0], v[0],
                         None if k_protect is None else k_protect[0])

    def _view(self, bt) -> SparseKV:
        return SparseKV(**{name: self._gather_tok(t, bt) for name, t in self._tensors()})

    def insert_pages(self, src: SparseKV, page_ids) -> "PagedSparseKV":
        page = self.page_size
        for name, t in self._tensors():
            self._insert_tok(t, getattr(src, name), page_ids, page)
        return self


@dataclasses.dataclass
class PagedFeatureMajorKV(PagedKV):
    """Paged persistent feature-major image (the ``cuda_fm`` layout).

    k_feat (hkv, pages, d, page_size)  — each pool page is a (d, page)
                                         tile of the image
    v      (hkv, pages, page_size, dv) — token-major values
    """
    k_feat: torch.Tensor
    v: torch.Tensor
    block_table: torch.Tensor

    @property
    def page_size(self) -> int:
        return self.k_feat.shape[-1]

    def _put(self, pids, offs, k_vals, k_idx, v):
        """Tokens' codes (T, hkv, k) densified into image columns; the
        indexed block of k_feat[:, pids, :, offs] is (T, hkv, d), its
        advanced indices being split by the feature axis."""
        col = densify(SparseCode(values=k_vals, indices=unpack_indices(k_idx),
                                 dim=self.k_feat.shape[-2]))         # (T, hkv, d)
        self.k_feat[:, pids, :, offs] = col.to(self.k_feat.dtype)
        if v is not None:
            self._scatter_tok(self.v, pids, offs, v)
        return self

    def write(self, pos, *, k_vals, k_idx, v=None,
              **_ignored) -> "PagedFeatureMajorKV":
        pids, offs = self._decode_coords(pos)
        return self._put(pids, offs, k_vals[:, 0], k_idx[:, 0],
                         None if v is None else v[:, 0])

    def write_chunk(self, slot, start, *, k_vals, k_idx, v,
                    **_ignored) -> "PagedFeatureMajorKV":
        pids, offs = self._chunk_coords(slot, start, k_vals.shape[1])
        return self._put(pids, offs, k_vals[0], k_idx[0], v[0])

    def _view(self, bt) -> FeatureMajorKV:
        g = self.k_feat[:, bt.long()]                # (hkv, s, mp, d, page)
        hkv, s, mp, d, page = g.shape
        kf = g.permute(1, 0, 3, 2, 4).reshape(s, hkv, d, mp * page)
        gv = self.v[:, bt.long()]                    # (hkv, s, mp, page, dv)
        v = gv.transpose(0, 1).reshape(s, hkv, mp * page, gv.shape[-1])
        return FeatureMajorKV(k_feat=kf, v=v)

    def insert_pages(self, src: FeatureMajorKV,
                     page_ids) -> "PagedFeatureMajorKV":
        page = self.page_size
        npg = page_ids.shape[0]
        kf = src.k_feat[:, 0]                        # (L, hkv, d, n)
        vv = src.v[:, 0]                             # (L, hkv, n, dv)
        L, hkv, d, n = kf.shape
        pad = npg * page - n
        if pad:
            kf = torch.cat([kf, kf.new_zeros((L, hkv, d, pad))], 3)
            vv = torch.cat([vv, vv.new_zeros((L, hkv, pad, vv.shape[-1]))], 2)
        kf = kf.reshape(L, hkv, d, npg, page).movedim(3, 2)   # (L, hkv, npg, d, page)
        self.k_feat[:, :, page_ids] = kf.to(self.k_feat.dtype)
        self.v[:, :, page_ids] = vv.reshape(L, hkv, npg, page, -1).to(self.v.dtype)
        return self


@dataclasses.dataclass
class PagedMLAKV(PagedKV):
    """Paged MLA latent cache: headless (pages, page_size, F) pools."""
    ckv: torch.Tensor
    kpe: torch.Tensor
    block_table: torch.Tensor

    @property
    def page_size(self) -> int:
        return self.ckv.shape[-2]

    def write(self, pos, *, ckv, kpe, **_ignored) -> "PagedMLAKV":
        pids, offs = self._decode_coords(pos)
        self._scatter_flat(self.ckv, pids, offs, ckv[:, 0])
        self._scatter_flat(self.kpe, pids, offs, kpe[:, 0])
        return self

    def _view(self, bt) -> MLAKV:
        return MLAKV(ckv=self._gather_flat(self.ckv, bt), kpe=self._gather_flat(self.kpe, bt))

    def insert_pages(self, src: MLAKV, page_ids) -> "PagedMLAKV":
        for name, t in self._tensors():
            self._insert_flat(t, getattr(src, name), page_ids, self.page_size)
        return self


@dataclasses.dataclass
class PagedMLASparseKV(PagedKV):
    """Paged MLA + SFA: the packed latent codes pooled beside the dense
    latent (the same headless page layout, indices packed at rest)."""
    ckv: torch.Tensor
    kpe: torch.Tensor
    ckv_sp_vals: torch.Tensor
    ckv_sp_idx: torch.Tensor
    block_table: torch.Tensor

    @property
    def page_size(self) -> int:
        return self.ckv.shape[-2]

    def write(self, pos, *, ckv, kpe, ckv_sp_vals=None, ckv_sp_idx=None,
              **_ignored) -> "PagedMLASparseKV":
        pids, offs = self._decode_coords(pos)
        for name, val in (("ckv", ckv), ("kpe", kpe), ("ckv_sp_vals", ckv_sp_vals),
                          ("ckv_sp_idx", ckv_sp_idx)):
            if val is not None:
                self._scatter_flat(getattr(self, name), pids, offs, val[:, 0])
        return self

    def _view(self, bt) -> MLASparseKV:
        return MLASparseKV(**{name: self._gather_flat(t, bt) for name, t in self._tensors()})

    def insert_pages(self, src: MLASparseKV, page_ids) -> "PagedMLASparseKV":
        for name, t in self._tensors():
            self._insert_flat(t, getattr(src, name), page_ids, self.page_size)
        return self


# --------------------------------------------------------------------------
# recurrent (SSM) state
# --------------------------------------------------------------------------

def _tree_map(fn, *trees):
    first = trees[0]
    if isinstance(first, dict):
        return {k: _tree_map(fn, *(t[k] for t in trees)) for k in first}
    if isinstance(first, (list, tuple)):
        return [_tree_map(fn, *(t[i] for t in trees)) for i in range(len(first))]
    return fn(*trees)


@dataclasses.dataclass
class RecurrentState:
    """The recurrent state of a stack of SSM layers: ``tree`` is the nested
    dict / list of one layer's state (``mamba_init_state``,
    ``rwkv_init_state``, or a jamba super-block's list of mamba states),
    each leaf with a leading layer axis and the slot axis next. Updated in
    place like the KV caches: ``layer(i)`` gives views of layer i and
    ``write`` copies a new state into them, cast to the stored dtype (a
    leaf keeps its dtype, where a JAX leaf of a bf16 cache promotes to f32
    at its first f32 decode step)."""
    tree: object

    def layer(self, i: int) -> "RecurrentState":
        """Views of layer ``i`` of a layer-stacked state."""
        return RecurrentState(_tree_map(lambda t: t[i], self.tree))

    @classmethod
    def stack(cls, states: list) -> "RecurrentState":
        """Stack per-layer states (``RecurrentState`` or plain trees) along a
        new leading layer axis."""
        trees = [s.tree if isinstance(s, RecurrentState) else s for s in states]
        return cls(_tree_map(lambda *ts: torch.stack(ts), *trees))

    def write(self, new) -> "RecurrentState":
        """Copy ``new`` (a tree of this one's shapes) into the state, in
        place, cast to each leaf's dtype."""
        _tree_map(lambda dst, src: dst.copy_(src), self.tree,
                  new.tree if isinstance(new, RecurrentState) else new)
        return self

    def insert_slot(self, src: "RecurrentState", *, slot: int,
                    max_len: Optional[int] = None) -> "RecurrentState":
        """Land a layer-stacked batch-1 prefill state in ``slot``, in place,
        cast to the destination's dtype: the reference's plain slot update
        (``repro/serve/engine.py:_insert_cache``). There is no token axis,
        so ``max_len`` is not read."""
        _tree_map(lambda dst, s: dst[:, slot].copy_(s[:, 0]), self.tree, src.tree)
        return self

    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in _nodes(self.tree, torch.Tensor))


@dataclasses.dataclass
class HybridCache:
    """A stack of jamba super-blocks' decode cache: the attention sublayer's
    KV cache beside the Mamba sublayers' ``RecurrentState`` (its tree a
    list, one state a Mamba sublayer). ``layer``, ``stack``, ``write`` and
    ``insert_slot`` act on both halves as the KV caches' and the states' do."""
    attn: KVCache
    mamba: RecurrentState

    def layer(self, i: int) -> "HybridCache":
        return HybridCache(self.attn.layer(i), self.mamba.layer(i))

    @classmethod
    def stack(cls, caches: list) -> "HybridCache":
        kv = [c.attn for c in caches]
        return cls(type(kv[0]).stack(kv), RecurrentState.stack([c.mamba for c in caches]))

    def write(self, new: "HybridCache") -> "HybridCache":
        """Copy ``new``'s Mamba states in place (attention writes the KV in
        place itself)."""
        self.mamba.write(new.mamba)
        return self

    def insert_slot(self, src: "HybridCache", *, slot: int, max_len: int) -> "HybridCache":
        self.attn.insert_slot(src.attn, slot=slot, max_len=max_len)
        self.mamba.insert_slot(src.mamba, slot=slot)
        return self


def _nodes(tree, cls) -> list:
    """All nodes of type ``cls`` of a (nested list/tuple/dict, HybridCache)
    tree, in order."""
    if isinstance(tree, cls):
        return [tree]
    if isinstance(tree, HybridCache):
        tree = [tree.attn, tree.mamba]
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return [n for t in tree for n in _nodes(t, cls)]
    return []


def state_nbytes(cache) -> int:
    """Total bytes of the recurrent states of a cache tree (KV excluded)."""
    return sum(n.nbytes() for n in _nodes(cache, RecurrentState))


def kv_cache_nodes(tree) -> list:
    """All KVCache nodes of a (nested list/tuple/dict) cache tree, in order
    (recurrent states are not KV: skipped)."""
    return _nodes(tree, KVCache)


def cache_nbytes(cache) -> int:
    """Total at-rest bytes of the KVCache nodes of a cache tree; the block
    table that paged caches share counts once."""
    nodes = kv_cache_nodes(cache)
    tables = {id(n.block_table): n.block_table for n in nodes if isinstance(n, PagedKV)}
    return (sum(t.numel() * t.element_size() for node in nodes for _, t in node._tensors())
            + sum(t.numel() * t.element_size() for t in tables.values()))
