"""Checkpoints with an asynchronous host writer, in the JAX package's format
(``repro/train/checkpoint.py``), so a checkpoint crosses between the two.

Layout per step::

    <dir>/step_000123/
        manifest.json    — step, leaf count, CRCs, dtypes, shapes, the tree
        arrays.npz       — the leaves, unsharded (key ``leaf_{i}``)
        DONE             — commit marker (written last; readers require it)

A step directory is written as ``<name>.tmp`` and renamed into place.

A tree is nested dicts, lists, tuples and NamedTuples whose leaves are
tensors, numpy arrays or Python ints. The format is positional, so the
leaves are numbered in ``jax.tree_util``'s order: a dict's entries by
sorted key, a list's or a tuple's by index, a NamedTuple's by field. The
port's Trainer state (``{"params", "opt": OptState(step, m, v)}``) then
numbers its leaves as the JAX Trainer's does. ``treedef`` in the manifest
is each package's own description; neither reads the other's.

numpy has no bf16 or fp8: those leaves are stored through a same-width
unsigned view (uint16, uint8) with the true dtype named in the manifest, as
the reference stores its ml_dtypes arrays, and read back through the same
view. ``restore`` checks the leaf count, each leaf's CRC-32 and shape, and
places each leaf on the device and dtype of the matching leaf of ``like``:
a checkpoint written from the card restores onto CPU tensors and the other
way round (the one-device form of the reference's mesh-elastic restore).

``AsyncCheckpointer.save`` takes its own host copy of every leaf before it
returns — a synchronous device-to-host copy on the card, a clone on the
CPU — since the optimizer updates parameters and moments in place and the
next step would change a state the writer is still reading. The writer
thread touches no tensor on the card.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import zlib
from typing import Any, Optional

import numpy as np
import torch

# dtype name in the manifest -> (torch dtype, the unsigned numpy type it is
# stored as, the torch and numpy views of the same width that carry it)
_EXOTIC = {"bfloat16": (torch.bfloat16, np.uint16, torch.int16, np.int16),
           "float8_e4m3fn": (torch.float8_e4m3fn, np.uint8, torch.uint8, np.uint8),
           "float8_e5m2": (torch.float8_e5m2, np.uint8, torch.uint8, np.uint8)}
_EXOTIC_NAME = {spec[0]: name for name, spec in _EXOTIC.items()}


def tree_leaves(tree) -> list:
    """The leaves of ``tree`` in jax.tree_util's order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for sub in tree for x in tree_leaves(sub)]
    return [tree]


def _unflatten(like, leaves):
    """``like``'s structure with its leaves taken in order from the iterator
    ``leaves`` (dicts keep ``like``'s key order)."""
    if isinstance(like, dict):
        filled = {k: _unflatten(like[k], leaves) for k in sorted(like)}
        return {k: filled[k] for k in like}
    if isinstance(like, list):
        return [_unflatten(sub, leaves) for sub in like]
    if isinstance(like, tuple):
        items = [_unflatten(sub, leaves) for sub in like]
        return type(like)(*items) if hasattr(like, "_fields") else tuple(items)
    return next(leaves)


def _treedef_str(tree) -> str:
    if isinstance(tree, dict):
        return "{" + ", ".join(f"{k!r}: {_treedef_str(tree[k])}" for k in sorted(tree)) + "}"
    if isinstance(tree, list):
        return "[" + ", ".join(_treedef_str(sub) for sub in tree) + "]"
    if isinstance(tree, tuple):
        return type(tree).__name__ + "(" + ", ".join(_treedef_str(sub) for sub in tree) + ")"
    return "*"


def _dtype_name(leaf) -> str:
    if torch.is_tensor(leaf) and leaf.dtype in _EXOTIC_NAME:
        return _EXOTIC_NAME[leaf.dtype]
    return str(_storable(leaf).dtype)


def _storable(leaf) -> np.ndarray:
    """A host leaf as the numpy array that ``arrays.npz`` stores (bf16 /
    fp8 as their unsigned view)."""
    if not torch.is_tensor(leaf):
        return np.asarray(leaf)
    t = leaf.detach()
    if t.dtype in _EXOTIC_NAME:
        _, store, view, _ = _EXOTIC[_EXOTIC_NAME[t.dtype]]
        return t.view(view).numpy().view(store)
    return t.numpy()


def _host_copy(leaf):
    """A copy of ``leaf`` that no later in-place update reaches."""
    if torch.is_tensor(leaf):
        t = leaf.detach()
        return t.cpu() if t.device.type != "cpu" else t.clone()
    return np.array(leaf)


def _crc(arr: np.ndarray) -> int:
    return zlib.crc32(memoryview(np.ascontiguousarray(arr)).cast("B"))


def save(ckpt_dir: str, step: int, tree: Any, *, extra: dict | None = None):
    """Synchronous save (the async writer calls this off-thread). Leaves on
    the card are copied to the host here."""
    leaves = [leaf.detach().cpu() if torch.is_tensor(leaf) else leaf
              for leaf in tree_leaves(tree)]
    step_dir = os.path.join(ckpt_dir, f"step_{step:09d}")
    tmp_dir = step_dir + ".tmp"
    if os.path.exists(tmp_dir):
        shutil.rmtree(tmp_dir)
    os.makedirs(tmp_dir, exist_ok=True)
    arrays = {f"leaf_{i}": _storable(leaf) for i, leaf in enumerate(leaves)}
    np.savez(os.path.join(tmp_dir, "arrays.npz"), **arrays)
    manifest = {
        "step": step,
        "num_leaves": len(leaves),
        "crcs": [_crc(arr) for arr in arrays.values()],
        "dtypes": [_dtype_name(leaf) for leaf in leaves],
        "shapes": [list(arr.shape) for arr in arrays.values()],
        "treedef": _treedef_str(tree),
        "extra": extra or {},
    }
    with open(os.path.join(tmp_dir, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    with open(os.path.join(tmp_dir, "DONE"), "w") as f:
        f.write("ok")
    if os.path.exists(step_dir):
        shutil.rmtree(step_dir)
    os.rename(tmp_dir, step_dir)
    return step_dir


def _committed_steps(ckpt_dir: str) -> list:
    return sorted(int(name[5:]) for name in os.listdir(ckpt_dir)
                  if name.startswith("step_") and not name.endswith(".tmp")
                  and os.path.exists(os.path.join(ckpt_dir, name, "DONE")))


def latest_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = _committed_steps(ckpt_dir)
    return steps[-1] if steps else None


def _from_storable(arr: np.ndarray, dtype_name: str) -> torch.Tensor:
    """The stored array as a CPU tensor of the manifest's dtype: bf16 / fp8
    reinterpreted from their unsigned view, anything else converted."""
    if dtype_name in _EXOTIC:
        dtype, store, _, np_view = _EXOTIC[dtype_name]
        if arr.dtype == store:
            return torch.from_numpy(arr.view(np_view)).view(dtype)
        return torch.from_numpy(arr).to(dtype)
    return torch.from_numpy(arr.astype(np.dtype(dtype_name)))


def _place(t: torch.Tensor, like):
    """``t`` on the device and in the dtype of ``like``'s leaf (a tensor, a
    numpy array or a Python int)."""
    if torch.is_tensor(like):
        return t.to(device=like.device, dtype=like.dtype)
    if isinstance(like, (np.ndarray, np.generic)):
        return t.to(torch.from_numpy(np.zeros(0, like.dtype)).dtype).numpy()
    return int(t)


def restore(ckpt_dir: str, step: int, like: Any) -> Any:
    """Restore into the structure of ``like`` (validates the leaf count, each
    leaf's CRC and shape; places each leaf as ``like``'s is placed)."""
    step_dir = os.path.join(ckpt_dir, f"step_{step:09d}")
    if not os.path.exists(os.path.join(step_dir, "DONE")):
        raise FileNotFoundError(f"no committed checkpoint at {step_dir}")
    with open(os.path.join(step_dir, "manifest.json")) as f:
        manifest = json.load(f)
    want = tree_leaves(like)
    if manifest["num_leaves"] != len(want):
        raise ValueError(f"leaf count mismatch: ckpt {manifest['num_leaves']} vs "
                         f"model {len(want)}")
    out = []
    with np.load(os.path.join(step_dir, "arrays.npz")) as data:
        for i, leaf in enumerate(want):
            arr = data[f"leaf_{i}"]
            if _crc(arr) != manifest["crcs"][i]:
                raise IOError(f"CRC mismatch on leaf {i} (corrupt checkpoint)")
            shape = tuple(leaf.shape) if hasattr(leaf, "shape") else ()
            if tuple(arr.shape) != shape:
                raise ValueError(f"shape mismatch leaf {i}: {arr.shape} vs {shape}")
            out.append(_place(_from_storable(arr, manifest["dtypes"][i]), leaf))
    return _unflatten(like, iter(out))


class AsyncCheckpointer:
    """One-deep async writer: save() returns once it holds a host copy of
    the state; the next save (or wait()) joins the previous thread first.
    At most one write is in flight, and commits are never reordered."""

    def __init__(self, ckpt_dir: str, keep: int = 3):
        self.ckpt_dir = ckpt_dir
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def save(self, step: int, tree: Any, extra: dict | None = None):
        self.wait()
        host_tree = _unflatten(tree, iter([_host_copy(leaf) for leaf in tree_leaves(tree)]))

        def work():
            try:
                save(self.ckpt_dir, step, host_tree, extra=extra)
                self._gc()
            except BaseException as e:        # surfaced on the next wait()
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _gc(self):
        for s in _committed_steps(self.ckpt_dir)[:-self.keep]:
            shutil.rmtree(os.path.join(self.ckpt_dir, f"step_{s:09d}"), ignore_errors=True)
