"""Logical-axis sharding rules over a ``launch.mesh.Mesh``, as in the JAX
package's ``repro/distributed/sharding.py``.

A (mesh, rules) context, installed by ``axis_rules``, maps logical axis
names to mesh axes; the kernel regions (``distributed/shard.py``,
``distributed/ring.py``) and the train step read the mesh from it, so the
model code stays mesh-agnostic and runs unchanged outside one. The
reference keeps it per thread; here it is per process (a process is one
rank), because autograd runs a backward on CUDA tensors, and the remat
recompute inside it, on a device thread of its own, which must see the
mesh the forward ran under.

The port keeps one placement rule where the reference lets XLA place arrays
(PyTorch runs one process a rank): outside a kernel region every rank of a
``seq`` or ``model`` line holds the same global tensors, its ``data`` share
of the batch. That is the layout the reference's layer-boundary pins
``("batch", None, "embed")`` give on a debug mesh, with the token axis whole
outside the ring. So ``constrain`` has nothing to move and is the identity;
``logical_to_spec`` and ``named_sharding`` still say where the rules would
put an array.
"""
from __future__ import annotations

import contextlib
from typing import NamedTuple, Optional, Sequence

# the installed contexts, innermost last
_CONTEXTS: list = []

# logical axis -> mesh axis (or tuple of axes), the reference's defaults
DEFAULT_RULES = {
    "batch": ("pod", "data"),     # DP over pod x data
    "seq": "seq",                 # Ring-SFA's axis, where the mesh has one
    "embed": "model",
    "heads": "model",             # TP
    "kv_heads": "model",
    "head_dim": None,
    "mlp": "model",
    "vocab": "model",
    "expert": "model",            # EP
    "capacity": None,
    "layers": None,
    "sfa_k": None,
    "state": None,
    "cache_seq": None,
    "latent": None,
    "moe_groups": ("pod", "data"),
    "seq_sp": "model",
}


def _current():
    return _CONTEXTS[-1] if _CONTEXTS else None


@contextlib.contextmanager
def axis_rules(mesh, rules: dict | None = None):
    """Install (mesh, rules) for the block; rules naming axes the mesh lacks
    clean to None (e.g. "pod" on a single-pod mesh)."""
    rules = dict(DEFAULT_RULES, **(rules or {}))
    clean = {}
    for k, v in rules.items():
        if v is None:
            clean[k] = None
        elif isinstance(v, tuple):
            axes = tuple(a for a in v if a in mesh.axis_names)
            clean[k] = axes if axes else None
        else:
            clean[k] = v if v in mesh.axis_names else None
    _CONTEXTS.append((mesh, clean))
    try:
        yield
    finally:
        _CONTEXTS.pop()


def axis_size(mesh_axis: str) -> int:
    """Size of a mesh axis under the active rules context (1 if none)."""
    ctx = _current()
    return 1 if ctx is None else ctx[0].size(mesh_axis)


def current_mesh():
    """The mesh of the active rules context (None outside one)."""
    ctx = _current()
    return None if ctx is None else ctx[0]


def logical_to_spec(logical: Sequence[Optional[str]]) -> tuple:
    """The mesh axis (or axes, or None) of each logical axis name: the
    reference's PartitionSpec as a tuple."""
    ctx = _current()
    if ctx is None:
        return (None,) * len(logical)
    _, rules = ctx
    return tuple(rules.get(name) if name else None for name in logical)


def constrain(x, logical: Sequence[Optional[str]]):
    """The identity: outside a kernel region every rank of a seq / model
    line already holds the global tensor of its data share (module
    docstring), which is what the reference's constraint pins."""
    return x


class NamedSharding(NamedTuple):
    mesh: object
    spec: tuple


def named_sharding(logical: Sequence[Optional[str]]) -> Optional[NamedSharding]:
    ctx = _current()
    if ctx is None:
        return None
    return NamedSharding(ctx[0], logical_to_spec(logical))
