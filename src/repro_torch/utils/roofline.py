"""Roofline terms on the NVIDIA H100, as in the JAX package's
``repro/utils/roofline.py``:

    compute term    = FLOPs / (devices x peak FLOP/s)
    memory term     = HBM bytes / (devices x HBM B/s)
    collective term = wire bytes a device / link B/s

The reference reads FLOPs and bytes from a compiled XLA artefact and parses
its collectives from the optimized HLO (``parse_collectives``,
``from_compiled``); the port has no such artefact, so its census of
collectives is ``from_mesh``: the calls and bytes each rank passed to each
collective, by group size, as ``launch.mesh.Mesh`` counts them. The wire
bytes a device per op follow the reference's model (ring algorithms, group
size g, ``result_bytes`` the op's result):

    all-gather         result_bytes x (g-1)/g   (each device receives the rest)
    reduce-scatter     result_bytes x (g-1)     (the result is 1/g of the operand)
    all-reduce         2 x result_bytes x (g-1)/g  (reduce-scatter + all-gather)
    all-to-all         result_bytes x (g-1)/g
    collective-permute result_bytes

Constants: the H100 SXM data sheet's dense bf16 tensor-core peak, its HBM3
rate, and NVLink 4's 450 GB/s a direction (900 GB/s both ways).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

H100_SXM_BF16_FLOPS = 989e12      # dense, tensor cores, at 700 W
H100_SXM_F32_FLOPS = 67e12        # CUDA cores, outside the tensor cores
H100_SXM_HBM_BW = 3.35e12         # bytes/s
H100_SXM_NVLINK_BW = 450e9        # bytes/s a direction

PEAK_FLOPS = H100_SXM_BF16_FLOPS
HBM_BW = H100_SXM_HBM_BW
LINK_BW = H100_SXM_NVLINK_BW

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")

# a Mesh collective -> (the reference's op kind, its result bytes from the
# bytes a rank passed and the group size); anything else is a shift
_MESH_OPS = {"all_gather": ("all-gather", lambda b, g: b * g),
             "reduce_scatter": ("reduce-scatter", lambda b, g: b / g),
             "all_reduce": ("all-reduce", lambda b, g: b)}


def wire_bytes(kind: str, result_bytes: float, g: int) -> float:
    """Bytes a device puts on the wire for one ``kind`` op whose result is
    ``result_bytes``, over a group of ``g``."""
    if kind == "all-gather":
        return result_bytes * (g - 1) / max(g, 1)
    if kind == "reduce-scatter":
        return result_bytes * (g - 1)
    if kind == "all-reduce":
        return 2 * result_bytes * (g - 1) / max(g, 1)
    if kind == "all-to-all":
        return result_bytes * (g - 1) / max(g, 1)
    if kind == "collective-permute":
        return result_bytes
    raise ValueError(f"unknown collective {kind!r}; expected one of {COLLECTIVES}")


@dataclasses.dataclass
class CollectiveStats:
    counts: dict
    wire_bytes: dict            # a device, by op kind

    @property
    def total_wire_bytes(self) -> float:
        return sum(self.wire_bytes.values())


def from_mesh(mesh) -> CollectiveStats:
    """The census of the collectives ``mesh`` ran since its counts were
    last reset (``Mesh.census``: calls and bytes passed by (op, group
    size)), in the reference's op kinds and wire bytes."""
    counts: dict = {}
    wire: dict = {}
    for (op, g), (calls, passed) in mesh.census.items():
        kind, result = _MESH_OPS.get(op, ("collective-permute", lambda b, g: b))
        counts[kind] = counts.get(kind, 0) + calls
        # the op's result per call, from what a call passed on average
        w = calls * wire_bytes(kind, result(passed / calls, g), g)
        wire[kind] = wire.get(kind, 0.0) + w
    return CollectiveStats(counts, wire)


@dataclasses.dataclass
class Roofline:
    flops: float                 # total flops (whole program)
    hbm_bytes: float
    wire_bytes: float            # a device
    num_devices: int
    collectives: Optional[CollectiveStats] = None

    @property
    def t_compute(self) -> float:
        return self.flops / (self.num_devices * PEAK_FLOPS)

    @property
    def t_memory(self) -> float:
        return self.hbm_bytes / (self.num_devices * HBM_BW)

    @property
    def t_collective(self) -> float:
        return self.wire_bytes / LINK_BW

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    def as_dict(self) -> dict:
        return {
            "flops": self.flops, "hbm_bytes": self.hbm_bytes,
            "wire_bytes_per_dev": self.wire_bytes,
            "t_compute_s": self.t_compute, "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "bottleneck": self.bottleneck,
            "collective_counts": self.collectives.counts if self.collectives else {},
        }


def model_flops(n_params: int, tokens: int, *, active_params: int | None = None,
                train: bool = True) -> float:
    """MODEL_FLOPS = 6·N·D (dense) or 6·N_active·D (MoE); 2·N·D inference."""
    n = active_params if active_params is not None else n_params
    return (6.0 if train else 2.0) * n * tokens
