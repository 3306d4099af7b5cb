"""Dry run: plan every (arch x shape) cell on the production meshes, on the
H100's constants, without ranks and without allocating.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3-8b \\
        --shape train_4k --multi-pod both --out results/dryrun.json

``--arch all --shape all`` sweeps the 40 cells of the JAX package's
``repro/launch/dryrun.py`` (skips recorded with their reasons) on the 16 x
16 (data, model) mesh, and with ``--multi-pod both`` also on 2 x 16 x 16
(pod, data, model). Each mesh is a ``launch.mesh.ShapeMesh`` and every
tensor is on the ``meta`` device. A cell records:

  * its status, and the skip reason where it does not run;
  * the partition mode and the logical-axis rules, as the reference
    chooses them (``_partition_mode``: zero3 for attention-free training
    whose batch covers the mesh, tp otherwise);
  * bytes a device: the f32 parameters and (train) both AdamW moments by
    ``launch.specs.param_specs``, the decode caches by ``cache_specs``, the
    batch by ``input_specs`` split over the batch axes;
  * ``utils.analytic``'s FLOPs and HBM bytes;
  * the roofline terms on the H100 constants (``utils.roofline``), with the
    wire bytes of the parameter collectives the specs imply in a step: an
    all-gather over each split axis of each leaf (as
    ``distributed.shard.gather_leaf`` runs it), and in training the
    gradient's reduce-scatter over each split batch axis and all-reduce over
    each batch axis that does not split the leaf.

The reference reads what it does not model here from XLA's compiled
artefact; the dry run states it instead (``NOT_MODELLED``).
"""
import argparse
import json
import math
import os
import traceback

import torch

from repro_torch.configs import ASSIGNED_ARCHS, LM_SHAPES, get_config, skip_reason
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.distributed.shard import named_leaves, split_axes
from repro_torch.launch import specs as S
from repro_torch.launch.mesh import ShapeMesh, production_shape
from repro_torch.utils import analytic as A
from repro_torch.utils import roofline as R

NOT_MODELLED = (
    "temporaries: activations, workspaces and remat's recomputed values "
    "(the reference's memory_analysis temp_size)",
    "the activation collectives of the TP kernel regions and the ring's hops",
    "a second parameter all-gather where remat recomputes a layer in the backward",
)


def _partition_mode(cfg: ModelConfig, shape: ShapeConfig, mesh) -> str:
    """zero3 (pure DP, fully sharded params) for attention-free training
    when the batch covers the whole mesh; TP otherwise."""
    in_pod = mesh.shape.get("data", 1) * mesh.shape.get("model", 1)
    if cfg.family == "ssm" and shape.kind == "train" and shape.global_batch % in_pod == 0:
        return "zero3"          # batch over (data, model); pod stays pure-DP
    return "tp"


def _rules(mode: str, shape: ShapeConfig):
    """The logical-axis rules the reference lowers the cell under (None:
    the defaults)."""
    if mode == "zero3":
        return {"batch": ("data", "model"), "seq_sp": None, "heads": None,
                "mlp": None, "vocab": None, "embed": None}
    if shape.kind != "train":
        return {"embed": None}
    return None


def _nbytes(shape, dtype) -> int:
    return math.prod(shape) * torch.empty((), dtype=dtype).element_size()


def _tree_bytes(tree, specs, mesh) -> int:
    """Bytes a device of a tree placed by ``specs``."""
    return sum(_nbytes(S.shard_shape(t.shape, s, mesh), t.dtype)
               for (_, t), (_, s) in zip(named_leaves(tree), named_leaves(specs)))


def _batch_bytes(batch: dict, batch_ax, mesh) -> int:
    """Bytes a device of the step's inputs, each split over ``batch_ax``
    along its first dim where that divides it, else whole."""
    total = 0
    for leaf in batch.values():
        spec = S._clean(mesh, (batch_ax,) + (None,) * (leaf.ndim - 1), leaf.shape)
        total += _nbytes(S.shard_shape(leaf.shape, spec, mesh), leaf.dtype)
    return total


def param_collectives(params, specs, mesh, *, train: bool, summed=("pod", "data")):
    """The parameter collectives one step runs on a device, by the specs:
    -> ``roofline.CollectiveStats``. Forward, each leaf is all-gathered
    over its split axes, minor first; in training its gradient is cut back
    to the shard (a slice over an axis not in ``summed``, a reduce-scatter
    over one in it) and all-reduced over each axis of ``summed`` that does
    not split it."""
    counts: dict = {}
    wire: dict = {}

    def add(kind, result, g):
        counts[kind] = counts.get(kind, 0) + 1
        wire[kind] = wire.get(kind, 0.0) + R.wire_bytes(kind, result, g)

    for (_, leaf), (_, spec) in zip(named_leaves(params), named_leaves(specs)):
        axes = split_axes(spec, mesh)
        size = _nbytes(S.shard_shape(leaf.shape, spec, mesh), torch.float32)
        for _, axis in reversed(axes):
            size *= mesh.size(axis)
            add("all-gather", size, mesh.size(axis))
        if not train:
            continue
        for _, axis in axes:
            if axis not in summed:
                size //= mesh.size(axis)
        for _, axis in axes:
            if axis in summed:
                size //= mesh.size(axis)
                add("reduce-scatter", size, mesh.size(axis))
        for axis in summed:
            if mesh.size(axis) > 1 and axis not in [a for _, a in axes]:
                add("all-reduce", size, mesh.size(axis))
    return R.CollectiveStats(counts, wire)


def plan_cell(cfg: ModelConfig, shape: ShapeConfig, mesh) -> dict:
    """The cell's record on ``mesh`` (a ``ShapeMesh``): mode, rules, bytes
    a device, analytic FLOPs and HBM bytes, the roofline."""
    ndev = math.prod(mesh.shape.values())
    mode = _partition_mode(cfg, shape, mesh)
    batch_ax = (tuple(a for a in ("data", "model") if a in mesh.shape) if mode == "zero3"
                else S.batch_axes(mesh))
    ins = S.input_specs(cfg, shape)
    params, opt = S.abstract_state(cfg)
    pspec = S.param_specs(params, cfg, mesh, mode=mode)
    mem = {"params": _tree_bytes(params, pspec, mesh)}
    if shape.kind == "train":
        mem["opt_moments"] = _tree_bytes(opt.m, pspec, mesh) + _tree_bytes(opt.v, pspec, mesh)
        mem["batch"] = _batch_bytes(ins, batch_ax, mesh)
    elif shape.kind == "prefill":
        mem["batch"] = _batch_bytes(ins, batch_ax, mesh)
    else:
        cspec = S.cache_specs(ins["caches"], cfg, mesh, batch=shape.global_batch,
                              max_len=shape.seq_len)
        mem["caches"] = sum(_nbytes(S.shard_shape(t.shape, s, mesh), t.dtype)
                            for t, s in zip(_cache_leaves(ins["caches"]),
                                            _cache_leaves(cspec)))
        split = shape.global_batch % (ndev // mesh.shape.get("model", 1)) == 0
        mem["batch"] = _batch_bytes({k: ins[k] for k in ("token", "cache_len")},
                                    batch_ax if split else None, mesh)
    mem["total"] = sum(mem.values())
    summed = ("pod", "data", "model") if mode == "zero3" else ("pod", "data")
    stats = param_collectives(params, pspec, mesh, train=shape.kind == "train",
                              summed=summed)
    fl = A.step_flops(cfg, shape)
    hb = A.step_hbm_bytes(cfg, shape, ndev)
    rf = R.Roofline(flops=fl["total_flops"], hbm_bytes=hb["bytes_per_dev"] * ndev,
                    wire_bytes=stats.total_wire_bytes, num_devices=ndev, collectives=stats)
    roof = dict(rf.as_dict(), model_flops=fl["model_flops"],
                useful_ratio=fl["useful_ratio"],
                collective_wire_bytes=dict(stats.wire_bytes))
    return {"mode": mode, "rules": _rules(mode, shape), "bytes_per_device": mem,
            "analytic": {"flops": fl, "hbm": hb}, "roofline": roof,
            "not_modelled": list(NOT_MODELLED)}


def _cache_leaves(tree) -> list:
    """The tensor (or spec) leaves of a decode-cache tree, in order."""
    from repro_torch.core.kv_cache import HybridCache, KVCache, RecurrentState
    if isinstance(tree, KVCache):
        return [v for v in vars(tree).values() if v is not None and not isinstance(v, int)]
    if isinstance(tree, HybridCache):
        return _cache_leaves(tree.attn) + _cache_leaves(tree.mamba)
    if isinstance(tree, RecurrentState):
        return [leaf for _, leaf in named_leaves(tree.tree)]
    return [leaf for sub in tree for leaf in _cache_leaves(sub)]


def run_cell(arch: str, shape_name: str, multi_pod: bool) -> dict:
    cfg = get_config(arch)
    shape = next(s for s in LM_SHAPES if s.name == shape_name)
    reason = skip_reason(cfg, shape)
    rec = {"arch": arch, "shape": shape_name, "mesh": "2x16x16" if multi_pod else "16x16"}
    if reason:
        rec["status"] = "skipped"
        rec["reason"] = reason
        return rec
    try:
        rec.update(plan_cell(cfg, shape, ShapeMesh(production_shape(multi_pod=multi_pod))))
        rec["status"] = "ok"
    except Exception as e:       # noqa: BLE001 - a cell's error is its record
        rec["status"] = "error"
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["trace"] = traceback.format_exc(limit=20)
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--multi-pod", choices=["on", "off", "both"], default="off")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    archs = list(ASSIGNED_ARCHS) if args.arch == "all" else [args.arch]
    shapes = [s.name for s in LM_SHAPES] if args.shape == "all" else [args.shape]
    pods = {"on": [True], "off": [False], "both": [False, True]}[args.multi_pod]

    results = []
    for arch in archs:
        for shape in shapes:
            for mp in pods:
                rec = run_cell(arch, shape, mp)
                status = rec["status"]
                extra = ""
                if status == "ok":
                    r = rec["roofline"]
                    extra = (f" {rec['mode']} {rec['bytes_per_device']['total'] / 2**30:.2f} GiB"
                             f" bottleneck={r['bottleneck']}"
                             f" tc={r['t_compute_s']:.3e}"
                             f" tm={r['t_memory_s']:.3e}"
                             f" tx={r['t_collective_s']:.3e}")
                elif status == "skipped":
                    extra = f" ({rec['reason'][:40]}…)"
                else:
                    extra = f" {rec['error'][:120]}"
                print(f"[{status:7s}] {arch:22s} {shape:12s} {rec['mesh']:8s}{extra}",
                      flush=True)
                results.append(rec)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
        print(f"wrote {args.out}")
    bad = [r for r in results if r["status"] == "error"]
    print(f"\n{len(results)} cells: "
          f"{sum(r['status'] == 'ok' for r in results)} ok, "
          f"{sum(r['status'] == 'skipped' for r in results)} skipped, "
          f"{len(bad)} errors; not modelled: " + "; ".join(NOT_MODELLED))
    return 1 if bad else 0


if __name__ == "__main__":
    raise SystemExit(main())
