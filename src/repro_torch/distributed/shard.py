"""Kernel regions over the ``model`` mesh axis (tensor parallelism), as in
the JAX package's ``repro/distributed/shard.py``.

The reference runs a kernel through ``shard_map`` over global arrays. Here
each rank holds the global tensors (``distributed/sharding.py``), so
``run_tp`` is the same region by hand: it takes this rank's slice of each
split input axis, runs the kernel on it, and reassembles the outputs as
``shard_map``'s ``out_specs`` do, an all-gather along a split output axis
and an all-reduce for a ``reduce_out`` partial sum.

  * ``tp_flash_sfa`` / ``tp_flash_sfa_bwd`` split the folded (b·h) axis:
    every row is its own attention problem, so the dQ/dK code gradients
    need no reduction, which is what makes the compact seam TP-eligible.
  * ``tp_proj_rtopk`` splits the head axis of the fused projection's
    weight blocks (column-parallel: each rank projects and sparsifies its
    own heads).
  * ``models/layers.py::sparse_proj_bwd`` runs the seam's projection
    backward through ``run_tp``: dW stays per head slice, dx all-reduces.

Outside a mesh, on a size-1 axis, or when a split axis does not divide the
degree, every wrapper is the plain call. The kernels are imported inside
the wrappers: ``kernels/ops.py`` imports this module.
"""
from __future__ import annotations

from repro_torch.distributed.sharding import current_mesh


def tp_degree(axis_name: str = "model") -> int:
    """Size of the TP mesh axis under the active rules context (1 if none)."""
    mesh = current_mesh()
    return 1 if mesh is None else mesh.size(axis_name)


def replicate(x):
    """The identity: outside a region every rank of a model line holds the
    global tensor already (the reference reshards a shard_map output to
    replicated here)."""
    return x


def run_tp(fn, args, in_axes, out_axes, *, reduce_out=(), axis_name: str = "model"):
    """``fn(*args)`` as a region over the ``axis_name`` axis.

    ``in_axes`` / ``out_axes``: per input / output, the axis split over the
    mesh axis (None: whole on every rank). ``reduce_out``: the output
    positions whose per-rank partials are summed over the axis (their
    out_axes entry is None). Falls back to ``fn(*args)`` outside a mesh, on
    a size-1 axis, or when a split axis does not divide the degree."""
    mesh = current_mesh()
    tp = 1 if mesh is None else mesh.size(axis_name)
    if tp == 1 or any(ax is not None and a.shape[ax] % tp for a, ax in zip(args, in_axes)):
        return fn(*args)
    r = mesh.index(axis_name)
    local = [a if ax is None else a.narrow(ax, r * (a.shape[ax] // tp), a.shape[ax] // tp)
             for a, ax in zip(args, in_axes)]
    out = fn(*local)
    single = not isinstance(out_axes, (tuple, list))
    outs = (out,) if single else tuple(out)
    axes = (out_axes,) if single else tuple(out_axes)
    full = []
    for i, (o, ax) in enumerate(zip(outs, axes)):
        if i in reduce_out:
            o = mesh.all_reduce(o.contiguous(), axis_name)
        elif ax is not None:
            o = mesh.all_gather(o.contiguous(), axis_name, dim=ax)
        full.append(o)
    return full[0] if single else tuple(full)


def tp_flash_sfa(q_vals, q_idx, k_vals, k_idx, v, **kw):
    """``flash_sfa`` with the folded (b·h) axis split over the model axis."""
    from repro_torch.kernels.flash_sfa import flash_sfa

    def fn(qv, qi, kv, ki, vf):
        return flash_sfa(qv, qi, kv, ki, vf, **kw)
    out_axes = (0, 0) if kw.get("return_residuals") else 0
    return run_tp(fn, (q_vals, q_idx, k_vals, k_idx, v), in_axes=(0,) * 5,
                  out_axes=out_axes)


def tp_flash_sfa_bwd(q_vals, q_idx, k_vals, k_idx, v, o, lse, g, **kw):
    """``flash_sfa_bwd`` with the folded (b·h) axis split over the model
    axis: dQ/dK code gradients and dV are per slice, no reduction."""
    from repro_torch.kernels.flash_sfa_bwd import flash_sfa_bwd

    def fn(*a):
        return flash_sfa_bwd(*a, **kw)
    return run_tp(fn, (q_vals, q_idx, k_vals, k_idx, v, o, lse, g), in_axes=(0,) * 8,
                  out_axes=(0, 0, 0))


def tp_proj_rtopk(x, w_heads, positions, **kw):
    """``proj_rtopk`` with the head axis of w (and of the codes, axis 1 of
    (b, H, n, k)) split over the model axis: column-parallel."""
    from repro_torch.kernels.rtopk import proj_rtopk

    def fn(xx, ww, pp):
        return proj_rtopk(xx, ww, pp, **kw)
    return run_tp(fn, (x, w_heads, positions), in_axes=(None, 0, None), out_axes=(1, 1))
