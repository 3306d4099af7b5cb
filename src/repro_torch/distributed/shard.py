"""Kernel regions over the ``model`` mesh axis (tensor parallelism), as in
the JAX package's ``repro/distributed/shard.py``, and the sharded
parameter leaves that ``launch/specs.py::param_specs`` places.

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

Sharded leaves. The reference's launcher places every parameter and both
AdamW moments by their specs and XLA gathers at use. Here a rank holds
``shard_leaf``'s slice of each leaf (its contiguous block along every split
dim; a split over a tuple of axes takes the first axis as major), and the
model gathers a leaf where it reads it, through ``gather_leaf``: an
all-gather over each split axis forward; backward, over ``pod`` / ``data``
(whose ranks hold different rows of the batch) a reduce-scatter that sums
the gradient, over ``model`` (whose ranks hold the same gradient, as every
rank of a model line computes the global tensors) this rank's slice. A
sharded parameter carries its spec as the attribute ``spec``
(``mark_specs``), which the train step, the optimizer and the checkpoints
read. Outside a mesh, or on a leaf that nothing splits, both are the
identity. The train step splits the batch over data only, so the runtime
takes specs of mode "tp" (``param_specs``' default); mode "zero3", which
also puts the batch on model, is the dry run's.
"""
from __future__ import annotations

import torch

from repro_torch.distributed.sharding import current_mesh

# mesh axes whose ranks hold different rows of the batch: a gradient is
# summed over them
SUMMED_AXES = ("pod", "data")


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


# --------------------------------------------------------------------------
# sharded leaves
# --------------------------------------------------------------------------

def map_tree(fn, tree, *rest):
    """``fn`` over the leaves of a nested dict / list ``tree`` (and of the
    trees in ``rest``, which share its containers: a spec tree's tuples are
    its leaves)."""
    if isinstance(tree, dict):
        return {k: map_tree(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, list):
        return [map_tree(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree)]
    return fn(tree, *rest)


def named_leaves(tree, prefix=()) -> list:
    """[(path parts, leaf)] of a nested dict / list, in its order."""
    if isinstance(tree, dict):
        return [x for k, v in tree.items() for x in named_leaves(v, prefix + (str(k),))]
    if isinstance(tree, list):
        return [x for i, v in enumerate(tree) for x in named_leaves(v, prefix + (str(i),))]
    return [(prefix, tree)]


def split_axes(spec, mesh) -> list:
    """[(dim, axis)] of every mesh axis of size > 1 that ``spec`` splits a
    dim over, dims in order, a tuple's axes major first."""
    if spec is None or mesh is None:
        return []
    out = []
    for dim, entry in enumerate(spec):
        for axis in (entry if isinstance(entry, tuple) else (entry,)):
            if axis is not None and mesh.size(axis) > 1:
                out.append((dim, axis))
    return out


def _cut(x, dim, axis, mesh):
    """This rank's block of ``x`` along ``dim`` over the ``axis`` line (a view)."""
    n = x.shape[dim] // mesh.size(axis)
    return x.narrow(dim, mesh.index(axis) * n, n)


def shard_leaf(full, spec, mesh=None):
    """This rank's shard of ``full`` placed by ``spec`` on ``mesh`` (the
    active one by default): a copy, since a view keeps the whole storage
    alive. ``full`` itself where nothing splits it."""
    mesh = current_mesh() if mesh is None else mesh
    axes = split_axes(spec, mesh)
    if not axes:
        return full
    for dim, axis in axes:
        full = _cut(full, dim, axis, mesh)
    return full.clone()


def gather_full(x, spec, mesh=None):
    """The whole tensor of which ``x`` is this rank's shard placed by
    ``spec``, without a graph (a gradient or a residual): an all-gather
    over each split axis, the later dim's first."""
    mesh = current_mesh() if mesh is None else mesh
    for dim, axis in reversed(split_axes(spec, mesh)):
        x = mesh.all_gather(x, axis, dim=dim)
    return x


class _GatherLeaf(torch.autograd.Function):
    """The whole leaf from this rank's shard; backward, this rank's shard
    of the gradient (summed over ``SUMMED_AXES``)."""

    @staticmethod
    def forward(ctx, x, spec, mesh):
        ctx.axes, ctx.mesh = split_axes(spec, mesh), mesh
        return gather_full(x, spec, mesh)

    @staticmethod
    def backward(ctx, g):
        mesh = ctx.mesh
        # slices first: the reduce-scatters then move the smaller tensor
        for dim, axis in ctx.axes:
            if axis not in SUMMED_AXES:
                g = _cut(g, dim, axis, mesh)
        for dim, axis in ctx.axes:
            if axis in SUMMED_AXES:
                g = mesh.reduce_scatter(g.contiguous(), axis, dim=dim)
        return g.contiguous(), None, None


def gather_leaf(x, spec, mesh=None):
    """The whole leaf of which ``x`` is this rank's shard placed by
    ``spec`` (``x`` itself where nothing splits it), differentiable."""
    mesh = current_mesh() if mesh is None else mesh
    if not split_axes(spec, mesh):
        return x
    return _GatherLeaf.apply(x, spec, mesh)


def gather_tree(tree, specs):
    """``gather_leaf`` over a nested dict / list of shards and their spec
    tree (None: the tree is whole)."""
    if specs is None:
        return tree
    return map_tree(gather_leaf, tree, specs)


def spec_of(t):
    """The spec a sharded parameter carries (None: whole)."""
    return getattr(t, "spec", None)


def layer_specs(seg):
    """The specs of one layer of a segment's stacked parameters (their
    leading layer axis dropped), or None if none is sharded."""
    specs = map_tree(lambda t: None if spec_of(t) is None else spec_of(t)[1:], seg)
    return specs if any(s is not None for _, s in named_leaves(specs)) else None


def mark_specs(tree, specs) -> None:
    """Record each parameter's spec on it (``spec``), for the readers
    that take the parameters alone."""
    map_tree(lambda t, s: setattr(t, "spec", s), tree, specs)


def sums_over_data(t, mesh=None) -> bool:
    """Whether the gradient of parameter ``t`` comes back from its gather
    summed over the batch axes (reduce-scattered): the train step must not
    sum it again."""
    return any(axis in SUMMED_AXES
               for _, axis in split_axes(spec_of(t), current_mesh() if mesh is None else mesh))
