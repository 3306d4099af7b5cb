"""Meshes over ``torch.distributed`` ranks, and the one place that starts them.

The JAX package's ``launch/mesh.py`` names the devices of one controller
(``jax.make_mesh``). PyTorch runs one process a rank, so a ``Mesh`` here is
this rank's view of the initialised process group laid out on named axes:
the size of each axis, this rank's coordinate on it, and one subgroup per
axis line (the ranks that differ only on that axis). Ranks are laid out
row-major over the axes, as ``jax.make_mesh`` lays out devices.

The collectives the port runs go through the ``Mesh`` methods, and one
function, ``transport``, decides how each reaches the wire: NCCL takes CUDA
tensors; gloo takes CPU tensors, and of CUDA tensors only the collectives
in ``GLOO_CUDA_OPS`` (``tools/gloo_cuda_probe.py`` on the H100 machine:
gloo's send / receive refuse device memory, "writev: Bad address"), so the
ring's hops are staged through pinned host memory. A collective that fails
raises; no rank moves to the CPU.

``spawn(fn, world, device=...)`` starts ``world`` ranks and owns what the
reference leaves to the cluster: the ``file://`` store in a temporary
directory, the backend (NCCL only where each rank has a card of its own:
NCCL refuses two ranks on one device, so ranks that share a card use gloo),
the seed, and the teardown. The launcher, ``chip_smoke.py`` and the tests
all start ranks through it.
"""
from __future__ import annotations

import datetime
import itertools
import math
import os
import pickle
import tempfile
import time
import traceback
from typing import Callable, Optional, Sequence

import torch
import torch.distributed as dist

# the collectives gloo runs on CUDA tensors itself (its CUDA support
# differs by collective); every other one is staged through pinned host
# memory on a gloo group
GLOO_CUDA_OPS = frozenset({"all_reduce", "all_gather", "reduce_scatter"})


def transport(op: str, backend: str, device: torch.device) -> str:
    """How collective ``op`` moves tensors on ``device`` over ``backend``:
    "device" (the backend takes them as they are) or "pinned host" (copied
    to pinned host memory, sent, copied back)."""
    if device.type != "cuda" or backend == "nccl" or op in GLOO_CUDA_OPS:
        return "device"
    return "pinned host"


class Mesh:
    """This rank's view of the process group on named axes.

    ``shape`` maps axis names, in order, to sizes whose product is the
    world size. ``sent`` counts the bytes this rank passed to each kind of
    collective, ``census`` the calls and bytes of each (kind, group size)
    (``utils.roofline.from_mesh`` turns it into wire bytes), ``transports``
    how each kind moved ("gloo, pinned host", ...). A mesh of one rank
    needs no process group."""

    def __init__(self, shape: dict):
        self.axis_names = tuple(shape)
        self.shape = {name: int(size) for name, size in shape.items()}
        world = math.prod(self.shape.values())
        initialised = dist.is_available() and dist.is_initialized()
        if initialised:
            self.rank, size = dist.get_rank(), dist.get_world_size()
            self.backend = dist.get_backend()
        else:
            self.rank, size, self.backend = 0, 1, "none"
        if world != size:
            raise ValueError(f"mesh {self.shape} holds {world} ranks; the process group "
                             f"has {size}")
        sizes = [self.shape[a] for a in self.axis_names]
        coords = list(itertools.product(*(range(s) for s in sizes)))
        self.coords = dict(zip(self.axis_names, coords[self.rank]))
        self._lines, self._groups = {}, {}
        for ax, name in enumerate(self.axis_names):
            # every rank creates every group, in the same order
            others = [range(s) for i, s in enumerate(sizes) if i != ax]
            for fixed in itertools.product(*others):
                ranks = []
                for c in range(sizes[ax]):
                    full = list(fixed)
                    full.insert(ax, c)
                    ranks.append(coords.index(tuple(full)))
                group = dist.new_group(ranks) if initialised and len(ranks) > 1 else None
                if self.rank in ranks:
                    self._lines[name], self._groups[name] = ranks, group
        self.sent: dict = {}
        self.census: dict = {}
        self.transports: dict = {}

    def __repr__(self):
        return f"Mesh({self.shape}, rank {self.rank}, {self.backend})"

    def size(self, axis: str) -> int:
        return self.shape.get(axis, 1)

    def index(self, axis: str) -> int:
        return self.coords.get(axis, 0)

    def line(self, axis: str) -> list:
        """The global ranks of this rank's line along ``axis``."""
        return self._lines.get(axis, [self.rank])

    def wire(self, op: str, device) -> str:
        """"<backend>, <transport>" of collective ``op`` on ``device``'s
        tensors."""
        return f"{self.backend}, {transport(op, self.backend, torch.device(device))}"

    def _count(self, op: str, nbytes: int, how: str, group: int) -> None:
        self.sent[op] = self.sent.get(op, 0) + nbytes
        calls, total = self.census.get((op, group), (0, 0))
        self.census[(op, group)] = (calls + 1, total + nbytes)
        self.transports[op] = f"{self.backend}, {how}"

    def _stage(self, op: str, x: torch.Tensor) -> tuple:
        """(the tensor the backend gets, how it moves)."""
        how = transport(op, self.backend, x.device)
        if how == "pinned host":
            host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
            host.copy_(x)
            return host, how
        return x.contiguous(), how

    def all_reduce(self, x: torch.Tensor, axis: str) -> torch.Tensor:
        """The sum of ``x`` over the ``axis`` line, in place (x must be
        contiguous)."""
        if self.size(axis) == 1:
            return x
        buf, how = self._stage("all_reduce", x)
        dist.all_reduce(buf, group=self._groups[axis])
        if buf is not x:
            x.copy_(buf)
        self._count("all_reduce", x.numel() * x.element_size(), how, self.size(axis))
        return x

    def all_reduce_many(self, tensors: Sequence[torch.Tensor], axis: str) -> None:
        """Sum every tensor of ``tensors`` (one dtype) over the ``axis``
        line in place, as one flat collective."""
        if self.size(axis) == 1 or not tensors:
            return
        flat = torch.cat([t.reshape(-1) for t in tensors])
        self.all_reduce(flat, axis)
        start = 0
        for t in tensors:
            t.copy_(flat[start:start + t.numel()].view_as(t))
            start += t.numel()

    def all_gather(self, x: torch.Tensor, axis: str, dim: int) -> torch.Tensor:
        """Every rank's ``x`` of the ``axis`` line, in line order,
        concatenated along ``dim``."""
        p = self.size(axis)
        if p == 1:
            return x
        buf, how = self._stage("all_gather", x)
        parts = [torch.empty_like(buf) for _ in range(p)]
        dist.all_gather(parts, buf, group=self._groups[axis])
        out = torch.cat(parts, dim=dim)
        self._count("all_gather", x.numel() * x.element_size(), how, p)
        return out.to(x.device, non_blocking=False) if out.device != x.device else out

    def reduce_scatter(self, x: torch.Tensor, axis: str, dim: int) -> torch.Tensor:
        """The sum of ``x`` over the ``axis`` line, cut into the line's
        size along ``dim``: this rank's part (its index on the line)."""
        p = self.size(axis)
        if p == 1:
            return x
        if x.shape[dim] % p:
            raise ValueError(f"reduce_scatter: dim {dim} of {tuple(x.shape)} does not divide "
                             f"the {axis} axis of {p}")
        # the parts are contiguous blocks of a tensor whose first dim is the cut one
        buf, how = self._stage("reduce_scatter", x.movedim(dim, 0))
        out = torch.empty((buf.shape[0] // p, *buf.shape[1:]), dtype=buf.dtype,
                          device=buf.device, pin_memory=how == "pinned host")
        dist.reduce_scatter_tensor(out, buf, group=self._groups[axis])
        self._count("reduce_scatter", x.numel() * x.element_size(), how, p)
        return out.to(x.device).movedim(0, dim).contiguous()

    def shift(self, tensors: Sequence[torch.Tensor], axis: str, op: str = "ring") -> tuple:
        """One ring hop along ``axis``: send ``tensors`` to the next rank of
        the line, receive the previous rank's (same shapes and dtypes).
        They travel as one byte buffer; ``sent[op]`` counts its bytes."""
        p = self.size(axis)
        if p == 1:
            return tuple(tensors)
        line, me = self.line(axis), self.index(axis)
        flat = torch.cat([t.contiguous().reshape(-1).view(torch.uint8) for t in tensors])
        buf, how = self._stage("send", flat)
        recv = torch.empty_like(buf)
        reqs = [dist.isend(buf, line[(me + 1) % p], group=self._groups[axis]),
                dist.irecv(recv, line[(me - 1) % p], group=self._groups[axis])]
        for req in reqs:
            req.wait()
        if recv.device != flat.device:
            recv = recv.to(flat.device)
        self._count(op, flat.numel(), how, p)
        out, start = [], 0
        for t in tensors:
            nbytes = t.numel() * t.element_size()
            out.append(recv[start:start + nbytes].view(t.dtype).view(t.shape))
            start += nbytes
        return tuple(out)

    def barrier(self) -> None:
        if self.backend != "none":
            dist.barrier()

    def reset_counts(self) -> None:
        self.sent.clear()
        self.census.clear()


class ShapeMesh:
    """A mesh of axis sizes alone, with no ranks: the counterpart of JAX's
    ``AbstractMesh``. ``launch/specs.py`` and ``launch/dryrun.py`` read
    only its ``shape``, so the production meshes are planned in one
    process."""

    def __init__(self, shape: dict):
        self.axis_names = tuple(shape)
        self.shape = {name: int(size) for name, size in shape.items()}

    def __repr__(self):
        return f"ShapeMesh({self.shape})"

    def size(self, axis: str) -> int:
        return self.shape.get(axis, 1)


def _world() -> int:
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def production_shape(*, multi_pod: bool = False) -> dict:
    """The reference's 16 x 16 (data, model) mesh, or 2 x 16 x 16 (pod,
    data, model)."""
    return ({"pod": 2, "data": 16, "model": 16} if multi_pod
            else {"data": 16, "model": 16})


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The production mesh (``production_shape``) over 256 or 512 ranks,
    and nowhere else (``ShapeMesh(production_shape(...))`` plans it in one
    process)."""
    shape = production_shape(multi_pod=multi_pod)
    want = math.prod(shape.values())
    if _world() != want:
        raise ValueError(f"the {'multi' if multi_pod else 'single'}-pod production mesh "
                         f"needs {want} ranks; the process group has {_world()}")
    return Mesh(shape)


def make_debug_mesh(model: int = 1, data: Optional[int] = None, seq: int = 1) -> Mesh:
    """A small mesh over the ranks there are. ``seq > 1`` puts a "seq" axis
    between data and model for Ring-SFA (``distributed/ring.py``); the
    (data, model) shape is kept when ``seq == 1``. ``data`` defaults to the
    world size over model x seq."""
    data = data or (_world() // (model * seq))
    shape = ({"data": data, "seq": seq, "model": model} if seq > 1
             else {"data": data, "model": model})
    return Mesh(shape)


# --------------------------------------------------------------------------
# starting ranks
# --------------------------------------------------------------------------

def backend_for(device, world: int) -> str:
    """NCCL where every rank has a card of its own, else gloo."""
    if torch.device(device).type == "cuda" and torch.cuda.device_count() >= world > 1:
        return "nccl"
    return "gloo"


def _to_host(tree):
    from torch.utils._pytree import tree_map
    return tree_map(lambda x: x.detach().cpu() if torch.is_tensor(x) else x, tree)


def _rank_main(rank, world, device, tmp, seed, timeout_s):
    """One rank: join the group, run the parent's fn(*args), write its
    result (or its traceback) for the parent, leave the group."""
    try:
        with open(os.path.join(tmp, "call.pkl"), "rb") as f:
            fn, args = pickle.load(f)
        dev = torch.device(device)
        backend = backend_for(dev, world)
        if dev.type == "cuda":
            count = torch.cuda.device_count()
            if count == 0:
                raise RuntimeError("spawn(device='cuda'): no card in this rank")
            torch.cuda.set_device(rank % count)
        else:
            torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
        dist.init_process_group(backend, init_method=f"file://{tmp}/store", rank=rank,
                                world_size=world,
                                timeout=datetime.timedelta(seconds=timeout_s))
        try:
            torch.manual_seed(seed)
            out = fn(*args)
            torch.save(_to_host(out), os.path.join(tmp, f"result_{rank}.pt"))
        finally:
            dist.destroy_process_group()
    except BaseException:
        with open(os.path.join(tmp, f"error_{rank}.txt"), "w") as f:
            f.write(traceback.format_exc())
        raise


def spawn(fn: Callable, world: int, *, device="cuda", args=(), seed: int = 0,
          timeout_s: float = 600.0) -> list:
    """Run ``fn(*args)`` on ``world`` new ranks and return their results by
    rank (tensors moved to the host). ``fn`` must be importable by name
    (the ranks start from a fresh interpreter). Every rank uses ``device``'s
    type: rank r takes card r % cards. A rank that fails ends the others
    and raises here with its traceback; so does a run past ``timeout_s``."""
    from multiprocessing.connection import wait

    import torch.multiprocessing as mp
    name = getattr(fn, "__name__", fn)
    with tempfile.TemporaryDirectory(prefix="repro_torch_mesh_") as tmp:
        # the call goes through a file: a process's start blocks until it
        # has read its arguments through a pipe, so large ones would start
        # the ranks one after another
        with open(os.path.join(tmp, "call.pkl"), "wb") as f:
            pickle.dump((fn, args), f)
        ctx = mp.get_context("spawn")
        procs = [ctx.Process(target=_rank_main, daemon=False,
                             args=(r, world, str(device), tmp, seed, timeout_s))
                 for r in range(world)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout_s + 60
        try:
            pending = procs
            while pending and time.monotonic() < deadline:
                wait([p.sentinel for p in pending], timeout=deadline - time.monotonic())
                if any(p.exitcode for p in procs):
                    break               # a rank failed: end the others
                pending = [p for p in procs if p.exitcode is None]
        finally:
            for p in procs:
                if p.is_alive():
                    p.terminate()
            for p in procs:
                p.join(30)
        errors = [open(os.path.join(tmp, f)).read() for f in sorted(os.listdir(tmp))
                  if f.startswith("error_")]
        if errors:
            raise RuntimeError(f"a rank of spawn({name}, {world}) failed:\n{errors[0]}")
        codes = [p.exitcode for p in procs]
        if any(c != 0 for c in codes):
            raise RuntimeError(f"spawn({name}, {world}): exit codes {codes} "
                               f"(timeout {timeout_s} s)")
        return [torch.load(os.path.join(tmp, f"result_{r}.pt"), weights_only=False)
                for r in range(world)]
