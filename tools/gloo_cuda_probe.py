#!/usr/bin/env python3
"""Which collectives gloo runs on CUDA tensors, on this machine's card.

    PYTHONPATH=src python3 tools/gloo_cuda_probe.py

Starts two ranks on the one card through ``launch.mesh.spawn`` (gloo: NCCL
refuses two ranks on one device) and hands each collective a CUDA tensor
as it is, with no staging: all_reduce, broadcast, all_gather,
reduce_scatter and barrier on one pair of ranks, then send / recv on a
pair of its own (a refused send closes the pair's connection, and gloo can
abort the process from its background thread). Prints one line a
collective, "ok" (and whether the values arrived) or the error's first
line. ``launch/mesh.py``'s ``GLOO_CUDA_OPS`` names the collectives the port
hands gloo as CUDA tensors; every other one it stages through pinned host
memory.
"""
import sys
from pathlib import Path

import torch
import torch.distributed as dist

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))


def _probe(names):
    rank = dist.get_rank()
    dev = torch.device("cuda", torch.cuda.current_device())
    x = torch.full((1024,), float(rank + 1), device=dev)
    want_sum = torch.full_like(x, 3.0)

    def all_reduce():
        y = x.clone()
        dist.all_reduce(y)
        return torch.equal(y, want_sum)

    def broadcast():
        y = x.clone()
        dist.broadcast(y, 0)
        return torch.equal(y, torch.ones_like(y))

    def all_gather():
        parts = [torch.empty_like(x) for _ in range(2)]
        dist.all_gather(parts, x)
        return all(torch.equal(p, torch.full_like(x, float(i + 1))) for i, p in enumerate(parts))

    def send_recv():
        y = torch.empty_like(x)
        reqs = [dist.isend(x, 1 - rank), dist.irecv(y, 1 - rank)]
        for r in reqs:
            r.wait()
        return torch.equal(y, torch.full_like(x, float(2 - rank)))

    def reduce_scatter():
        y = torch.empty(512, device=dev)
        dist.reduce_scatter_tensor(y, x)
        return torch.equal(y, torch.full_like(y, 3.0))

    def barrier():
        dist.barrier()
        return True

    out = {}
    fns = {fn.__name__: fn for fn in (all_reduce, broadcast, all_gather, reduce_scatter,
                                      barrier, send_recv)}
    for fn in (fns[name] for name in names):
        try:
            ok = fn()
            torch.cuda.synchronize()
            out[fn.__name__] = "ok, values right" if ok else "ran, values WRONG"
        except Exception as err:  # noqa: BLE001 - a probe reports what each collective does
            out[fn.__name__] = f"refused: {str(err).splitlines()[0][:120]}"
    return out


def main():
    from repro_torch.launch.mesh import GLOO_CUDA_OPS, spawn
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")
    for names in (("all_reduce", "broadcast", "all_gather", "reduce_scatter", "barrier"),
                  ("send_recv",)):
        try:
            results = spawn(_probe, 2, device="cuda", args=(names,), timeout_s=120)
        except RuntimeError as err:       # a rank aborted inside gloo
            print(f"[gloo cuda] {', '.join(names)}: a rank ended abnormally: "
                  f"{str(err).splitlines()[0][:160]}")
            continue
        for op, what in results[0].items():
            print(f"[gloo cuda] {op}: rank 0 {what}; rank 1 {results[1][op]}")
    print(f"[gloo cuda] the port hands gloo CUDA tensors for {sorted(GLOO_CUDA_OPS)}")


if __name__ == "__main__":
    main()
