"""Training launcher: train a model on the synthetic Markov stream.

    PYTHONPATH=src python -m repro_torch.launch.train --arch gpt2-small-sfa8 \
        --steps 20 [--reduced | --no-reduced] [--attn-backend cuda] \
        [--ring P] [--tp T]

Runs on the card (``--device cpu`` for the CPU). ``--reduced`` (the
default) trains the tiny same-family config; ``--no-reduced`` (or
``--full``) trains at full width. Weights are random, from ``--seed``.
``--attn-backend`` selects the full-sequence attention path through the
registry (``repro_torch/models/backends.py``): ``cuda`` = the hand-written
kernels forward and backward, ``torch`` = the plain oracle, ``auto`` =
``cuda`` wherever it can serve the layer. ``--remat full`` recomputes each
layer in the backward; ``--remat codes`` keeps each SFA layer's top-k codes
and LSE besides its input and recomputes the rest. ``--bwd-emit compact``
(or ``compact2``) trains seam-eligible SFA layers through the compact
code-gradient seam: FlashSFA's backward writes (n, k) code gradients that
the code_grad kernels turn into dx and dW, no dense dQ/dK anywhere;
``--fwd-fuse`` (the default) runs that seam's forward as proj_rtopk ->
block-skip FlashSFA. The slice's policy:

    python -m repro_torch.launch.train --arch gpt2-small-sfa8 --no-reduced \
        --batch 8 --seq-len 1024 --bwd-emit compact --remat codes

``--ring P`` / ``--tp T`` train on the debug mesh (``launch/mesh.py``)
with a "seq" axis of P (Ring-SFA, ``distributed/ring.py``) and a "model"
axis of T (tensor-parallel kernel regions, ``distributed/shard.py``);
started as one process, the launcher spawns the P x T ranks itself
(``launch.mesh.spawn``: NCCL where each rank has a card, else gloo, ranks
sharing one card). ``--mesh single-pod`` / ``multi-pod`` build the
production meshes, which need a process group of 256 / 512 ranks started
around this launcher. Under a mesh the parameters and both AdamW moments
are sharded by ``launch.specs.param_specs(..., mode="tp")``, as the JAX
launcher places them (``distributed/shard.py``: each rank holds its shard
and gathers a leaf at use); rank 0 prints the state bytes a rank.

The run is supervised (``Trainer.train``): it checkpoints into a fresh
temporary directory, removed at exit, every 50 steps and at the last (rank
0 writes it under a mesh), and replays from the newest checkpoint after a
fault. Backend fallbacks, compact-seam and ring routing and remat degrades
(``core.reports``) are printed at exit.
"""
import argparse
import contextlib
import io
import math
import tempfile

import torch.distributed as dist

from repro_torch.configs import get_config
from repro_torch.configs.base import TrainPolicy
from repro_torch.core.reports import collect_reports
from repro_torch.data import DataConfig
from repro_torch.distributed.sharding import axis_rules
from repro_torch.distributed.shard import named_leaves
from repro_torch.launch import specs as S
from repro_torch.launch.mesh import make_debug_mesh, make_production_mesh, spawn
from repro_torch.models.model import param_tree
from repro_torch.optim import OptimizerConfig
from repro_torch.train import FTConfig, Trainer, TrainerConfig


def _parser():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gpt2-small-sfa8")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--reduced", action=argparse.BooleanOptionalAction, default=True,
                    help="train the tiny same-family config (--no-reduced: full width)")
    ap.add_argument("--full", dest="reduced", action="store_false",
                    help="the same as --no-reduced")
    ap.add_argument("--mesh", default="debug",
                    choices=["debug", "single-pod", "multi-pod"])
    ap.add_argument("--tp", type=int, default=1,
                    help="tensor-parallel degree of the debug mesh's model axis "
                         "(distributed/shard.py)")
    ap.add_argument("--ring", type=int, default=1,
                    help="ring degree of the debug mesh's seq axis: > 1 takes Ring-SFA "
                         "on eligible SFA layers (distributed/ring.py)")
    ap.add_argument("--attn-backend", default=None, choices=["torch", "cuda", "auto"],
                    help="override cfg.attention.backend for the step")
    ap.add_argument("--bwd-emit", default=None, choices=["dense", "compact", "compact2"],
                    help="FlashSFA backward emit: compact/compact2 train SFA layers "
                         "through the compact code-gradient seam")
    ap.add_argument("--fwd-fuse", action=argparse.BooleanOptionalAction, default=None,
                    help="the seam's forward as proj_rtopk -> block-skip FlashSFA "
                         "(default: the config's, on)")
    ap.add_argument("--remat", default=None, choices=["none", "full", "codes"],
                    help="per-layer checkpointing: none = keep every "
                         "activation; full = recompute each layer in the backward; "
                         "codes = keep the SFA codes too and recompute the rest")
    ap.add_argument("--device", default=None, help="torch device (default: the card)")
    ap.add_argument("--seed", type=int, default=0)
    return ap


def _print_reports():
    for rep in collect_reports():
        if rep.component == "backend":
            print(f"backend fallback: {rep.detail('requested')} -> {rep.detail('selected')} "
                  f"({rep.reason}) at {rep.where}")
        elif rep.component == "compact_seam":
            print(f"compact seam at {rep.where}: "
                  + (f"taken (fused forward: {rep.detail('fused_fwd')})" if rep.eligible
                     else f"not taken ({rep.reason})"))
        elif rep.component == "ring":
            print(f"ring at {rep.where}: "
                  + (f"taken ({rep.detail('transport')})" if rep.eligible
                     else f"not taken ({rep.reason})"))
        elif rep.component == "remat" and not rep.eligible:
            print(f"remat {rep.detail('requested')} applied as {rep.detail('applied')} at "
                  f"{rep.where} ({rep.reason})")


def _train(args, ckpt_dir):
    """Build the mesh (if any) and run the supervised loop; rank 0 prints."""
    if args.mesh != "debug":
        mesh = make_production_mesh(multi_pod=args.mesh == "multi-pod")
    elif dist.is_available() and dist.is_initialized():
        mesh = make_debug_mesh(model=args.tp, seq=args.ring)
    else:
        mesh = None
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    overrides = {"backend": args.attn_backend, "tp": args.tp}
    for key in ("remat", "bwd_emit", "fwd_fuse"):
        if getattr(args, key) is not None:
            overrides[key] = getattr(args, key)
    if args.ring > 1:
        overrides["ring"] = True
    policy = TrainPolicy.from_model(cfg, **overrides)
    ocfg = OptimizerConfig(lr=args.lr, warmup_steps=max(args.steps // 10, 2),
                           total_steps=args.steps)
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq_len,
                      global_batch=args.batch, seed=args.seed)
    tcfg = TrainerConfig(total_steps=args.steps, log_every=max(args.steps // 10, 1),
                         seed=args.seed, policy=policy, ft=FTConfig(ckpt_dir=ckpt_dir))
    lead = mesh is None or mesh.rank == 0
    specs = None
    if mesh is not None:
        shapes = param_tree(cfg, device="meta")
        specs = S.param_specs(shapes, cfg, mesh, mode="tp")
        state = 12 * sum(math.prod(s) for _, s in named_leaves(
            S.shardings_of(shapes, specs, mesh)))
        if lead:
            print(f"state a rank (f32 parameters + AdamW m, v, by param_specs 'tp' on "
                  f"{mesh.shape}): {state} B")
    with contextlib.ExitStack() as stack:
        if mesh is not None:
            stack.enter_context(axis_rules(mesh))
        if not lead:             # one log: rank 0's
            stack.enter_context(contextlib.redirect_stdout(io.StringIO()))
        history = Trainer(cfg, ocfg, dcfg, tcfg, device=args.device, specs=specs).train()
    if lead:
        print(f"done: final loss {history[-1]['loss']:.4f}"
              + ("" if mesh is None else f" (mesh {mesh.shape})"))
        _print_reports()
    return history


def main(argv=None):
    args = _parser().parse_args(argv)
    if args.mesh != "debug" and (args.tp > 1 or args.ring > 1):
        raise SystemExit("--tp/--ring shape the debug mesh only; production meshes fix "
                         "their own axes (launch/mesh.py)")
    world = args.tp * args.ring
    with tempfile.TemporaryDirectory(prefix="repro_torch_ckpt_") as ckpt_dir:
        if args.mesh == "debug" and world > 1 and not (dist.is_available()
                                                       and dist.is_initialized()):
            device = "cpu" if args.device == "cpu" else "cuda"
            return spawn(_train, world, device=device, args=(args, ckpt_dir),
                         seed=args.seed)[0]
        return _train(args, ckpt_dir)


if __name__ == "__main__":
    main()
