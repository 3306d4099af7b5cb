"""Training launcher: train a model on the synthetic Markov stream.

    PYTHONPATH=src python -m repro_torch.launch.train --arch gpt2-small-sfa8 \
        --steps 20 [--reduced | --no-reduced] [--attn-backend cuda]

Runs on the card (``--device cpu`` for the CPU). ``--reduced`` (the
default) trains the tiny same-family config; ``--no-reduced`` (or
``--full``) trains at full width. Weights are random, from ``--seed``.
``--attn-backend`` selects the full-sequence attention path through the
registry (``repro_torch/models/backends.py``): ``cuda`` = the hand-written
kernels forward and backward, ``torch`` = the plain oracle, ``auto`` =
``cuda`` wherever it can serve the layer. ``--remat full`` recomputes each
layer in the backward. Backend fallbacks are printed at exit.

Not ported yet, and refused with the ROADMAP item that brings them: the
production meshes and ``--tp``/``--ring`` > 1 (A.6), the compact backward
emits and ``--remat codes`` (A.3).
"""
import argparse

from repro_torch.configs import get_config
from repro_torch.configs.base import TrainPolicy
from repro_torch.data import DataConfig
from repro_torch.models.backends import fallback_reports
from repro_torch.optim import OptimizerConfig
from repro_torch.train import Trainer, TrainerConfig


def main(argv=None):
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
    ap.add_argument("--tp", type=int, default=1)
    ap.add_argument("--ring", type=int, default=1)
    ap.add_argument("--attn-backend", default=None, choices=["torch", "cuda", "auto"],
                    help="override cfg.attention.backend for the step")
    ap.add_argument("--bwd-emit", default=None, choices=["dense", "compact", "compact2"])
    ap.add_argument("--remat", default=None, choices=["none", "full", "codes"],
                    help="per-layer checkpointing: none = keep every "
                         "activation; full = recompute each layer in the backward")
    ap.add_argument("--device", default=None, help="torch device (default: the card)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if args.mesh != "debug" or args.tp > 1 or args.ring > 1:
        raise NotImplementedError("production meshes and --tp/--ring > 1 are "
                                  "distribution work, ROADMAP A.6")
    if args.bwd_emit in ("compact", "compact2"):
        raise NotImplementedError(f"--bwd-emit {args.bwd_emit} is the compact "
                                  f"training seam, ROADMAP A.3")
    if args.remat == "codes":
        raise NotImplementedError("--remat codes is the compact training seam, "
                                  "ROADMAP A.3")

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    overrides = {"backend": args.attn_backend}
    if args.remat is not None:
        overrides["remat"] = args.remat
    policy = TrainPolicy.from_model(cfg, **overrides)
    ocfg = OptimizerConfig(lr=args.lr, warmup_steps=max(args.steps // 10, 2),
                           total_steps=args.steps)
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq_len,
                      global_batch=args.batch, seed=args.seed)
    trainer = Trainer(cfg, ocfg, dcfg, TrainerConfig(
        total_steps=args.steps, log_every=max(args.steps // 10, 1),
        seed=args.seed, policy=policy), device=args.device)
    history = trainer.train()
    print(f"done: final loss {history[-1]['loss']:.4f}")
    for rep in fallback_reports():
        print(f"backend fallback: {rep.requested} -> {rep.selected} "
              f"({rep.reason}) at {rep.where}")


if __name__ == "__main__":
    main()
