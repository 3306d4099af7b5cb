"""Serving launcher: build a model and answer batched requests.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch gpt2-small-sfa8 \
        --requests 4 --max-new 16 --decode-backend cuda

Runs on the card (``--device cpu`` for the CPU). ``--reduced`` (the
default) serves the tiny same-family config; ``--no-reduced`` serves at full
width. Weights are random, from ``--seed``. ``--decode-backend`` selects the
decode attention path through the registry (``repro_torch/models/
backends.py``): ``cuda`` = the hand-written kernels, ``torch`` = the plain
oracle, ``auto`` = ``cuda`` wherever it can serve the layer. Backend
fallbacks and the at-rest cache bytes are printed at exit. The paged and
speculative engines of the JAX launcher come with a later slice.
"""
import argparse

import numpy as np

from repro_torch.configs import get_config
from repro_torch.core.kv_cache import kv_cache_nodes
from repro_torch.models.backends import fallback_reports
from repro_torch.models.model import init as model_init
from repro_torch.serve import DecodeEngine, EngineConfig


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gpt2-small-sfa8")
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-len", type=int, default=256)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--decode-backend", default=None,
                    choices=["torch", "cuda", "auto"])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reduced", action=argparse.BooleanOptionalAction, default=True,
                    help="serve the tiny same-family config (--no-reduced: full width)")
    ap.add_argument("--paged", action="store_true",
                    help="paged/block-KV engine (not ported yet)")
    ap.add_argument("--speculative", action="store_true",
                    help="self-speculative decoding (not ported yet)")
    args = ap.parse_args(argv)
    if args.paged:
        raise NotImplementedError("--paged: the paged engine comes with a later slice")
    if args.speculative:
        raise NotImplementedError("--speculative: speculative decoding comes "
                                  "with a later slice")

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    params = model_init(cfg, device=args.device, seed=args.seed)
    eng = DecodeEngine(params, cfg, EngineConfig(
        max_slots=max(args.requests, 2), max_len=args.max_len,
        temperature=args.temperature, seed=args.seed,
        decode_backend=args.decode_backend), device=args.device)
    rs = np.random.RandomState(args.seed)
    for _ in range(args.requests):
        prompt = rs.randint(0, cfg.vocab_size, size=rs.randint(4, 32)).astype(np.int64)
        eng.add_request(prompt, args.max_new)
    steps = 0
    while eng.live.any():
        eng.step()
        steps += 1
    for i in range(args.requests):
        print(f"slot {i}: {eng.outputs[i]}")
    print(f"{steps} batched decode steps, {sum(len(o) for o in eng.outputs)} tokens")
    layouts = sorted({type(n).__name__ for n in kv_cache_nodes(eng.caches)})
    print(f"kv cache at rest: {eng.cache_bytes() / 2**20:.2f} MiB ({', '.join(layouts)})")
    for rep in fallback_reports():
        print(f"backend fallback: {rep.requested} -> {rep.selected} "
              f"({rep.reason}) at {rep.where}")


if __name__ == "__main__":
    main()
