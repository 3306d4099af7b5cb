"""Serving launcher: build a model and answer batched requests.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch gpt2-small-sfa8 \
        --requests 4 --max-new 16 --decode-backend cuda

    # paged engine: shared page pool, 64 MiB budget, chunked prefill
    PYTHONPATH=src python -m repro_torch.launch.serve --paged \
        --mem-budget-mb 64 --prefill-chunk 128

Runs on the card (``--device cpu`` for the CPU). ``--reduced`` (the
default) serves the tiny same-family config; ``--no-reduced`` serves at full
width. Weights are random, from ``--seed``. ``--decode-backend`` selects the
decode attention path through the registry (``repro_torch/models/
backends.py``): ``cuda`` = the token-major kernels, ``cuda_fm`` = the
feature-major kernels on the persistent ``FeatureMajorKV`` image (the cache
layout follows the backend), ``torch`` = the plain oracle, ``auto`` =
``cuda`` wherever it can serve the layer. ``--fm-debug`` checks the
persistent image against its recomputed form every ``cuda_fm`` step (a
correctness tool: it re-derives the image each step).

``--paged`` serves through ``PagedDecodeEngine``: block-table KV over a
shared page pool (``--page-size`` tokens a page) sized by
``--mem-budget-mb`` (default: full residency), with chunked prefill of
``--prefill-chunk`` tokens a tick. Requests beyond the slots or pages queue
(FCFS); decode-time page exhaustion preempts the youngest request
(recompute on resume, greedy streams unchanged).

``--speculative`` (implies ``--paged``) serves through
``SpeculativeDecodeEngine``: each tick drafts ``--draft-len`` tokens on the
top-``--draft-k`` sub-codes (default k/4), verifies them in one full-k pass
and accepts the longest matching prefix plus the bonus token. Greedy only;
acceptance statistics print at exit.

Backend fallbacks and the at-rest cache bytes (and a recurrent family's
state bytes) are printed at exit. The recurrent families (``--arch
jamba-v0.1-52b``, ``rwkv6-3b``) serve through the slot engine only:
``--paged`` and ``--speculative`` raise the reference's errors.
"""
import argparse

import numpy as np

from repro_torch.configs import get_config
from repro_torch.core.kv_cache import kv_cache_nodes
from repro_torch.models.backends import fallback_reports, set_fm_debug
from repro_torch.models.model import init as model_init
from repro_torch.serve import (
    DecodeEngine, EngineConfig, PagedDecodeEngine, PagedEngineConfig,
    SpeculativeDecodeEngine, SpeculativeEngineConfig,
)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gpt2-small-sfa8")
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-len", type=int, default=256)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--decode-backend", default=None,
                    choices=["torch", "cuda", "cuda_fm", "auto"])
    ap.add_argument("--fm-debug", action="store_true",
                    help="check the persistent feature-major K image against its "
                         "recomputed form every cuda_fm step")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reduced", action=argparse.BooleanOptionalAction, default=True,
                    help="serve the tiny same-family config (--no-reduced: full width)")
    ap.add_argument("--paged", action="store_true",
                    help="serve through the paged/block-KV engine")
    ap.add_argument("--page-size", type=int, default=128, help="tokens per pool page")
    ap.add_argument("--mem-budget-mb", type=float, default=None,
                    help="KV pool byte budget; smaller budgets queue admissions and "
                         "preempt on page exhaustion (default: full residency)")
    ap.add_argument("--prefill-chunk", type=int, default=None,
                    help="chunked prefill: tokens landed per engine tick "
                         "(default: whole-prompt)")
    ap.add_argument("--speculative", action="store_true",
                    help="self-speculative decoding on the paged engine "
                         "(greedy only; implies --paged)")
    ap.add_argument("--draft-len", type=int, default=4,
                    help="tokens drafted per speculative engine tick")
    ap.add_argument("--draft-k", type=int, default=None,
                    help="draft-pass sparse k' (default: sfa_k // 4)")
    args = ap.parse_args(argv)

    if args.fm_debug:
        set_fm_debug(True)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    params = model_init(cfg, device=args.device, seed=args.seed)
    paged = args.paged or args.speculative
    slots = max(args.requests, 2)
    if paged:
        budget = None if args.mem_budget_mb is None else int(args.mem_budget_mb * 2**20)
        common = dict(max_slots=slots, max_len=args.max_len, page_size=args.page_size,
                      mem_budget_bytes=budget, prefill_chunk=args.prefill_chunk,
                      temperature=args.temperature, seed=args.seed,
                      decode_backend=args.decode_backend)
        if args.speculative:
            eng = SpeculativeDecodeEngine(params, cfg, SpeculativeEngineConfig(
                **common, draft_len=args.draft_len, draft_k=args.draft_k),
                device=args.device)
        else:
            eng = PagedDecodeEngine(params, cfg, PagedEngineConfig(**common),
                                    device=args.device)
    else:
        eng = DecodeEngine(params, cfg, EngineConfig(
            max_slots=slots, max_len=args.max_len, temperature=args.temperature,
            seed=args.seed, decode_backend=args.decode_backend), device=args.device)
    rs = np.random.RandomState(args.seed)
    ids = []
    for _ in range(args.requests):
        prompt = rs.randint(0, cfg.vocab_size, size=rs.randint(4, 32)).astype(np.int64)
        ids.append(eng.add_request(prompt, args.max_new))
    steps = 0
    while eng.busy if paged else eng.live.any():
        eng.step()
        steps += 1
    for i in ids:
        print(f"{'request' if paged else 'slot'} {i}: {eng.outputs[i]}")
    total = sum(len(eng.outputs[i]) for i in ids)
    if paged:
        print(f"{steps} engine ticks, {total} tokens, {eng.num_pages - 1} pool pages x "
              f"{eng.ecfg.page_size} tokens, {eng.preemptions} preemptions, final page "
              f"utilization {eng.page_utilization():.2f}")
        if args.speculative:
            s = eng.spec_stats
            print(f"speculative: draft_len={eng.ecfg.draft_len} draft_k={eng.draft_k} "
                  f"alpha={s['alpha']:.2f} accepted-tokens/step={s['acc_per_step']:.2f}")
    else:
        print(f"{steps} batched decode steps, {total} tokens")
    layouts = sorted({type(n).__name__ for n in kv_cache_nodes(eng.caches)})
    print(f"kv cache at rest: {eng.cache_bytes() / 2**20:.2f} MiB ({', '.join(layouts)})")
    if not paged and eng.state_bytes():
        print(f"recurrent state: {eng.state_bytes() / 2**20:.2f} MiB")
    for rep in fallback_reports():
        print(f"backend fallback: {rep.requested} -> {rep.selected} "
              f"({rep.reason}) at {rep.where}")


if __name__ == "__main__":
    main()
