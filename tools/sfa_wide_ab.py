"""A/B of FlashSFA at the frontend families' head dims between two
checkouts, on one card: rows 3 and 5 (PERF.md) at hubert-xlarge's training
shape (HB: bh 8 x 16, n 1024, d = dv 80, k 16, bidirectional) and
paligemma-3b's prefill (PG: 8 heads, n 1024, d = dv 256, k 16, causal),
hubert-xlarge's training step (48 layers, batch 8 x 1024 seeded frames,
bf16, remat "full"), and rows 3-7 at their first shapes (d 64), whose
bodies share the tensor-core attention headers.

    python3 tools/sfa_wide_ab.py OTHER           # runs OTHER, this tree, this tree, OTHER
    python3 tools/sfa_wide_ab.py --one CHECKOUT  # one run, in CHECKOUT

Each run is a process of its own that imports CHECKOUT's ``chip_smoke.py``
(which puts CHECKOUT's ``src`` first on ``sys.path``), builds that
checkout's kernels into its own ``build/`` and runs its
``phase_flash_sfa``, ``phase_block_skip``, ``phase_flash_sfa_bwd``,
``phase_flash_attention`` and ``phase_frontend_shapes`` (every kernel held
against its plain version, as in ``chip_smoke.py``) and its hubert
``phase_train_frames`` (launches and bodies predicted from the checkout's
own ``tensor_core_body``). Its last line is one JSON object: per shape and
row the device ms per call, plain, library and bound ms; hubert's step
ms, frames/s, busy share and peak GiB. The A/B prints each run's object
and, last, the card's name and power limit. Unpack the other checkout
inside a directory that ``.gitignore`` lists (``git archive``), so the
chip call copies it.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROWS = ("flash_sfa", "flash_sfa_bwd")
SHAPES = ("HB", "PG")


def one(checkout: Path) -> dict:
    sys.path.insert(0, str(checkout))
    import chip_smoke as cs
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import COUNTERS
    from repro_torch.kernels.flash_sfa import tensor_core_body

    cs.phase_device()
    cs.timed(cs.phase_build)
    rs = np.random.RandomState(cs.SEED)
    first = {"flash_sfa": cs.timed(cs.phase_flash_sfa, rs),
             "flash_sfa_block_skip": cs.timed(cs.phase_block_skip, rs)}
    first["flash_sfa_bwd"], first["flash_sfa_bwd_compact"] = cs.timed(cs.phase_flash_sfa_bwd, rs)
    first["flash_attention"], first["flash_attention_bwd"] = cs.timed(cs.phase_flash_attention,
                                                                      rs)
    results = {name: dict({key: None for key in cs.SHAPE_KEYS}, max_abs_err=0.0)
               for name in COUNTERS}
    cs.timed(cs.phase_frontend_shapes, results)
    cs.release()
    hl = get_config("hubert-xlarge").num_layers
    bodies = {"rtopk_warp": 4 * hl}
    if not tensor_core_body(torch.bfloat16, 80, 80, 16, 16):
        bodies.update(flash_sfa_cuda_core=2 * hl, flash_sfa_bwd_cuda_core=hl)
    _, step = cs.timed(cs.phase_train_frames, "hubert-xlarge", 2,
                       {"rtopk": 4 * hl, "flash_sfa": 2 * hl, "flash_sfa_bwd": hl},
                       bodies=bodies)
    out = {"checkout": str(checkout),
           "hubert": dict(step, frames_s=8 * 1024 / step["step_ms"] * 1e3),
           "d64": {name: {key: r[key] for key in cs.SHAPE_KEYS} for name, r in first.items()}}
    for key in SHAPES:
        out[key] = {name: results[name]["shapes"][key] for name in ROWS
                    if key in results[name].get("shapes", {})}
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("other", nargs="?", help="the checkout to compare this tree with")
    ap.add_argument("--one", help="one run in this checkout")
    args = ap.parse_args()
    if args.one:
        print(json.dumps(one(Path(args.one).resolve())), flush=True)
        return
    if not args.other:
        ap.error("name the other checkout, or --one CHECKOUT")
    here = Path(__file__).resolve().parents[1]
    other = Path(args.other).resolve()
    runs = []
    for tree in (other, here, here, other):
        res = subprocess.run([sys.executable, __file__, "--one", str(tree)], text=True,
                             capture_output=True)
        print(res.stdout, flush=True)
        if res.returncode != 0:
            print(res.stderr, file=sys.stderr)
            raise SystemExit(f"the run in {tree} failed (exit {res.returncode})")
        runs.append(json.loads(res.stdout.strip().splitlines()[-1]))
    for run in runs:
        print(json.dumps(run))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(smi.strip())


if __name__ == "__main__":
    main()
