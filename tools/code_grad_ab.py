"""A/B of code_grad_dx / code_grad_dw (PERF.md rows 8 and 9) between two
checkouts, on one card: both rows at gpt2-small's compact seam (12 heads x
8,192 tokens, m 768, d 64, k 8: code widths 8 and 16) through
``chip_smoke.py``'s ``phase_code_grad`` (every body held against its plain
version there), both rows at llama3.2-3b's seam shape (LL: x 8 x 1024 x
3072, 24 heads, d 128, k 16, code width 32, duplicates on every 7th row),
and llama3.2-3b's seam training step (4 of 28 layers, batch 8 x 1024,
bf16, compact2, remat "codes").

    python3 tools/code_grad_ab.py OTHER           # runs OTHER, this tree, this tree, OTHER
    python3 tools/code_grad_ab.py --one CHECKOUT  # one run, in CHECKOUT

Each run is a process of its own that imports CHECKOUT's ``chip_smoke.py``
(which puts CHECKOUT's ``src`` first on ``sys.path``) and builds that
checkout's kernels into its own ``build/``. The LL rows run the
checkout's wrappers on the same seeded inputs in every run, held against
the plain versions (rtol 1e-4, atol 1e-4 of the largest output), and
record which body ran; the training step's launches and bodies are
predicted from the checkout's own ``tensor_core_body``. Its last line is
one JSON object: per shape and row the device ms per call (and the
kernels one call launches), plain, library and bound ms; llama's step ms,
tokens/s, busy share and peak GiB. The A/B writes each run's output to
``chiprun_out/code_grad_ab_run<i>.log`` and prints each run's object and,
last, the card's name and power limit. Unpack the other checkout inside a
directory that ``.gitignore`` lists (``git archive``), so the chip call
copies it.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

LL = dict(b=8, n=1024, h=24, d=128, k=16, m=3072)


def ll_rows(cs) -> dict:
    """Rows 8 and 9 at llama3.2-3b's seam shape through the checkout's
    wrappers: checked against the plain versions, then timed beside them
    and the library call (scatter_code_grads + torch.einsum)."""
    import numpy as np
    import torch
    from repro_torch.kernels import body_counts, code_grad_dw, code_grad_dx, reset_launches
    from repro_torch.kernels.ops import head_blocks
    from repro_torch.kernels.ref import code_grad_dw_ref, code_grad_dx_ref, scatter_code_grads
    rs = np.random.RandomState(cs.SEED + 31)
    ntok, h, d, k, m = LL["b"] * LL["n"], LL["h"], LL["d"], LL["k"], LL["m"]
    kw, es = 2 * k, 2
    w = (0.02 * torch.from_numpy(rs.randn(m, 3 * h * d).astype(np.float32))).cuda()
    wq = head_blocks(w, 0, h, d)
    xx = torch.from_numpy(rs.randn(ntok, m).astype(np.float32)).cuda().bfloat16()
    vals = torch.from_numpy(rs.randn(h, ntok, kw).astype(np.float32)).cuda().bfloat16()
    idx = torch.from_numpy(np.sort(np.argsort(rs.rand(h, ntok, d), -1)[..., :kw], -1)
                           .astype(np.int32)).cuda()
    idx[:, 3::7, 1] = idx[:, 3::7, 0]          # duplicates sum (pair closures)
    codes = h * ntok * kw * (es + 4)
    ops_s = cs.code_product_s(2 * ntok * m * h * kw, 2 * ntok * m * h * d)
    out = {}
    for name, kern, plain, lib, io_bytes in (
            ("code_grad_dx", lambda: code_grad_dx(vals, idx, wq, d=d),
             lambda: code_grad_dx_ref(vals, idx, wq, d=d),
             lambda: torch.einsum("hnd,hmd->nm", scatter_code_grads(vals, idx, d).float(), wq),
             h * m * d * 4 + ntok * m * 4),
            ("code_grad_dw", lambda: code_grad_dw(xx, vals, idx, d=d),
             lambda: code_grad_dw_ref(xx, vals, idx, d=d),
             lambda: torch.einsum("nm,hnd->hmd", xx.float(),
                                  scatter_code_grads(vals, idx, d).float()),
             ntok * m * es + h * m * d * 4)):
        reset_launches()
        got = kern()
        body = "cuda_core" if body_counts()[f"{name}_cuda_core"] else "tensor_core"
        want = plain()
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4 * want.abs().max().item(),
                                   msg=f"{name} LL")
        del got, want
        b_ms, b_by = cs.bound(codes + io_bytes, ops_s)
        r = dict(max_abs_err=err, bound_ms=b_ms, bound_by=b_by, body=body,
                 **cs.timings(kern, plain, lib))
        print(f"[{name}] LL: bf16 codes {h} x {ntok} x {kw}, m {m}, d {d} ({body} body): "
              f"{cs.fmt(r)}", flush=True)
        out[name] = r
        torch.cuda.empty_cache()
    return out


def one(checkout: Path) -> dict:
    sys.path.insert(0, str(checkout))
    import chip_smoke as cs
    import numpy as np
    import torch
    from repro_torch.kernels.code_grad import tensor_core_body

    cs.phase_device()
    cs.timed(cs.phase_build)
    rs = np.random.RandomState(cs.SEED)
    keys = cs.SHAPE_KEYS + ("kernels_ms",)
    gpt2 = dict(zip(("code_grad_dx", "code_grad_dw"), cs.timed(cs.phase_code_grad, rs)))
    ll = cs.timed(ll_rows, cs)
    cs.release()
    layers = 4
    bodies = ({} if tensor_core_body(torch.bfloat16, LL["d"], 2 * LL["k"], LL["m"])
              else {"code_grad_dx_cuda_core": 2 * layers, "code_grad_dw_cuda_core": 2 * layers})
    seam = {"proj_rtopk": 2, "flash_sfa_block_skip": 2, "flash_sfa_bwd_compact": 1,
            "code_grad_dx": 2, "code_grad_dw": 2}
    _, step = cs.timed(cs.phase_train, "llama3.2-3b", 2,
                       {name: n * layers for name, n in seam.items()}, layers=layers,
                       bodies=bodies, bwd_emit="compact2", fwd_fuse=True, remat="codes")
    return {"checkout": str(checkout), "llama": step,
            "gpt2": {name: {key: r[key] for key in keys} for name, r in gpt2.items()},
            "LL": {name: {key: r[key] for key in keys + ("body",)} for name, r in ll.items()}}


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
    logs = here / "chiprun_out"
    logs.mkdir(exist_ok=True)
    runs = []
    for i, tree in enumerate((other, here, here, other), 1):
        res = subprocess.run([sys.executable, __file__, "--one", str(tree)], text=True,
                             capture_output=True)
        (logs / f"code_grad_ab_run{i}.log").write_text(res.stdout + res.stderr)
        if res.returncode != 0:
            print(res.stdout[-4000:], res.stderr[-8000:], file=sys.stderr)
            raise SystemExit(f"the run in {tree} failed (exit {res.returncode})")
        runs.append(json.loads(res.stdout.strip().splitlines()[-1]))
        print(f"run {i} ({tree}): done; its output is in {logs.name}/code_grad_ab_run{i}.log",
              flush=True)
    for run in runs:
        print(json.dumps(run))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(smi.strip())


if __name__ == "__main__":
    main()
