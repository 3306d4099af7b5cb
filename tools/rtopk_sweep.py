"""Time rtopk (PERF.md row 1) at the three shapes of its main paths, and
variants of its one-thread body, on one card. ``chip_smoke.py`` checks and
times the kernel as the port ships it; this script is for design sweeps
and A/B calls.

    python3 tools/rtopk_sweep.py             # this tree: the kernel, then the variants
    python3 tools/rtopk_sweep.py --tree SRC  # the port under SRC, another checkout's src

Either way it prints chip_smoke's ``rtopk_shapes`` lines: d 64, k 8, bf16
and f32, on tie-heavy rows at 96, 12,288 and 98,304 rows, the codes equal
and bit-equal to ``rtopk_ref``'s, with the kernel's, plain and library
times and the byte bound. Without ``--tree`` it then builds a library of
variants from this tree's ``csrc/rtopk.cu`` (the source included whole,
plus one entry point that picks lanes a row in {1, 2, 4, 8} and threads a
block in {64, 128, 256}) and times each variant and the warp body at each
shape and dtype, each one's codes checked against ``rtopk_ref``'s. Every
library, another tree's too, is built under this checkout's ``build/``.
"""
from __future__ import annotations

import argparse
import ctypes
import hashlib
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke as cs  # noqa: E402  (puts this tree's src on sys.path)

LANES = (1, 2, 4, 8)
THREADS = (64, 128, 256)

VARIANTS_CU = r"""
#include "rtopk.cu"

namespace {
template <int L, typename T>
int variant_threads(const void* x, void* vals, int32_t* idx, int rows, int k, int threads,
                    cudaStream_t s) {
  if (threads == 64) return by_k<64, L, 64, T>(x, vals, idx, rows, k, s);
  if (threads == 128) return by_k<64, L, 128, T>(x, vals, idx, rows, k, s);
  return by_k<64, L, 256, T>(x, vals, idx, rows, k, s);
}

template <typename T>
int variant(const void* x, void* vals, int32_t* idx, int rows, int k, int lanes, int threads,
            cudaStream_t s) {
  if (lanes == 1) return variant_threads<1, T>(x, vals, idx, rows, k, threads, s);
  if (lanes == 2) return variant_threads<2, T>(x, vals, idx, rows, k, threads, s);
  if (lanes == 4) return variant_threads<4, T>(x, vals, idx, rows, k, threads, s);
  return variant_threads<8, T>(x, vals, idx, rows, k, threads, s);
}
}  // namespace

// the one-thread body at d 64, k <= 16, with `lanes` lanes a row and
// `threads` threads a block; arguments as rtopk_launch's
extern "C" int rtopk_variant_launch(const void* x, void* vals, void* idx, int rows, int k,
                                    int is_bf16, int lanes, int threads, void* stream) {
  cudaGetLastError();
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int32_t* ip = static_cast<int32_t*>(idx);
  return is_bf16 ? variant<uint16_t>(x, vals, ip, rows, k, lanes, threads, s)
                 : variant<uint32_t>(x, vals, ip, rows, k, lanes, threads, s);
}
"""


def build_variants():
    """The variants' library, built from this tree's csrc/rtopk.cu (named
    by its hash, as ``_build.library_path`` names the kernel's)."""
    from repro_torch.kernels import _build
    out = ROOT / "build" / "rtopk_sweep"
    out.mkdir(parents=True, exist_ok=True)
    (out / "variants.cu").write_text(VARIANTS_CU)
    tag = hashlib.sha256((VARIANTS_CU + _build.library_path("rtopk").name).encode())
    lib = out / f"librtopk_variants-{tag.hexdigest()[:16]}.so"
    if not lib.exists():
        res = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o",
                              str(lib), str(out / "variants.cu")],
                             capture_output=True, text=True, timeout=900)
        cs.check(res.returncode == 0, f"nvcc failed on the variants:\n{res.stdout}{res.stderr}")
    dll = ctypes.CDLL(str(lib))
    variant = dll.rtopk_variant_launch
    variant.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    launch = dll.rtopk_launch
    launch.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    return variant, launch


def sweep(k=8, d=64):
    """Every variant and the warp body at each shape and dtype: codes equal
    rtopk_ref's (indices equal, values bit-equal), device ms per call."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.ref import rtopk_ref
    variant, launch = build_variants()
    rs = np.random.RandomState(cs.SEED + 21)

    def run(x, lanes, threads):
        vals = torch.empty(x.shape[0], k, dtype=x.dtype, device=x.device)
        idx = torch.empty(x.shape[0], k, dtype=torch.int32, device=x.device)
        bf16 = int(x.dtype == torch.bfloat16)
        if lanes == 0:   # the warp body
            err = launch(x.data_ptr(), vals.data_ptr(), idx.data_ptr(), x.shape[0], d, k, bf16,
                         0, _build.stream_ptr(x))
        else:
            err = variant(x.data_ptr(), vals.data_ptr(), idx.data_ptr(), x.shape[0], k, bf16,
                          lanes, threads, _build.stream_ptr(x))
        cs.check(err == 0, f"rtopk variant {lanes} x {threads}: error {err}")
        return vals, idx

    for shape, rows in cs.RTOPK_SHAPES:
        x32 = torch.from_numpy(cs._tie_rows(rs, rows, d)).cuda()
        for x in (x32, x32.bfloat16()):
            pv, pi = rtopk_ref(x, k)
            bits = torch.int16 if x.dtype == torch.bfloat16 else torch.int32
            times = []
            for lanes, threads in [(a, b) for a in LANES for b in THREADS] + [(0, 256)]:
                vv, vi = run(x, lanes, threads)
                torch.cuda.synchronize()
                cs.check(torch.equal(vi, pi) and torch.equal(vv.view(bits), pv.view(bits)),
                         f"rtopk variant {lanes} x {threads}, {shape} {x.dtype}: codes differ")
                ms = cs.kernel_ms(lambda x=x, a=lanes, b=threads: run(x, a, b))
                times.append(f"{f'{lanes}x{threads}' if lanes else 'warp body'} {ms:.4f}")
            print(f"[sweep] {shape} {x.dtype} rows={rows} d={d} k={k} (lanes a row x threads "
                  f"a block: device ms; codes equal rtopk_ref's): {'; '.join(times)}", flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", help="time the port under this src directory instead")
    args = ap.parse_args()
    if args.tree:
        sys.path.insert(0, str(Path(args.tree).resolve()))
    cs.phase_device()
    from repro_torch.kernels import _build
    _build.BUILD_DIR = ROOT / "build" / "kernels"
    _build.library("rtopk")
    print(f"[sweep] rtopk of {_build.CSRC.parent.parent}", flush=True)
    cs.rtopk_shapes(np.random.RandomState(cs.SEED), np.random.RandomState(cs.SEED + 20))
    if not args.tree:
        sweep()


if __name__ == "__main__":
    main()
