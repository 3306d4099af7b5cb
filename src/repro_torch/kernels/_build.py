"""Build the CUDA sources under ``repro_torch/csrc`` and bind them by ctypes.

Each ``csrc/<name>.cu`` exposes plain C entry points and compiles on its own
with ``nvcc -gencode arch=compute_90a,code=sm_90a`` into a shared library,
which ``ctypes`` loads (no PyTorch headers, so a build takes seconds). The
libraries go into ``build/kernels/`` at the root of the checkout, one file
per source, named by a hash of the source, the shared headers and the
flags, so an edited source or header is rebuilt and an unchanged one is
reused. ``build_all`` starts one ``nvcc`` per source, all at once.

Nothing here runs at import: the package imports with neither ``nvcc`` nor
a GPU, and the CPU paths never reach the build. ``refuse_grad`` is the one
check here that every wrapper runs on either device.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = ("rtopk", "flash_sfa", "flash_sfa_decode", "flash_sfa_decode_fm",
           "flash_sfa_bwd", "flash_attention", "flash_sfa_tc", "flash_sfa_tc_wide",
           "proj_rtopk", "proj_rtopk_wide", "code_grad", "code_grad_wide")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v", "-lineinfo")

_LIBS: dict[str, ctypes.CDLL] = {}
_ENTRIES: dict = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found (neither on PATH nor under CUDA_HOME): "
                       "the CUDA kernels of repro_torch cannot be built")


def library_path(name: str) -> Path:
    """Where ``csrc/<name>.cu`` builds to: named by a hash of the source,
    every shared header ``csrc/*.cuh`` (any source may include one) and the
    flags, so an edit to any of them builds anew."""
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def _start(name: str, nvcc: str):
    """Start nvcc for one source; None when the library is already built."""
    out = library_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.parent / f"tmp{os.getpid()}-{out.name}"
    cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out, time.perf_counter()


def _wait(name: str, started) -> str | None:
    """Wait for one nvcc; the error text if it failed, else None. The log
    (ptxas's lines) ends with the compile's wall seconds."""
    proc, tmp, out, t0 = started
    log, _ = proc.communicate()
    log += f"nvcc wall {time.perf_counter() - t0:.1f} s\n"
    out.with_suffix(".log").write_text(log)
    if proc.returncode != 0:
        return f"nvcc failed on csrc/{name}.cu (exit {proc.returncode}):\n{log}"
    os.replace(tmp, out)
    return None


def _finish(name: str, started) -> None:
    err = _wait(name, started)
    if err is not None:
        raise RuntimeError(err)


def build_all() -> dict[str, str]:
    """Build every source in parallel; returns {name: ptxas/nvcc log}.
    Every nvcc started is waited for before a failure is raised."""
    nvcc = _nvcc()
    started = {name: _start(name, nvcc) for name in SOURCES}
    # one waiting thread per nvcc, so each log records its own compile's wall
    with ThreadPoolExecutor(len(SOURCES)) as pool:
        waits = [pool.submit(_wait, name, st) for name, st in started.items() if st is not None]
        errors = [err for w in waits for err in [w.result()] if err is not None]
    if errors:
        raise RuntimeError("\n".join(errors))
    return {name: library_path(name).with_suffix(".log").read_text()
            for name in SOURCES}


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        if not library_path(name).exists():
            _finish(name, _start(name, _nvcc()))
        lib = ctypes.CDLL(str(library_path(name)))
        lib.sfa_error_string.argtypes = [ctypes.c_int]
        lib.sfa_error_string.restype = ctypes.c_char_p
        _LIBS[name] = lib
    return lib


def entry(name: str, symbol: str, argtypes: list):
    """The C entry point ``symbol`` of ``csrc/<name>.cu``, with its argument
    types declared (pointers and the stream as ``c_void_p``) and an int
    return: the ``cudaError_t`` of the launch."""
    fn = _ENTRIES.get((name, symbol))
    if fn is None:
        fn = getattr(library(name), symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _ENTRIES[(name, symbol)] = fn
    return fn


def check(name: str, err: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error (launch refused)."""
    if err != 0:
        msg = library(name).sfa_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


def refuse_grad(what: str, *tensors) -> None:
    """Raise if a wrapper is asked to differentiate: its output has no
    ``grad_fn``, so a gradient would be dropped without a word. The
    differentiable entry points are the autograd Functions of
    ``kernels/ops.py`` and ``models/attention.py``, inside which grad mode
    is off."""
    import torch
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad
                                       for t in tensors):
        raise RuntimeError(
            f"{what} is not differentiable by itself: call it through "
            f"kernels.ops (sfa_attention_op / dense_attention_op), the compact "
            f"seam of models.attention, or under torch.no_grad()")


def tma_operand(t):
    """``t`` contiguous and 16-byte aligned, as a TMA tensor map needs its
    base (a copy only for a view that starts off the boundary)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def stream_ptr(t) -> ctypes.c_void_p:
    """PyTorch's current stream on the tensor's device, as a pointer."""
    import torch
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)
