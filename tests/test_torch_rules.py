"""Rules of the port: no JAX, no ml_dtypes and nothing of ``repro`` in ``repro_torch``,
``chip_smoke.py``, the port's ``tools/`` or the rank functions the spawned test ranks import
(``tests/torch_dist_workers.py``); the package imports without JAX; entry points default
to the card and say so when there is none."""
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = re.compile(
    r"^\s*(import\s+jax\b|from\s+jax\b|import\s+ml_dtypes\b|from\s+ml_dtypes\b|"
    r"import\s+repro\b(?!_)|from\s+repro\.|from\s+repro\s+import\b)", re.MULTILINE)


def _port_files():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files += [ROOT / "chip_smoke.py", ROOT / "tests" / "torch_dist_workers.py"]
    return files + sorted((ROOT / "tools").glob("*.py"))


def test_rule_pattern_tells_repro_from_repro_torch():
    for line in ("import jax", "from jax import numpy", "import jax.numpy as jnp",
                 "import repro", "from repro.core import sparse",
                 "from repro import kernels", "  import repro.models", "import ml_dtypes",
                 "from ml_dtypes import bfloat16"):
        assert FORBIDDEN.search(line), line
    for line in ("import repro_torch", "from repro_torch.core import sparse",
                 "import jaxlike", "# import jax", "import torch"):
        assert not FORBIDDEN.search(line), line


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_repro_imports(path):
    assert path.exists(), path
    hits = FORBIDDEN.findall(path.read_text())
    assert not hits, f"{path.relative_to(ROOT)} imports {hits}"


def test_package_imports_without_jax():
    code = ("import sys; sys.modules['jax'] = None; sys.modules['repro'] = None; "
            "sys.modules['ml_dtypes'] = None\n"
            "import repro_torch, repro_torch.kernels, repro_torch.serve, "
            "repro_torch.interop, repro_torch.launch.serve, repro_torch.train, "
            "repro_torch.optim, repro_torch.data, repro_torch.launch.train, "
            "repro_torch.core.remat, repro_torch.kernels.code_grad, "
            "repro_torch.models.attention, repro_torch.serve.speculative, "
            "repro_torch.serve.kv_cache, repro_torch.kernels.flash_sfa_decode, "
            "repro_torch.core.reports, repro_torch.train.checkpoint, "
            "repro_torch.launch.specs, repro_torch.launch.dryrun, repro_torch.utils.roofline\n"
            "from repro_torch.kernels import _build\n"
            "assert not _build._LIBS\n")
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"}
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


def test_engine_without_device_needs_a_card():
    from repro_torch.configs import get_config
    from repro_torch.models.model import init
    from repro_torch.serve import DecodeEngine, EngineConfig
    cfg = get_config("gpt2-small-sfa8").reduced()
    model = init(cfg, device="cpu")
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device exists")
    with pytest.raises(RuntimeError, match="CUDA"):
        DecodeEngine(model, cfg, EngineConfig(max_slots=2, max_len=32))
    with pytest.raises(RuntimeError, match="CUDA"):
        init(cfg)


def test_trainer_without_device_needs_a_card():
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig
    from repro_torch.optim import OptimizerConfig
    from repro_torch.train import Trainer, TrainerConfig
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device exists")
    cfg = get_config("gpt2-small-sfa8").reduced()
    with pytest.raises(RuntimeError, match="CUDA"):
        Trainer(cfg, OptimizerConfig(), DataConfig(cfg.vocab_size, 16, 2), TrainerConfig())


def test_kernel_wrappers_refuse_grad_outside_their_function():
    """A wrapper's output has no grad_fn: given a tensor that requires grad
    it raises, on either device, instead of dropping the gradient; the
    autograd Functions of kernels.ops are the way to differentiate."""
    from repro_torch.kernels import (
        code_grad_dw, code_grad_dx, flash_attention, flash_attention_bwd, flash_sfa,
        flash_sfa_bwd, flash_sfa_decode, flash_sfa_decode_fm, flash_sfa_decode_fm_paged,
        flash_sfa_decode_multi, flash_sfa_decode_paged, proj_rtopk, rtopk,
    )
    x = torch.randn(2, 8, 16, requires_grad=True)
    idx = torch.zeros(2, 8, 4, dtype=torch.int32)
    lse = torch.zeros(2, 8)
    pool = torch.randn(1, 3, 8, 16, requires_grad=True)     # (hkv, P, page, F)
    pidx = torch.zeros(1, 3, 8, 4, dtype=torch.uint8)
    bt = torch.ones(2, 1, dtype=torch.int32)
    calls = [lambda: rtopk(x, 4), lambda: flash_attention(x, x, x),
             lambda: flash_attention_bwd(x, x, x, x, lse, x),
             lambda: flash_sfa(x[..., :4], idx, x[..., :4], idx, x, d=16),
             lambda: flash_sfa_bwd(x[..., :4], idx, x[..., :4], idx, x, x, lse, x, d=16),
             lambda: flash_sfa_decode(x[:, 0], x[..., :4], idx, x, torch.ones(2), d=16),
             lambda: flash_sfa(x[..., :4], idx, x[..., :4], idx, x, d=16, block_skip=True),
             lambda: flash_sfa_bwd(x[..., :4], idx, x[..., :4], idx, x, x, lse, x, d=16,
                                   emit="compact"),
             lambda: proj_rtopk(x, x.transpose(1, 2), k=4),
             lambda: code_grad_dx(x[..., :4], idx, x, d=16),
             lambda: code_grad_dw(x[0], x[..., :4], idx, d=16),
             lambda: flash_sfa_decode_paged(x[:, 0], pool[..., :4], pidx, pool, bt,
                                            torch.ones(2), d=16, heads=1),
             lambda: flash_sfa_decode_multi(x[:, 0], x[..., :4], idx, x, torch.ones(2),
                                            d=16),
             lambda: flash_sfa_decode_fm(x[:, 0, :4], idx[:, 0], x.transpose(1, 2), x,
                                         torch.ones(2)),
             lambda: flash_sfa_decode_fm_paged(x[:, 0, :4], idx[:, 0], pool.transpose(2, 3),
                                               pool, bt, torch.ones(2))]
    for call in calls:
        with pytest.raises(RuntimeError, match="not differentiable"):
            call()
    with torch.no_grad():
        rtopk(x, 4)


def test_kernel_wrappers_refuse_other_devices():
    from repro_torch.kernels import (
        code_grad_dw, code_grad_dx, flash_sfa_decode, flash_sfa_decode_fm,
        flash_sfa_decode_fm_paged, flash_sfa_decode_multi, flash_sfa_decode_paged,
        proj_rtopk, rtopk,
    )
    x = torch.zeros(2, 8, device="meta")
    x3 = torch.zeros(2, 8, 8, device="meta")
    x4 = torch.zeros(1, 3, 8, 8, device="meta")
    bt = torch.ones(2, 1, dtype=torch.int32, device="meta")
    for call in (lambda: flash_sfa_decode_paged(x, x4, x4, x4, bt, x[:, 0], d=8),
                 lambda: flash_sfa_decode_multi(x, x3, x3, x3, x[:, 0], d=8),
                 lambda: flash_sfa_decode_fm(x, x, x3, x3, x[:, 0]),
                 lambda: flash_sfa_decode_fm_paged(x, x, x4, x4, bt, x[:, 0])):
        with pytest.raises(ValueError, match="cuda or cpu"):
            call()
    with pytest.raises(ValueError, match="cuda or cpu"):
        rtopk(x, 2)
    with pytest.raises(ValueError, match="cuda or cpu"):
        flash_sfa_decode(x, x, x, x, x, d=8)
    with pytest.raises(ValueError, match="cuda or cpu"):
        proj_rtopk(x3, x3, k=2)
    with pytest.raises(ValueError, match="cuda or cpu"):
        code_grad_dx(x3, x3, x3, d=8)
    with pytest.raises(ValueError, match="cuda or cpu"):
        code_grad_dw(x, x3, x3, d=8)
