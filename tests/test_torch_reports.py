"""``repro_torch.core.reports`` against ``repro.core.reports``: the same
components, and for the same reduced configs and policies the same routing
decisions — component, site, eligibility, details and (where the packages
share it) the reason.

The JAX side is traced with ``jax.eval_shape`` (no compile) on parameter
shapes from the port's ``param_tree(..., device="meta")``; the port runs
one loss and backward on the CPU. The port's backend names stand where
JAX's do: "cuda" for "pallas", "torch" for "xla".
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.core import reports as jax_reports
from repro.models import loss_fn as jax_loss_fn
from repro_torch.configs import get_config
from repro_torch.core import reports
from repro_torch.core.remat import remat_reports
from repro_torch.kernels.rtopk import PROJ_HEAD_DIMS
from repro_torch.models.attention import compact_seam_reports
from repro_torch.models.backends import fallback_reports
from repro_torch.models.model import init, loss_fn, param_tree

NAMES = {"pallas": "cuda", "xla": "torch", "pallas_fm": "cuda_fm"}
B, N = 2, 32


def _cfg(get, arch, remat, attention):
    cfg = get(arch).reduced()
    return dataclasses.replace(cfg, remat=remat, attention=dataclasses.replace(
        cfg.attention, **attention))


def _jax_reports(arch, remat, attention):
    jc = _cfg(jax_get_config, arch, remat, attention)
    params = jax.tree.map(lambda t: jax.ShapeDtypeStruct(tuple(t.shape), jnp.float32),
                          param_tree(_cfg(get_config, arch, remat, {
                              k: NAMES.get(v, v) for k, v in attention.items()}),
                              device="meta"))
    batch = {k: jax.ShapeDtypeStruct((B, N), jnp.int32) for k in ("tokens", "labels")}
    jax_reports.clear_reports()
    jax.eval_shape(jax.value_and_grad(lambda p, b: jax_loss_fn(p, b, jc)[0]), params, batch)
    out = jax_reports.collect_reports()
    jax_reports.clear_reports()
    return out


def _torch_reports(arch, remat, attention):
    tc = _cfg(get_config, arch, remat, {k: NAMES.get(v, v) for k, v in attention.items()})
    model = init(tc, device="cpu", seed=0).requires_grad_(True)
    rs = np.random.RandomState(0)
    batch = {k: torch.from_numpy(rs.randint(0, tc.vocab_size, (B, N))) for k in
             ("tokens", "labels")}
    reports.clear_reports()
    loss_fn(model, batch, tc)[0].backward()
    return reports.collect_reports()


def _mapped(rep):
    """A JAX report with the port's backend names."""
    details = tuple((k, NAMES.get(v, v) if k in ("requested", "selected") else v)
                    for k, v in rep.details)
    reason = rep.reason
    for jname, tname in NAMES.items():
        reason = reason and reason.replace(f"'{jname}'", f"'{tname}'")
    return dataclasses.replace(rep, details=details, reason=reason)


# (arch, remat, attention fields in JAX's names, what the case shows)
CASES = [
    ("gpt2-small-sfa8", "codes", dict(backend="pallas", bwd_emit="compact", fwd_fuse=True),
     "the compact seam taken, with the fused forward; remat codes applied"),
    ("moonshot-v1-16b-a3b", "codes", dict(backend="pallas", bwd_emit="compact2"),
     "MoE: the seam taken; one remat record per segment (dense, then MoE)"),
    ("qwen3-0.6b-sfa8", "codes", dict(backend="pallas", bwd_emit="compact", fwd_fuse=True),
     "qk-norm declines the compact request"),
    ("gemma3-4b", "full", dict(backend="pallas"),
     "windowed layers fall back from the kernel backend to the oracle"),
    ("gpt2-small-sfa8", "codes", dict(backend="xla"),
     "remat codes on the oracle backend degrades to full"),
]


@pytest.mark.parametrize("arch, remat, attention, what", CASES,
                         ids=[f"{c[0]}-{c[2].get('bwd_emit', c[1])}-{c[2]['backend']}"
                              for c in CASES])
def test_collect_reports_match_the_reference(arch, remat, attention, what):
    want = [_mapped(r) for r in _jax_reports(arch, remat, attention)]
    got = list(_torch_reports(arch, remat, attention))
    assert want, what
    key = [(r.component, r.where, r.eligible, r.details) for r in got]
    assert key == [(r.component, r.where, r.eligible, r.details) for r in want], what
    for g, w in zip(got, want):
        if g.component == "remat" and not g.eligible:
            # the clause after the colon names each package's mechanism: JAX
            # tags saveables on its pallas paths, the port's Functions keep
            # the codes on its cuda paths
            assert g.reason.split(":")[0] == w.reason.split(":")[0]
        else:
            assert g.reason == w.reason, what
    reports.clear_reports()


@pytest.mark.parametrize("head_dim", [256, 96])
def test_head_dim_the_port_declines_is_reported_where_pallas_takes_it(head_dim):
    """Pallas's fused seam takes any d. The port's seam kernels take d in
    ``PROJ_HEAD_DIMS`` (32, 64, 80, 128, 256): at paligemma's own head dim
    of 256 both packages record the seam taken; at 96, which no CUDA body
    takes (a port limit, ROADMAP B.1), the port's record differs from the
    reference's: not eligible, with the head dim as its reason."""
    taken = head_dim in PROJ_HEAD_DIMS
    assert taken == (head_dim == get_config("paligemma-3b").attention.head_dim)
    attention = dict(backend="pallas", bwd_emit="compact", head_dim=head_dim)
    (jseam,) = [r for r in _jax_reports("paligemma-3b", "full", attention)
                if r.component == "compact_seam"]
    (tseam,) = [r for r in _torch_reports("paligemma-3b", "full", attention)
                if r.component == "compact_seam"]
    assert jseam.eligible and jseam.where == tseam.where
    assert tseam.eligible == taken
    assert taken or str(head_dim) in tseam.reason
    reports.clear_reports()


def test_components_filters_and_native_accessors():
    """The reference's four components; a component's query and clear touch
    that component alone; the native accessors read the same records."""
    assert reports.components() == jax_reports.components() == (
        "backend", "compact_seam", "remat", "ring")
    got = _torch_reports("gpt2-small-sfa8", "codes",
                         dict(backend="pallas", bwd_emit="compact", fwd_fuse=True))
    assert [r.component for r in got] == ["compact_seam", "remat"]
    assert reports.collect_reports("compact_seam") == got[:1]
    assert compact_seam_reports()[0].taken and remat_reports()[0].applied == "codes"
    assert reports.collect_reports("ring") == ()
    reports.clear_reports("compact_seam")
    assert compact_seam_reports() == () and reports.collect_reports() == got[1:]
    _torch_reports("gemma3-4b", "full", dict(backend="pallas"))
    (fb,) = reports.collect_reports("backend")
    assert fallback_reports()[0].reason == fb.reason and fb.detail("selected") == "torch"
    reports.clear_reports()
    assert reports.collect_reports() == () and fallback_reports() == ()
    assert remat_reports() == ()
