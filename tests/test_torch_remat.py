"""remat="codes": keep the layer input and the SFA codes, rerun the rest.

Gradients under "codes" equal "full"'s, "none"'s and JAX's (``repro``'s
remat="codes" on the pallas backend) on reduced gpt2-small-sfa8 with the
compact seam, fused and unfused; a ``saved_tensors_hooks`` audit of an SFA
layer under "codes" sees the layer input and nothing wider than 2k values
per token and head; the backward reruns no projection -> top-k pass; a
stack whose forward keeps no codes degrades to "full" with a report; and
``TrainPolicy`` rejects the combinations JAX's rejects.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.configs.base import TrainPolicy as JaxTrainPolicy
from repro_torch.configs import get_config
from repro_torch.configs.base import TrainPolicy
from repro_torch.core import remat as R
from repro_torch.interop import from_jax
from repro_torch.kernels import ops
from repro_torch.models import loss_fn
from repro_torch.models import model as M
from test_torch_code_grad import compact_reference

TOL = 1e-4


def _cfg(tc, **attention):
    remat = attention.pop("remat")
    return dataclasses.replace(tc, remat=remat, attention=dataclasses.replace(
        tc.attention, **attention))


def _grads(model, batch, cfg):
    loss, _ = loss_fn(model, batch, cfg)
    named = dict(model.named_parameters())
    return float(loss.detach()), dict(zip(named, torch.autograd.grad(loss, list(named.values()))))


@pytest.fixture(scope="module")
def setup():
    tc, jbatch, jp, jloss, jgrads = compact_reference(None)
    model = from_jax(jp, tc, device="cpu").requires_grad_(True)
    batch = {k: torch.from_numpy(v).long() for k, v in jbatch.items()}
    return tc, model, batch, jloss, jgrads


@pytest.mark.parametrize("fuse", [True, False], ids=["fused", "unfused"])
def test_codes_grads_equal_full_none_and_jax(setup, fuse):
    tc, model, batch, jloss, jgrads = setup
    runs = {remat: _grads(model, batch, _cfg(tc, backend="cuda", bwd_emit="compact",
                                             fwd_fuse=fuse, remat=remat))
            for remat in ("codes", "full", "none")}
    loss, grads = runs["codes"]
    np.testing.assert_allclose(loss, jloss, rtol=0, atol=TOL)
    for name, g in grads.items():
        np.testing.assert_allclose(g.numpy(), jgrads[name], rtol=0, atol=TOL, err_msg=name)
        for other in ("full", "none"):
            np.testing.assert_allclose(g.numpy(), runs[other][1][name].numpy(), rtol=0,
                                       atol=1e-6, err_msg=f"{name} vs {other}")


@pytest.mark.parametrize("emit", ["compact", "dense"])
def test_saved_tensors_across_an_sfa_layer_are_codes(setup, emit):
    """What autograd keeps for one layer under "codes": the layer input,
    then only code-sized tensors — at most 2k values per token and head
    (the codes at k, their int16 indices, the (b·h, n) LSE) — whether the
    layer takes the compact seam or the op-level Function."""
    tc, model, batch, _, _ = setup
    cfg = _cfg(tc, backend="cuda", bwd_emit=emit, remat="codes")
    a = cfg.attention
    layer = M.L.tree_index(model.tree()["segments"][0], 0)
    x = torch.randn(2, 40, cfg.d_model, requires_grad=True)
    pos = torch.arange(40)[None, :]
    saved = []

    def pack(t):
        saved.append(t)
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        y = R.checkpoint_codes(lambda x, p: M._tx_block(
            p, x, cfg, positions=pos, mode="train")[0], x, layer)
    assert saved and saved[0] is x
    b, n = x.shape[:2]
    limit = a.num_heads * 2 * a.sfa_k
    for t in saved[1:]:
        assert t.numel() // (b * n) <= limit, (tuple(t.shape), t.dtype)
    assert {t.dtype for t in saved[1:]} >= {torch.int16, torch.float32}
    assert len(saved) == 1 + len(R.CODE_SAVEABLES)
    y.sum().backward()
    assert x.grad is not None and torch.isfinite(x.grad).all()


def test_backward_reruns_no_projection_topk(setup, monkeypatch):
    """Under "codes" the backward's rerun takes the recorded codes:
    proj_rtopk runs twice per layer (q, k) in the forward and never again;
    under "full" the backward runs it again."""
    tc, model, batch, _, _ = setup
    calls = []
    orig = ops.proj_rtopk

    def spy(*a, **kw):
        calls.append(1)
        return orig(*a, **kw)

    monkeypatch.setattr(ops, "proj_rtopk", spy)
    layers = tc.num_layers
    for remat, after_bwd in (("codes", 2 * layers), ("full", 4 * layers)):
        calls.clear()
        cfg = _cfg(tc, backend="cuda", bwd_emit="compact", remat=remat)
        loss, _ = loss_fn(model, batch, cfg)
        assert len(calls) == 2 * layers, remat
        loss.backward()
        assert len(calls) == after_bwd, remat
    model.zero_grad(set_to_none=True)


def test_codes_on_a_stack_without_codes_degrades_to_full_with_report(setup):
    tc, model, batch, _, _ = setup
    R.clear_remat_reports()
    cfg = _cfg(tc, backend="torch", remat="codes")
    assert M.attn.remat_codes_ineligible_reason(cfg) is not None
    loss_full, grads_full = _grads(model, batch, _cfg(tc, backend="torch", remat="full"))
    loss, grads = _grads(model, batch, cfg)
    rep = [r for r in R.remat_reports() if not r.eligible]
    assert len(rep) == 1 and rep[0].requested == "codes" and rep[0].applied == "full"
    assert "cuda" in rep[0].reason
    assert loss == loss_full
    for name in grads:
        assert torch.equal(grads[name], grads_full[name]), name
    R.clear_remat_reports()
    _grads(model, batch, _cfg(tc, backend="cuda", remat="codes"))
    assert [r.eligible for r in R.remat_reports()] == [True]
    R.clear_remat_reports()


def test_train_policy_rejects_what_jax_rejects():
    """Incoherent combinations fail at config time in both packages; the
    port's "torch" backend stands where JAX's "xla" does."""
    from repro.configs import get_config as jax_get_config
    jc = jax_get_config("gpt2-small-sfa8").reduced()
    tc = get_config("gpt2-small-sfa8").reduced()
    dense_j, dense_t = jax_get_config("gpt2-small").reduced(), get_config("gpt2-small").reduced()
    cases = [
        (dict(remat="codes"), dense_j, dense_t),
        (dict(remat="codes", backend="xla"), jc, None),
        (dict(remat="codes", backend="torch"), None, tc),
        (dict(bwd_emit="sparse"), jc, tc),
        (dict(remat="some"), jc, tc),
        (dict(tp=0), jc, tc),
        (dict(tp=3), jc, tc),
    ]
    for kw, jcfg, tcfg in cases:
        if jcfg is not None:
            with pytest.raises(ValueError):
                JaxTrainPolicy(**kw).validate(jcfg.attention)
        if tcfg is not None:
            with pytest.raises(ValueError):
                TrainPolicy(**kw).validate(tcfg.attention)
    for kw in (dict(remat="codes", bwd_emit="compact", fwd_fuse=True),
               dict(remat="codes", bwd_emit="compact2", fwd_fuse=False)):
        applied = TrainPolicy(**kw).apply(tc)
        assert applied.remat == "codes" and applied.attention.bwd_emit == kw["bwd_emit"]
        assert applied.attention.fwd_fuse == kw["fwd_fuse"]
        JaxTrainPolicy(**kw, backend="pallas").apply(jc)
