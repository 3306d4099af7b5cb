"""The ``cuda`` backend's capability check against the kernels' shapes.

The CUDA kernels take only some head dims (the dense FlashAttention kernels
d = dv in {32, 64, 128}; FlashSFA dv in {32, 64, 128}, d <= 256, k <= 32
for its backward; the decode kernels dv in {32, 64, 128}). A layer outside
them must resolve to the ``torch`` oracle under ``backend="auto"``, and an
explicit ``"cuda"`` must record a ``FallbackReport``, instead of reaching a
wrapper that raises on the card. On the CPU the wrappers run their plain
versions and would take any shape, so the routing itself is what these
tests check.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.models import forward_logits, init, loss_fn, prefill
from repro_torch.models import attention as attn
from repro_torch.models.backends import (
    AttentionRequest, clear_fallback_reports, fallback_reports, kernel_shape_reason,
    resolve_backend_name, select_backend,
)


def _with(cfg, **attention):
    return dataclasses.replace(cfg, attention=dataclasses.replace(cfg.attention, **attention))


def _req(cfg, mode="full"):
    if mode == "forward only":              # a prefill or eval under no_grad
        return attn._request(cfg.attention, mode="full", window=None, backward=False)
    return attn._request(cfg.attention, mode=mode, window=None)


@pytest.mark.parametrize("arch", ["gpt2-small-sfa8", "gpt2-small", "qwen3-0.6b-sfa8"])
def test_layers_the_kernels_take_still_resolve_to_cuda(arch):
    cfg = get_config(arch)
    assert resolve_backend_name("auto", _req(cfg)) == "cuda"
    decode = "cuda" if cfg.attention.sfa_k is not None else "torch"  # no dense-decode kernel
    assert resolve_backend_name("auto", _req(cfg, "decode")) == decode


def test_short_embedding_head_dim_resolves_to_torch_with_the_reason():
    cfg = get_config("gpt2-small-short4")
    assert cfg.attention.head_dim == 16
    req = _req(cfg)
    assert (req.head_dim, req.v_head_dim, req.sfa_k) == (16, 16, None)
    assert resolve_backend_name("auto", req) == "torch"
    clear_fallback_reports()
    assert select_backend("auto", req).backend.name == "torch"
    assert fallback_reports() == ()                     # "auto" records nothing
    sel = select_backend("cuda", req, where="short4/attention")
    assert sel.backend.name == "torch"
    assert "16" in sel.reason and "(32, 64, 128)" in sel.reason
    (report,) = fallback_reports()
    assert (report.requested, report.selected, report.reason, report.where) == (
        "cuda", "torch", sel.reason, "short4/attention")
    clear_fallback_reports()


@pytest.mark.parametrize("shape,mode,declined", [
    (dict(head_dim=16, sfa_k=8), "full", "v head dim 16"),
    (dict(head_dim=256, sfa_k=8), "full", None),        # either dtype's backward takes 256
    (dict(head_dim=64, sfa_k=48), "full", "k <= 32"),
    (dict(head_dim=64, sfa_k=48), "decode", None),      # no backward at decode
    (dict(head_dim=128, sfa_k=32), "full", None),
    (dict(head_dim=32, sfa_k=8), "decode", None),
    (dict(head_dim=16, sfa_k=8), "decode", "v head dim 16"),
    (dict(head_dim=64, sfa_k=48), "forward only", None),  # no backward: any k
    (dict(head_dim=16, sfa_k=8), "forward only", "v head dim 16"),
])
def test_sfa_shapes_outside_the_kernels_resolve_to_torch(shape, mode, declined):
    cfg = _with(get_config("gpt2-small-sfa8"), **shape)
    req = _req(cfg, mode)
    reason = kernel_shape_reason(req)
    if declined is None:
        assert reason is None and resolve_backend_name("auto", req) == "cuda"
    else:
        assert declined in reason
        assert resolve_backend_name("auto", req) == "torch"
        assert resolve_backend_name("cuda", req) == "torch"
        assert select_backend("cuda", req).reason == reason


def test_dense_kernels_need_equal_head_dims_and_requests_without_shapes_pass():
    req = AttentionRequest(mode="full", head_dim=64, v_head_dim=128)
    assert "d = dv" in kernel_shape_reason(req)
    assert resolve_backend_name("auto", req) == "torch"
    assert kernel_shape_reason(AttentionRequest(mode="full")) is None
    assert resolve_backend_name("auto", AttentionRequest(mode="full")) == "cuda"


def test_cuda_fm_declines_the_same_decode_shapes():
    req = _req(_with(get_config("gpt2-small-sfa8"), head_dim=16), "decode")
    assert resolve_backend_name("cuda_fm", req) == "torch"
    assert resolve_backend_name("cuda_fm", _req(get_config("gpt2-small-sfa8"), "decode")) == \
        "cuda_fm"


@pytest.mark.parametrize("shape,reason", [
    (dict(head_dim=16), "proj_rtopk"), (dict(head_dim=256), None),
    (dict(sfa_k=40), "k <= 32")])
def test_compact_seam_declines_shapes_its_kernels_do_not_take(shape, reason):
    cfg = _with(get_config("gpt2-small-sfa8"), bwd_emit="compact", **shape)
    got = attn.compact_seam_ineligible_reason(cfg)
    assert got is None if reason is None else reason in got
    assert attn.compact_seam_ineligible_reason(
        _with(get_config("gpt2-small-sfa8"), bwd_emit="compact")) is None


def test_short_embedding_model_runs_on_the_oracle_with_a_report():
    # the reduced short-embedding baseline (head_dim 16) through the model:
    # "cuda" falls back per layer with the reason, "auto" silently, and
    # both give the oracle's logits
    cfg = _with(dataclasses.replace(get_config("gpt2-small-short4").reduced(),
                                    dtype="float32"), backend="cuda")
    assert cfg.attention.head_dim == 16
    model = init(cfg, device="cpu", seed=0)
    tokens = torch.from_numpy(np.random.RandomState(0).randint(0, cfg.vocab_size, (2, 12)))
    clear_fallback_reports()
    got = forward_logits(model, {"tokens": tokens}, cfg)
    reports = fallback_reports()
    assert reports and all(r.selected == "torch" and "head dim 16" in r.reason
                           for r in reports)
    clear_fallback_reports()
    auto = forward_logits(model, {"tokens": tokens}, _with(cfg, backend="auto"))
    assert fallback_reports() == ()
    want = forward_logits(model, {"tokens": tokens}, _with(cfg, backend="torch"))
    assert torch.equal(got, want) and torch.equal(auto, want)


def test_code_width_past_the_backward_declines_only_where_a_backward_runs():
    # sfa_k 48 > the FlashSFA backward's k: a no-grad prefill keeps "cuda"
    # (the forward's bodies take any k); a train-mode forward falls back
    cfg = _with(dataclasses.replace(get_config("gpt2-small-sfa8").reduced(),
                                    dtype="float32"), backend="cuda", head_dim=64, sfa_k=48)
    model = init(cfg, device="cpu", seed=0)
    tokens = torch.from_numpy(np.random.RandomState(0).randint(0, cfg.vocab_size, (1, 12)))
    clear_fallback_reports()
    prefill(model, {"tokens": tokens}, cfg)
    assert fallback_reports() == ()
    loss, _ = loss_fn(model, {"tokens": tokens, "labels": tokens}, cfg)
    reports = fallback_reports()
    assert reports and all("k <= 32" in r.reason and r.request.backward for r in reports)
    assert torch.isfinite(loss)
    clear_fallback_reports()
