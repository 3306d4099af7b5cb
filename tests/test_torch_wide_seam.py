"""The compact seam at head dims 80 and 256, against the JAX package on the
CPU, f32.

The reference's seam (``repro/models/attention.py``) has no condition on
the head dim, and its Pallas ``proj_rtopk``, ``code_grad_dx`` and
``code_grad_dw`` take any d; the port's seam now takes d 80 (hubert-xlarge:
16 heads, bidirectional, no RoPE) and 256 (paligemma-3b: 8 query heads over
one kv head, RoPE, code width 32 on the pair closure) as the reference
does:

  * ``compact_seam_ineligible_reason`` equals the reference's for every
    registered arch under ``bwd_emit`` "compact" and "compact2" (no
    compile);
  * the plain ``proj_rtopk`` (indices exact, values within 1e-4),
    ``code_grad_dx`` and ``code_grad_dw`` (1e-4) at d 80 and 256 against
    the Pallas kernels in interpret mode;
  * the reduced hubert (compact) and the reduced paligemma (compact2) of
    ``tests/test_torch_frontends.py``, their sfa_k set back to the full
    models' 16, trained through the port's seam under remat "codes" on
    the ``cuda`` backend (the wrappers' plain versions on CPU tensors):
    the loss and every gradient within 1e-4 of JAX's seam on its pallas
    backend (one JAX compile each, a module fixture); the seam and remat
    reports say the seam and "codes" were taken;
  * every dtype has a body: an f32 layer at d 256 takes the seam and keeps
    its codes under remat "codes" on a ``cuda`` request, as in bf16 (the
    f32 FlashSFA backward runs dv 256 on 32-row tiles), and nothing in the
    decision depends on the device.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ASSIGNED_ARCHS
from repro.configs import get_config as jax_get_config
from repro.kernels.code_grad import code_grad_dw as jax_code_grad_dw
from repro.kernels.code_grad import code_grad_dx as jax_code_grad_dx
from repro.kernels.rtopk import proj_rtopk as jax_proj_rtopk
from repro.models import init as jax_init
from repro.models import loss_fn as jax_loss_fn
from repro.models.attention import compact_seam_ineligible_reason as jax_seam_reason
from repro_torch.configs import get_config
from repro_torch.core.remat import clear_remat_reports, remat_reports
from repro_torch.interop import from_jax
from repro_torch.kernels import code_grad_dw, code_grad_dx, proj_rtopk
from repro_torch.models import attention as attn
from repro_torch.models import loss_fn
from repro_torch.train.train_step import to_batch
from test_torch_frontends import _flat_np, _pair, _patches

TOL = 1e-4
PAPER_ARCHS = ("gpt2-small", "gpt2-medium", "gpt2-small-sfa8", "gpt2-medium-sfa16",
               "gpt2-small-short2", "qwen3-0.6b", "qwen3-0.6b-sfa8", "qwen3-0.6b-short2")
SEAMS = {"hubert-xlarge": "compact", "paligemma-3b": "compact2"}


def _with_emit(cfg, emit, **attention):
    return dataclasses.replace(cfg, attention=dataclasses.replace(cfg.attention, bwd_emit=emit,
                                                                  **attention))


@pytest.mark.parametrize("emit", ["compact", "compact2"])
@pytest.mark.parametrize("name", [a for a in ASSIGNED_ARCHS + PAPER_ARCHS if a != "rwkv6-3b"])
def test_seam_reason_equals_the_reference_for_every_registered_arch(name, emit):
    assert get_config(name).attention is not None
    jc, tc = _with_emit(jax_get_config(name), emit), _with_emit(get_config(name), emit)
    assert attn.compact_seam_ineligible_reason(tc) == jax_seam_reason(jc)


def test_seam_takes_80_and_256_and_declines_what_no_body_takes():
    for name in SEAMS:
        assert attn.compact_seam_ineligible_reason(_with_emit(get_config(name), "compact")) \
            is None
    gpt = _with_emit(get_config("gpt2-small-sfa8"), "compact")
    for hd in (16, 48, 96):
        reason = attn.compact_seam_ineligible_reason(
            _with_emit(gpt, "compact", head_dim=hd))
        assert f"head_dim {hd}" in reason and "proj_rtopk" in reason
    assert "k <= 32" in attn.compact_seam_ineligible_reason(_with_emit(gpt, "compact",
                                                                       sfa_k=40))


@pytest.mark.parametrize("name,dtype", [
    ("paligemma-3b", torch.float32),     # the CUDA-core backward's 32-row tiles at dv 256
    ("paligemma-3b", torch.bfloat16),    # the tensor-core bodies
    ("hubert-xlarge", torch.float32),    # the CUDA-core bodies take 80
    ("hubert-xlarge", torch.bfloat16),
])
def test_the_card_without_a_body_is_decided_before_the_step(name, dtype):
    """No layer of a registered arch lacks a body on the card any more: a
    cuda request takes the seam and keeps its codes in either dtype, so
    there is nothing left to decide before the step."""
    cfg = dataclasses.replace(_with_emit(get_config(name), SEAMS[name], backend="cuda"),
                              dtype=str(dtype).removeprefix("torch."), remat="codes")
    assert attn.compact_seam_ineligible_reason(cfg) is None
    assert attn._seam_backend(cfg, None) == "cuda"
    assert attn.remat_codes_ineligible_reason(cfg) is None
    assert not hasattr(attn, "seam_body_reason")


# --------------------------------------------------------------------------
# the kernels' plain versions at the new widths against Pallas
# --------------------------------------------------------------------------

@pytest.mark.parametrize("d,nh,rope_on", [(80, 3, False), (256, 1, True)])
def test_plain_proj_rtopk_matches_pallas(d, nh, rope_on):
    rs = np.random.RandomState(d + nh)
    b, n, m, k = 2, 72, 40, 16
    x = rs.randn(b, n, m).astype(np.float32)
    w = (0.1 * rs.randn(nh, m, d)).astype(np.float32)
    pos = np.broadcast_to(np.arange(n), (b, n)).astype(np.int32)
    spec = (10_000.0, d) if rope_on else None
    vals, idx = proj_rtopk(torch.from_numpy(x), torch.from_numpy(w),
                           torch.from_numpy(pos) if rope_on else None, k=k, rope_spec=spec)
    jv, ji = jax_proj_rtopk(x, w, pos if rope_on else None, k=k, rope_spec=spec,
                            interpret=True)
    assert vals.shape == idx.shape == (b, nh, n, k) and idx.dtype == torch.int32
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ji))
    np.testing.assert_allclose(vals.numpy(), np.asarray(jv), rtol=0, atol=TOL)


@pytest.mark.parametrize("d,nh,kw", [(80, 3, 16), (256, 2, 32)])
def test_plain_code_grads_match_pallas(d, nh, kw):
    rs = np.random.RandomState(d + kw)
    n, m = 130, 40
    vals = rs.randn(nh, n, kw).astype(np.float32)
    idx = np.sort(np.argsort(rs.rand(nh, n, d), -1)[..., :kw], -1).astype(np.int32)
    idx[:, 3::7, 1] = idx[:, 3::7, 0]              # duplicates sum (the pair closure's)
    idx[:, 5::11, -1] = d + 1                      # outside [0, d): adds nothing
    w = (0.1 * rs.randn(nh, m, d)).astype(np.float32)
    x = rs.randn(n, m).astype(np.float32)
    tv, ti = torch.from_numpy(vals), torch.from_numpy(idx)
    dx = code_grad_dx(tv, ti, torch.from_numpy(w), d=d)
    dw = code_grad_dw(torch.from_numpy(x), tv, ti, d=d)
    np.testing.assert_allclose(dx.numpy(), np.asarray(jax_code_grad_dx(
        vals, idx, w, d=d, interpret=True)), rtol=0, atol=TOL)
    np.testing.assert_allclose(dw.numpy(), np.asarray(jax_code_grad_dw(
        x, vals, idx, d=d, interpret=True)), rtol=0, atol=TOL)


# --------------------------------------------------------------------------
# the reduced models through the seam against JAX's seam
# --------------------------------------------------------------------------

def _seam_pair(name):
    """(JAX config, port config): the frontends' reduced f32 pair at the full
    head dim, sfa_k back at the full model's, the seam's policy."""
    k = get_config(name).attention.sfa_k
    return [dataclasses.replace(_with_emit(c, SEAMS[name], sfa_k=k, backend=backend,
                                           fwd_fuse=True), remat="codes")
            for c, backend in zip(_pair(name), ("pallas", "cuda"))]


def _batch(name, cfg):
    rs = np.random.RandomState(31)
    b, n = 1, 16
    batch = {"labels": rs.randint(0, cfg.vocab_size, (b, n)).astype(np.int32)}
    if name == "hubert-xlarge":
        batch["frames"] = rs.randn(b, n, cfg.frontend.input_dim).astype(np.float32)
        batch["labels"][:, 5:8] = -1
    else:
        batch["tokens"] = rs.randint(0, cfg.vocab_size, (b, n)).astype(np.int32)
        batch["patches"] = _patches(32, cfg, b)
    return batch


@pytest.fixture(scope="module", params=list(SEAMS))
def seam(request):
    """JAX's reduced model through its compact seam: parameters, a batch,
    its loss and every leaf gradient."""
    name = request.param
    jc, tc = _seam_pair(name)
    batch = _batch(name, jc)
    jp = jax_init(jax.random.PRNGKey(5), jc)
    (loss, _), grads = jax.jit(jax.value_and_grad(
        lambda p, b: jax_loss_fn(p, b, jc), has_aux=True))(
            jp, {k: jnp.asarray(v) for k, v in batch.items()})
    return dict(name=name, jc=jc, tc=tc, params=jax.tree.map(np.asarray, jp), batch=batch,
                loss=float(loss), grads=_flat_np(grads))


def test_reduced_seam_loss_and_every_grad_match_jax(seam):
    """The port's loss and every leaf gradient through the seam under remat
    "codes" equal JAX's through its seam at 1e-4; both take the seam, the
    port with the fused forward, and keep the codes."""
    jc, tc = seam["jc"], seam["tc"]
    a = tc.attention
    assert a.head_dim == {"hubert-xlarge": 80, "paligemma-3b": 256}[seam["name"]]
    assert a.sfa_k == 16 and jax_seam_reason(jc) is None
    assert attn.compact_seam_ineligible_reason(tc) is None
    model = from_jax(seam["params"], tc, device="cpu").requires_grad_(True)
    attn.clear_compact_seam_reports()
    clear_remat_reports()
    loss, _ = loss_fn(model, to_batch(seam["batch"], "cpu"), tc)
    named = dict(model.named_parameters())
    grads = torch.autograd.grad(loss, list(named.values()), allow_unused=True)
    seams, remats = attn.compact_seam_reports(), remat_reports()
    attn.clear_compact_seam_reports()
    clear_remat_reports()
    assert [r.taken for r in seams] == [True] and seams[0].fused_fwd
    assert remats and all(r.requested == r.applied == "codes" for r in remats)
    np.testing.assert_allclose(float(loss.detach()), seam["loss"], rtol=0, atol=TOL)
    got = {n: (torch.zeros_like(p) if g is None else g)
           for (n, p), g in zip(named.items(), grads)}
    assert set(got) == set(seam["grads"])
    for name, g in got.items():
        np.testing.assert_allclose(g.numpy(), seam["grads"][name], rtol=0, atol=TOL,
                                   err_msg=name)
