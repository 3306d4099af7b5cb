"""The MoE family trained through the compact seam, against the JAX package
on the CPU, f32.

The reduced moonshot-v1-16b-a3b (1 dense + 1 MoE layer; RoPE, MHA, 4 heads
of 32) with its sfa_k set back to the full model's 16 — ``reduced()`` caps
it at 4 — so the RoPE pair closure makes its code gradients 2k = 32 wide,
the width code_grad's tensor-core bodies take at d 64 and 128 on the card
(width 32 at d 32 stays on their CUDA-core bodies; on CPU tensors either
runs its plain version). The port trains it with ``bwd_emit="compact2"``
(and a "compact" request, which the RoPE layer widens to the pair
closure), ``fwd_fuse`` and ``remat="codes"`` on its ``cuda`` backend; the
JAX model runs the same emit and remat on its pallas backend (Pallas in
interpret mode). The weights are JAX's, carried by ``interop.from_jax``.
The loss, the aux metric (the MoE load-balance term) and every leaf
gradient agree at 1e-4; both packages' eligibility checks admit the layer
to the seam, the port's seam report says it took the seam with the fused
forward, and its remat report says "codes" was applied. The JAX reference
compiles once (a module fixture).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import init as jax_init
from repro.models import loss_fn as jax_loss_fn
from repro.models.attention import compact_seam_ineligible_reason as jax_seam_reason
from repro_torch.configs import get_config
from repro_torch.core.remat import clear_remat_reports, remat_reports
from repro_torch.interop import from_jax
from repro_torch.kernels.code_grad import tensor_core_body
from repro_torch.kernels.rtopk import PROJ_HEAD_DIMS
from repro_torch.models import attention as attn
from repro_torch.models import loss_fn, segments
from test_torch_code_grad import _batch, _flat

TOL = 1e-4
ARCH = "moonshot-v1-16b-a3b"


def _pair():
    """(JAX config, port config): reduced, f32, the full model's sfa_k, the
    seam's policy."""
    k = get_config(ARCH).attention.sfa_k
    out = []
    for get, backend in ((jax_get_config, "pallas"), (get_config, "cuda")):
        c = dataclasses.replace(get(ARCH).reduced(), dtype="float32", loss_chunk=16,
                                remat="codes")
        out.append(dataclasses.replace(c, attention=dataclasses.replace(
            c.attention, sfa_k=k, backend=backend, bwd_emit="compact2", fwd_fuse=True)))
    return out


@pytest.fixture(scope="module")
def moonshot_seam():
    """JAX's reduced moonshot through its compact seam: parameters, a batch,
    its loss, aux metric and every leaf gradient."""
    jc, tc = _pair()
    jp = jax_init(jax.random.PRNGKey(7), jc)
    batch = _batch(np.random.RandomState(23), jc.vocab_size)
    (loss, metrics), grads = jax.jit(jax.value_and_grad(
        lambda p, b: jax_loss_fn(p, b, jc), has_aux=True))(
            jp, {k: jnp.asarray(v) for k, v in batch.items()})
    return dict(jc=jc, tc=tc, params=jax.tree.map(np.asarray, jp), batch=batch,
                loss=float(loss), aux=float(metrics["aux"]), grads=_flat(grads))


def test_reduced_moonshot_takes_the_seam_at_code_width_32(moonshot_seam):
    """Both packages admit the reduced moonshot to the compact seam; its
    codes are 32 wide at d 32, which code_grad runs on its CUDA-core bodies
    on the card (the full model's d 128 on its tensor-core bodies)."""
    jc, tc = moonshot_seam["jc"], moonshot_seam["tc"]
    a = tc.attention
    assert segments(tc) == [("block_dense", 1), ("block_moe", 1)]
    assert a.rope and not a.qk_norm and a.num_kv_heads == a.num_heads
    assert a.sfa_k == 16 and a.head_dim == 32 and a.head_dim in PROJ_HEAD_DIMS
    assert attn.compact_seam_ineligible_reason(tc) is None
    assert jax_seam_reason(jc) is None
    assert attn.remat_codes_ineligible_reason(tc) is None
    assert not tensor_core_body(torch.bfloat16, a.head_dim, 2 * a.sfa_k, tc.d_model)
    full = get_config(ARCH)
    assert tensor_core_body(torch.bfloat16, full.attention.head_dim, 2 * full.attention.sfa_k,
                            full.d_model)


@pytest.mark.parametrize("emit", ["compact2", "compact"])
def test_moonshot_seam_loss_aux_and_every_grad_match_jax(moonshot_seam, emit):
    """The port's loss, aux and every leaf gradient through the seam under
    remat "codes" equal JAX's through its seam at 1e-4; a "compact" request
    on the RoPE layer takes the same pair-closure seam."""
    s = moonshot_seam
    tc = dataclasses.replace(s["tc"], attention=dataclasses.replace(s["tc"].attention,
                                                                    bwd_emit=emit))
    model = from_jax(s["params"], tc, device="cpu").requires_grad_(True)
    attn.clear_compact_seam_reports()
    clear_remat_reports()
    loss, metrics = loss_fn(model, {k: torch.from_numpy(v).long()
                                    for k, v in s["batch"].items()}, tc)
    named = dict(model.named_parameters())
    grads = dict(zip(named, torch.autograd.grad(loss, list(named.values()))))
    seams, remats = attn.compact_seam_reports(), remat_reports()
    attn.clear_compact_seam_reports()
    clear_remat_reports()
    assert [r.taken for r in seams] == [True] and seams[0].fused_fwd
    assert remats and all(r.requested == r.applied == "codes" for r in remats)
    np.testing.assert_allclose(float(loss.detach()), s["loss"], rtol=0, atol=TOL)
    np.testing.assert_allclose(float(metrics["aux"]), s["aux"], rtol=0, atol=1e-6)
    assert set(grads) == set(s["grads"])
    for name, g in grads.items():
        np.testing.assert_allclose(g.numpy(), s["grads"][name], rtol=0, atol=TOL, err_msg=name)
