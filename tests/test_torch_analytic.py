"""The port's analytic models against the JAX package's: ``param_count``,
``step_flops`` and ``step_hbm_bytes`` equal for every arch the port takes,
full and reduced, at every ``LM_SHAPES`` entry (exact: the same closed
forms on the same integers)."""
import dataclasses

import pytest

from repro.configs import LM_SHAPES as JAX_SHAPES
from repro.configs import get_config as jax_get_config
from repro.utils import analytic as jax_analytic
from repro_torch.configs import LM_SHAPES, NOT_YET_PORTED, get_config, shape_by_name
from repro_torch.utils import analytic

ARCHS = ["gpt2-small", "gpt2-small-sfa8", "gpt2-medium-sfa16", "gpt2-small-short2",
         "qwen3-0.6b", "qwen3-0.6b-sfa8", "llama3.2-3b", "llama3-8b", "deepseek-7b",
         "moonshot-v1-16b-a3b"]


def test_shapes_equal_the_reference():
    assert [vars(s) for s in LM_SHAPES] == [vars(s) for s in JAX_SHAPES]
    assert shape_by_name("decode_32k") == LM_SHAPES[2]
    with pytest.raises(KeyError):
        shape_by_name("train_1m")


@pytest.mark.parametrize("reduced", [False, True], ids=["full", "reduced"])
@pytest.mark.parametrize("arch", ARCHS)
def test_counts_equal_the_reference(arch, reduced):
    jc, tc = jax_get_config(arch), get_config(arch)
    if reduced:
        jc, tc = jc.reduced(), tc.reduced()
    assert analytic.param_count(tc) == jax_analytic.param_count(jc)
    for js, ts in zip(JAX_SHAPES, LM_SHAPES):
        assert analytic.step_flops(tc, ts) == jax_analytic.step_flops(jc, js), ts.name
        for ndev in (1, 4):
            assert (analytic.step_hbm_bytes(tc, ts, ndev)
                    == jax_analytic.step_hbm_bytes(jc, js, ndev)), (ts.name, ndev)


@pytest.mark.parametrize("remat", ["none", "full", "codes"])
def test_train_flops_follow_the_remat_policy(remat):
    jc = dataclasses.replace(jax_get_config("qwen3-0.6b-sfa8"), remat=remat)
    tc = dataclasses.replace(get_config("qwen3-0.6b-sfa8"), remat=remat)
    shape = shape_by_name("train_4k")
    got = analytic.step_flops(tc, shape)
    assert got == jax_analytic.step_flops(jc, JAX_SHAPES[0])
    assert got["total_flops"] == got["forward_flops"] * (3 if remat == "none" else 4)


def test_moonshot_counts_total_and_active_as_the_reference():
    """moonshot-v1-16b-a3b: 1 dense layer (MLP widened to expert_dim x
    top_k = 8,448), 47 MoE layers of 64 experts top-6 + 2 shared, an untied
    head; total and active parameters and the step FLOPs (with the
    reference's dispatch and combine terms) at every LM shape equal the
    JAX package's."""
    jc, tc = jax_get_config("moonshot-v1-16b-a3b"), get_config("moonshot-v1-16b-a3b")
    pc = analytic.param_count(tc)
    assert pc == jax_analytic.param_count(jc)
    one = dataclasses.replace(tc, num_layers=2)
    dense = analytic._attn_params(tc) + analytic._mlp_params(tc, 8448)
    moe_total, moe_active = analytic._moe_params(tc)
    moe_layer = analytic._attn_params(tc) + moe_total
    assert (dense, moe_layer) == (68_681_728, 587_857_920)
    assert analytic.param_count(one)["total"] == 2 * 163_840 * 2048 + dense + moe_layer
    assert pc["total"] == 2 * 163_840 * 2048 + dense + 47 * moe_layer == 28_369_092_608
    assert pc["active"] == pc["total"] - 47 * (moe_total - moe_active)
    for js, ts in zip(JAX_SHAPES, LM_SHAPES):
        got = analytic.step_flops(tc, ts)
        assert got == jax_analytic.step_flops(jc, js), ts.name
        assert got["model_flops"] < got["total_flops"]


@pytest.mark.parametrize("arch,total,active", [
    ("jamba-v0.1-52b", 51_569_819_648, 12_109_807_616),
    ("rwkv6-3b", 3_072_409_600, 3_072_409_600)])
def test_recurrent_families_count_as_the_reference(arch, total, active):
    """jamba's super-blocks (Mamba or attention, MoE or an MLP of d_ff) and
    rwkv's layers: total and active parameters, the step FLOPs (the Mamba
    scan and WKV terms) and HBM bytes at every LM shape equal the JAX
    package's; one jamba super-block holds 13,295,108,096 parameters."""
    jc, tc = jax_get_config(arch), get_config(arch)
    pc = analytic.param_count(tc)
    assert pc == jax_analytic.param_count(jc) == {"total": total, "active": active}
    if arch.startswith("jamba"):
        one = dataclasses.replace(tc, num_layers=tc.hybrid_period)
        assert analytic.param_count(one)["total"] == 13_295_108_096
    for js, ts in zip(JAX_SHAPES, LM_SHAPES):
        assert analytic.step_flops(tc, ts) == jax_analytic.step_flops(jc, js), ts.name
        for ndev in (1, 4):
            assert (analytic.step_hbm_bytes(tc, ts, ndev)
                    == jax_analytic.step_hbm_bytes(jc, js, ndev)), (ts.name, ndev)
    assert arch not in NOT_YET_PORTED
