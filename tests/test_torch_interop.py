"""Weights carried from the JAX param tree into the port's Model."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import init as jax_init
from repro_torch.configs import get_config
from repro_torch.interop import _flatten, from_jax
from repro_torch.models.attention import split_qkv
from repro_torch.models.model import init as torch_init


def _cfgs(name):
    jc = dataclasses.replace(jax_get_config(name).reduced(), dtype="float32")
    tc = dataclasses.replace(get_config(name).reduced(), dtype="float32")
    return jc, tc


@pytest.mark.parametrize("name", ["gpt2-small-sfa8", "qwen3-0.6b-sfa8", "gpt2-small"])
def test_every_leaf_converted(name):
    jc, tc = _cfgs(name)
    tree = jax.tree.map(np.asarray, jax_init(jax.random.PRNGKey(0), jc))
    model = from_jax(tree, tc, device="cpu")
    flat = _flatten(tree)
    params = dict(model.named_parameters())
    assert set(params) == set(flat)
    for key, arr in flat.items():
        np.testing.assert_array_equal(params[key].numpy(), arr)
    # the stacked per-segment layer axis is kept
    assert model.segments[0].attn.w_qkv.w.shape[0] == tc.num_layers
    # the port's own init builds the same tree (shapes only)
    own = torch_init(tc, device="cpu", seed=1)
    assert {k: tuple(v.shape) for k, v in own.named_parameters()} == \
        {k: tuple(v.shape) for k, v in params.items()}


def test_missing_extra_or_misshapen_leaf_raises():
    jc, tc = _cfgs("gpt2-small-sfa8")
    tree = jax.tree.map(np.asarray, jax_init(jax.random.PRNGKey(0), jc))
    bad = dict(tree, final_norm={"scale": tree["final_norm"]["scale"]})
    with pytest.raises(ValueError, match="missing"):
        from_jax(bad, tc, device="cpu")
    bad = dict(tree, extra={"w": np.zeros(3, np.float32)})
    with pytest.raises(ValueError, match="unconsumed"):
        from_jax(bad, tc, device="cpu")
    bad = dict(tree, pos={"w": tree["pos"]["w"][:7]})
    with pytest.raises(ValueError, match="shape"):
        from_jax(bad, tc, device="cpu")


def test_w_qkv_split_matches_jax_columns():
    """q | k | v column order of the packed projection, GQA widths."""
    jc, tc = _cfgs("qwen3-0.6b-sfa8")
    jc = dataclasses.replace(jc, attention=dataclasses.replace(jc.attention, num_kv_heads=2))
    tc = dataclasses.replace(tc, attention=dataclasses.replace(tc.attention, num_kv_heads=2))
    a = tc.attention
    h, hkv, hd = a.num_heads, a.num_kv_heads, a.head_dim
    assert hkv < h
    tree = jax.tree.map(np.asarray, jax_init(jax.random.PRNGKey(1), jc))
    model = from_jax(tree, tc, device="cpu")
    w = model.segments[0].attn.w_qkv.w[0]
    x = np.random.RandomState(0).randn(2, 5, tc.d_model).astype(np.float32)
    q, k, v = split_qkv(torch.from_numpy(x) @ w, h, hkv, hd)
    jqkv = jnp.asarray(x) @ jnp.asarray(tree["segments"][0]["attn"]["w_qkv"]["w"][0])
    jq, jk, jv = jnp.split(jqkv, [h * hd, (h + hkv) * hd], axis=-1)
    for got, want, heads in ((q, jq, h), (k, jk, hkv), (v, jv, hkv)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want).reshape(2, 5, heads, hd),
                                   rtol=0, atol=1e-5)
