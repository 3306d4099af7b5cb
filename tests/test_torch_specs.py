"""``repro_torch.launch.specs`` against ``repro.launch.specs``, leaf for leaf
by name, with no allocation on either side.

  * ``param_specs`` in modes "tp" and "zero3" on every arch ``get_config``
    resolves (the assigned archs and the paper models), on the meshes
    (data 4, model 1), (data 2, model 2), (data 1, seq 4, model 1), 16 x
    16 and 2 x 16 x 16 (``jax.sharding.AbstractMesh`` against the port's
    ``ShapeMesh``); the JAX tree from ``jax.eval_shape`` of its ``init``,
    the port's from ``abstract_state`` (the ``meta`` device), each leaf's
    path and shape equal first;
  * ``cache_specs`` of gpt2-small-sfa8, deepseek-v2-236b, jamba-v0.1-52b
    and rwkv6-3b at both decode cells on those meshes;
  * ``input_specs``' shapes and dtypes for every (arch x shape) cell;
  * ``shardings_of`` against the reference's shard shapes, and the state
    bytes a rank of gpt2-small-sfa8 on DP 4, TP 2 x DP 2 and the ring of 4
    (the reference's specs give the same counts).
"""
import dataclasses
import functools
import math

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh, NamedSharding

from repro.configs import ASSIGNED_ARCHS as JAX_ARCHS
from repro.configs import LM_SHAPES as JAX_SHAPES
from repro.configs import get_config as jax_get_config
from repro.configs import skip_reason as jax_skip_reason
from repro.core.kv_cache import KVCache as JaxKVCache
from repro.launch import specs as JS
from repro.models import init as jax_init
from repro.models import init_decode_caches as jax_init_decode_caches
from repro_torch.configs import ASSIGNED_ARCHS, LM_SHAPES, get_config, skip_reason
from repro_torch.core.kv_cache import HybridCache, KVCache, RecurrentState
from repro_torch.launch import specs as S
from repro_torch.launch.mesh import ShapeMesh, production_shape

PAPER_ARCHS = ("gpt2-small", "gpt2-medium", "gpt2-small-sfa8", "gpt2-medium-sfa16",
               "gpt2-small-short2", "qwen3-0.6b", "qwen3-0.6b-sfa8", "qwen3-0.6b-short2")
MESHES = {"data4": {"data": 4, "model": 1}, "tp2dp2": {"data": 2, "model": 2},
          "seq4": {"data": 1, "seq": 4, "model": 1},
          "16x16": production_shape(), "2x16x16": production_shape(multi_pod=True)}
CACHE_ARCHS = ("gpt2-small-sfa8", "deepseek-v2-236b", "jamba-v0.1-52b", "rwkv6-3b")


def _jmesh(shape):
    return AbstractMesh(tuple(shape.values()), tuple(shape))


def _spec(s):
    """A spec of either package as a tuple whose entries are an axis, a
    tuple of two or more axes, or None (a PartitionSpec keeps a one-axis
    tuple as the axis, which means the same placement)."""
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e for e in s)


def _jax_paths(tree):
    out = {}
    for kp, leaf in jax.tree_util.tree_flatten_with_path(
            tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]:
        parts = [str(e.key) if hasattr(e, "key") else str(e.idx) for e in kp]
        out["/".join(parts)] = leaf
    return out


def _torch_paths(tree):
    return {"/".join(p): leaf for p, leaf in S.named_leaves(tree)}


@functools.lru_cache(maxsize=None)
def _jax_params(arch):
    return jax.eval_shape(lambda: jax_init(jax.random.PRNGKey(0), jax_get_config(arch)))


def test_the_arch_and_shape_registries_match():
    assert ASSIGNED_ARCHS == JAX_ARCHS
    assert [dataclasses.astuple(s) for s in LM_SHAPES] == \
        [dataclasses.astuple(s) for s in JAX_SHAPES]


@pytest.mark.parametrize("arch", ASSIGNED_ARCHS + PAPER_ARCHS)
def test_param_specs_match_the_reference(arch):
    """Both modes on every mesh: the same spec for every leaf, by path;
    and each leaf's shard shape from ``shardings_of`` equal to the
    reference's ``NamedSharding.shard_shape``."""
    jp = _jax_params(arch)
    params, opt = S.abstract_state(get_config(arch))
    jflat, tflat = _jax_paths(jp), _torch_paths(params)
    assert {k: tuple(v.shape) for k, v in jflat.items()} == \
        {k: tuple(v.shape) for k, v in tflat.items()}
    assert opt.step == 0 and _torch_paths(opt.m).keys() == tflat.keys()
    assert all(t.device.type == "meta" and t.dtype == torch.float32
               for t in list(tflat.values()) + list(_torch_paths(opt.v).values()))
    for mesh_name, shape in MESHES.items():
        for mode in ("tp", "zero3"):
            jspecs = _jax_paths(JS.param_specs(jp, jax_get_config(arch), _jmesh(shape),
                                               mode=mode))
            mesh = ShapeMesh(shape)
            specs = S.param_specs(params, get_config(arch), mesh, mode=mode)
            got = {k: _spec(v) for k, v in _torch_paths(specs).items()}
            want = {k: _spec(v) for k, v in jspecs.items()}
            assert got == want, (mesh_name, mode)
            shards = _torch_paths(S.shardings_of(params, specs, mesh))
            for path, leaf in jflat.items():
                ns = NamedSharding(_jmesh(shape), jspecs[path])
                assert shards[path] == tuple(ns.shard_shape(leaf.shape)), (mesh_name, mode, path)


def _cache_leaves(tree, prefix=""):
    """{path: leaf} of a decode-cache tree of either package (KVCache
    fields by name, dict keys, list indices; the port's RecurrentState /
    HybridCache as the reference's dict / {"attn", "mamba"})."""
    if isinstance(tree, (KVCache, JaxKVCache)):
        return {f"{prefix}{f.name}": getattr(tree, f.name) for f in dataclasses.fields(tree)
                if getattr(tree, f.name) is not None}
    if isinstance(tree, RecurrentState):
        return _cache_leaves(tree.tree, prefix)
    if isinstance(tree, HybridCache):
        tree = {"attn": tree.attn, "mamba": tree.mamba}
    if isinstance(tree, dict):
        return {k: v for key in tree
                for k, v in _cache_leaves(tree[key], f"{prefix}{key}/").items()}
    if isinstance(tree, list):                  # a spec tuple is a leaf
        return {k: v for i, sub in enumerate(tree)
                for k, v in _cache_leaves(sub, f"{prefix}{i}/").items()}
    return {prefix[:-1]: tree}


@pytest.mark.parametrize("arch", CACHE_ARCHS)
def test_cache_specs_match_the_reference(arch):
    """Both decode cells on every mesh: the stacked caches' leaves (path,
    shape, dtype) and their specs."""
    jc, tc = jax_get_config(arch), get_config(arch)
    for shape in (s for s in LM_SHAPES if s.kind == "decode"):
        if skip_reason(tc, shape):
            continue
        b, n = shape.global_batch, shape.seq_len
        jcache = jax.eval_shape(lambda: jax_init_decode_caches(jc, b, n))
        tcache = S.input_specs(tc, shape)["caches"]
        jleaves, tleaves = _cache_leaves(jcache), _cache_leaves(tcache)
        assert {k: (tuple(v.shape), str(v.dtype)) for k, v in jleaves.items()} == \
            {k: (tuple(v.shape), str(v.dtype).replace("torch.", "")) for k, v in tleaves.items()}
        for mesh_name, mshape in MESHES.items():
            want = _cache_leaves(JS.cache_specs(jcache, jc, _jmesh(mshape), batch=b, max_len=n))
            got = _cache_leaves(S.cache_specs(tcache, tc, ShapeMesh(mshape), batch=b, max_len=n))
            assert {k: _spec(v) for k, v in got.items()} == \
                {k: _spec(v) for k, v in want.items()}, (shape.name, mesh_name)


@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_input_specs_match_the_reference(arch):
    """Every cell the reference runs: each input's shape and dtype (decode:
    the token, the lengths and every cache leaf); nothing allocated."""
    jc, tc = jax_get_config(arch), get_config(arch)
    for shape in LM_SHAPES:
        assert skip_reason(tc, shape) == jax_skip_reason(jc, shape)
        if skip_reason(tc, shape):
            continue
        want = JS.input_specs(jc, shape)
        got = S.input_specs(tc, shape)
        assert set(got) == set(want)
        for key in got:
            if key == "caches":
                continue            # test_cache_specs_match_the_reference
            assert tuple(got[key].shape) == tuple(want[key].shape), (shape.name, key)
            assert str(got[key].dtype).replace("torch.", "") == str(want[key].dtype)
            assert got[key].device.type == "meta"
        if "caches" in got:
            assert {k: tuple(v.shape) for k, v in _cache_leaves(got["caches"]).items()} == \
                {k: tuple(v.shape) for k, v in _cache_leaves(want["caches"]).items()}


def test_gpt2_small_sfa8_state_bytes_a_rank():
    """Parameters and both f32 moments, 12 B a parameter: 173,902,080
    parameters; a rank holds 43,504,320 of them on DP 4 and 53,153,664 on TP
    2 x DP 2 (the embedding's vocabulary of 50,257 does not divide 2, so it
    stays whole along "model"); the ring of 4 splits nothing."""
    cfg = get_config("gpt2-small-sfa8")
    params, _ = S.abstract_state(cfg)
    total = sum(t.numel() for _, t in S.named_leaves(params))
    assert total == 173_902_080
    per_rank = {}
    for name, shape in (("data4", MESHES["data4"]), ("tp2dp2", MESHES["tp2dp2"]),
                        ("seq4", MESHES["seq4"])):
        mesh = ShapeMesh(shape)
        shards = S.shardings_of(params, S.param_specs(params, cfg, mesh), mesh)
        per_rank[name] = sum(math.prod(s) for _, s in S.named_leaves(shards))
    assert per_rank == {"data4": 43_504_320, "tp2dp2": 53_153_664, "seq4": total}
    assert 12 * per_rank["tp2dp2"] == 637_843_968 and 12 * per_rank["data4"] == 522_051_840
    specs = S.param_specs(params, cfg, ShapeMesh(MESHES["tp2dp2"]))
    assert specs["embed"]["w"] == (None, "data")
    split = [p for p, s in S.named_leaves(specs) if any(e is not None for e in s)]
    assert len(split) == 6 and len(S.named_leaves(specs)) == 12


def test_specs_allocate_nothing():
    """``abstract_state`` and ``input_specs`` of the largest cells stay on
    the meta device."""
    cfg = get_config("deepseek-v2-236b")
    params, opt = S.abstract_state(cfg)
    assert sum(t.numel() for _, t in S.named_leaves(params)) > 2e11
    caches = S.input_specs(cfg, next(s for s in LM_SHAPES if s.name == "decode_32k"))["caches"]
    assert all(t.device.type == "meta" for t in _cache_leaves(caches).values())
    assert np.all([t.device.type == "meta" for _, t in S.named_leaves(opt.m)])


def test_param_specs_refuse_an_unknown_mode():
    with pytest.raises(ValueError, match="zero3"):
        S.param_specs({"w": torch.empty(4, 4, device="meta")}, get_config("gpt2-small"),
                      ShapeMesh({"data": 2}), mode="fsdp")
