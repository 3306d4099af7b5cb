"""``repro_torch.launch.dryrun``: every (arch x shape) cell on both
production meshes, planned on ``ShapeMesh``es and ``meta`` tensors.

  * the CLI over every cell on both meshes exits 0 with 32 cells ok and 8
    skipped on each, the skips the reference's (tests/test_distribution.py),
    without allocating (the process's peak resident memory grows by less
    than 1 GiB: deepseek-v2-236b's f32 parameters alone are 945 GB);
  * each cell's parameter bytes a device equal the reference specs' shard
    sizes (``repro.launch.specs.param_specs`` on a ``jax.sharding.
    AbstractMesh``, ``NamedSharding.shard_shape``), in the mode the
    reference's dry run picks;
  * the parameter collectives of gpt2-small-sfa8 on a small mesh, by hand.

The reference's ``repro/launch/dryrun.py`` is not imported: importing it
sets ``XLA_FLAGS`` for 512 host devices in the whole process.
"""
import json
import math
import resource

import jax
import pytest
from jax.sharding import AbstractMesh, NamedSharding

from repro.configs import get_config as jax_get_config
from repro.launch import specs as JS
from repro.models import init as jax_init
from repro_torch.configs import ASSIGNED_ARCHS, LM_SHAPES, get_config
from repro_torch.launch import dryrun as D
from repro_torch.launch import specs as S
from repro_torch.launch.mesh import ShapeMesh, production_shape

SKIPPED = {("hubert-xlarge", "decode_32k"), ("hubert-xlarge", "long_500k")} | {
    (arch, "long_500k") for arch in ("llama3.2-3b", "llama3-8b", "deepseek-7b",
                                     "moonshot-v1-16b-a3b", "deepseek-v2-236b",
                                     "paligemma-3b")}


@pytest.fixture(scope="module")
def cells(tmp_path_factory):
    out = tmp_path_factory.mktemp("dryrun") / "cells.json"
    before = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
    assert D.main(["--arch", "all", "--shape", "all", "--multi-pod", "both",
                   "--out", str(out)]) == 0
    grown_kib = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss - before
    return json.loads(out.read_text()), grown_kib


def test_every_cell_on_both_meshes_without_allocating(cells):
    recs, grown_kib = cells
    assert grown_kib < 2**20
    assert len(recs) == 2 * len(ASSIGNED_ARCHS) * len(LM_SHAPES)
    for mesh in ("16x16", "2x16x16"):
        mine = [r for r in recs if r["mesh"] == mesh]
        assert sum(r["status"] == "ok" for r in mine) == 32
        assert {(r["arch"], r["shape"]) for r in mine if r["status"] == "skipped"} == SKIPPED
    for r in recs:
        if r["status"] != "ok":
            continue
        want_mode = "zero3" if (r["arch"], r["shape"]) == ("rwkv6-3b", "train_4k") else "tp"
        assert r["mode"] == want_mode
        mem = r["bytes_per_device"]
        assert mem["total"] == sum(v for k, v in mem.items() if k != "total")
        assert ("opt_moments" in mem) == (r["shape"] == "train_4k")
        assert ("caches" in mem) == (r["shape"] in ("decode_32k", "long_500k"))
        roof = r["roofline"]
        assert roof["bottleneck"] in ("compute", "memory", "collective")
        assert roof["t_collective_s"] > 0 and r["not_modelled"]


def test_parameter_bytes_equal_the_reference_specs(cells):
    recs, _ = cells
    for arch in ASSIGNED_ARCHS:
        jc = jax_get_config(arch)
        jp = jax.eval_shape(lambda: jax_init(jax.random.PRNGKey(0), jc))
        for mp, name in ((False, "16x16"), (True, "2x16x16")):
            shape = production_shape(multi_pod=mp)
            jmesh = AbstractMesh(tuple(shape.values()), tuple(shape))
            for r in recs:
                if (r["arch"], r["mesh"], r["status"]) != (arch, name, "ok"):
                    continue
                specs = JS.param_specs(jp, jc, jmesh, mode=r["mode"])
                want = sum(4 * math.prod(NamedSharding(jmesh, s).shard_shape(p.shape))
                           for p, s in zip(jax.tree.leaves(jp), jax.tree.leaves(
                               specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))))
                assert r["bytes_per_device"]["params"] == want, (arch, r["shape"], name)
                if "opt_moments" in r["bytes_per_device"]:
                    assert r["bytes_per_device"]["opt_moments"] == 2 * want


def test_parameter_collectives_of_a_small_mesh():
    """gpt2-small-sfa8 on (data 2, model 2), training: the six split leaves
    each all-gathered over their axes and reduce-scattered over data, the
    six whole ones all-reduced over data; wire bytes by the reference's
    model from the leaf sizes."""
    cfg = get_config("gpt2-small-sfa8")
    mesh = ShapeMesh({"data": 2, "model": 2})
    params, _ = S.abstract_state(cfg)
    specs = S.param_specs(params, cfg, mesh)
    stats = D.param_collectives(params, specs, mesh, train=True)
    leaves = {"/".join(p): t for p, t in S.named_leaves(params)}
    two_axes = ("w_qkv", "w_o", "up", "down", "pos")     # data and model
    split = [k for k in leaves if any(n in k for n in two_axes)]
    assert len(split) == 5
    # the embedding's vocabulary of 50,257 stays whole: data only
    assert specs["embed"]["w"] == (None, "data")
    assert stats.counts == {"all-gather": 5 * 2 + 1, "reduce-scatter": 6, "all-reduce": 6}
    full = {k: 4 * t.numel() for k, t in leaves.items()}
    whole = [k for k in leaves if k not in split and k != "embed/w"]
    assert len(whole) == 6
    assert stats.wire_bytes["all-reduce"] == sum(2 * full[k] / 2 for k in whole)
    # reduce-scatter after the model slice: result = full / 4, wire x (g - 1)
    assert stats.wire_bytes["reduce-scatter"] == \
        sum(full[k] / 4 for k in split) + full["embed/w"] / 2
    # all-gather over data then model (minor first: the later dim's axis)
    assert D.param_collectives(params, specs, mesh, train=False).counts == {"all-gather": 11}
