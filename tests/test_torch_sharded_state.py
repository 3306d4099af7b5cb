"""Sharded training state (``launch/specs.py``, ``distributed/shard.py``) on
4 gloo ranks of the CPU, data 2 x model 2, against the same state
replicated, one process and JAX. The reduced gpt2-small-sfa8 in f32 through
the compact seam (remat "codes"), the parameters JAX's; the ranks start
once for the module (``launch.mesh.spawn``, ``torch_dist_workers.
sharded_state_worker``) and run while JAX computes its reference here
(``compact_reference`` of tests/test_torch_code_grad.py).

  * every parameter's shard shape is the specs' (``shardings_of``);
  * the first step's loss and gathered gradients against JAX's
    single-device ones (1e-4, the repo's f32 tolerance);
  * two sharded steps against the same two replicated: loss, grad_norm,
    the gathered parameters after AdamW and both moments within 1e-6
    relative (the global norm sums in another order);
  * two compressed sharded steps against one process (1e-4: the data
    shards sum in another order than one process);
  * the Trainer's checkpoints of a sharded and a replicated run (clip off,
    so both hold the same bits): the manifest and every stored array
    identical byte for byte;
  * ``elastic_remesh`` of the sharded checkpoint onto data 4: the shards
    re-cut by the new specs, the gathered state the checkpoint's bit for
    bit, and the next step's loss one process's.
"""
import dataclasses
import os
import zipfile
from concurrent.futures import ThreadPoolExecutor

import jax
import numpy as np
import pytest
import torch

import torch_dist_workers as W
from repro.models import init as jax_init
from repro_torch.launch.mesh import spawn
from repro_torch.train import checkpoint as ckpt
from test_torch_checkpoint import _equal
from test_torch_code_grad import _batch, _configs, compact_reference

TOL = 1e-4
REL = 1e-6
FRACTION = 0.05


def _rel(a, b):
    return float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b).clamp(min=1e-30))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    jc, tc = _configs("gpt2-small-sfa8", loss_chunk=16)
    seam = dataclasses.replace(tc, attention=dataclasses.replace(
        tc.attention, backend="cuda", bwd_emit="compact"), remat="codes")
    rs = np.random.RandomState(6)
    batches = [_batch(rs, jc.vocab_size)]
    jp = jax.tree.map(np.asarray, jax_init(jax.random.PRNGKey(3), jc))
    rs = np.random.RandomState(12)
    batches.append(_batch(rs, jc.vocab_size))
    cbatches = [_batch(rs, jc.vocab_size) for _ in range(2)]
    root = tmp_path_factory.mktemp("sharded")
    with ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(spawn, W.sharded_state_worker, 4, device="cpu", timeout_s=240,
                            args=(seam, jp, batches, cbatches, FRACTION, str(root)))
        _, batch_ref, jp_ref, jloss, jgrads = compact_reference(None)
        local = W.placed_steps(seam, jp, cbatches, None, FRACTION)
        out = ranks.result()
    assert all(np.array_equal(batches[0][k], batch_ref[k]) for k in batch_ref)
    assert all(np.array_equal(a, b) for a, b in zip(jax.tree.leaves(jp),
                                                    jax.tree.leaves(jp_ref)))
    # one process from the sharded checkpoint: its leaves and its next step
    tr = W._sharded_trainer(seam, str(root / "unused1"), None, grad_clip=1e30)
    tr._load_state(ckpt.restore(str(root / "sharded"), 2, tr._save_state()))
    one = ([x.clone() if torch.is_tensor(x) else np.asarray(x)
            for x in ckpt.tree_leaves(tr._save_state())], tr.run_step(2)["loss"])
    return {"ranks": out, "jax": (jloss, jgrads), "local": local, "one": one, "root": root}


def test_shards_follow_the_specs(runs):
    for r in runs["ranks"]:
        got, want = r["shapes"]
        assert got == want
        split = [k for k, s in r["specs"].items() if s is not None and any(s)]
        assert len(split) >= 5, r["specs"]
    # the first step ran the gathers and their reduce-scatters
    assert {"all_gather", "reduce_scatter", "all_reduce"} <= set(runs["ranks"][0]["first_sent"])


def test_first_sharded_step_matches_single_device_jax(runs):
    jloss, jgrads = runs["jax"]
    for rank, r in enumerate(runs["ranks"]):
        loss, grads = r["first"]
        np.testing.assert_allclose(loss, jloss, rtol=0, atol=TOL)
        assert set(grads) == set(jgrads)
        for name, g in grads.items():
            np.testing.assert_allclose(g.numpy(), jgrads[name], rtol=0, atol=TOL,
                                       err_msg=f"rank {rank} {name}")


def test_sharded_steps_match_replicated(runs):
    for rank, r in enumerate(runs["ranks"]):
        got, want = r["sharded"], r["replicated"]
        for (lg, ng), (lw, nw) in zip(got["metrics"], want["metrics"]):
            assert abs(lg - lw) <= REL * abs(lw) and abs(ng - nw) <= REL * abs(nw)
        for key in ("params", "m", "v"):
            for name, t in want[key].items():
                assert got[key][name].shape == t.shape
                assert _rel(got[key][name], t) <= REL, (rank, key, name)


def test_compressed_sharded_steps_match_one_process(runs):
    want = runs["local"]
    for rank, r in enumerate(runs["ranks"]):
        got = r["compressed"]
        for (lg, _), (lw, _) in zip(got["metrics"], want["metrics"]):
            np.testing.assert_allclose(lg, lw, rtol=0, atol=TOL)
        for key in ("params", "err"):
            for name, t in want[key].items():
                np.testing.assert_allclose(got[key][name].numpy(), t.numpy(), rtol=0, atol=TOL,
                                           err_msg=f"rank {rank} {key} {name}")


def _members(path):
    with zipfile.ZipFile(path) as z:
        return {name: z.read(name) for name in z.namelist()}


def test_sharded_checkpoint_equals_the_replicated_one(runs):
    """Step 2's manifest and every array, byte for byte (the npz's zip
    headers carry the write time, so the archives are compared by member)."""
    r0 = runs["ranks"][0]
    assert r0["train_sharded"] == r0["train_replicated"]
    rep, sha = (runs["root"] / key / "step_000000002" for key in ("replicated", "sharded"))
    assert (rep / "manifest.json").read_bytes() == (sha / "manifest.json").read_bytes()
    a, b = _members(rep / "arrays.npz"), _members(sha / "arrays.npz")
    assert len(a) == 1 + 3 * 12 and a == b
    assert sorted(os.listdir(rep)) == sorted(os.listdir(sha))


def test_elastic_remesh_onto_data_4(runs):
    leaves, loss = runs["one"]
    for r in runs["ranks"]:
        got = r["remesh"]
        assert got["step"] == 2 and got["shapes"] == got["want"]
        assert len(got["leaves"]) == len(leaves)
        for i, (a, b) in enumerate(zip(got["leaves"], leaves)):
            assert _equal(a, b), i
        np.testing.assert_allclose(got["loss"], loss, rtol=0, atol=TOL)
