"""Distribution of the port (``repro_torch.distributed``, ``launch/mesh.py``)
against the JAX package, on gloo ranks on the CPU.

  * ``compress_tree`` bit for bit against JAX's on the same numpy gradients
    (a tree with tuple leaves, as tests/test_compression.py), and its error
    feedback unbiased over steps;
  * a checkpoint with the compression residuals ``"err"`` crossing both
    ways between the port's Trainer state and JAX's;
  * on 2 ranks, started once for the module (``launch.mesh.spawn``): a
    TP-2 step through the compact seam and a DP-2 step, loss and every
    gradient against JAX's single-device ones (``compact_reference`` of
    tests/test_torch_code_grad.py, remat "codes"), two compressed DP-2
    steps against the same steps in one process, and ``elastic_remesh``
    of a one-process checkpoint onto a ring of 2;
  * the meshes' axes and lines, and the reasons the compact seam gives
    under TP against JAX's;
  * the launcher with ``--reduced --ring 2 --device cpu`` for 2 steps.

Tolerance 1e-4 in f32, the repo's; compression and checkpoints exact.
"""
import dataclasses
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dist_workers as W
from repro.distributed.compression import compress_tree as jax_compress_tree
from repro.distributed.compression import init_error_state as jax_init_error_state
from repro.models import attention as jax_attn
from repro.models import init as jax_init
from repro.train import checkpoint as jax_ckpt
from repro_torch.configs import get_config
from repro_torch.data import DataConfig
from repro_torch.distributed.compression import compress_tree, init_error_state
from repro_torch.launch import train as launch_train
from repro_torch.launch.mesh import Mesh, make_debug_mesh, make_production_mesh, spawn
from repro_torch.models import attention as attn
from repro_torch.optim import OptimizerConfig
from repro_torch.train import FTConfig, Trainer, TrainerConfig
from repro_torch.train import checkpoint as ckpt
from test_torch_checkpoint import _equal, _jax_state
from test_torch_code_grad import _batch, _configs, compact_reference

TOL = 1e-4
FRACTION = 0.05


# --------------------------------------------------------------------------
# gradient compression
# --------------------------------------------------------------------------

def _tuple_leaf_grads(seed, scale=1.0):
    rs = np.random.RandomState(seed)
    mk = lambda *s: (rs.randn(*s) * scale).astype(np.float32)  # noqa: E731
    return {"attn": (mk(96, 48), mk(96, 48)), "mlp": mk(128, 40), "tiny": mk(8)}


def _torch_tree(tree):
    return jax.tree.map(torch.from_numpy, tree)


@pytest.mark.parametrize("fraction,min_size", [(0.05, 4096), (0.1, 64), (0.5, 1)])
def test_compress_tree_bit_for_bit_against_jax(fraction, min_size):
    """Two steps of error feedback: every compressed leaf and residual
    equal to JAX's bit for bit, the tuple leaves kept apart."""
    jerr = jax_init_error_state(jax.tree.map(jnp.asarray, _tuple_leaf_grads(0)))
    err = init_error_state(_torch_tree(_tuple_leaf_grads(0)))
    for seed in (1, 2):
        g = _tuple_leaf_grads(seed)
        jcomp, jerr = jax_compress_tree(jax.tree.map(jnp.asarray, g), jerr,
                                        fraction=fraction, min_size=min_size)
        comp, err = compress_tree(_torch_tree(g), err, fraction=fraction, min_size=min_size)
        assert isinstance(comp["attn"], tuple) and isinstance(err["attn"], tuple)
        for got, want in zip(jax.tree.leaves(comp) + jax.tree.leaves(err),
                             jax.tree.leaves(jcomp) + jax.tree.leaves(jerr)):
            assert got.dtype == torch.float32
            np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                          np.asarray(want).view(np.uint32))


def test_error_feedback_unbiased_over_steps():
    """sum_t comp_t + err_T == sum_t g_t (telescoping), and the tiny leaf
    passes through."""
    err = init_error_state(_torch_tree(_tuple_leaf_grads(0)))
    total_comp = total_true = None
    for seed in (1, 2, 3, 4):
        g = _torch_tree(_tuple_leaf_grads(seed))
        comp, err = compress_tree(g, err, fraction=FRACTION)
        add = lambda a, b: b if a is None else jax.tree.map(torch.add, a, b)  # noqa: E731
        total_comp, total_true = add(total_comp, comp), add(total_true, g)
        assert torch.equal(comp["tiny"], g["tiny"])
        assert float((comp["attn"][0] != 0).float().mean()) <= FRACTION + 1e-3
    for tc, e, tt in zip(jax.tree.leaves(total_comp), jax.tree.leaves(err),
                         jax.tree.leaves(total_true)):
        np.testing.assert_allclose((tc + e).numpy(), tt.numpy(), rtol=0, atol=TOL)


def test_init_error_state_of_a_model_is_per_parameter_zeros():
    from repro_torch.models.model import init
    model = init(get_config("gpt2-small-sfa8").reduced(), device="cpu", seed=0)
    err = init_error_state(model)
    names = [n for n, _ in model.named_parameters()]
    assert list(err) == names
    assert all(e.dtype == torch.float32 and not e.any() for e in err.values())


# --------------------------------------------------------------------------
# the Trainer's "err" state through checkpoints, both ways
# --------------------------------------------------------------------------

def _compressing_trainer(ckpt_dir, cfg, steps=4):
    return Trainer(cfg, OptimizerConfig(lr=3e-3, warmup_steps=2, total_steps=steps),
                   DataConfig(vocab_size=cfg.vocab_size, seq_len=32, global_batch=2),
                   TrainerConfig(total_steps=steps, log_every=steps, grad_compression=FRACTION,
                                 ft=FTConfig(ckpt_dir=str(ckpt_dir))),
                   device="cpu")


def test_err_state_crosses_checkpoints_both_ways(tmp_path):
    """Port -> JAX: two compressing port steps (residuals nonzero), saved,
    restored by JAX into its Trainer's layout {"err", "opt", "params"}
    bit for bit; JAX -> port: a JAX state with random residuals restored
    into the port's Trainer."""
    cfg = get_config("gpt2-small-sfa8").reduced()
    tr = _compressing_trainer(tmp_path / "unused", cfg)
    for s in range(2):
        tr.run_step(s)
    state = tr._save_state()
    assert list(state) == ["params", "opt", "err"]
    assert any(bool(e.any()) for e in ckpt.tree_leaves(state["err"]))
    ckpt.save(str(tmp_path), 2, state)
    jlike = _jax_state(cfg)
    jlike["err"] = jax_init_error_state(jlike["params"])
    back = jax_ckpt.restore(str(tmp_path), 2, jax.tree.map(jnp.zeros_like, jlike))
    leaves = ckpt.tree_leaves(state)
    jleaves = jax.tree_util.tree_leaves(back)
    assert len(leaves) == len(jleaves) == 37 + len(ckpt.tree_leaves(state["params"]))
    for i, (got, want) in enumerate(zip(jleaves, leaves)):
        assert _equal(got, want), i
    rs = np.random.RandomState(4)
    jlike["err"] = jax.tree.map(lambda p: jnp.asarray(rs.randn(*p.shape), jnp.float32),
                                jlike["params"])
    jax_ckpt.save(str(tmp_path), 7, jlike)
    tr2 = _compressing_trainer(tmp_path / "unused2", cfg)
    tr2._load_state(ckpt.restore(str(tmp_path), 7, tr2._save_state()))
    for i, (got, want) in enumerate(zip(ckpt.tree_leaves(tr2._save_state()),
                                        jax.tree_util.tree_leaves(jlike))):
        assert _equal(got, want), i


# --------------------------------------------------------------------------
# two ranks: TP-2 and DP-2 against JAX, compressed DP-2, elastic re-mesh
# --------------------------------------------------------------------------

def _f32_tiny():
    return dataclasses.replace(get_config("gpt2-small-sfa8").reduced(), dtype="float32")


@pytest.fixture(scope="module")
def dist_runs(tmp_path_factory):
    """The two ranks start first and run while JAX compiles its reference
    here (``compact_reference``: the same configs, batch and parameters)."""
    jc, tc = _configs("gpt2-small-sfa8", loss_chunk=16)
    batch = _batch(np.random.RandomState(6), jc.vocab_size)
    jp = jax.tree.map(np.asarray, jax_init(jax.random.PRNGKey(3), jc))
    rs = np.random.RandomState(11)
    cbatches = [_batch(rs, tc.vocab_size) for _ in range(2)]
    tmp = tmp_path_factory.mktemp("remesh")
    with ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(spawn, W.distribution_worker, 2, device="cpu", timeout_s=240,
                            args=(tc, jp, batch, FRACTION, cbatches, str(tmp), _f32_tiny()))
        tc_ref, batch_ref, jp_ref, jloss, jgrads = compact_reference(None)
        out = ranks.result()
    assert tc_ref == tc and all(np.array_equal(batch[k], batch_ref[k]) for k in batch)
    assert all(np.array_equal(a, b) for a, b in zip(jax.tree.leaves(jp),
                                                    jax.tree.leaves(jp_ref)))
    local = W.compressed_steps(tc, jp, cbatches, FRACTION, None)
    return (jloss, jgrads), out, local


@pytest.mark.parametrize("kind", ["tp", "dp"])
def test_two_rank_step_matches_single_device_jax(dist_runs, kind):
    """TP-2 (heads split over "model") and DP-2 (rows split over "data")
    through the compact seam under remat "codes": the loss and every
    gradient, on both ranks, against JAX's single-device ones."""
    (jloss, jgrads), out, _ = dist_runs
    for rank, r in enumerate(out):
        got = r[kind]
        assert got["seam"] == [True]
        assert got["tokens"] == 74.0
        np.testing.assert_allclose(got["loss"], jloss, rtol=0, atol=TOL)
        assert set(got["grads"]) == set(jgrads)
        for name, g in got["grads"].items():
            np.testing.assert_allclose(g.numpy(), jgrads[name], rtol=0, atol=TOL,
                                       err_msg=f"{kind} rank {rank} {name}")
    # TP moves codes and the seam's dx; DP only the gradient all-reduce
    assert set(out[0]["tp"]["sent"]) == {"all_gather", "all_reduce"}
    assert set(out[0]["dp"]["sent"]) == {"all_reduce"}


def test_tp_proj_rtopk_splits_the_heads(dist_runs):
    """Under a model axis of 2 each rank projects and sparsifies its 2 of 4
    heads; the gathered codes equal one proj_rtopk over all 4 bit for bit."""
    for r in dist_runs[1]:
        got = r["regions"]
        assert got["equal"] and got["replicate"] and got["degrees"] == (2, 1)
        assert set(got["sent"]) == {"all_gather"}


def test_compressed_dp_steps_match_one_process(dist_runs):
    """Two steps with top-5% compression on DP-2 against the same two steps
    in one process over the global batch: the parameters and residuals of
    both ranks."""
    _, out, local = dist_runs
    for rank, r in enumerate(out):
        for step, (got, want) in enumerate(zip(r["compressed"], local)):
            np.testing.assert_allclose(got["loss"], want["loss"], rtol=0, atol=TOL)
            for key in ("params", "err"):
                for name, t in want[key].items():
                    np.testing.assert_allclose(got[key][name].numpy(), t.numpy(), rtol=0,
                                               atol=TOL,
                                               err_msg=f"rank {rank} step {step} {key} {name}")


def test_elastic_remesh_onto_a_ring(dist_runs):
    """A one-process checkpoint restored by elastic_remesh on each rank of a
    ring of 2, bit for bit, then one step there: the ring taken, the loss
    the one-process step's."""
    _, out, _ = dist_runs
    leaves, loss = out[0]["remesh"]["one"]
    for r in out:
        got = r["remesh"]
        assert got["step"] == 2 and got["ring"] == [True]
        assert len(got["leaves"]) == len(leaves)
        for i, (a, b) in enumerate(zip(got["leaves"], leaves)):
            assert _equal(a, b), i
        np.testing.assert_allclose(got["loss"], loss, rtol=0, atol=TOL)


# --------------------------------------------------------------------------
# meshes, reasons, the launcher
# --------------------------------------------------------------------------

def test_mesh_of_one_process():
    """Without a process group a mesh holds one rank: every axis 1, the
    collectives the identity; the production meshes need 256 / 512 ranks."""
    mesh = make_debug_mesh(model=1)
    assert mesh.axis_names == ("data", "model") and mesh.shape == {"data": 1, "model": 1}
    assert make_debug_mesh(seq=1).axis_names == ("data", "model")
    x = torch.arange(6.0)
    assert mesh.all_gather(x, "model", 0) is x and mesh.all_reduce(x, "data") is x
    assert mesh.shift((x,), "seq")[0] is x and mesh.sent == {}
    with pytest.raises(ValueError, match="256"):
        make_production_mesh()
    with pytest.raises(ValueError, match="512"):
        make_production_mesh(multi_pod=True)
    with pytest.raises(ValueError, match="holds 2 ranks"):
        Mesh({"data": 2})


def test_sharding_rules_match_jax():
    """Under the one-process debug mesh the rules clean as the reference's
    ("pod" drops out, "seq" is absent without a seq axis): the specs of the
    model's pins equal JAX's PartitionSpecs; ``constrain`` is the identity
    and every helper is inert outside a mesh, as in JAX."""
    from jax.sharding import PartitionSpec as JP
    from repro.distributed import sharding as jsh
    from repro.launch.mesh import make_debug_mesh as jax_debug_mesh
    from repro_torch.distributed import sharding as sh
    pins = [("batch", None, "embed"), ("batch", "seq", None, "heads"), (None, "vocab"),
            ("moe_groups", "expert", None, "sfa_k")]
    x = torch.arange(6.0)
    assert sh.current_mesh() is None and sh.named_sharding(pins[0]) is None
    assert sh.logical_to_spec(pins[0]) == (None, None, None) and sh.axis_size("model") == 1
    jmesh, mesh = jax_debug_mesh(model=1), make_debug_mesh(model=1)
    with jsh.axis_rules(jmesh), sh.axis_rules(mesh):
        for pin in pins:
            assert JP(*sh.logical_to_spec(pin)) == jsh.logical_to_spec(pin), pin
        assert sh.current_mesh() is mesh and sh.axis_size("data") == 1
        assert sh.named_sharding(pins[0]) == (mesh, sh.logical_to_spec(pins[0]))
        assert sh.constrain(x, pins[0]) is x
    assert sh.current_mesh() is None


def test_compact_seam_tp_reasons_match_jax(monkeypatch):
    """Under a model axis of 2 the seam takes heads that divide it and
    refuses others with JAX's reason (JAX's axis size patched to 2)."""
    from repro.configs import get_config as jax_get_config
    from repro_torch.distributed import sharding
    jc = jax_get_config("gpt2-small-sfa8").reduced()
    tc = get_config("gpt2-small-sfa8").reduced()

    def both(heads, kv):
        j = dataclasses.replace(jc, attention=dataclasses.replace(
            jc.attention, num_heads=heads, num_kv_heads=kv, bwd_emit="compact"))
        t = dataclasses.replace(tc, attention=dataclasses.replace(
            tc.attention, num_heads=heads, num_kv_heads=kv, bwd_emit="compact"))
        return jax_attn.compact_seam_ineligible_reason(j), attn.compact_seam_ineligible_reason(t)

    class TwoWide:
        axis_names = ("data", "model")

        def size(self, axis):
            return 2 if axis == "model" else 1

    monkeypatch.setattr(jax_attn, "axis_size", lambda axis: 2 if axis == "model" else 1)
    with sharding.axis_rules(TwoWide()):
        ok, ok_t = both(4, 4)
        bad, bad_t = both(6, 3)
    assert ok is None and ok_t is None
    assert bad == bad_t and "divide the TP degree 2" in bad


def test_launcher_trains_on_a_ring_of_two(capfd):
    """``--reduced --ring 2 --device cpu`` spawns two ranks and trains 2
    steps; rank 0 logs, the ring is reported taken, and the losses are the
    one-process launcher's within bf16 rounding (the reduced model
    computes in bf16)."""
    argv = ["--reduced", "--device", "cpu", "--steps", "2", "--seq-len", "32", "--batch", "2"]
    ring = launch_train.main(argv + ["--ring", "2"])
    text = capfd.readouterr().out
    assert "ring at gpt2-small-sfa8-smoke/attention: taken (gloo, device)" in text
    assert text.count("step     0") == 1
    one = launch_train.main(argv)
    assert [e["step"] for e in ring] == [e["step"] for e in one] == [0, 1]
    for a, b in zip(ring, one):
        assert abs(a["loss"] - b["loss"]) <= 2 ** -7 * abs(b["loss"]), (a, b)
