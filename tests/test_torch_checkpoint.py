"""Checkpointing and fault tolerance of the port (``repro_torch.train``)
against the JAX package's ``repro.train``: the file format both ways, bit
for bit, on the reduced gpt2-small-sfa8 Trainer state; the asynchronous
writer's host copy; the Supervisor and the straggler monitor on the same
scripted steps and times; and a faulted port run against an uninterrupted
one. No model-level JAX compile: JAX's state is the port's ``init`` values
(as tests/test_torch_jamba.py does) and JAX's eager ``init_opt_state``.
"""
import dataclasses
import json
import os
import threading
from typing import NamedTuple

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import repro.train as jax_train
from repro.optim import init_opt_state as jax_init_opt_state
from repro.train import checkpoint as jax_ckpt
from repro.train import fault_tolerance as jax_ft
from repro_torch import train as port_train
from repro_torch.configs import get_config
from repro_torch.data import DataConfig
from repro_torch.interop import from_jax
from repro_torch.models.model import init
from repro_torch.optim import OptimizerConfig
from repro_torch.optim import optimizer as port_optimizer
from repro_torch.train import FTConfig, Trainer, TrainerConfig
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import fault_tolerance as ft

ARCH = "gpt2-small-sfa8"
STEPS = 10


def _manifest(path, step):
    with open(os.path.join(path, f"step_{step:09d}", "manifest.json")) as f:
        return json.load(f)


def _equal(a, b):
    """Bit equality of two leaves (tensors, numpy or JAX arrays, ints)."""
    a, b = (x.detach().cpu() if torch.is_tensor(x) else torch.from_numpy(np.array(x))
            for x in (a, b))
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)


def _trainer(ckpt_dir, ckpt_every=3, cfg=None, **ft_kw):
    cfg = cfg or get_config(ARCH).reduced()
    return Trainer(cfg, OptimizerConfig(lr=3e-3, warmup_steps=2, total_steps=STEPS),
                   DataConfig(vocab_size=cfg.vocab_size, seq_len=32, global_batch=2),
                   TrainerConfig(total_steps=STEPS, log_every=STEPS,
                                 ft=FTConfig(ckpt_dir=str(ckpt_dir), ckpt_every=ckpt_every,
                                             **ft_kw)),
                   device="cpu")


# --------------------------------------------------------------------------
# the port alone: round trip, corruption, garbage collection, leaf order
# --------------------------------------------------------------------------

class Pair(NamedTuple):
    first: object
    second: object


def _mixed_tree():
    gen = torch.Generator().manual_seed(0)
    return {"w": torch.randn(4, 3, generator=gen),
            "h": torch.randn(2, 5, generator=gen).bfloat16(),
            "f8": torch.randn(6, generator=gen).to(torch.float8_e4m3fn),
            "pair": Pair(torch.arange(7, dtype=torch.int32), [np.float32(2.5), 11])}


def test_checkpoint_roundtrip(tmp_path):
    """f32, bf16, fp8 and int32 tensors, a numpy scalar and a Python int
    restore bit for bit into zeros of their structure."""
    tree = _mixed_tree()
    ckpt.save(str(tmp_path), 7, tree, extra={"note": "x"})
    assert ckpt.latest_step(str(tmp_path)) == 7
    m = _manifest(tmp_path, 7)
    assert m["dtypes"] == ["float8_e4m3fn", "bfloat16", "int32", "float32", "int64", "float32"]
    assert m["extra"] == {"note": "x"} and m["num_leaves"] == 6
    like = {"w": torch.zeros(4, 3), "h": torch.zeros(2, 5, dtype=torch.bfloat16),
            "f8": torch.zeros(6, dtype=torch.float8_e4m3fn),
            "pair": Pair(torch.zeros(7, dtype=torch.int32), [np.float32(0), 0])}
    out = ckpt.restore(str(tmp_path), 7, like)
    assert list(out) == list(like) and isinstance(out["pair"], Pair)
    for got, want in zip(ckpt.tree_leaves(out), ckpt.tree_leaves(tree)):
        if torch.is_tensor(want) and want.dtype == torch.float8_e4m3fn:
            got, want = got.view(torch.uint8), want.view(torch.uint8)
        assert _equal(got, want) if not isinstance(want, int) else got == want


def test_checkpoint_detects_corruption(tmp_path):
    path = ckpt.save(str(tmp_path), 1, {"a": torch.arange(100, dtype=torch.float32)})
    npz = os.path.join(path, "arrays.npz")
    data = dict(np.load(npz))
    data["leaf_0"] = data["leaf_0"] + 1          # corrupt
    np.savez(npz, **data)
    with pytest.raises(IOError):
        ckpt.restore(str(tmp_path), 1, {"a": torch.zeros(100)})
    with pytest.raises(ValueError, match="leaf count"):
        ckpt.restore(str(tmp_path), 1, {"a": torch.zeros(100), "b": torch.zeros(1)})
    with pytest.raises(FileNotFoundError):
        ckpt.restore(str(tmp_path), 2, {"a": torch.zeros(100)})


def test_async_checkpointer_gc(tmp_path):
    cp = ckpt.AsyncCheckpointer(str(tmp_path), keep=2)
    for s in range(5):
        cp.save(s, {"x": torch.full((4,), float(s))})
    cp.wait()
    steps = sorted(int(n[5:]) for n in os.listdir(tmp_path) if n.startswith("step_"))
    assert steps == [3, 4]
    assert ckpt.restore(str(tmp_path), 4, {"x": torch.zeros(4)})["x"].tolist() == [4.0] * 4


def test_leaf_order_is_jax_order():
    """Sorted dict keys (not insertion order), list and tuple indices (12
    entries: not "10" before "2"), NamedTuple fields, as jax.tree_util."""
    tree = {"z": [np.full(1, i, np.float32) for i in range(12)],
            "a": Pair(np.zeros(2, np.float32), {"y": np.ones(3, np.float32),
                                                 "b": (np.full(4, 5, np.float32),)})}
    assert [x.tolist() for x in ckpt.tree_leaves(tree)] == \
        [x.tolist() for x in jax.tree_util.tree_leaves(tree)]


# --------------------------------------------------------------------------
# across the packages, both ways, on the reduced Trainer state
# --------------------------------------------------------------------------

def _jax_state(cfg, seed=3):
    """JAX's Trainer state on the port's init values, with random moments
    and step 5 (zeros would not tell leaves apart)."""
    params = jax.tree.map(lambda t: jnp.asarray(t.numpy()),
                          init(cfg, device="cpu", seed=seed).tree())
    rs = np.random.RandomState(seed)
    rand = lambda p: jnp.asarray(rs.randn(*p.shape).astype(np.float32))  # noqa: E731
    opt = jax_init_opt_state(params)
    opt = opt._replace(step=jnp.asarray(5, jnp.int32), m=jax.tree.map(rand, opt.m),
                       v=jax.tree.map(rand, opt.v))
    return {"params": params, "opt": opt}


def test_jax_checkpoint_restores_into_the_port_trainer(tmp_path):
    cfg = get_config(ARCH).reduced()
    jstate = _jax_state(cfg)
    jax_ckpt.save(str(tmp_path), 5, jstate)
    tr = _trainer(tmp_path / "unused", cfg=cfg)
    tr._load_state(ckpt.restore(str(tmp_path), 5, tr._save_state()))
    assert tr.opt_state.step == 5
    want = from_jax(jax.tree.map(np.asarray, jstate["params"]), cfg, device="cpu")
    assert [n for n, _ in tr.params.named_parameters()] == \
        [n for n, _ in want.named_parameters()]
    for (name, got), ref in zip(tr.params.named_parameters(), want.parameters()):
        assert _equal(got, ref), name
    assert all(p.requires_grad for p in tr.params.parameters())
    leaves = ckpt.tree_leaves(tr._save_state())
    jleaves = jax.tree_util.tree_leaves(jstate)
    assert len(leaves) == len(jleaves) == 37
    for i, (got, want_leaf) in enumerate(zip(leaves, jleaves)):
        assert _equal(got, want_leaf), i


def test_port_checkpoint_restores_into_jax(tmp_path):
    """Two port steps (moments nonzero), saved by the port and restored by
    JAX into its Trainer state; the manifests of the same state written by
    either package agree in CRCs, dtypes and shapes."""
    cfg = get_config(ARCH).reduced()
    tr = _trainer(tmp_path / "unused", cfg=cfg)
    for s in range(2):
        tr.run_step(s)
    ckpt.save(str(tmp_path), 2, tr._save_state())
    like = jax.tree.map(jnp.zeros_like, _jax_state(cfg))
    back = jax_ckpt.restore(str(tmp_path), 2, like)
    assert int(back["opt"].step) == 2
    for i, (got, want) in enumerate(zip(jax.tree_util.tree_leaves(back),
                                        ckpt.tree_leaves(tr._save_state()))):
        assert _equal(got, want), i
    jax_ckpt.save(str(tmp_path), 3, back)
    port_m, jax_m = _manifest(tmp_path, 2), _manifest(tmp_path, 3)
    for key in ("num_leaves", "crcs", "dtypes", "shapes"):
        assert port_m[key] == jax_m[key], key
    assert port_m["dtypes"][0] == "int32" and port_m["shapes"][0] == []


def test_bf16_and_fp8_leaves_cross_both_ways(tmp_path):
    """bf16 and fp8 through their unsigned views: the port's files restore
    in JAX as bf16 / fp8 bit for bit, and JAX's in the port."""
    gen = torch.Generator().manual_seed(1)
    tree = {"h": torch.randn(3, 5, generator=gen).bfloat16(),
            "f8": torch.randn(4, generator=gen).to(torch.float8_e5m2),
            "i": torch.arange(6, dtype=torch.int32)}
    ckpt.save(str(tmp_path), 1, tree)
    jlike = {"h": jnp.zeros((3, 5), jnp.bfloat16),
             "f8": jnp.zeros(4, ml_dtypes.float8_e5m2), "i": jnp.zeros(6, jnp.int32)}
    jout = jax_ckpt.restore(str(tmp_path), 1, jlike)
    assert jout["h"].dtype == jnp.bfloat16 and jout["f8"].dtype == ml_dtypes.float8_e5m2
    assert np.array_equal(np.asarray(jout["h"]).view(np.uint16),
                          tree["h"].view(torch.int16).numpy().view(np.uint16))
    assert np.array_equal(np.asarray(jout["f8"]).view(np.uint8),
                          tree["f8"].view(torch.uint8).numpy())
    jax_ckpt.save(str(tmp_path), 2, jout)
    assert _manifest(tmp_path, 1)["dtypes"] == _manifest(tmp_path, 2)["dtypes"] == \
        ["float8_e5m2", "bfloat16", "int32"]
    assert _manifest(tmp_path, 1)["crcs"] == _manifest(tmp_path, 2)["crcs"]
    out = ckpt.restore(str(tmp_path), 2, {k: torch.zeros_like(v) for k, v in tree.items()})
    assert out["h"].dtype == torch.bfloat16 and torch.equal(out["h"], tree["h"])
    assert torch.equal(out["f8"].view(torch.uint8), tree["f8"].view(torch.uint8))
    # onto another dtype: values converted, as the reference's astype
    f32 = ckpt.restore(str(tmp_path), 2, {"h": torch.zeros(3, 5), "f8": torch.zeros(4),
                                          "i": torch.zeros(6)})
    assert f32["h"].dtype == torch.float32 and torch.equal(f32["h"], tree["h"].float())


# --------------------------------------------------------------------------
# the asynchronous writer owns a host copy
# --------------------------------------------------------------------------

def test_async_save_writes_the_state_before_the_next_in_place_step(tmp_path, monkeypatch):
    """The writer is held back until an in-place optimizer step has run, so
    a writer that read the live tensors would save the later state."""
    tr = _trainer(tmp_path / "unused")
    tr.run_step(0)
    before = [t.clone() if torch.is_tensor(t) else t for t in
              ckpt.tree_leaves(tr._save_state())]
    stepped = threading.Event()
    save = ckpt.save

    def held_save(*args, **kwargs):
        assert stepped.wait(timeout=60)
        return save(*args, **kwargs)

    monkeypatch.setattr(ckpt, "save", held_save)
    cp = ckpt.AsyncCheckpointer(str(tmp_path), keep=2)
    cp.save(1, tr._save_state())
    tr.run_step(1)                                 # parameters, m and v change in place
    stepped.set()
    cp.wait()
    after = ckpt.tree_leaves(tr._save_state())
    restored = ckpt.tree_leaves(ckpt.restore(str(tmp_path), 1, tr._save_state()))
    assert not all(_equal(a, b) for a, b in zip(after[1:], before[1:]))
    for i, (got, want) in enumerate(zip(restored, before)):
        assert _equal(got, want), i


# --------------------------------------------------------------------------
# the Supervisor and the straggler monitor against the reference's
# --------------------------------------------------------------------------

def _scripted_run(sup_cls, cfg, state, add, faults, total=10):
    """Run a Supervisor over a step that adds ``step + 1`` to a counter and
    raises once at each step in ``faults``; -> (logs, restarts, the
    committed steps on disk, the final counter)."""
    pending = set(faults)
    holder = {"x": state}

    def step_fn(step):
        if step in pending:
            pending.discard(step)
            raise RuntimeError(f"fault at {step}")
        holder["x"] = add(holder["x"], step + 1)
        return {"loss": float(step)}

    sup = sup_cls(cfg, save_state=lambda: {"x": holder["x"]},
                  load_state=lambda s: holder.update(x=s["x"]))
    logs = sup.run(step_fn, total)
    steps = sorted(int(n[5:]) for n in os.listdir(cfg.ckpt_dir) if n.startswith("step_"))
    return logs, sup.restarts, steps, float(np.asarray(holder["x"]).sum())


@pytest.mark.parametrize("faults", [(4, 7), (1,), (9,)],
                         ids=["two-faults", "before-first-checkpoint", "last-step"])
def test_supervisor_matches_the_reference(tmp_path, faults):
    """The same logs (restart entries with the error's repr), restarts,
    committed steps and final state. A fault at step 1 comes before the
    first checkpoint: both packages resume at step 0 without resetting the
    state (a reference-side caveat the port mirrors)."""
    fields = dict(ckpt_every=3, keep=2, max_restarts=3)
    got = _scripted_run(ft.Supervisor, ft.FTConfig(ckpt_dir=str(tmp_path / "t"), **fields),
                        torch.zeros(3), lambda x, k: x + k, faults)
    want = _scripted_run(jax_ft.Supervisor,
                         jax_ft.FTConfig(ckpt_dir=str(tmp_path / "j"), **fields),
                         jnp.zeros(3), lambda x, k: x + k, faults)
    assert got == want
    assert got[1] == len(faults)


def test_supervisor_max_restarts_and_interrupt_match_the_reference(tmp_path):
    for i, (sup_cls, cfg_cls) in enumerate(((ft.Supervisor, ft.FTConfig),
                                            (jax_ft.Supervisor, jax_ft.FTConfig))):
        cfg = cfg_cls(ckpt_dir=str(tmp_path / str(i)), max_restarts=2)
        sup = sup_cls(cfg, save_state=lambda: {}, load_state=lambda s: None)

        def always(step):
            raise ValueError("bad")

        with pytest.raises(RuntimeError, match="exceeded max_restarts=2"):
            sup.run(always, 5)
        assert sup.restarts == 3

        def interrupt(step):
            raise KeyboardInterrupt

        with pytest.raises(KeyboardInterrupt):
            sup_cls(cfg, save_state=lambda: {}, load_state=lambda s: None).run(interrupt, 5)


def test_straggler_monitor_matches_the_reference():
    rs = np.random.RandomState(0)
    times = list(0.1 + 0.01 * rs.rand(80))
    for i in (2, 7, 30, 31, 60):
        times[i] = 0.5
    times[70] = 10.0
    runs = []
    for mon_cls, cfg_cls in ((ft.StragglerMonitor, ft.FTConfig),
                             (jax_ft.StragglerMonitor, jax_ft.FTConfig)):
        calls = []
        mon = mon_cls(cfg_cls(straggler_factor=3.0, min_steps_for_median=5),
                      on_straggler=lambda *a: calls.append(a))
        for step, dt in enumerate(times):
            mon.record(step, dt)
        runs.append((mon.events, calls))
    assert runs[0] == runs[1]
    assert runs[0][0] == [7, 30, 31, 60, 70]      # step 2 comes before the median's 5


def test_train_package_exports_the_reference_names():
    assert set(jax_train.__all__) <= set(port_train.__all__)
    assert dataclasses.asdict(ft.FTConfig()) == dataclasses.asdict(jax_ft.FTConfig())


# --------------------------------------------------------------------------
# recovery of the port's Trainer
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def uninterrupted(tmp_path_factory):
    tr = _trainer(tmp_path_factory.mktemp("clean"), ckpt_every=100)
    logs = tr.train()
    return logs, [t.clone() if torch.is_tensor(t) else t
                  for t in ckpt.tree_leaves(tr._save_state())]


@pytest.mark.parametrize("where", ["injector", "mid_update"])
def test_trainer_recovers_bitwise_from_a_fault(tmp_path, monkeypatch, uninterrupted, where):
    """A fault at step 7 — raised before the step, or inside the in-place
    AdamW update after half the leaves have new moments — restores step 6
    and replays: every step's metrics and the final parameters, m, v and
    step equal the uninterrupted run's bit for bit."""
    clean_logs, clean_state = uninterrupted
    tr = _trainer(tmp_path, ckpt_every=3)
    n_leaves = len(list(tr.params.parameters()))
    armed = {"step": None, "seen": 0}

    def injector(step):
        if step == 7 and armed["step"] is None:
            armed["step"] = step
            if where == "injector":
                raise RuntimeError("injected before step 7")

    is_matrix = port_optimizer._is_matrix

    def faulty_is_matrix(p):
        if armed["step"] is not None and armed["seen"] >= 0:
            armed["seen"] += 1
            if armed["seen"] > n_leaves // 2:
                armed["seen"] = -1
                raise RuntimeError("fault inside the in-place update")
        return is_matrix(p)

    if where == "mid_update":
        monkeypatch.setattr(port_optimizer, "_is_matrix", faulty_is_matrix)
    logs = tr.train(injector)
    restarts = [entry for entry in logs if "event" in entry]
    assert [(r["step"], r["event"]) for r in restarts] == [(6, "restart")]
    runs = [entry for entry in logs if "event" not in entry]
    assert [r["step"] for r in runs] == list(range(7)) + list(range(6, STEPS))
    by_step = {r["step"]: r for r in runs}
    assert runs[6] == runs[7]                    # the replayed step 6 equals the first
    assert [by_step[s] for s in range(STEPS)] == clean_logs
    for i, (got, want) in enumerate(zip(ckpt.tree_leaves(tr._save_state()), clean_state)):
        assert _equal(got, want), i


def test_elastic_remesh_restores_onto_the_placement_of_state_like(tmp_path):
    """The one-device form of the reference's contract: the step is rebuilt
    for the new placement and the newest checkpoint lands on ``state_like``'s
    devices and dtypes (here bf16 parameters from an f32 run)."""
    with pytest.raises(FileNotFoundError):
        ft.elastic_remesh(lambda mesh: mesh, "cpu", str(tmp_path), {})
    tr = _trainer(tmp_path, ckpt_every=4)
    tr.tcfg.total_steps = 5
    tr.train()
    state = tr._save_state()
    like = dict(state, params=jax.tree.map(lambda t: torch.zeros_like(t, dtype=torch.bfloat16),
                                           state["params"]))
    step_fn, out, step = ft.elastic_remesh(lambda mesh: ("step for", mesh), "cpu",
                                           str(tmp_path), like)
    assert step_fn == ("step for", "cpu") and step == 5
    assert out["params"]["embed"]["w"].dtype == torch.bfloat16
    assert torch.equal(out["params"]["embed"]["w"], state["params"]["embed"]["w"].bfloat16())
    assert torch.equal(out["opt"].m["embed"]["w"], state["opt"].m["embed"]["w"])
    assert int(out["opt"].step) == 5


def test_resumed_run_equals_the_uninterrupted_run(tmp_path, uninterrupted):
    """A run stopped after 5 steps and resumed by a new Trainer from its
    newest checkpoint (the README's recipe) ends as the 10-step run does."""
    clean_logs, clean_state = uninterrupted
    first = _trainer(tmp_path)
    first.tcfg.total_steps = 5
    first.train()
    tr = _trainer(tmp_path)
    step = ckpt.latest_step(str(tmp_path))
    tr._load_state(ckpt.restore(str(tmp_path), step, tr._save_state()))
    logs = ft.Supervisor(tr.tcfg.ft, save_state=tr._save_state,
                         load_state=tr._load_state).run(tr.run_step, STEPS, start_step=step)
    assert step == 5 and logs == clean_logs[5:]
    for i, (got, want) in enumerate(zip(ckpt.tree_leaves(tr._save_state()), clean_state)):
        assert _equal(got, want), i
