"""Optimizer, schedule, data pipeline and train policy against the JAX
package, on the same numpy inputs.

AdamW and Lion update a tree shaped like the JAX param tree, stacked
per-layer LayerNorm leaves (num_layers, d_model) included: JAX decays every
leaf with ndim >= 2, so those are decayed in both. Parameters agree to 1e-6
(f32, one step), the schedule to 1e-6 relative, and the synthetic batches
exactly.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs.base import TrainPolicy as JaxTrainPolicy
from repro.data import DataConfig as JaxDataConfig
from repro.data import copy_batch as jax_copy_batch
from repro.data import markov_batch as jax_markov_batch
from repro.optim import OptimizerConfig as JaxOptimizerConfig
from repro.optim import init_opt_state as jax_init_opt_state
from repro.optim import make_optimizer as jax_make_optimizer
from repro.optim.optimizer import schedule_lr as jax_schedule_lr
from repro_torch.configs import get_config
from repro_torch.configs.base import TrainPolicy
from repro_torch.data import DataConfig, batches, copy_batch, markov_batch
from repro_torch.optim import (
    OptimizerConfig, global_norm, init_opt_state, make_optimizer, schedule_lr,
)


def _tree(rs):
    """A JAX-shaped tree: embedding, one stacked 3-layer segment with
    LayerNorm scale/bias (3, 16), a (3, 16, 48) projection, a final norm."""
    f = lambda *s: rs.randn(*s).astype(np.float32)
    return {"embed": {"w": f(40, 16)},
            "segments": [{"ln1": {"scale": 1 + 0.1 * f(3, 16), "bias": 0.1 * f(3, 16)},
                          "attn": {"w_qkv": {"w": f(3, 16, 48)}}}],
            "final_norm": {"scale": 1 + 0.1 * f(16), "bias": 0.1 * f(16)}}


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, list):
        items = enumerate(tree)
    else:
        return {prefix[:-1]: np.asarray(tree)}
    out = {}
    for key, sub in items:
        out.update(_flat(sub, f"{prefix}{key}."))
    return out


@pytest.mark.parametrize("schedule", ["cosine", "linear", "constant"])
def test_schedule_matches_jax(schedule):
    jc = JaxOptimizerConfig(lr=3e-3, warmup_steps=5, total_steps=20, schedule=schedule)
    tc = OptimizerConfig(lr=3e-3, warmup_steps=5, total_steps=20, schedule=schedule)
    for step in (0, 1, 3, 5, 12, 20, 25):
        np.testing.assert_allclose(schedule_lr(tc, step),
                                   float(jax_schedule_lr(jc, jnp.asarray(step))), rtol=1e-6)


@pytest.mark.parametrize("name", ["adamw", "lion"])
@pytest.mark.parametrize("step", [0, 4, 19])      # the update at steps 1, warmup, total
def test_optimizer_step_matches_jax(name, step):
    """One update from a state whose step counter is ``step``, with moments
    carried from earlier steps and a gradient big enough to be clipped."""
    rs = np.random.RandomState(step)
    params, grads = _tree(rs), jax.tree.map(lambda x: 3 * x, _tree(rs))
    m, v = _tree(rs), jax.tree.map(lambda x: np.abs(x), _tree(rs))
    jcfg = JaxOptimizerConfig(name=name, lr=3e-3, warmup_steps=5, total_steps=20)
    tcfg = OptimizerConfig(name=name, lr=3e-3, warmup_steps=5, total_steps=20)
    jstate = jax_init_opt_state(params)._replace(step=jnp.asarray(step, jnp.int32), m=m, v=v)
    jp, jst, jmet = jax_make_optimizer(jcfg)(jcfg, grads, jstate, params)
    tparams = {k: torch.from_numpy(a.copy()) for k, a in _flat(params).items()}
    state = init_opt_state(tparams)._replace(
        step=step, m={k: torch.from_numpy(a.copy()) for k, a in _flat(m).items()},
        v={k: torch.from_numpy(a.copy()) for k, a in _flat(v).items()})
    tgrads = {k: torch.from_numpy(a) for k, a in _flat(grads).items()}
    tp, tst, tmet = make_optimizer(tcfg)(tcfg, tgrads, state, tparams)
    assert tst.step == int(jst.step) == step + 1
    np.testing.assert_allclose(tmet["lr"], float(jmet["lr"]), rtol=1e-6)
    np.testing.assert_allclose(float(tmet["grad_norm"]), float(jmet["grad_norm"]), rtol=1e-6)
    for (k, want), (km, wm) in zip(_flat(jp).items(), _flat(jst.m).items()):
        np.testing.assert_allclose(tp[k].numpy(), want, rtol=0, atol=1e-6, err_msg=k)
        np.testing.assert_allclose(tst.m[km].numpy(), wm, rtol=0, atol=1e-6, err_msg=km)
    # the stacked norm leaves are decayed (ndim 2), the final norm is not
    assert tp["segments.0.ln1.scale"].ndim == 2


def test_global_norm_and_fresh_state():
    rs = np.random.RandomState(7)
    tree = {k: torch.from_numpy(a) for k, a in _flat(_tree(rs)).items()}
    want = np.sqrt(sum((a.double() ** 2).sum().item() for a in tree.values()))
    np.testing.assert_allclose(float(global_norm(tree)), want, rtol=1e-6)
    st = init_opt_state({"w": torch.zeros(2, 3, dtype=torch.bfloat16)})
    assert st.step == 0 and st.m["w"].dtype == st.v["w"].dtype == torch.float32


@pytest.mark.parametrize("fn,jfn", [(markov_batch, jax_markov_batch),
                                    (copy_batch, jax_copy_batch)])
def test_batches_equal_jax(fn, jfn):
    for seed, step in ((0, 0), (3, 7)):
        tc = DataConfig(vocab_size=97, seq_len=48, global_batch=4, seed=seed)
        jc = JaxDataConfig(vocab_size=97, seq_len=48, global_batch=4, seed=seed)
        t, j = fn(tc, step, host=1, nhosts=2), jfn(jc, step, host=1, nhosts=2)
        assert set(t) == set(j) == {"tokens", "labels"}
        for key in t:
            assert t[key].dtype == j[key].dtype == np.int32
            np.testing.assert_array_equal(t[key], j[key])
    cfg = DataConfig(vocab_size=97, seq_len=48, global_batch=2, kind="copy")
    np.testing.assert_array_equal(next(batches(cfg, 2))["tokens"], copy_batch(cfg, 2)["tokens"])


def test_train_policy_mirrors_jax():
    """Same fields and defaults, ``from_model``/``apply`` round trip, and
    the same config-time refusals; backend names follow each package's
    registry (the port's "torch" is JAX's "xla")."""
    tcfg = get_config("gpt2-small-sfa8").reduced()
    jcfg = jax_get_config("gpt2-small-sfa8").reduced()
    assert ([f.name for f in dataclasses.fields(TrainPolicy)]
            == [f.name for f in dataclasses.fields(JaxTrainPolicy)])
    assert TrainPolicy.from_model(tcfg).apply(tcfg) == tcfg
    assert (dataclasses.asdict(TrainPolicy.from_model(tcfg, remat="full"))
            == dataclasses.asdict(JaxTrainPolicy.from_model(jcfg, remat="full")))
    applied = TrainPolicy(remat="full", backend="cuda").apply(tcfg)
    assert applied.remat == "full" and applied.attention.backend == "cuda"
    with pytest.warns(DeprecationWarning):
        assert TrainPolicy(remat=True).validate(tcfg.attention).remat == "full"
    dense = get_config("gpt2-small").reduced()
    for bad, att in [(dict(remat="codes"), dense.attention),
                     (dict(remat="codes", backend="torch"), tcfg.attention),
                     (dict(ring=True), dense.attention), (dict(tp=3), tcfg.attention),
                     (dict(bwd_emit="sparse"), tcfg.attention),
                     (dict(backend="xla"), tcfg.attention)]:
        with pytest.raises(ValueError):
            TrainPolicy(**bad).validate(att)
