"""Rank functions for the port's multi-rank CPU tests (tests/test_torch_ring.py,
tests/test_torch_distribution.py, tests/test_torch_sharded_state.py), run by
``repro_torch.launch.mesh.spawn``.

The ranks start from a fresh interpreter and import this module by name, so
it imports neither JAX nor the JAX package: the tests compute their JAX
references in the parent and hand the ranks numpy inputs.
"""
import dataclasses

import numpy as np
import torch

from repro_torch.configs.base import AttentionConfig, ModelConfig, TrainPolicy
from repro_torch.distributed import ring as R
from repro_torch.distributed.sharding import axis_rules, current_mesh
from repro_torch.launch.mesh import make_debug_mesh
from repro_torch.models import attention as attn


def _t(a, grad=False):
    return torch.tensor(np.asarray(a), requires_grad=grad)


def _run(fn):
    """fn() with the ring's counters and the mesh's byte counts reset; ->
    (fn's result, the counters, the bytes by collective)."""
    R.STATS.reset()
    current_mesh().reset_counts()
    out = fn()
    return out, dataclasses.asdict(R.STATS), dict(current_mesh().sent)


def ring_codes(c, d, scale):
    """ring_sfa on codes, L = sum(o^2): o and the code-value gradients."""
    qv, kv, v = _t(c["qv"], True), _t(c["kv"], True), _t(c["v"], True)
    o = R.ring_sfa(qv, _t(c["qi"]), kv, _t(c["ki"]), v, d=d, scale=scale)
    (o ** 2).sum().backward()
    return {"o": o.detach(), "dqv": qv.grad, "dkv": kv.grad, "dv": v.grad}


def ring_dense(c, sfa_k, scale):
    """ring_sfa_op on dense folded q/k/v, L = sum(o^2)."""
    q, k, v = _t(c["q"], True), _t(c["k"], True), _t(c["v"], True)
    o = R.ring_sfa_op(q, k, v, sfa_k=sfa_k, scale=scale)
    (o ** 2).sum().backward()
    return {"o": o.detach(), "dq": q.grad, "dk": k.grad, "dv": v.grad}


def ring_layer_config(**att):
    """The llama-geometry layer of the reference's ring test: 8 query heads
    over 2 kv heads of 32, k 4, RoPE theta 500k, compact2, ring."""
    a = AttentionConfig(num_heads=8, num_kv_heads=2, head_dim=32, sfa_k=4, rope=True,
                        rope_theta=500_000.0, backend="cuda", bwd_emit="compact2",
                        ring=True, **att)
    return ModelConfig(name="ring-test", family="dense", num_layers=1, d_model=64, d_ff=64,
                       vocab_size=64, attention=a)


def ring_layer(params, x):
    """One attention layer (train mode) under the ring: out and the
    gradients of w_qkv, w_o and x for L = sum(o·w + o²/2)."""
    cfg = ring_layer_config()
    p = {name: {"w": _t(w["w"], True)} for name, w in params.items()}
    xt = _t(x, True)
    attn.clear_ring_reports()
    o = attn.attention_apply(p, xt, cfg=cfg, mode="train").out
    w = torch.arange(o.numel(), dtype=o.dtype).reshape(o.shape) / o.numel()
    (o * w + 0.5 * o * o).sum().backward()
    return {"o": o.detach(), "w_qkv": p["w_qkv"]["w"].grad, "w_o": p["w_o"]["w"].grad,
            "dx": xt.grad, "reports": [dataclasses.asdict(r) for r in attn.ring_reports()]}


def ring_reasons():
    cfg = ring_layer_config()
    plain = dataclasses.replace(cfg, attention=dataclasses.replace(
        cfg.attention, num_kv_heads=8, rope=False, bwd_emit="compact"))
    return {"256": attn.ring_ineligible_reason(plain, n=256),
            "255": attn.ring_ineligible_reason(plain, n=255),
            "window": attn.ring_ineligible_reason(plain, window=16, n=256),
            "seam": attn.compact_seam_ineligible_reason(plain)}


def ring_worker(cases, d, scale, sfa_k, layer):
    """Every ring check of tests/test_torch_ring.py on one set of ranks:
    on the seq-4 mesh (one ring of 4) and the seq-2 mesh (data 2 x a ring
    of 2), the code-level op on each case of ``cases`` and the dense op on
    the "random" case; on the seq-4 mesh the llama-geometry layer and the
    routing reasons. Each entry carries the ring's counters and the bytes
    this rank sent."""
    out = {"rank": torch.distributed.get_rank()}
    for p in (4, 2):
        mesh = make_debug_mesh(seq=p)
        with axis_rules(mesh):
            for name, c in cases.items():
                out[(p, "codes", name)] = _run(lambda c=c: ring_codes(c, d, scale))
            out[(p, "dense", "random")] = _run(
                lambda: ring_dense(cases["random"], sfa_k, scale))
            if p == 4:
                out["layer"] = _run(lambda: ring_layer(*layer))
                out["reasons"] = ring_reasons()
                out["wire"] = mesh.transports
    out["reasons_outside"] = ring_reasons()
    return out


# --------------------------------------------------------------------------
# tests/test_torch_distribution.py
# --------------------------------------------------------------------------

def _model(cfg, params):
    from repro_torch.interop import from_jax
    return from_jax(params, cfg, device="cpu").requires_grad_(True)


def seam_grads(cfg, params, batch, mesh_kw):
    """The train step's loss and gradients (``train_step.loss_and_grads``)
    of the global ``batch`` on the mesh ``make_debug_mesh(**mesh_kw)``,
    with the compact seam's counters and routing."""
    from repro_torch.kernels import reset_launches
    from repro_torch.train.train_step import loss_and_grads
    mesh = make_debug_mesh(**mesh_kw)
    model = _model(cfg, params)
    reset_launches()
    attn.clear_compact_seam_reports()
    with axis_rules(mesh):
        loss, metrics, grads = loss_and_grads(model, batch, cfg)
    return {"loss": float(loss.detach()), "tokens": float(metrics["tokens"]),
            "grads": grads,
            "seam": [r.taken for r in attn.compact_seam_reports()],
            "sent": dict(mesh.sent)}


def compressed_steps(cfg, params, batches, fraction, mesh_kw):
    """Two steps of ``make_train_step(grad_compression=fraction)`` on the
    mesh (None: one process): the parameters and residuals after each."""
    from repro_torch.optim import OptimizerConfig, init_opt_state
    from repro_torch.distributed.compression import init_error_state
    from repro_torch.train.train_step import make_train_step
    model = _model(cfg, params)
    opt = init_opt_state(dict(model.named_parameters()))
    err = init_error_state(model)
    step = make_train_step(cfg, OptimizerConfig(lr=1e-2, warmup_steps=1, total_steps=4),
                           grad_compression=fraction,
                           policy=TrainPolicy.from_model(cfg))
    mesh = None if mesh_kw is None else make_debug_mesh(**mesh_kw)
    out = []
    for batch in batches:
        if mesh is None:
            model, opt, m, err = step(model, opt, batch, err)
        else:
            with axis_rules(mesh):
                model, opt, m, err = step(model, opt, batch, err)
        out.append({"loss": float(m["loss"]),
                    "params": {k: p.detach().clone() for k, p in model.named_parameters()},
                    "err": {k: e.clone() for k, e in err.items()}})
    return out


def _one_process_run(ckpt_dir, cfg, ocfg, dcfg):
    """A Trainer without a mesh: 2 steps, checkpointed at step 2, then
    step 2 again from that state -> (the state's leaves, that step's loss)."""
    from repro_torch.train import FTConfig, Trainer, TrainerConfig
    from repro_torch.train import checkpoint as ckpt
    tr = Trainer(cfg, ocfg, dcfg, TrainerConfig(total_steps=2, seed=5, log_every=10,
                                                ft=FTConfig(ckpt_dir=ckpt_dir, ckpt_every=2)),
                 device="cpu")
    tr.train()
    leaves = [x.clone() if torch.is_tensor(x) else np.asarray(x)
              for x in ckpt.tree_leaves(tr._save_state())]
    return leaves, tr.run_step(2)["loss"]


def remesh(ckpt_dir, cfg, mesh_kw):
    """Rank 0 alone (no mesh) trains 2 steps into a checkpoint; then every
    rank of the mesh restores it through ``elastic_remesh`` and runs step 2
    there: the restored leaves and that step's loss (and rank 0's
    one-process ones)."""
    from repro_torch.data import DataConfig
    from repro_torch.optim import OptimizerConfig
    from repro_torch.train import Trainer, TrainerConfig
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train.fault_tolerance import elastic_remesh
    from repro_torch.train.train_step import make_train_step
    ocfg = OptimizerConfig(lr=3e-3, warmup_steps=2, total_steps=10)
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=32, global_batch=2)
    one = _one_process_run(ckpt_dir, cfg, ocfg, dcfg) if torch.distributed.get_rank() == 0 \
        else None
    mesh = make_debug_mesh(**mesh_kw)
    policy = TrainPolicy.from_model(cfg, ring=mesh.size("seq") > 1)
    tr = Trainer(cfg, ocfg, dcfg, TrainerConfig(total_steps=10, seed=7, policy=policy),
                 device="cpu")
    step_fn, state, step = elastic_remesh(
        lambda m: make_train_step(cfg, ocfg, policy=policy), mesh, ckpt_dir,
        tr._save_state())
    tr._load_state(state)
    leaves = [x.clone() if torch.is_tensor(x) else np.asarray(x)
              for x in ckpt.tree_leaves(tr._save_state())]
    attn.clear_ring_reports()
    with axis_rules(mesh):
        tr.step_fn = step_fn
        metrics = tr.run_step(step)
    return {"step": step, "leaves": leaves, "loss": metrics["loss"],
            "ring": [r.taken for r in attn.ring_reports()], "one": one}


def tp_regions():
    """``tp_proj_rtopk`` (each rank projects and sparsifies 2 of 4 heads,
    the codes gathered) against one ``proj_rtopk`` over all 4, with RoPE;
    ``tp_degree`` and ``replicate`` inside and outside the mesh."""
    from repro_torch.distributed.shard import replicate, tp_degree, tp_proj_rtopk
    from repro_torch.kernels import proj_rtopk
    gen = torch.Generator().manual_seed(0)
    x, w = torch.randn(2, 16, 32, generator=gen), torch.randn(4, 32, 32, generator=gen)
    pos = torch.arange(16)[None].expand(2, 16)
    kw = dict(k=4, rope_spec=(10_000.0, 32))
    want = proj_rtopk(x, w, pos, **kw)
    mesh = make_debug_mesh(model=2)
    with axis_rules(mesh):
        got = tp_proj_rtopk(x, w, pos, **kw)
        inside = tp_degree(), replicate(x) is x
    return {"equal": all(torch.equal(a, b) for a, b in zip(got, want)),
            "sent": dict(mesh.sent), "degrees": (inside[0], tp_degree()), "replicate": inside[1]}


def distribution_worker(cfg, params, batch, fraction, cbatches, ckpt_dir, tiny):
    """Every multi-rank check of tests/test_torch_distribution.py on two
    ranks: the TP-2 seam step, the DP-2 step, two compressed DP-2 steps and
    an elastic re-mesh onto a ring of 2."""
    seam_cfg = dataclasses.replace(cfg, attention=dataclasses.replace(
        cfg.attention, backend="cuda", bwd_emit="compact"), remat="codes")
    return {"regions": tp_regions(),
            "tp": seam_grads(seam_cfg, params, batch, {"model": 2}),
            "dp": seam_grads(seam_cfg, params, batch, {"data": 2}),
            "compressed": compressed_steps(cfg, params, cbatches, fraction, {"data": 2}),
            "remesh": remesh(ckpt_dir, tiny, {"seq": 2})}


# --------------------------------------------------------------------------
# tests/test_torch_sharded_state.py
# --------------------------------------------------------------------------

def _gathered(named, tree):
    """Each tensor of the flat dict ``tree`` (a parameter's, or its
    gradient or moment) gathered whole by its parameter's spec."""
    from repro_torch.distributed.shard import gather_full, spec_of
    return {k: gather_full(t.detach(), spec_of(named[k])) for k, t in tree.items()}


def placed_steps(cfg, params, batches, specs, fraction=None, device="cpu"):
    """``len(batches)`` steps of ``make_train_step`` (AdamW, its default
    clip) from the JAX ``params`` (None: ``init`` on ``device``, seed 0),
    the state sharded by ``specs`` (None: replicated) on the active mesh:
    per step the loss and grad_norm, and after the last the parameters,
    moments and residuals gathered whole."""
    from repro_torch.distributed.compression import init_error_state
    from repro_torch.models.model import init
    from repro_torch.optim import OptimizerConfig, init_opt_state
    from repro_torch.train.train_step import make_train_step
    model = (_model(cfg, params) if params is not None
             else init(cfg, device=device, seed=0).requires_grad_(True))
    if specs is not None:
        model.shard(specs)
    named = dict(model.named_parameters())
    opt = init_opt_state(named)
    err = init_error_state(model) if fraction else None
    step = make_train_step(cfg, OptimizerConfig(lr=1e-2, warmup_steps=1, total_steps=4),
                           grad_compression=fraction, policy=TrainPolicy.from_model(cfg))
    metrics = []
    for batch in batches:
        out = step(model, opt, batch) if err is None else step(model, opt, batch, err)
        model, opt, m = out[:3]
        err = out[3] if err is not None else None
        metrics.append((float(m["loss"]), float(m["grad_norm"])))
    return {"metrics": metrics, "params": _gathered(named, named),
            "m": _gathered(named, opt.m), "v": _gathered(named, opt.v),
            "err": None if err is None else _gathered(named, err)}


def _sharded_trainer(cfg, ckpt_dir, specs, grad_clip):
    from repro_torch.data import DataConfig
    from repro_torch.optim import OptimizerConfig
    from repro_torch.train import FTConfig, Trainer, TrainerConfig
    return Trainer(cfg, OptimizerConfig(lr=3e-3, warmup_steps=2, total_steps=10,
                                        grad_clip=grad_clip),
                   DataConfig(vocab_size=cfg.vocab_size, seq_len=32, global_batch=4),
                   TrainerConfig(total_steps=2, seed=5, log_every=10,
                                 policy=TrainPolicy.from_model(cfg),
                                 ft=FTConfig(ckpt_dir=ckpt_dir, ckpt_every=2)),
                   device="cpu", specs=specs)


def sharded_state_worker(cfg, params, batches, cbatches, fraction, ckpt_root):
    """Every check of tests/test_torch_sharded_state.py on 4 ranks (data 2 x
    model 2; the re-mesh on data 4): shard shapes, the first step's loss and
    gathered gradients, two steps sharded and replicated, two compressed
    steps sharded, the Trainer's checkpoints sharded and replicated (clip
    off: the two runs then hold the same bits), and ``elastic_remesh`` of
    the sharded checkpoint onto data 4, one step there."""
    import os

    from repro_torch.distributed.shard import spec_of
    from repro_torch.launch import specs as S
    from repro_torch.models.model import param_tree
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train.fault_tolerance import elastic_remesh
    from repro_torch.train.train_step import loss_and_grads, make_train_step
    rank = torch.distributed.get_rank()
    shapes = param_tree(cfg, device="meta")
    mesh = make_debug_mesh(model=2, data=2)
    out = {"rank": rank}
    with axis_rules(mesh):
        specs = S.param_specs(shapes, cfg, mesh)
        want = {".".join(p): s for p, s in S.named_leaves(S.shardings_of(shapes, specs, mesh))}
        model = _model(cfg, params).shard(specs)
        named = dict(model.named_parameters())
        out["shapes"] = ({k: tuple(p.shape) for k, p in named.items()}, want)
        out["specs"] = {k: spec_of(p) for k, p in named.items()}
        mesh.reset_counts()
        loss, _, grads = loss_and_grads(model, batches[0], cfg)
        out["first"] = (float(loss.detach()), _gathered(named, grads))
        out["first_sent"] = dict(mesh.sent)
        out["replicated"] = placed_steps(cfg, params, batches, None)
        out["sharded"] = placed_steps(cfg, params, batches, specs)
        out["compressed"] = placed_steps(cfg, params, cbatches, specs, fraction)
        # the Trainer's checkpoints, replicated and sharded, clip off
        dirs = {k: os.path.join(ckpt_root, k) for k in ("replicated", "sharded")}
        for key, sp in (("replicated", None), ("sharded", specs)):
            tr = _sharded_trainer(cfg, dirs[key], sp, grad_clip=1e30)
            out[f"train_{key}"] = [e["loss"] for e in tr.train()]
    # elastic re-mesh of the sharded checkpoint onto data 4
    mesh4 = make_debug_mesh(data=4)
    with axis_rules(mesh4):
        specs4 = S.param_specs(shapes, cfg, mesh4)
        tr = _sharded_trainer(cfg, os.path.join(ckpt_root, "unused"), specs4, grad_clip=1e30)
        step_fn, state, step = elastic_remesh(
            lambda m: make_train_step(cfg, tr.opt_cfg, policy=tr.tcfg.policy), mesh4,
            dirs["sharded"], tr._save_state(), specs=specs4)
        tr._load_state(state)
        named = dict(tr.params.named_parameters())
        out["remesh"] = {"step": step,
                         "shapes": {k: tuple(p.shape) for k, p in named.items()},
                         "want": {".".join(p): s for p, s in S.named_leaves(
                             S.shardings_of(shapes, specs4, mesh4))},
                         "leaves": [x.clone() if torch.is_tensor(x) else np.asarray(x)
                                    for x in ckpt.tree_leaves(tr._save_state())]}
        tr.step_fn = step_fn
        out["remesh"]["loss"] = tr.run_step(step)["loss"]
    return out


# --------------------------------------------------------------------------
# tests/test_torch_gpu.py
# --------------------------------------------------------------------------

def ring_on_card(seed, bh, n, d, k):
    """On a ring of 2 on the card: bf16 ``ring_sfa`` of seeded codes
    against ``flash_sfa`` of the same codes on this rank; -> the largest
    difference, the largest |v| and where it ran."""
    from repro_torch.kernels import flash_sfa, launch_counts, reset_launches, rtopk
    dev = torch.device("cuda", torch.cuda.current_device())
    gen = torch.Generator().manual_seed(seed)
    q, kk, v = (torch.randn(bh, n, d, generator=gen).to(dev, torch.bfloat16) for _ in range(3))
    qv, qi = rtopk(q, k)
    kv, ki = rtopk(kk, k)
    want = flash_sfa(qv, qi, kv, ki, v, d=d)
    mesh = make_debug_mesh(seq=2)
    reset_launches()
    with axis_rules(mesh):
        got = R.ring_sfa(qv, qi, kv, ki, v, d=d)
    return {"err": (got.float() - want.float()).abs().max().item(),
            "vmax": v.float().abs().max().item(), "device": str(got.device),
            "wire": dict(mesh.transports), "flash_sfa": launch_counts()["flash_sfa"]}


def sharded_steps_on_card(cfg, batches):
    """On data 2 over 2 ranks of the card: two steps with the state sharded
    by the launcher's specs and the same two replicated."""
    from repro_torch.distributed.shard import named_leaves, split_axes
    from repro_torch.launch import specs as S
    from repro_torch.models.model import param_tree
    dev = torch.device("cuda", torch.cuda.current_device())
    mesh = make_debug_mesh(data=2)
    with axis_rules(mesh):
        specs = S.param_specs(param_tree(cfg, device="meta"), cfg, mesh)
        out = {"replicated": placed_steps(cfg, None, batches, None, device=dev)}
        mesh.reset_counts()
        out["sharded"] = placed_steps(cfg, None, batches, specs, device=dev)
    out["split"] = sum(bool(split_axes(s, mesh)) for _, s in named_leaves(specs))
    out["wire"] = dict(mesh.transports)
    out["sent"] = dict(mesh.sent)
    return out
