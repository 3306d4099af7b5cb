"""Ring-SFA of the port (``repro_torch.distributed.ring``) against the JAX
package's, on gloo ranks on the CPU.

The ranks start once for the module (``launch.mesh.spawn``, 4 ranks) and run
every case on a seq-4 mesh (one ring of 4) and a seq-2 mesh (data 2 x a
ring of 2); the JAX references run here in the parent, on one device, as
tests/test_ring.py holds its ring to them:

  * the byte model and ``ring_hop_stats`` equal the reference's exactly,
    and the bytes every rank passes to its sends equal the byte model;
  * ``ring_sfa`` and ``ring_sfa_op``, output and gradients, against JAX's
    ``flash_sfa`` + ``flash_sfa_bwd(emit="compact")`` (Pallas in interpret
    mode) at tests/test_ring.py's shapes, one case with banded codes that
    send hops to the closed form (hops computed / closed / skipped per rank
    summed against ``ring_hop_stats``);
  * one llama-geometry attention layer with ``ring=True`` against JAX's
    ``attention_apply`` (the single-device seam), the ring report taken;
  * the routing reasons against JAX's;
  * the hop bodies never densify K (a grep, as the reference's test).

Tolerance 1e-4 in f32 (the hops sum in another order), the repo's.
"""
import dataclasses
import functools
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dist_workers as W
from repro.configs.base import AttentionConfig as JaxAttentionConfig
from repro.configs.base import ModelConfig as JaxModelConfig
from repro.distributed import ring as JR
from repro.kernels.code_grad import scatter_code_grads as jax_scatter
from repro.kernels.flash_sfa import flash_sfa as jax_flash_sfa
from repro.kernels.flash_sfa_bwd import flash_sfa_bwd as jax_flash_sfa_bwd
from repro.kernels.rtopk import rtopk as jax_rtopk
from repro.models import attention as jax_attn
from repro_torch.distributed import ring as R
from repro_torch.launch.mesh import spawn

TOL = 1e-4
BH, N, D, K, DV = 4, 256, 64, 8, 64
SCALE = D ** -0.5
WORLD = 4


def _banded(seed=0, bh=2, k=4, dv=32, p=4):
    """tests/test_ring.py's closed-form case at P = 4: Q in features
    [0, 8), K shard 0 there too, shard s > 0 in [8s, 8s + 8)."""
    rs = np.random.default_rng(seed)
    nl = N // p
    qi = np.sort(rs.choice(8, size=(bh, N, k)), axis=-1)
    ki = np.empty((bh, N, k), np.int64)
    for s in range(p):
        ki[:, s * nl:(s + 1) * nl] = (0 if s == 0 else 8 * s) + np.sort(
            rs.choice(8, size=(bh, nl, k)), axis=-1)
    return {"qv": rs.normal(size=(bh, N, k)).astype(np.float32), "qi": qi.astype(np.int32),
            "kv": rs.normal(size=(bh, N, k)).astype(np.float32), "ki": ki.astype(np.int32),
            "v": rs.normal(size=(bh, N, dv)).astype(np.float32)}


def _random(seed=1):
    rs = np.random.RandomState(seed)
    q, k, v = (rs.randn(BH, N, D).astype(np.float32) for _ in range(3))
    qv, qi = (np.asarray(a) for a in jax_rtopk(jnp.asarray(q), K))
    kv, ki = (np.asarray(a) for a in jax_rtopk(jnp.asarray(k), K))
    return {"q": q, "k": k, "v": v, "qv": qv, "qi": qi.astype(np.int32), "kv": kv,
            "ki": ki.astype(np.int32)}


@functools.lru_cache(maxsize=None)
def _jax_compact(case):
    """Single-device reference for L = sum(o^2) on ``CASES[case]``:
    flash_sfa residuals and the compact-emit backward."""
    c, d, scale = CASES[case], D, SCALE
    a = [jnp.asarray(c[x]) for x in ("qv", "qi", "kv", "ki", "v")]
    o, lse = jax_flash_sfa(*a, d=d, causal=True, scale=scale, return_residuals=True)
    grads = jax_flash_sfa_bwd(*a, o, lse, 2.0 * o, d=d, causal=True, scale=scale,
                              emit="compact")
    return [np.asarray(t) for t in (o, *grads)]


def _layer_inputs():
    cfg = _jax_layer_config()
    rng = jax.random.PRNGKey(0)
    params = jax_attn.attention_init(rng, cfg)
    x = jax.random.normal(jax.random.fold_in(rng, 9), (2, N, cfg.d_model))
    return cfg, jax.tree.map(np.asarray, params), np.asarray(x)


def _jax_layer_config(**att):
    a = JaxAttentionConfig(num_heads=8, num_kv_heads=2, head_dim=32, sfa_k=4, rope=True,
                           rope_theta=500_000.0, backend="pallas", bwd_emit="compact2",
                           ring=True, **att)
    return JaxModelConfig(name="ring-test", family="dense", num_layers=1, d_model=64,
                          d_ff=64, vocab_size=64, attention=a)


CASES = {}


@pytest.fixture(scope="module")
def runs():
    cases = CASES
    cases.update(random=_random(), banded=_banded())
    jcfg, jparams, x = _layer_inputs()
    out = spawn(W.ring_worker, WORLD, device="cpu", timeout_s=240,
                args=(cases, D, SCALE, K, (jparams, x)))
    return cases, (jcfg, jparams, x), out


# --------------------------------------------------------------------------
# the byte model and the hop statistics
# --------------------------------------------------------------------------

@pytest.mark.parametrize("widths", [{}, dict(val_bytes=2, idx_bytes=4, v_bytes=2)],
                         ids=["f32", "bf16-codes"])
def test_byte_model_equals_the_reference(widths):
    for p, bh, nl, k, dv in ((8, 2, 32, 8, 64), (4, 24, 1024, 8, 64), (2, 3, 7, 5, 80)):
        assert R.ring_bytes_per_hop(bh, nl, k, dv, **widths) == \
            JR.ring_bytes_per_hop(bh, nl, k, dv, **widths)
        assert R.ring_fwd_wire_bytes(p, bh, nl, k, dv, **widths) == \
            JR.ring_fwd_wire_bytes(p, bh, nl, k, dv, **widths)
        for gb in (4, 2):
            assert R.ring_bwd_wire_bytes(p, bh, nl, k, dv, grad_bytes=gb, **widths) == \
                JR.ring_bwd_wire_bytes(p, bh, nl, k, dv, grad_bytes=gb, **widths)
        assert R.ring_dense_bytes_per_hop(bh, nl, 64, dv) == \
            JR.ring_dense_bytes_per_hop(bh, nl, 64, dv)
    for d, k in ((64, 8), (128, 16), (64, 4)):
        assert R.ring_byte_ratio(d, k, **{k_: v for k_, v in widths.items()
                                          if k_ != "v_bytes"}) == \
            JR.ring_byte_ratio(d, k, **{k_: v for k_, v in widths.items() if k_ != "v_bytes"})
    # the chip phase's figures: full-width gpt2-small-sfa8 on a ring of 4
    w = dict(val_bytes=2, idx_bytes=4, v_bytes=2)
    assert R.ring_bytes_per_hop(24, 1024, 8, 64, **w) == 4_325_376
    assert R.ring_fwd_wire_bytes(4, 24, 1024, 8, 64, **w) == 12_976_128
    assert R.ring_bwd_wire_bytes(4, 24, 1024, 8, 64, grad_bytes=4, **w) == 41_287_680


@pytest.mark.parametrize("case", ["random", "banded"])
@pytest.mark.parametrize("p", [2, 4, 8])
def test_hop_stats_equal_the_reference(runs, case, p):
    c = runs[0][case]
    d = D if case == "random" else 64
    assert R.ring_hop_stats(c["qi"], c["ki"], p, d=d) == \
        JR.ring_hop_stats(jnp.asarray(c["qi"]), jnp.asarray(c["ki"]), p, d=d)


# --------------------------------------------------------------------------
# numerical parity with JAX's single-device kernels
# --------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["random", "banded"])
@pytest.mark.parametrize("p", [4, 2])
def test_ring_sfa_matches_single_device_jax(runs, case, p):
    cases, _, out = runs
    want = _jax_compact(case)
    for rank in out:
        got, _, _ = rank[(p, "codes", case)]
        for name, g, w in zip(("o", "dqv", "dkv", "dv"), (got["o"], got["dqv"],
                                                          got["dkv"], got["dv"]), want):
            np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=TOL,
                                       err_msg=f"rank {rank['rank']} {name}")


@pytest.mark.parametrize("case", ["random", "banded"])
@pytest.mark.parametrize("p", [4, 2])
def test_ring_hops_and_bytes(runs, case, p):
    """Summed over one ring, the hops computed / closed / skipped are
    ``ring_hop_stats``' (forward and backward alike); each rank's sends are
    the byte model's at f32 widths, forward P-1 hops, backward P."""
    cases, _, out = runs
    c = cases[case]
    bh, n, k = c["qv"].shape
    dv = c["v"].shape[-1]
    stats = JR.ring_hop_stats(jnp.asarray(c["qi"]), jnp.asarray(c["ki"]), p, d=64)
    ring = out[:p]                       # ranks 0..p-1: one ring on either mesh
    for way in ("fwd", "bwd"):
        assert sum(r[(p, "codes", case)][1][f"{way}_computed"] for r in ring) == \
            stats["computed"]
        assert sum(r[(p, "codes", case)][1][f"{way}_closed"] for r in ring) == \
            stats["overlap_skipped"]
        assert sum(r[(p, "codes", case)][1][f"{way}_skipped"] for r in ring) == \
            stats["causal_skipped"]
    if case == "banded" and p == 4:
        assert stats["overlap_skipped"] > 0
    fwd = JR.ring_fwd_wire_bytes(p, bh, n // p, k, dv)
    bwd = JR.ring_bwd_wire_bytes(p, bh, n // p, k, dv)
    for r in out:
        _, st, sent = r[(p, "codes", case)]
        assert (st["fwd_bytes"], st["bwd_bytes"], sent["ring"]) == (fwd, bwd, fwd + bwd)


@pytest.mark.parametrize("p", [4, 2])
def test_ring_sfa_op_matches_single_device_jax(runs, p):
    cases, _, out = runs
    c = cases["random"]
    o, dqc, dkc, dv = _jax_compact("random")
    want = (o, np.asarray(jax_scatter(jnp.asarray(dqc), jnp.asarray(c["qi"]), D)),
            np.asarray(jax_scatter(jnp.asarray(dkc), jnp.asarray(c["ki"]), D)), dv)
    for rank in out:
        got, _, _ = rank[(p, "dense", "random")]
        for name, w in zip(("o", "dq", "dk", "dv"), want):
            np.testing.assert_allclose(got[name].numpy(), w, rtol=0, atol=TOL,
                                       err_msg=f"rank {rank['rank']} {name}")


def test_ring_layer_matches_jax_attention_apply(runs):
    """The llama-geometry layer (GQA 8:2, RoPE theta 500k, compact2,
    ring=True) on a ring of 4 against JAX's single-device layer (its
    compact seam, the ring flag inert outside a mesh), <= 1e-4, and the
    ring report taken with its transport."""
    _, (jcfg, jparams, x), out = runs
    params = jax.tree.map(jnp.asarray, jparams)

    def loss(p, x):
        o = jax_attn.attention_apply(p, x, cfg=jcfg, mode="train").out
        w = jnp.arange(o.size, dtype=o.dtype).reshape(o.shape) / o.size
        return jnp.sum(o * w + 0.5 * o * o), o

    (_, o_ref), g_ref = jax.jit(jax.value_and_grad(loss, argnums=(0, 1), has_aux=True))(
        params, jnp.asarray(x))
    want = {"o": o_ref, "w_qkv": g_ref[0]["w_qkv"]["w"], "w_o": g_ref[0]["w_o"]["w"],
            "dx": g_ref[1]}
    for rank in out:
        got, stats, sent = rank["layer"]
        assert [(r["taken"], r["transport"]) for r in got["reports"]] == \
            [(True, "gloo, device")]
        for name, w in want.items():
            np.testing.assert_allclose(got[name].numpy(), np.asarray(w), rtol=0, atol=TOL,
                                       err_msg=f"rank {rank['rank']} {name}")
        assert stats["calls"] == 1 and sent["ring"] == stats["fwd_bytes"] + stats["bwd_bytes"]


def test_ring_reasons_match_jax(runs, monkeypatch):
    """The ring and compact-seam reasons inside the seq-4 mesh and outside
    any mesh, against JAX's (its ring degree patched to 4: this process has
    one device)."""
    _, _, out = runs
    jcfg = _jax_layer_config()
    plain = dataclasses.replace(jcfg, attention=dataclasses.replace(
        jcfg.attention, num_kv_heads=8, rope=False, bwd_emit="compact"))

    def reasons():
        return {"256": jax_attn.ring_ineligible_reason(plain, n=256),
                "255": jax_attn.ring_ineligible_reason(plain, n=255),
                "window": jax_attn.ring_ineligible_reason(plain, window=16, n=256),
                "seam": jax_attn.compact_seam_ineligible_reason(plain)}

    outside = reasons()
    monkeypatch.setattr(jax_attn, "ring_degree", lambda axis_name="seq": 4)
    inside = reasons()
    assert inside["256"] is None and "divide" in inside["255"]
    assert "ring" in inside["seam"] and outside["seam"] is None
    for rank in out:
        assert rank["reasons"] == inside
        assert rank["reasons_outside"] == outside


def test_ring_falls_back_outside_a_mesh():
    """Outside a seq mesh both ops are the single-device composition."""
    c = _random()
    t = {k: torch.from_numpy(v) for k, v in c.items()}
    from repro_torch.kernels import flash_sfa, rtopk
    want = flash_sfa(t["qv"], t["qi"], t["kv"], t["ki"], t["v"], d=D, scale=SCALE)
    got = R.ring_sfa(t["qv"], t["qi"], t["kv"], t["ki"], t["v"], d=D, scale=SCALE)
    assert torch.equal(got, want)
    qv, qi = rtopk(t["q"], K)
    kv, ki = rtopk(t["k"], K)
    want = flash_sfa(qv, qi, kv, ki, t["v"], d=D, scale=SCALE)
    assert torch.equal(R.ring_sfa_op(t["q"], t["k"], t["v"], sfa_k=K, scale=SCALE), want)
    with pytest.raises(NotImplementedError, match="causal"):
        R.ring_sfa(t["qv"], t["qi"], t["kv"], t["ki"], t["v"], d=D, causal=False)


def test_hop_bodies_never_densify_k():
    banned = ("scatter_code_grads", "densify", "one_hot", "index_put", "scatter_")
    for body in (R._ring_fwd_local, R._ring_bwd_local):
        src = inspect.getsource(body)
        for token in banned:
            assert token not in src, (body.__name__, token)
    # the occupancy helper is the exception: a d-bit bitmap, outside the hops
    occ = R._occupancy(torch.tensor([[1, 3], [3, 5]], dtype=torch.int32), 8)
    assert occ.tolist() == [False, True, False, True, False, True, False, False]


def test_wire_of_cpu_tensors(runs):
    """On CPU tensors every collective goes to gloo as it is."""
    for rank in runs[2]:
        assert rank["wire"] == {"ring": "gloo, device", "all_gather": "gloo, device"}
