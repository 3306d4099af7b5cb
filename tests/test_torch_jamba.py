"""The hybrid family's pieces (jamba-v0.1-52b) in the port against the JAX
package, f32: ``mamba_apply`` and the caches. The model itself is held in
``test_torch_jamba_model.py``.

A jamba super-block is 8 sublayers: attention at index 4, Mamba-1
(``models/mamba.py``) elsewhere, MoE on every second sublayer, an MLP of
width ``d_ff`` on the others. The decode caches hold the attention layer's
KV beside each Mamba sublayer's (conv window, ssm state) in a
``HybridCache`` (the states a ``RecurrentState``, no token axis). Held
here:

  * ``mamba_apply`` alone, weights carried from ``mamba_init``: prompts
    longer than the chunk with a ragged tail (output and final state on
    chunks of 256; every parameter gradient too on chunks of 8, through the
    chunk checkpoints), a prompt shorter than the conv width, and prefill
    -> decode steps equal to the full forward;
  * the paged and speculative engines' refusal with the reference's
    message; the byte model (2,432 B a token and attention layer at full
    width, counted over all 32 layers as the reference does) and the
    realized KV; the recurrent state's slot insert against the reference's
    slot update.

Tolerance 1e-4.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import mamba as jmamba
from repro.models import model as jmodel
from repro.serve import kv_cache as jserve
from repro_torch.configs import get_config
from repro_torch.core.kv_cache import (
    HybridCache, RecurrentState, cache_nbytes, state_nbytes,
)
from repro_torch.launch import serve as serve_launcher
from repro_torch.models import init, init_decode_caches, init_paged_decode_caches
from repro_torch.models import mamba as tmamba
from repro_torch.serve import (
    PagedDecodeEngine, PagedEngineConfig, SpeculativeDecodeEngine, SpeculativeEngineConfig,
)
from repro_torch.serve import kv_cache as tserve
from test_torch_rope_protect import _close, _flat_np

ARCH = "jamba-v0.1-52b"
TOL = 1e-4
NEAR_TIE = 0.05


def _pair():
    """(JAX config, port config): reduced to one super-block, f32, 4 query
    heads over 2 kv heads, MoE capacity factor 2."""
    out = []
    for get in (jax_get_config, get_config):
        c = get(ARCH).reduced()
        c = dataclasses.replace(
            c, num_layers=c.hybrid_period, dtype="float32", loss_chunk=16,
            moe=dataclasses.replace(c.moe, capacity_factor=2.0),
            attention=dataclasses.replace(c.attention, num_kv_heads=2))
        out.append(c)
    return out


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _jax_params(cfg, seed):
    """A JAX param tree of the port's ``init`` values (the trees share their
    layout, so the JAX model runs on them; this skips the JAX init's own
    compile)."""
    tree = init(cfg, device="cpu", seed=seed).tree()
    return jax.tree.map(lambda t: jnp.asarray(t.numpy()), tree)


def assert_greedy_streams(run_ref, prompts, streams, cache_dtype):
    """Each streamed token against the reference's logits over the stream
    so far (``run_ref(tokens) -> (b, n, vocab)``, one full forward): on f32
    caches the argmax; on bf16 caches the argmax or a near-tie, within
    ``NEAR_TIE`` of the max logit (bf16 rounding of the K/V cache and the
    recurrent state moves the logits by about that much)."""
    n0 = len(prompts[0])
    tokens = np.stack([np.concatenate([p, s]) for p, s in zip(prompts, streams)])
    lg = np.asarray(run_ref(tokens))[:, n0 - 1:-1]
    if cache_dtype == torch.float32:
        np.testing.assert_array_equal(lg.argmax(-1), tokens[:, n0:])
    else:
        gap = lg.max(-1) - np.take_along_axis(lg, tokens[:, n0:, None], -1)[..., 0]
        assert gap.max() <= NEAR_TIE, gap


def _torch_tree(tree):
    if isinstance(tree, dict):
        return {k: _torch_tree(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree, dtype=np.float32))


# --------------------------------------------------------------------------
# mamba_apply alone
# --------------------------------------------------------------------------

def _mamba(seed=0, d=16):
    ssm = jax_get_config(ARCH).reduced().ssm
    jp = jmamba.mamba_init(jax.random.PRNGKey(seed), d, ssm)
    return ssm, jp, _np_tree(jp)


@pytest.mark.parametrize("n,chunk,grads", [(270, 256, False), (20, 8, True), (2, 256, False)],
                         ids=["two-chunks-ragged", "chunks-of-8-grads", "shorter-than-conv"])
def test_mamba_prefill_state_and_grads_match_jax(n, chunk, grads):
    """Prefill output and state (conv tail, h) against the reference, on
    chunks of 256 (270 = 256 + 14) and of 8 (20 = 8 + 8 + 4, with every
    parameter gradient, through the port's chunk checkpoints), and below
    the conv width."""
    ssm, jp, npp = _mamba()
    rs = np.random.RandomState(n)
    x = rs.randn(2, n, 16).astype(np.float32)
    g = rs.randn(2, n, 16).astype(np.float32)
    jout, jst = jax.jit(lambda p, x: jmamba.mamba_apply(p, x, ssm, mode="prefill",
                                                        chunk=chunk))(jp, jnp.asarray(x))
    tp = _torch_tree(npp)
    with torch.no_grad():
        tout, tst = tmamba.mamba_apply(tp, torch.from_numpy(x), ssm, mode="prefill",
                                       chunk=chunk)
    _close(tout, jout)
    np.testing.assert_array_equal(tst["conv"].numpy(), np.asarray(jst["conv"]))
    _close(tst["h"], jst["h"])
    if not grads:
        return
    jgrads = jax.jit(jax.grad(lambda p: (jmamba.mamba_apply(p, jnp.asarray(x), ssm,
                                                            chunk=chunk)[0] * g).sum()))(jp)
    for leaf in jax.tree.leaves(tp):
        leaf.requires_grad_(True)
    out, _ = tmamba.mamba_apply(tp, torch.from_numpy(x), ssm, chunk=chunk)
    (out * torch.from_numpy(g)).sum().backward()
    want = _flat_np(jgrads)
    got = _flat_np(jax.tree.map(lambda t: t.grad.numpy(), tp))
    assert set(got) == set(want)
    for name in want:
        np.testing.assert_allclose(got[name], want[name], rtol=1e-4, atol=TOL, err_msg=name)


def test_mamba_decode_continues_the_prefill_as_the_full_forward():
    """Prefill of 5 tokens, then 4 decode steps on the carried state: each
    output is the full forward's at its position (and the reference's
    decode step's)."""
    ssm, jp, npp = _mamba(1)
    x = np.random.RandomState(3).randn(2, 9, 16).astype(np.float32)
    tp = _torch_tree(npp)
    jrun = jax.jit(lambda p, x, st, mode: jmamba.mamba_apply(p, x, ssm, mode=mode, state=st),
                   static_argnums=3)
    with torch.no_grad():
        full, _ = tmamba.mamba_apply(tp, torch.from_numpy(x), ssm, mode="eval")
        _, st = tmamba.mamba_apply(tp, torch.from_numpy(x[:, :5]), ssm, mode="prefill")
        jfull, jst = jrun(jp, jnp.asarray(x), None, "prefill")
        _close(full, jfull)
        _, jst = jrun(jp, jnp.asarray(x[:, :5]), None, "prefill")
        for i in range(5, 9):
            out, st = tmamba.mamba_apply(tp, torch.from_numpy(x[:, i:i + 1]), ssm,
                                         mode="decode", state=st)
            jout, jst = jrun(jp, jnp.asarray(x[:, i:i + 1]), jst, "decode")
            _close(out[:, 0], full[:, i].numpy())
            _close(out, jout)
            _close(st["h"], jst["h"])

def test_paged_and_speculative_engines_refuse_as_the_reference():
    """The reference's message, from the caches, both engines and the
    serve launcher's ``--paged``."""
    jc, tc = _pair()
    model = init(tc, device="cpu", seed=0)
    with pytest.raises(NotImplementedError) as want:
        jmodel.init_paged_decode_caches(jc, slots=2, num_pages=5, page_size=8, max_pages=2)
    with pytest.raises(NotImplementedError) as got:
        init_paged_decode_caches(tc, slots=2, num_pages=5, page_size=8, max_pages=2,
                                 device="cpu")
    assert str(got.value) == str(want.value)
    assert "recurrent state" in str(want.value)
    with pytest.raises(NotImplementedError, match="recurrent state"):
        PagedDecodeEngine(model, tc, PagedEngineConfig(max_slots=2, page_size=8), device="cpu")
    with pytest.raises(NotImplementedError, match="recurrent state"):
        SpeculativeDecodeEngine(model, tc, SpeculativeEngineConfig(max_slots=2, page_size=8),
                                device="cpu")
    with pytest.raises(NotImplementedError, match="recurrent state"):
        serve_launcher.main(["--arch", ARCH, "--device", "cpu", "--paged"])


def test_byte_model_and_realized_caches_equal_the_reference():
    """(8 x 16 x (2 + 1) + 8 x 128 x 2) = 2,432 B a token per attention
    layer, multiplied by all 32 layers as the reference's model does; the
    caches hold the 4 attention layers' KV, and the recurrent state apart."""
    jc, tc = jax_get_config(ARCH), get_config(ARCH)
    per = tserve.cache_bytes_per_token(tc)
    assert per == jserve.cache_bytes_per_token(jc)
    assert per == {"dense": 4_096 * 32, "sfa": 2_432 * 32, "fm": 4_096 * 32}
    realized = tserve.realized_cache_bytes_per_token(tc)
    assert realized == jserve.realized_cache_bytes_per_token(jc) == 2_432 * 4
    caches = init_decode_caches(tc, 8, 2048, device="meta")
    assert cache_nbytes(caches) == 2_432 * 4 * 8 * 2048
    assert state_nbytes(caches) == 4 * 7 * 8 * (4 * 8192 * 2 + 8192 * 16 * 4)


def test_recurrent_state_insert_write_and_layers():
    """A layer-stacked bf16 state takes an f32 batch-1 prefill state in slot
    1, cast as the reference's slot update casts; ``layer`` views and
    ``write`` land in the stacked storage."""
    tc = _pair()[1]
    caches = init_decode_caches(tc, 3, 8, device="cpu")
    assert isinstance(caches[0], HybridCache)
    st = caches[0].mamba
    assert isinstance(st, RecurrentState)
    rs = np.random.RandomState(5)
    src = [{"conv": rs.randn(1, 1, 4, 128).astype(np.float32),
            "h": rs.randn(1, 1, 128, 4).astype(np.float32)} for _ in range(7)]
    dst = [{k: rs.randn(*((1, 3) + a.shape[2:])).astype(np.float32) for k, a in d.items()}
           for d in src]
    t_dst = RecurrentState([{k: torch.from_numpy(a).to(st.tree[0][k].dtype) for k, a in d.items()}
                            for d in dst])
    t_dst.insert_slot(RecurrentState([_torch_tree(d) for d in src]), slot=1)
    for i in range(7):
        for k in ("conv", "h"):
            want = jax.lax.dynamic_update_slice(
                jnp.asarray(dst[i][k]).astype(jnp.bfloat16 if k == "conv" else jnp.float32),
                jnp.asarray(src[i][k]).astype(jnp.bfloat16 if k == "conv" else jnp.float32),
                (0, 1, 0, 0))
            np.testing.assert_array_equal(t_dst.tree[i][k].float().numpy(),
                                          np.asarray(want.astype(jnp.float32)))
    view = t_dst.layer(0)
    view.write([{"conv": torch.ones(3, 4, 128), "h": torch.full((3, 128, 4), 2.0)}] * 7)
    assert bool((t_dst.tree[6]["conv"] == 1).all()) and bool((t_dst.tree[6]["h"] == 2).all())
    assert t_dst.tree[6]["conv"].dtype == torch.bfloat16
