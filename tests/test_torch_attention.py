"""core/attention.py and forward_logits parity with the JAX package (f32)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.core import attention as jatt
from repro.models import forward_logits as jax_forward_logits
from repro.models import init as jax_init
from repro_torch.configs import get_config
from repro_torch.core import attention as tatt
from repro_torch.interop import from_jax
from repro_torch.models import forward_logits

TOL = 1e-4


def _qkv(seed, b=2, n=70, h=3, d=16):
    rs = np.random.RandomState(seed)
    return [rs.randn(b, n, h, d).astype(np.float32) for _ in range(3)]


def _both(fn_j, fn_t, arrays, **kw):
    want = np.asarray(fn_j(*(jnp.asarray(a) for a in arrays), **kw))
    got = fn_t(*(torch.from_numpy(a) for a in arrays), **kw).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)


@pytest.mark.parametrize("causal,window", [(True, None), (False, None), (True, 9)])
def test_dense_and_chunked_attention_match(causal, window):
    arrays = _qkv(0)
    _both(jatt.dense_attention_ref, tatt.dense_attention_ref, arrays,
          causal=causal, window=window)
    _both(jatt.chunked_attention, tatt.chunked_attention, arrays,
          causal=causal, window=window, chunk_size=32, q_chunk=48)


def test_sfa_attention_matches():
    arrays = _qkv(1)
    _both(jatt.sfa_attention, tatt.sfa_attention, arrays, sfa_k=4, chunk_size=32)
    _both(jatt.sfa_attention, tatt.sfa_attention, arrays, sfa_k=4, materialize=True)


def test_decode_attention_matches():
    rs = np.random.RandomState(2)
    q = rs.randn(3, 1, 2, 8).astype(np.float32)
    k, v = (rs.randn(3, 20, 2, 8).astype(np.float32) for _ in range(2))
    lens = np.array([5, 20, 11], np.int32)
    want = jatt.decode_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                 jnp.asarray(lens), window=4)
    got = tatt.decode_attention(torch.from_numpy(q), torch.from_numpy(k),
                                torch.from_numpy(v), torch.from_numpy(lens), window=4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=TOL)


def test_forward_logits_match():
    jc = dataclasses.replace(jax_get_config("gpt2-small-sfa8").reduced(), dtype="float32")
    tc = dataclasses.replace(get_config("gpt2-small-sfa8").reduced(), dtype="float32")
    jp = jax_init(jax.random.PRNGKey(3), jc)
    model = from_jax(jax.tree.map(np.asarray, jp), tc, device="cpu")
    toks = np.random.RandomState(4).randint(0, tc.vocab_size, size=(2, 24)).astype(np.int32)
    want = jax.jit(lambda p, t: jax_forward_logits(p, {"tokens": t}, jc).logits)(
        jp, jnp.asarray(toks))
    got = forward_logits(model, {"tokens": torch.from_numpy(toks).long()}, tc)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=TOL)
