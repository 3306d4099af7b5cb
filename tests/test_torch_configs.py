"""Config parity: the port's config dataclasses equal the JAX package's.

Every field of ``dataclasses.asdict`` matches, except the two backend-name
fields, which follow each package's own registry. The stated mapping: the
JAX package's defaults are ``backend="xla"`` (its XLA oracle) and
``decode_backend="auto"``; the port's are both ``"auto"`` (its CUDA kernels
wherever they can serve the layer).
"""
import dataclasses

import pytest

from repro.configs import ASSIGNED_ARCHS
from repro.configs import get_config as jax_get_config
from repro.models.model import segments as jax_segments
from repro_torch.configs import NOT_YET_PORTED, get_config
from repro_torch.models import segments

NAMES = ["gpt2-small", "gpt2-small-sfa8", "gpt2-medium-sfa16",
         "qwen3-0.6b-sfa8", "moonshot-v1-16b-a3b"]

# (JAX default, port default) of the backend-name fields
BACKEND_FIELDS = {"backend": ("xla", "auto"), "decode_backend": ("auto", "auto")}


def _split_backends(d):
    att = d["attention"]
    names = {k: att.pop(k) for k in BACKEND_FIELDS} if att is not None else {}
    return d, names


@pytest.mark.parametrize("reduced", [False, True], ids=["full", "reduced"])
@pytest.mark.parametrize("name", NAMES)
def test_asdict_equal_across_packages(name, reduced):
    jc, tc = jax_get_config(name), get_config(name)
    if reduced:
        jc, tc = jc.reduced(), tc.reduced()
    jd, jnames = _split_backends(dataclasses.asdict(jc))
    td, tnames = _split_backends(dataclasses.asdict(tc))
    assert td == jd
    for field, (jax_value, port_value) in BACKEND_FIELDS.items():
        assert jnames[field] == jax_value
        assert tnames[field] == port_value


@pytest.mark.parametrize("name", ["gpt2-small-short2", "qwen3-0.6b",
                                  "qwen3-0.6b-short2", "gpt2-medium"])
def test_variant_names_match(name):
    jd, _ = _split_backends(dataclasses.asdict(jax_get_config(name)))
    td, _ = _split_backends(dataclasses.asdict(get_config(name)))
    assert td == jd


@pytest.mark.parametrize("reduced", [False, True], ids=["full", "reduced"])
@pytest.mark.parametrize("name", ["jamba-v0.1-52b", "rwkv6-3b"])
def test_recurrent_archs_equal_the_reference(name, reduced):
    """The hybrid and SSM archs resolve, equal to the JAX package's (rwkv6-3b
    has no attention, so no backend fields); no registered arch is left
    unported."""
    jc, tc = jax_get_config(name), get_config(name)
    if reduced:
        jc, tc = jc.reduced(), tc.reduced()
    jd, _ = _split_backends(dataclasses.asdict(jc))
    td, _ = _split_backends(dataclasses.asdict(tc))
    assert td == jd
    assert NOT_YET_PORTED == ()


@pytest.mark.parametrize("name", ASSIGNED_ARCHS)
def test_segments_equal_the_reference_for_every_registered_arch(name):
    jc, tc = jax_get_config(name), get_config(name)
    assert [tuple(s) for s in segments(tc)] == [tuple(s) for s in jax_segments(jc)]


def test_remat_validation_and_bool_alias():
    cfg = get_config("gpt2-small")
    with pytest.raises(ValueError):
        dataclasses.replace(cfg, remat="sometimes")
    with pytest.warns(DeprecationWarning):
        assert dataclasses.replace(cfg, remat=True).remat == "full"
