"""The port's pure-Python LM configs against the JAX package's, on the CPU.

For every arch, ``full()`` and ``smoke()``: every ``ModelConfig`` field
(the MoE config too), ``param_count``, ``active_param_count`` and
``q_group`` equal JAX's; ``launch/analytic.py``'s ``flops_model`` and
``bytes_model`` give equal numbers for train, prefill and decode at two
sequence lengths and batches; the COBS presets equal; ``__post_init__``
raises where JAX raises, with JAX's message. Every comparison is exact.
"""
import dataclasses

import pytest

from repro import configs as jax_configs
from repro.configs import cobs as jax_cobs
from repro.launch import analytic as jax_analytic
from repro.models import LAYERS_PER_KIND as JAX_LAYERS_PER_KIND
from repro.models import ModelConfig as JaxConfig

from repro_torch import configs
from repro_torch.configs import cobs
from repro_torch.launch import analytic
from repro_torch.models import LAYERS_PER_KIND, ModelConfig, MoEConfig

ARCHS = jax_configs.list_archs()
SIZES = ("full", "smoke")


def _pair(arch, size):
    smoke = size == "smoke"
    return jax_configs.get(arch, smoke=smoke), configs.get(arch, smoke=smoke)


def test_registry_equal():
    assert configs.list_archs() == ARCHS
    assert LAYERS_PER_KIND == JAX_LAYERS_PER_KIND
    with pytest.raises(KeyError, match="unknown arch"):
        configs.get("gpt-9")


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("arch", ARCHS)
def test_config_fields_and_counts_equal(arch, size):
    want, got = _pair(arch, size)
    assert isinstance(got, ModelConfig)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert (got.moe is None) == (want.moe is None)
    if got.moe is not None:
        assert isinstance(got.moe, MoEConfig)
    assert got.param_count() == want.param_count()
    assert got.active_param_count() == want.active_param_count()
    assert got.q_group == want.q_group


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("arch", ARCHS)
def test_analytic_models_equal(arch, size):
    want, got = _pair(arch, size)
    for mode in ("train", "prefill", "decode"):
        for seq, batch in ((128, 4), (4096, 32)):
            fw = jax_analytic.flops_model(want, mode, seq, batch)
            fg = analytic.flops_model(got, mode, seq, batch)
            assert dataclasses.asdict(fg) == dataclasses.asdict(fw)
            assert analytic.bytes_model(got, mode, seq, batch) == \
                jax_analytic.bytes_model(want, mode, seq, batch)
            assert analytic._cache_bytes(got, seq, batch) == \
                jax_analytic._cache_bytes(want, seq, batch)


def test_cobs_presets_equal():
    for name in ("paper_default", "small_test"):
        assert getattr(cobs, name)().to_json() == \
            dataclasses.asdict(getattr(jax_cobs, name)())
    assert cobs.PAPER_BLOCK_DOCS == jax_cobs.PAPER_BLOCK_DOCS


@pytest.mark.parametrize("kw", [
    dict(n_layers=3, block_pattern=(("attn", 2),)),    # pattern covers 2
    dict(block_pattern=(("griffin", 1),)),             # griffin is 3 layers
    dict(n_heads=4, n_kv_heads=3),                     # 4 % 3 != 0
], ids=["layers", "composite", "heads"])
def test_post_init_errors_equal(kw):
    base = dict(name="bad", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                d_ff=64, vocab=128)
    base.update(kw)
    with pytest.raises(ValueError) as want:
        JaxConfig(**base)
    with pytest.raises(ValueError) as got:
        ModelConfig(**base)
    assert str(got.value) == str(want.value)


def test_post_init_defaults_equal():
    kw = dict(name="d", n_layers=2, d_model=96, n_heads=6, n_kv_heads=2,
              d_ff=64, vocab=128)
    want, got = JaxConfig(**kw), ModelConfig(**kw)
    assert (got.head_dim, got.block_pattern) == (16, (("attn", 2),))
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
