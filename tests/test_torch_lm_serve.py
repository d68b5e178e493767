"""The port's LM serving steps (``repro_torch.serve.step``) against the JAX
package's, on the CPU.

* ``greedy_generate`` at fp32 compute gives token ids equal to JAX's for
  ``tests/test_serve.py``'s three archs (qwen2.5-3b, recurrentgemma-2b,
  xlstm-125m), with JAX's parameters carried across;
* that file's teacher-forced check holds in the port at the configs' own
  bf16: re-scoring the generated prefix with ``forward_train`` picks every
  greedy token;
* ``make_prefill_step(last_only=True)`` returns [B, 1, V]; a decode step
  advances the cache ``pos``;
* a decode at ``pos >= cache_len`` writes the last slot, as JAX's
  ``dynamic_update_slice`` clamps its start: logits and caches equal JAX's
  (fp32, ``rtol = atol = 1e-4``).

Token ids are compared exactly.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jax_configs
from repro.models import build_model as jax_build
from repro.serve import greedy_generate as jax_greedy
from repro.serve import make_decode_step as jax_decode_step

from repro_torch import configs
from repro_torch.models import build_model, params_from_numpy
from repro_torch.serve import (greedy_generate, make_decode_step,
                               make_prefill_step)

torch.set_num_threads(2)

CPU = "cpu"
SERVE_ARCHS = ["qwen2.5-3b", "recurrentgemma-2b", "xlstm-125m"]
FP32 = dict(rtol=1e-4, atol=1e-4)


def _pair(arch, seed, fp32):
    """(JAX model, its params, port model, the same params carried)."""
    jcfg, cfg = jax_configs.get(arch, smoke=True), configs.get(arch,
                                                               smoke=True)
    if fp32:
        jcfg = dataclasses.replace(jcfg, compute_dtype="float32")
        cfg = dataclasses.replace(cfg, compute_dtype="float32")
    jm = jax_build(jcfg)
    jparams, _ = jm.init(jax.random.PRNGKey(seed))
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), CPU,
                               cfg=cfg)
    return jm, jparams, build_model(cfg, CPU), params


def _prompt(cfg, B=2, S=6):
    return np.random.default_rng(0).integers(0, cfg.vocab, (B, S)) \
        .astype(np.int32)


@pytest.mark.parametrize("arch", SERVE_ARCHS)
def test_greedy_generate_equals_jax_at_fp32(arch):
    jm, jparams, model, params = _pair(arch, 2, fp32=True)
    prompt = _prompt(model.cfg)
    want = np.asarray(jax_greedy(jm, jparams, jnp.asarray(prompt), 4,
                                 cache_len=16))
    got = greedy_generate(model, params, torch.from_numpy(prompt), 4,
                          cache_len=16)
    assert got.shape == (2, 10) and got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("arch", SERVE_ARCHS)
def test_greedy_generate_teacher_forced(arch):
    """``tests/test_serve.py``'s check, in the port at the config's bf16."""
    _, _, model, params = _pair(arch, 2, fp32=False)
    prompt = _prompt(model.cfg)
    out = greedy_generate(model, params, prompt, 4, cache_len=16)
    assert out.shape == (2, 10)
    np.testing.assert_array_equal(out[:, :6].numpy(), prompt)
    logits, _ = model.forward_train(params, out[:, :-1])
    for i in range(4):
        np.testing.assert_array_equal(logits[:, 6 + i - 1].argmax(-1).numpy(),
                                      out[:, 6 + i].numpy())


def test_prefill_last_only_shape():
    cfg = configs.get("qwen3-4b", smoke=True)
    model = build_model(cfg, CPU)
    params, _ = model.init(torch.Generator().manual_seed(0))
    toks = torch.zeros((2, 8), dtype=torch.int32)
    logits, caches = make_prefill_step(model, 16)(params, {"tokens": toks})
    assert logits.shape == (2, 1, cfg.vocab)
    full, _ = make_prefill_step(model, 16, last_only=False)(
        params, {"tokens": toks})
    assert full.shape == (2, 8, cfg.vocab)
    assert torch.equal(full[:, -1:], logits)
    assert int(caches["seg0_attn"]["attn"]["pos"][0]) == 8


def test_decode_pos_advances_cache():
    cfg = configs.get("phi4-mini-3.8b", smoke=True)
    model = build_model(cfg, CPU)
    params, _ = model.init(torch.Generator().manual_seed(0))
    caches = model.init_cache(2, 8)
    dec = make_decode_step(model)
    toks = torch.ones((2, 1), dtype=torch.int32)
    _, caches = dec(params, caches, toks, torch.tensor(0, dtype=torch.int32))
    seg = next(iter(caches.values()))
    assert int(seg["attn"]["pos"][0]) == 1
    _, caches = dec(params, caches, toks, 1)
    assert seg["attn"]["pos"].tolist() == [2] * cfg.n_layers


def test_decode_past_the_cache_clamps_like_jax():
    """A cache of 8 after a prefill of 6: decodes at 6, 7, 8 and 9; the last
    two write slot 7, as JAX's ``dynamic_update_slice`` clamps."""
    jm, jparams, model, params = _pair("qwen2.5-3b", 0, fp32=True)
    toks = np.random.default_rng(1).integers(0, model.cfg.vocab, (2, 10)) \
        .astype(np.int32)
    _, jc = jm.prefill(jparams, jnp.asarray(toks[:, :6]), 8)
    _, tc = model.prefill(params, toks[:, :6], 8)
    jdec = jax.jit(jax_decode_step(jm))
    for t in range(6, 10):
        lj, jc = jdec(jparams, jc, jnp.asarray(toks[:, t:t + 1]),
                      jnp.asarray(t, jnp.int32))
        lt, tc = model.decode_step(params, tc, toks[:, t:t + 1], t)
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **FP32)
        for key in ("k", "v"):
            np.testing.assert_allclose(
                tc["seg0_attn"]["attn"][key].numpy(),
                np.asarray(jc["seg0_attn"]["attn"][key]), **FP32)
        np.testing.assert_array_equal(tc["seg0_attn"]["attn"]["pos"].numpy(),
                                      np.asarray(jc["seg0_attn"]["attn"]
                                                 ["pos"]))
