"""Four train steps of every arch's ``smoke()`` config at fp32 compute
(``tests/test_torch_train_steps_bf16.py`` at the configs' bf16), the
port's ``make_train_step`` (in place) against JAX's jitted step from the
same state on one fixed batch, and gradient accumulation, on the CPU.

Tolerances, each step: loss, ce and aux losses as
``tests/_torch_train_common.py`` states (fp32 ``1e-5`` grows to at most
4e-6 over 4 steps here; bf16 ``5e-2``); accuracy within 2 tokens of the
batch's 24 at bf16 (an argmax near tie), ``1e-6`` at fp32; ``grad_norm``
``rtol = 1e-4`` at fp32 (measured at most 2.2e-5), ``5e-2`` at bf16
(measured at most 2.4e-2: after a step the parameters differ, so the
grads do); ``lr`` ``rtol = 1e-6``; every parameter within ``2.1 x`` the
sum of the steps' learning rates (Adam's first steps are sign-like, so a
grad of either sign near zero moves a parameter by up to ``lr`` either
way; ``tests/test_train.py`` bounds its own microbatch reassociation the
same way); ``step`` and ``rng`` exactly.
"""
import jax
import numpy as np
import pytest
import torch

from repro.train import AdamWConfig as JaxAdamW
from repro.train import make_train_step as jax_make_train_step

from repro_torch.train import AdamWConfig, make_train_step, state_from_numpy
from repro_torch.train.optim import tree_leaves

from _torch_train_common import (ARCHS, LOSS_TOL, both, check_four_steps,
                                 param_gap)

torch.set_num_threads(2)


@pytest.mark.parametrize("arch", ARCHS)
def test_four_steps_equal(arch):
    check_four_steps(arch, "float32")


def test_microbatches_equal_full_batch():
    """microbatches=4 against 1 in the port (loss to 1e-4, the update to
    2.1 lr, as ``tests/test_train.py``), and against JAX's microbatches=4
    step (loss 5e-2 at the config's bf16, the update to 2.1 lr)."""
    opt = dict(lr=1e-3, warmup_steps=1, total_steps=10)
    jm, st, model, _ = both("qwen3-4b", "bfloat16", seed=0)
    rng = np.random.default_rng(0)
    vocab = model.cfg.vocab
    batch = {"tokens": rng.integers(0, vocab, (8, 12)).astype(np.int32),
             "labels": rng.integers(0, vocab, (8, 12)).astype(np.int32)}
    fresh = lambda: state_from_numpy(jax.tree.map(np.asarray, st), "cpu",
                                     cfg=model.cfg)
    s1, m1 = make_train_step(model, AdamWConfig(**opt))(fresh(), batch)
    s4, m4 = make_train_step(model, AdamWConfig(**opt),
                             microbatches=4)(fresh(), batch)
    assert abs(float(m1["loss"]) - float(m4["loss"])) < 1e-4
    assert set(m1) == set(m4)
    d = max(float((a - b).abs().max()) for a, b in
            zip(tree_leaves(s1.params), tree_leaves(s4.params)))
    assert d <= 2.1 * opt["lr"]
    js4, jm4 = jax.jit(jax_make_train_step(jm, JaxAdamW(**opt),
                                           microbatches=4))(st, batch)
    assert abs(float(m4["loss"]) - float(jm4["loss"])) <= LOSS_TOL["bfloat16"]
    assert set(m4) == set(jm4)
    assert param_gap(js4, s4) <= 2.1 * opt["lr"]
