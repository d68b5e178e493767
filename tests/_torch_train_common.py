"""Shared by the port's train tests (``tests/test_torch_train*.py``): the
configs at a compute dtype, seeded batches, JAX's initial state carried
into the port, the port's grads, the bf16 MoE near-tie cut, and the
loss-and-grads check.

Tolerances (the JAX package is the reference):

* loss and metrics at fp32 compute ``atol = 1e-5`` (measured at most
  1e-6); each grad leaf at fp32 within ``1e-4`` of the leaf's largest
  |JAX grad| (measured at most 1.1e-5), the global norm ``rtol = 1e-5``;
* at the configs' bf16: loss ``atol = 5e-2`` (the repo's bf16 bound), each
  grad leaf within ``0.15`` of its largest |JAX grad| (measured at most
  0.087: two libraries round bf16 at other points, and those differences
  pass through every layer's backward), the global norm ``rtol = 2e-2``
  (measured at most 6e-3). A MoE router whose bf16 top-k margin is under
  ``TIE`` may pick another expert in each package, so each row's labels
  from its first such token on are masked (-1) in both packages' batch.
"""
import dataclasses

import jax
import numpy as np
import torch

from repro import configs as jax_configs
from repro.models import build_model as jax_build
from repro.train import AdamWConfig as JaxAdamW
from repro.train import loss_fn as jax_loss_fn
from repro.train import make_init_state as jax_init_state
from repro.train import make_train_step as jax_make_train_step

from repro_torch import configs
from repro_torch.models import build_model
from repro_torch.models import moe as torch_moe
from repro_torch.train import (AdamWConfig, loss_fn, make_train_step,
                               state_from_numpy)
from repro_torch.train.optim import tree_leaves, tree_map

ARCHS = jax_configs.list_archs()
DTYPES = ("float32", "bfloat16")
TIE = 5e-3
GRAD_TOL = {"float32": 1e-4, "bfloat16": 0.15}
LOSS_TOL = {"float32": 1e-5, "bfloat16": 5e-2}
NORM_RTOL = {"float32": 1e-5, "bfloat16": 2e-2}
GNORM_RTOL = {"float32": 1e-4, "bfloat16": 5e-2}     # after steps
OPT = dict(lr=1e-3, warmup_steps=2, total_steps=50)


def configs_at(arch, dtype):
    """(JAX config, port config) of ``arch``'s smoke() at ``dtype``."""
    jcfg = jax_configs.get(arch, smoke=True)
    cfg = configs.get(arch, smoke=True)
    if dtype != jcfg.compute_dtype:
        jcfg = dataclasses.replace(jcfg, compute_dtype=dtype)
        cfg = dataclasses.replace(cfg, compute_dtype=dtype)
    return jcfg, cfg


def make_batch(cfg, B=2, S=12, seed=0):
    rng = np.random.default_rng(seed)
    b = {"tokens": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32),
         "labels": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)}
    if cfg.n_enc_layers:
        b["enc_feats"] = rng.normal(
            size=(B, cfg.enc_seq, cfg.d_model)).astype(np.float32)
    if cfg.frontend == "vision":
        b["vis_embeds"] = rng.normal(size=(B, 4, cfg.d_model)) \
            .astype(np.float32)
    return b


def as_np(t):
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t, dtype=np.float32)


def jax_state(jm, seed=1, opt=None):
    opt = JaxAdamW(**OPT) if opt is None else opt
    return jax.jit(jax_init_state(jm, opt))(jax.random.PRNGKey(seed))


def both(arch, dtype, seed=1):
    """JAX model and state; the port's model and that state on the CPU."""
    jcfg, cfg = configs_at(arch, dtype)
    jm, model = jax_build(jcfg), build_model(cfg, "cpu")
    st = jax_state(jm, seed)
    return jm, st, model, state_from_numpy(jax.tree.map(np.asarray, st),
                                           "cpu", cfg=cfg)


def port_grads(model, params, batch):
    req = tree_map(lambda t: t.detach().requires_grad_(True), params)
    loss, metrics = loss_fn(model, req, batch)
    grads = torch.autograd.grad(loss, tree_leaves(req), allow_unused=True,
                                materialize_grads=True)
    return loss, {k: v.detach() for k, v in metrics.items()}, grads


def cut_at_ties(model, params, batch):
    """Labels of each row masked from its first bf16 router near tie."""
    margins, route = [], torch_moe.route

    def recorded(p, cfg, xt):
        out = route(p, cfg, xt)
        probs = out[1].sort(dim=-1, descending=True).values
        k = cfg.moe.top_k
        margins.append((probs[:, k - 1] - probs[:, k]).reshape(
            batch["tokens"].shape))
        return out

    torch_moe.route = recorded
    try:
        with torch.no_grad():
            model.forward_train(params, batch["tokens"],
                                enc_feats=batch.get("enc_feats"),
                                vis_embeds=batch.get("vis_embeds"))
    finally:
        torch_moe.route = route
    labels = batch["labels"].copy()
    for m in margins:
        for row, pos in (m < TIE).nonzero().tolist():
            labels[row, pos:] = -1
    return dict(batch, labels=labels)


def check_loss_and_grads(arch, dtype):
    """One value_and_grad of ``arch`` at ``dtype`` in both packages, from
    JAX's state, within the tolerances above."""
    jm, st, model, state = both(arch, dtype)
    batch = make_batch(model.cfg)
    if dtype == "bfloat16" and model.cfg.moe is not None:
        batch = cut_at_ties(model, state.params, batch)
    (_, mj), gj = jax.jit(jax.value_and_grad(
        lambda p: jax_loss_fn(jm, p, batch), has_aux=True))(st.params)
    _, mt, gt = port_grads(model, state.params, batch)
    assert set(mt) == set(mj)
    for k in mj:
        assert abs(float(mt[k]) - float(mj[k])) <= LOSS_TOL[dtype], \
            (k, float(mt[k]), float(mj[k]))
    flat_j = jax.tree_util.tree_flatten_with_path(gj)[0]
    assert len(flat_j) == len(gt)
    for (path, w), g in zip(flat_j, gt):
        w, g = np.asarray(w, dtype=np.float32), as_np(g)
        assert g.shape == w.shape, path
        scale = max(float(np.abs(w).max()), 1e-6)
        err = float(np.abs(g - w).max())
        assert err <= GRAD_TOL[dtype] * scale, (path, err, scale)

    def norm(leaves):
        return float(np.sqrt(sum(np.square(np.asarray(x, np.float64)).sum()
                                 for x in leaves)))

    np.testing.assert_allclose(norm([as_np(g) for g in gt]),
                               norm([w for _, w in flat_j]),
                               rtol=NORM_RTOL[dtype])


def param_gap(st, state) -> float:
    return max(float(np.abs(np.asarray(a, np.float32)
                            - b.detach().float().numpy()).max())
               for a, b in zip(jax.tree.leaves(st.params),
                               tree_leaves(state.params)))


def check_four_steps(arch, dtype):
    """Four steps of the port's and JAX's train steps from JAX's state on
    one fixed batch, within the tolerances of
    ``tests/test_torch_train_steps.py``."""
    jm, st, model, state = both(arch, dtype)
    jstep = jax.jit(jax_make_train_step(jm, JaxAdamW(**OPT)))
    tstep = make_train_step(model, AdamWConfig(**OPT))
    batch = make_batch(model.cfg)
    n_tok = batch["labels"].size
    lr_sum, losses = 0.0, []
    for i in range(4):
        st, mj = jstep(st, batch)
        state, mt = tstep(state, batch)
        assert set(mt) == set(mj)
        for k in set(mj) - {"accuracy", "grad_norm", "lr"}:
            assert abs(float(mt[k]) - float(mj[k])) <= LOSS_TOL[dtype], \
                (i, k, float(mt[k]), float(mj[k]))
        acc_tol = 2 / n_tok if dtype == "bfloat16" else 1e-6
        assert abs(float(mt["accuracy"]) - float(mj["accuracy"])) <= acc_tol
        np.testing.assert_allclose(float(mt["grad_norm"]),
                                   float(mj["grad_norm"]),
                                   rtol=GNORM_RTOL[dtype])
        np.testing.assert_allclose(float(mt["lr"]), float(mj["lr"]),
                                   rtol=1e-6)
        lr_sum += float(mj["lr"])
        gap = param_gap(st, state)
        assert gap <= 2.1 * lr_sum, (i, gap, lr_sum)
        assert int(state.step) == int(st.step) == i + 1
        assert int(state.opt_state["count"]) == i + 1
        np.testing.assert_array_equal(state.rng.numpy(), np.asarray(st.rng))
        losses.append(float(mt["loss"]))
    assert losses[-1] < losses[0]              # memorizes a fixed batch
