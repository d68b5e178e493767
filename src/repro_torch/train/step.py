"""The train step: cross-entropy + aux losses, autograd, AdamW; as the JAX
package's ``train/step.py``.

``make_train_step`` returns ``train_step(state, batch) -> (state, metrics)``.
JAX's step is a pure function whose jitted form donates the old state's
buffers; the port's step writes the state's tensors in place (params,
``mu``, ``nu``, ``count``) and returns a new ``TrainState`` over them, so a
state at full width is held once. Microbatches run as a Python loop where
JAX runs ``lax.scan``: grads and metrics are summed, then divided by N.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import numpy as np
import torch

from ..device import resolve_device
from ..models.transformer import Model, params_from_numpy
from . import optim
from .prng import fold_in, prng_key


class TrainState(NamedTuple):
    step: torch.Tensor        # int32 [] on the model's device
    params: Any
    opt_state: Any
    rng: torch.Tensor         # uint32 [2] threefry key data, on the CPU


def _key(data: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.asarray(data, dtype=np.uint32).copy())


def loss_fn(model: Model, params, batch):
    """batch: {"tokens": [B,S], "labels": [B,S] (-1 = masked), optional
    "enc_feats"/"vis_embeds" for the stub frontends} -> (loss, metrics)."""
    logits, aux = model.forward_train(
        params, batch["tokens"],
        enc_feats=batch.get("enc_feats"),
        vis_embeds=batch.get("vis_embeds"))
    labels = torch.as_tensor(batch["labels"], device=logits.device)
    valid = labels >= 0
    safe = torch.where(valid, labels, 0)
    # JAX's sharding-friendly form: logsumexp over the vocab and the label
    # logit through a one-hot product (no gather of the full logits)
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)                        # [B, S]
    onehot = (torch.arange(logits.shape[-1], device=logits.device)
              [None, None, :] == safe[..., None])
    label_logit = torch.sum(logits * onehot, dim=-1)             # [B, S]
    nll = lse - label_logit
    denom = torch.clamp(valid.sum(), min=1)
    ce = torch.where(valid, nll, 0.0).sum() / denom
    total = ce
    for v in aux.values():
        total = total + v
    metrics = {"loss": total, "ce": ce,
               "accuracy": (torch.where(
                   valid, logits.argmax(-1) == safe, False).sum() / denom)}
    for k, v in aux.items():
        metrics[k] = v
    return total, metrics


def make_init_state(model: Model, opt_cfg: optim.AdamWConfig):
    def init(generator: torch.Generator) -> TrainState:
        """Parameters drawn from ``generator``; ``rng`` is JAX's
        ``fold_in(PRNGKey(seed), 17)`` for the generator's seed."""
        params, _ = model.init(generator)
        rng = fold_in(prng_key(generator.initial_seed()), 17)
        return TrainState(
            step=torch.zeros((), dtype=torch.int32, device=model.device),
            params=params, opt_state=optim.adamw_init(params),
            rng=_key(rng))
    return init


def _fill(tree, leaves):
    """``tree``'s structure over ``leaves`` (in ``optim.tree_leaves``'
    order)."""
    it = iter(leaves)

    def go(node):
        if isinstance(node, dict):
            return {k: go(node[k]) for k in sorted(node)}
        return next(it)
    return go(tree)


def make_train_step(model: Model, opt_cfg: optim.AdamWConfig,
                    microbatches: int = 1):
    """microbatches > 1 enables gradient accumulation: the global batch is
    split along dim 0 and run in turn, dividing activation memory by N at
    one optimizer step of identical math."""

    def grads_of(params, batch):
        req = optim.tree_map(lambda t: t.detach().requires_grad_(True),
                             params)
        leaves = optim.tree_leaves(req)
        loss, metrics = loss_fn(model, req, batch)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                    materialize_grads=True)
        return {k: v.detach() for k, v in metrics.items()}, \
            _fill(params, grads)

    def train_step(state: TrainState, batch) -> tuple[TrainState, dict]:
        if microbatches == 1:
            metrics, grads = grads_of(state.params, batch)
        else:
            n = next(iter(batch.values())).shape[0] // microbatches
            grads = metrics = None
            for i in range(microbatches):
                one = {k: v[i * n:(i + 1) * n] for k, v in batch.items()}
                m, g = grads_of(state.params, one)
                if grads is None:
                    grads, metrics = g, m
                else:
                    optim.tree_map(lambda a, b: a.add_(b), grads, g)
                    metrics = {k: metrics[k] + v for k, v in m.items()}
                del g
            optim.tree_map(lambda a: a.div_(microbatches), grads)
            metrics = {k: v / microbatches for k, v in metrics.items()}
        params, opt_state, opt_metrics = optim.adamw_update(
            opt_cfg, grads, state.opt_state, state.params, inplace=True)
        metrics.update(opt_metrics)
        new_state = TrainState(step=state.step + 1, params=params,
                               opt_state=opt_state,
                               rng=_key(fold_in(state.rng.numpy(), 1)))
        return new_state, metrics
    return train_step


def state_from_numpy(tree, device=None, *, cfg):
    """A JAX ``TrainState`` passed through ``np.asarray`` leaf by leaf ->
    the port's ``TrainState`` on ``device`` (None = the card; ``rng`` stays
    on the CPU). Raises ``ValueError`` on a tree, shape or dtype other than
    the port's state of ``Model(cfg)`` holds."""
    dev = resolve_device(device)
    opt = tree.opt_state
    if not isinstance(opt, dict) or set(opt) != {"mu", "nu", "count"}:
        raise ValueError("opt_state: expected the keys count, mu and nu")
    moments = dataclasses.replace(cfg, param_dtype="float32")

    def scalar(name, a, dtype, shape):
        a = np.asarray(a)
        if a.shape != shape or a.dtype != dtype:
            raise ValueError(f"{name}: {a.dtype} {a.shape}, expected "
                             f"{np.dtype(dtype)} {shape}")
        return torch.from_numpy(a.copy())

    return TrainState(
        step=scalar("step", tree.step, np.int32, ()).to(dev),
        params=params_from_numpy(tree.params, dev, cfg=cfg),
        opt_state={
            "mu": params_from_numpy(opt["mu"], dev, cfg=moments),
            "nu": params_from_numpy(opt["nu"], dev, cfg=moments),
            "count": scalar("count", opt["count"], np.int32, ()).to(dev)},
        rng=scalar("rng", tree.rng, np.uint32, (2,)))
