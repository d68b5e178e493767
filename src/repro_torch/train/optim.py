"""AdamW with decoupled weight decay, global-norm clipping, and a
warmup+cosine schedule, as the JAX package's ``train/optim.py``: written
directly on trees of tensors (no external optimizer). The optimizer state
has the parameters' tree, so the sharding rules apply to it unchanged.

The arithmetic is JAX's, leaf by leaf and in fp32. ``adamw_update`` is
functional by default; with ``inplace=True`` it writes the parameters,
``mu``, ``nu``, ``count`` and the (clipped) grads in place, which is how
the train step keeps one copy of a state that fills most of the card (JAX
donates the state's buffers to its jitted step instead).
"""
from __future__ import annotations

import dataclasses
import math

import torch


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1


def cosine_schedule(cfg: AdamWConfig, step) -> torch.Tensor:
    """The learning rate at ``step`` (an int or an integer tensor), fp32."""
    step = torch.as_tensor(step).float()
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    t = torch.clamp((step - cfg.warmup_steps)
                    / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * t))
    return cfg.lr * warm * (cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * cos)


def tree_map(fn, *trees):
    """Map ``fn`` over the leaves of nested dicts with equal keys."""
    if isinstance(trees[0], dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def tree_leaves(tree) -> list:
    """Leaves of nested dicts in sorted-key order, as ``jax.tree.leaves``."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    return [tree]


def adamw_init(params):
    zeros = lambda p: torch.zeros_like(p, dtype=torch.float32)
    count_dev = tree_leaves(params)[0].device
    return {"mu": tree_map(zeros, params), "nu": tree_map(zeros, params),
            "count": torch.zeros((), dtype=torch.int32, device=count_dev)}


def _global_norm(tree) -> torch.Tensor:
    """sqrt of the fp32 sum of squares over every leaf."""
    return torch.sqrt(sum(torch.sum(torch.square(leaf.float()))
                          for leaf in tree_leaves(tree)))


def adamw_update(cfg: AdamWConfig, grads, opt_state, params, *,
                 inplace: bool = False):
    """Returns (new_params, new_opt_state, metrics). With ``inplace`` the
    returned trees hold the given tensors, written in place."""
    with torch.no_grad():
        gnorm = _global_norm(grads)
        scale = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
        count = opt_state["count"] + 1
        lr = cosine_schedule(cfg, count)
        b1, b2 = cfg.beta1, cfg.beta2
        c = count.float()
        mu_hat_scale = 1.0 / (1 - b1 ** c)
        nu_hat_scale = 1.0 / (1 - b2 ** c)

        def upd(p, g, m, v):
            if inplace and g.dtype == torch.float32:
                g.mul_(scale)
            else:
                g = g.float() * scale
            if not inplace:
                p, m, v = p.clone(), m.clone(), v.clone()
            m.mul_(b1).add_(g, alpha=1 - b1)
            v.mul_(b2).addcmul_(g, g, value=1 - b2)
            denom = torch.mul(v, nu_hat_scale).sqrt_().add_(cfg.eps)
            step = torch.mul(m, mu_hat_scale).div_(denom)
            if p.ndim >= 2 and cfg.weight_decay:
                step.add_(torch.mul(p.float(), cfg.weight_decay, out=denom))
            del denom
            if p.dtype == torch.float32:
                p.sub_(step.mul_(lr))
            else:
                p.copy_(p.float() - step.mul_(lr))
            return p, m, v

        out = tree_map(upd, params, grads, opt_state["mu"], opt_state["nu"])
        new_params = tree_map(lambda o: o[0], out)
        mu = tree_map(lambda o: o[1], out)
        nu = tree_map(lambda o: o[2], out)
        if inplace:
            opt_state["count"].copy_(count)
            count = opt_state["count"]
        new_state = {"mu": mu, "nu": nu, "count": count}
    return new_params, new_state, {"grad_norm": gnorm, "lr": lr}
