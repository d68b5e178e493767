"""Mixture-of-Experts MLP with capacity-based top-k routing.

Dispatch is sort-free one-hot/capacity based, as the JAX package's
``models/moe.py``: each (token, k) pick takes the next slot of its
expert's [capacity, d_model] buffer in token order (a ``cumsum`` over the
one-hot picks); picks beyond an expert's capacity are dropped (their
combine weight is zero). The aux load-balancing and router-z losses are
returned for the training loss.

The top-k keeps the lower expert index among equal probabilities, as
``jax.lax.top_k`` does (a stable descending sort). ``dispatch="local"``
(JAX's ``moe_apply_local``, per-data-shard capacity under a mesh with a
"model" axis) comes with ``launch/sharding.py`` (ROADMAP A17.4).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .config import ModelConfig
from .layers import Draws, dtype_of, mlp_apply, mlp_init
from .partition import ParamMeta, current, hint


def moe_init(draws: Draws, cfg: ModelConfig):
    e = cfg.moe
    d, f = cfg.d_model, e.d_ff_expert
    dt = dtype_of(cfg.param_dtype)
    p = {
        "router": ParamMeta(draws.normal((d, e.n_experts), dt, d ** -0.5),
                            ("embed", "experts")),
        "wi": ParamMeta(draws.normal((e.n_experts, d, f), dt, d ** -0.5),
                        ("experts", "embed", "ff")),
        "wg": ParamMeta(draws.normal((e.n_experts, d, f), dt, d ** -0.5),
                        ("experts", "embed", "ff")),
        "wo": ParamMeta(draws.normal((e.n_experts, f, d), dt, f ** -0.5),
                        ("experts", "ff", "embed")),
    }
    if e.shared_expert:
        p["shared"] = mlp_init(draws, cfg, d_ff=cfg.d_ff, gated=True)
    return p


def _capacity(n_tokens: int, e) -> int:
    c = int(n_tokens * e.top_k * e.capacity_factor / e.n_experts)
    return max(4, (c + 3) // 4 * 4)


def _local_dispatch_applicable(cfg: ModelConfig, mesh) -> bool:
    if "model" not in mesh.axis_names:
        return False
    return cfg.moe.n_experts % mesh.shape["model"] == 0


def moe_apply(p, cfg: ModelConfig, x):
    """x [B, S, D] -> (out [B, S, D], aux-losses dict). Raises
    ``NotImplementedError`` where JAX would take its local dispatch."""
    if cfg.moe.dispatch == "local":
        ctx = current()
        if ctx is not None and _local_dispatch_applicable(cfg, ctx[0]):
            raise NotImplementedError(
                "moe_apply_local (dispatch='local' under a mesh with a "
                "'model' axis) comes with launch/sharding.py, ROADMAP A17.4")
    return moe_apply_einsum(p, cfg, x)


def route(p, cfg: ModelConfig, xt):
    """Router of tokens xt [T, D] -> (logits [T, E] fp32, probs, gate
    values [T, k], gate expert ids [T, k], capacity slot of each pick
    [T, k], kept picks [T, k])."""
    e = cfg.moe
    n_tok = xt.shape[0]
    cap = _capacity(n_tok, e)
    logits = xt.float() @ p["router"].float()                # [T, E] fp32
    probs = torch.softmax(logits, dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_vals, gate_idx = vals[:, :e.top_k], idx[:, :e.top_k]   # [T, k]
    if e.top_k > 1:
        gate_vals = gate_vals / (gate_vals.sum(-1, keepdim=True) + 1e-9)

    # position of each (token, k) within its expert's capacity buffer
    onehot = F.one_hot(gate_idx, e.n_experts).to(torch.int32)   # [T,k,E]
    flat = onehot.reshape(n_tok * e.top_k, e.n_experts)
    pos_in_expert = torch.cumsum(flat, dim=0, dtype=torch.int32) - flat
    pos = (pos_in_expert * flat).sum(-1, dtype=torch.int32) \
        .reshape(n_tok, e.top_k)
    keep = pos < cap
    gate_vals = gate_vals * keep.to(gate_vals.dtype)
    return logits, probs, gate_vals, gate_idx, pos, keep


def moe_apply_einsum(p, cfg: ModelConfig, x):
    """GSPMD-style one-hot/scatter dispatch with GLOBAL capacity."""
    e = cfg.moe
    B, S, D = x.shape
    n_tok = B * S
    cap = _capacity(n_tok, e)
    cd = dtype_of(cfg.compute_dtype)

    xt = x.reshape(n_tok, D)
    logits, probs, gate_vals, gate_idx, pos, keep = route(p, cfg, xt)

    # dispatch [T, k] -> [E, cap, D] via scatter
    tok_idx = torch.arange(n_tok, device=x.device)[:, None] \
        .expand(n_tok, e.top_k).reshape(-1)
    eid = gate_idx.reshape(-1)
    cpos = torch.where(keep, pos, cap).reshape(-1).long()   # dropped -> cap
    buf = torch.zeros((e.n_experts, cap + 1, D), dtype=cd, device=x.device)
    buf.index_put_((eid, cpos), xt.to(cd)[tok_idx], accumulate=True)
    buf = hint(buf[:, :cap], "experts", None, "embed")      # [E, cap, D]

    h = torch.einsum("ecd,edf->ecf", buf, p["wi"].to(cd))
    g = torch.einsum("ecd,edf->ecf", buf, p["wg"].to(cd))
    h = hint(F.silu(g) * h, "experts", None, "ff")
    y = torch.einsum("ecf,efd->ecd", h, p["wo"].to(cd))     # [E, cap, D]

    # combine: gather each kept (token, k) result and weight by its gate
    y_tok = y[eid, cpos.clamp(0, cap - 1)]                  # [T*k, D]
    y_tok = y_tok * gate_vals.reshape(-1, 1).to(cd)
    out = torch.zeros((n_tok, D), dtype=cd, device=x.device) \
        .index_add_(0, tok_idx, y_tok)

    if e.shared_expert:
        shared = mlp_apply(p["shared"], cfg, x)
        out = out + shared.reshape(n_tok, D).to(cd)

    # aux losses (Switch-style load balance + router z)
    me = probs.mean(0)                                      # [E]
    ce = torch.zeros(e.n_experts, dtype=torch.float32, device=x.device) \
        .index_add_(0, eid, torch.ones_like(eid, dtype=torch.float32)) \
        / (n_tok * e.top_k)
    aux = {
        "moe_aux": e.aux_coef * e.n_experts * torch.sum(me * ce),
        "moe_z": e.router_z_coef * torch.mean(
            torch.logsumexp(logits, dim=-1) ** 2),
    }
    return out.reshape(B, S, D), aux
