"""Mixture-of-Experts MLP with capacity-based top-k routing.

Dispatch is sort-free one-hot/capacity based, as the JAX package's
``models/moe.py``: each (token, k) pick takes the next slot of its
expert's [capacity, d_model] buffer in token order (a ``cumsum`` over the
one-hot picks); picks beyond an expert's capacity are dropped (their
combine weight is zero). The aux load-balancing and router-z losses are
returned for the training loss.

The top-k keeps the lower expert index among equal probabilities, as
``jax.lax.top_k`` does (a stable descending sort). ``dispatch="local"``
under a ``partitioning`` context whose mesh has a "model" axis takes
``moe_apply_local``: per-data-shard capacity, each mesh position running
its own experts (JAX's ``shard_map`` body, driven position by position).
"""
from __future__ import annotations

import math

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
    """x [B, S, D] -> (out [B, S, D], aux-losses dict). Dispatch routing per
    cfg.moe.dispatch ('einsum' global-capacity baseline vs 'local' expert
    parallelism under a mesh with a "model" axis)."""
    if cfg.moe.dispatch == "local":
        ctx = current()
        if ctx is not None and _local_dispatch_applicable(cfg, ctx[0]):
            return moe_apply_local(p, cfg, x, ctx[0])
    return moe_apply_einsum(p, cfg, x)


def _gates(router, e, xt):
    """Router of tokens xt [T, D] -> (logits [T, E] fp32, probs, gate
    values [T, k], gate expert ids [T, k])."""
    logits = xt.float() @ router.float()                     # [T, E] fp32
    probs = torch.softmax(logits, dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_vals, gate_idx = vals[:, :e.top_k], idx[:, :e.top_k]   # [T, k]
    if e.top_k > 1:
        gate_vals = gate_vals / (gate_vals.sum(-1, keepdim=True) + 1e-9)
    return logits, probs, gate_vals, gate_idx


def _aux_losses(e, probs, gate_idx, logits):
    """Switch-style load balance and router z losses of one routing."""
    eid = gate_idx.reshape(-1)
    me = probs.mean(0)                                      # [E]
    ce = torch.zeros(e.n_experts, dtype=torch.float32, device=probs.device) \
        .index_add_(0, eid, torch.ones_like(eid, dtype=torch.float32)) \
        / eid.numel()
    return (e.aux_coef * e.n_experts * torch.sum(me * ce),
            e.router_z_coef * torch.mean(torch.logsumexp(logits, dim=-1) ** 2))


def route(p, cfg: ModelConfig, xt):
    """Router of tokens xt [T, D] -> (logits [T, E] fp32, probs, gate
    values [T, k], gate expert ids [T, k], capacity slot of each pick
    [T, k], kept picks [T, k])."""
    e = cfg.moe
    n_tok = xt.shape[0]
    cap = _capacity(n_tok, e)
    logits, probs, gate_vals, gate_idx = _gates(p["router"], e, xt)

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

    aux_lb, aux_z = _aux_losses(e, probs, gate_idx, logits)
    return out.reshape(B, S, D), {"moe_aux": aux_lb, "moe_z": aux_z}


# ---------------------------------------------------------------------------
# local-capacity dispatch: JAX's shard_map body, position by position
# ---------------------------------------------------------------------------

def _position(mesh, dp: tuple[str, ...], s: int, m: int):
    """The device of data shard ``s`` (row-major over ``dp``) and model
    position ``m``; every other mesh axis at 0."""
    coords = {}
    for a in reversed(dp):
        s, coords[a] = divmod(s, mesh.shape[a])
    coords["model"] = m
    return mesh.devices[tuple(coords.get(a, 0) for a in mesh.axis_names)]


def _local_body(cfg: ModelConfig, xb, router, wi, wg, wo, m: int):
    """One (data shard, model position m): route the shard's tokens xb
    [B_loc, S, D], run only experts [m e_loc, (m+1) e_loc) (the weights
    given) at the shard's own capacity, scatter back -> (partial output,
    aux_lb, aux_z)."""
    e = cfg.moe
    cd = dtype_of(cfg.compute_dtype)
    dev = xb.device
    e_loc = wi.shape[0]
    T, D = xb.shape[0] * xb.shape[1], xb.shape[2]
    xt = xb.reshape(T, D)
    cap = max(4, int(T * e.top_k * e.capacity_factor / e.n_experts)
              // 4 * 4)
    logits, probs, gate_vals, gate_idx = _gates(router, e, xt)

    # keep only this position's experts; slots by a LOCAL cumsum per expert
    local_e = gate_idx - m * e_loc                           # [T, k]
    mine = (local_e >= 0) & (local_e < e_loc)
    le = torch.where(mine, local_e, e_loc).reshape(-1)       # dump row
    onehot = F.one_hot(le, e_loc + 1).to(torch.int32)        # [T*k, E1]
    pos = torch.cumsum(onehot, dim=0, dtype=torch.int32) - onehot
    cpos = (pos * onehot).sum(-1, dtype=torch.int32)         # [T*k]
    keep = mine.reshape(-1) & (cpos < cap)
    cpos = torch.where(keep, cpos, cap).long()
    le_flat = torch.where(keep, le, e_loc).long()

    tok = torch.arange(T, device=dev)[:, None].expand(T, e.top_k).reshape(-1)
    buf = torch.zeros((e_loc + 1, cap + 1, D), dtype=cd, device=dev)
    buf.index_put_((le_flat, cpos), xt.to(cd)[tok], accumulate=True)
    buf = buf[:e_loc, :cap]

    h = torch.einsum("ecd,edf->ecf", buf, wi.to(cd))
    g = torch.einsum("ecd,edf->ecf", buf, wg.to(cd))
    y = torch.einsum("ecf,efd->ecd", F.silu(g) * h, wo.to(cd))  # [E1,cap,D]

    y_tok = y[le_flat.clamp(0, e_loc - 1), cpos.clamp(0, cap - 1)]
    w = torch.where(keep, gate_vals.reshape(-1), 0.0).to(cd)
    partial = torch.zeros((T, D), dtype=cd, device=dev) \
        .index_add_(0, tok, y_tok * w[:, None])
    aux_lb, aux_z = _aux_losses(e, probs, gate_idx, logits)
    return partial.reshape(xb.shape), aux_lb, aux_z


def moe_apply_local(p, cfg: ModelConfig, x, mesh):
    """Expert-parallel MoE with PER-DATA-SHARD capacity, as JAX's
    ``shard_map`` version, driven by one process over the mesh's
    positions: the batch splits over ("pod", "data"); for each data shard
    s and model position m, the position's device routes shard s's tokens
    and runs its experts (``n_experts / mesh.shape["model"]`` of them) at
    ``max(4, int(T k cf / E) // 4 * 4)`` slots for the shard's T tokens.
    The partials of a shard are summed over m (JAX's psum over "model")
    and the aux losses averaged over the data shards (its pmean)."""
    e = cfg.moe
    B, S, D = x.shape
    dp = tuple(a for a in ("pod", "data") if a in mesh.axis_names)
    n_dp = math.prod(mesh.shape[a] for a in dp)
    n_mp = mesh.shape["model"]
    if B % n_dp:
        raise ValueError(f"batch {B} does not split over {n_dp} data shards")
    e_loc, b_loc = e.n_experts // n_mp, B // n_dp
    # one split a weight (its backward is one cat)
    wi, wg, wo = (torch.split(p[k], e_loc) for k in ("wi", "wg", "wo"))
    outs, aux_lb, aux_z = [], [], []
    for s in range(n_dp):
        xs = x[s * b_loc:(s + 1) * b_loc]
        total = None
        for m in range(n_mp):
            dev = _position(mesh, dp, s, m)
            part, lb, z = _local_body(cfg, xs.to(dev), p["router"].to(dev),
                                      wi[m].to(dev), wg[m].to(dev),
                                      wo[m].to(dev), m)
            part = part.to(x.device)
            total = part if total is None else total + part
            if m == 0:          # the same routing on every model position
                aux_lb.append(lb.to(x.device))
                aux_z.append(z.to(x.device))
        outs.append(total)
    out = torch.cat(outs)
    aux = {"moe_aux": torch.stack(aux_lb).mean(),
           "moe_z": torch.stack(aux_z).mean()}
    if e.shared_expert:
        out = out + mlp_apply(p["shared"], cfg, x).to(out.dtype)
    return out, aux
