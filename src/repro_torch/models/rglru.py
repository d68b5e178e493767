"""RG-LRU recurrent block (Griffin / RecurrentGemma, arXiv:2402.19427).

Block structure (per the paper):
  x -> [linear gate branch: GeLU(W_g x)] ⊙ [conv1d(width 4) -> RG-LRU] -> W_out

RG-LRU recurrence (diagonal, per channel):
  r_t = sigmoid(W_a x_t + b_a)          recurrence gate
  i_t = sigmoid(W_x x_t + b_x)          input gate
  a_t = exp(c * softplus(Λ) * (-r_t))   in (0,1), c = 8
  h_t = a_t ⊙ h_{t-1} + sqrt(1 - a_t²) ⊙ (i_t ⊙ x_t)

Prefill composes the affine maps (a_t, b_t) with an associative scan
(log2 S doubling steps), as the JAX package does with
``jax.lax.associative_scan``, and yields the exact final state; decode is
the O(1) state update.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .config import ModelConfig
from .layers import Draws, dense, dense_init, dtype_of, gelu
from .partition import ParamMeta, hint

_C = 8.0
CONV_W = 4


def rglru_init(draws: Draws, cfg: ModelConfig):
    d = cfg.d_model
    dr = d  # recurrence width == d_model (RecurrentGemma uses d_rnn ~ d)
    dt = dtype_of(cfg.param_dtype)
    # Λ init so that a^c spans ~(0.9, 0.999) as in the paper
    if draws.device.type == "meta":
        lam = torch.empty(dr, dtype=dt, device="meta")
    else:
        lin = torch.linspace(0.9, 0.999, dr, dtype=torch.float32)
        lam = torch.log(torch.expm1(-torch.log(lin) / _C)).to(
            dtype=dt, device=draws.device)
    return {
        "w_in": dense_init(draws, d, dr, ("embed", "rec"), dtype=dt),
        "w_gate": dense_init(draws, d, dr, ("embed", "rec"), dtype=dt),
        "conv": ParamMeta(draws.normal((CONV_W, dr), dt, 0.1),
                          (None, "rec")),
        "w_a": dense_init(draws, dr, dr, ("rec", "rec"), bias=True, dtype=dt,
                          scale=dr ** -0.5),
        "w_x": dense_init(draws, dr, dr, ("rec", "rec"), bias=True, dtype=dt,
                          scale=dr ** -0.5),
        "lam": ParamMeta(lam, ("rec",)),
        "w_out": dense_init(draws, dr, d, ("rec", "embed"), dtype=dt),
    }


def _gates(p, u):
    """u [B, S, dr] (post-conv) -> (a, b) of the affine recurrence."""
    r = torch.sigmoid(dense(p["w_a"], u, torch.float32))
    i = torch.sigmoid(dense(p["w_x"], u, torch.float32))
    log_a = -_C * F.softplus(p["lam"].float()) * r
    a = torch.exp(log_a)
    b = torch.sqrt(torch.clamp(1.0 - a * a, 0.0, 1.0)) * i * u.float()
    return a, b


def _causal_conv(p, u, state=None):
    """Width-4 causal depthwise conv. state [B, CONV_W-1, dr] for decode."""
    w = p["conv"].float()
    if state is None:
        pads = F.pad(u, (0, 0, CONV_W - 1, 0))
    else:
        pads = torch.cat([state.to(u.dtype), u], dim=1)
    out = sum(pads[:, i:i + u.shape[1], :] * w[i] for i in range(CONV_W))
    new_state = pads[:, -(CONV_W - 1):, :]
    return out, new_state


def affine_scan(a, b):
    """Inclusive scan over dim 1 of the affine maps h -> a h + b:
    returns (A_t, h_t) with h_t = a_t h_{t-1} + b_t from h_{-1} = 0, by
    doubling steps (compose((a1,b1),(a2,b2)) = (a1 a2, a2 b1 + b2))."""
    S = a.shape[1]
    for k in range(math.ceil(math.log2(S)) if S > 1 else 0):
        off = 1 << k
        a, b = (torch.cat([a[:, :off], a[:, :-off] * a[:, off:]], dim=1),
                torch.cat([b[:, :off], a[:, off:] * b[:, :-off] + b[:, off:]],
                          dim=1))
    return a, b


def rglru_apply(p, cfg: ModelConfig, x, *, state=None):
    """x [B, S, D]; state (decode) = {"h": [B, dr], "conv": [B, 3, dr]}.

    Returns (out [B, S, D], new_state).
    """
    u = dense(p["w_in"], x, torch.float32)                 # [B, S, dr]
    gate = gelu(dense(p["w_gate"], x, torch.float32))

    if state is None:
        u, conv_tail = _causal_conv(p, u)
        a, b = _gates(p, u)
        _, h = affine_scan(a, b)
        h = hint(h, "batch", "seq", "rec")
        # final state (exact): enables parallel prefill -> O(1) decode
        new_state = {"h": h[:, -1, :], "conv": conv_tail}
    else:
        u, conv_state = _causal_conv(p, u, state["conv"])
        a, b = _gates(p, u)
        h = a * state["h"].float()[:, None, :] + b          # S == 1
        new_state = {"h": h[:, -1, :], "conv": conv_state}

    out = dense(p["w_out"], (h * gate).to(x.dtype), cfg.compute_dtype)
    return hint(out, "batch", "seq", "embed"), new_state


def rglru_state_init(cfg: ModelConfig, batch: int, dtype=torch.float32,
                     device="cpu"):
    dr = cfg.d_model
    return {"h": torch.zeros((batch, dr), dtype=dtype, device=device),
            "conv": torch.zeros((batch, CONV_W - 1, dr), dtype=dtype,
                                device=device)}
