"""xLSTM blocks (arXiv:2405.04517): mLSTM (matrix memory, parallelizable)
and sLSTM (scalar memory with recurrent gate connections).

mLSTM runs its parallel form (stabilized exponential-gate attention
analogue) over a prompt and decodes with the O(1) recurrent matrix-memory
update C_t = f C_{t-1} + i v k^T. sLSTM has true recurrent connections
(h_{t-1} enters the gates), so its prompt path is a loop over time (JAX's
``lax.scan``); heads use block-diagonal recurrent matrices as in the paper.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .config import ModelConfig
from .layers import Draws, dense, dense_init, dtype_of
from .partition import ParamMeta, hint

_EPS = 1e-6


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------

def mlstm_init(draws: Draws, cfg: ModelConfig):
    d = cfg.d_model
    di = 2 * d                       # inner width (paper's proj factor 2)
    dt = dtype_of(cfg.param_dtype)
    return {
        "up": dense_init(draws, d, 2 * di, ("embed", "ff"), dtype=dt),
        "wq": dense_init(draws, di, di, ("ff", "ff"), dtype=dt),
        "wk": dense_init(draws, di, di, ("ff", "ff"), dtype=dt),
        "wv": dense_init(draws, di, di, ("ff", "ff"), dtype=dt),
        "wi": dense_init(draws, di, cfg.n_heads, ("ff", "heads"), bias=True,
                         dtype=dt),
        "wf": dense_init(draws, di, cfg.n_heads, ("ff", "heads"), bias=True,
                         dtype=dt),
        "norm": ParamMeta(draws.full((di,), 1.0, dt), ("ff",)),
        "down": dense_init(draws, di, d, ("ff", "embed"), dtype=dt),
    }


def _heads(x, h):
    B, S, D = x.shape
    return x.reshape(B, S, h, D // h).transpose(1, 2)     # [B,H,S,dh]


def mlstm_apply(p, cfg: ModelConfig, x, *, state=None):
    """x [B, S, D]. state (decode): {"C": [B,H,dh,dh], "n": [B,H,dh],
    "m": [B,H]}. Returns (out, new_state)."""
    B, S, D = x.shape
    H = cfg.n_heads
    u, g = torch.chunk(dense(p["up"], x, torch.float32), 2, dim=-1)
    di = u.shape[-1]
    dh = di // H
    q = _heads(dense(p["wq"], u, torch.float32), H)
    k = _heads(dense(p["wk"], u, torch.float32), H) * dh ** -0.5
    v = _heads(dense(p["wv"], u, torch.float32), H)
    logi = dense(p["wi"], u, torch.float32).transpose(1, 2)      # [B,H,S]
    logf = F.logsigmoid(dense(p["wf"], u, torch.float32)).transpose(1, 2)

    if state is None:
        # parallel stabilized form
        Fc = torch.cumsum(logf, dim=-1)                          # [B,H,S]
        Dm = Fc[:, :, :, None] - Fc[:, :, None, :] + logi[:, :, None, :]
        causal = torch.tril(torch.ones((S, S), dtype=torch.bool,
                                       device=x.device))
        Dm = torch.where(causal[None, None], Dm, -float("inf"))
        m = torch.clamp_min(Dm.amax(-1, keepdim=True), -30.0)   # [B,H,S,1]
        W = torch.exp(Dm - m) * torch.einsum("bhsd,bhtd->bhst", q, k)
        n = torch.maximum(torch.abs(W.sum(-1, keepdim=True)),
                          torch.exp(-m)) + _EPS
        h = torch.einsum("bhst,bhtd->bhsd", W / n, v)            # [B,H,S,dh]
        # exact final recurrent state (for parallel prefill -> O(1) decode):
        # logw_s = F_S - F_s + logi_s, stabilized against m0 = -30
        logw = Fc[:, :, -1:] - Fc + logi                         # [B,H,S]
        mS = torch.maximum(logw.amax(-1), Fc[:, :, -1] - 30.0)
        wS = torch.exp(logw - mS[..., None])                     # [B,H,S]
        C1 = torch.einsum("bhs,bhsd,bhse->bhde", wS, k, v)
        n1 = torch.einsum("bhs,bhsd->bhd", wS, k)
        new_state = {"C": C1, "n": n1, "m": mS}
    else:
        # recurrent decode (S == 1)
        C, n0, m0 = state["C"], state["n"], state["m"]
        li, lf = logi[:, :, 0], logf[:, :, 0]                    # [B,H]
        m1 = torch.maximum(lf + m0, li)
        fs = torch.exp(lf + m0 - m1)[..., None]
        is_ = torch.exp(li - m1)[..., None]
        k0, v0, q0 = k[:, :, 0], v[:, :, 0], q[:, :, 0]          # [B,H,dh]
        C1 = fs[..., None] * C + is_[..., None] * torch.einsum(
            "bhd,bhe->bhde", k0, v0)
        n1 = fs * n0 + is_ * k0
        num = torch.einsum("bhde,bhd->bhe", C1, q0)
        den = torch.maximum(torch.abs((n1 * q0).sum(-1, keepdim=True)),
                            torch.exp(-m1)[..., None]) + _EPS
        h = (num / den)[:, :, None, :]                           # [B,H,1,dh]
        new_state = {"C": C1, "n": n1, "m": m1}

    h = h.transpose(1, 2).reshape(B, S, di)
    # per-channel group norm (paper: head-wise LayerNorm on h)
    mean = h.mean(-1, keepdim=True)
    var = h.var(-1, keepdim=True, correction=0)
    h = (h - mean) * torch.rsqrt(var + _EPS) * p["norm"].float()
    h = h * F.silu(g)
    out = dense(p["down"], h.to(x.dtype), cfg.compute_dtype)
    return hint(out, "batch", "seq", "embed"), new_state


def mlstm_state_init(cfg: ModelConfig, batch: int, dtype=torch.float32,
                     device="cpu"):
    H = cfg.n_heads
    dh = 2 * cfg.d_model // H
    return {"C": torch.zeros((batch, H, dh, dh), dtype=dtype, device=device),
            "n": torch.zeros((batch, H, dh), dtype=dtype, device=device),
            "m": torch.full((batch, H), -30.0, dtype=dtype, device=device)}


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------

def slstm_init(draws: Draws, cfg: ModelConfig):
    d = cfg.d_model
    H = cfg.n_heads
    dh = d // H
    dt = dtype_of(cfg.param_dtype)
    return {
        # 4 gates (z, i, f, o) from input
        "wx": dense_init(draws, d, 4 * d, ("embed", "ff"), bias=True,
                         dtype=dt),
        # block-diagonal recurrent connections per head: [4, H, dh, dh]
        "r": ParamMeta(draws.normal((4, H, dh, dh), dt, dh ** -0.5),
                       (None, "heads", None, None)),
        "down": dense_init(draws, d, d, ("embed", "embed"), dtype=dt),
    }


def _slstm_step(p, cfg, carry, gx):
    """carry: (h, c, n, m) each [B, H, dh]; gx [B, 4, H, dh] (input gates)."""
    h, c, n, m = carry
    r = p["r"].float()                                   # [4,H,dh,dh]
    rec = torch.einsum("bhd,ghde->bghe", h, r)           # [B,4,H,dh]
    z = torch.tanh(gx[:, 0] + rec[:, 0])
    li = gx[:, 1] + rec[:, 1]                            # log-space input gate
    lf = F.logsigmoid(gx[:, 2] + rec[:, 2])              # log forget gate
    o = torch.sigmoid(gx[:, 3] + rec[:, 3])
    m1 = torch.maximum(lf + m, li)
    i_ = torch.exp(li - m1)
    f_ = torch.exp(lf + m - m1)
    c1 = f_ * c + i_ * z
    n1 = torch.clamp_min(f_ * n + i_, _EPS)
    h1 = o * (c1 / n1)
    return (h1, c1, n1, m1)


def slstm_apply(p, cfg: ModelConfig, x, *, state=None):
    """x [B, S, D]. state (decode): {"h","c","n","m"} each [B,H,dh]."""
    B, S, D = x.shape
    H = cfg.n_heads
    dh = D // H
    gx = dense(p["wx"], x, torch.float32).reshape(B, S, 4, H, dh)

    if state is None:
        zeros = torch.zeros((B, H, dh), dtype=torch.float32, device=x.device)
        carry = (zeros, zeros, zeros, torch.full_like(zeros, -30.0))
        hs = []
        for t in range(S):
            carry = _slstm_step(p, cfg, carry, gx[:, t])
            hs.append(carry[0])
        h = torch.stack(hs, dim=1).reshape(B, S, D)      # [B,S,H,dh]->[B,S,D]
    else:
        carry = _slstm_step(p, cfg, (state["h"], state["c"], state["n"],
                                     state["m"]), gx[:, 0])
        h = carry[0].reshape(B, 1, D)
    new_state = dict(zip(("h", "c", "n", "m"), carry))

    out = dense(p["down"], h.to(x.dtype), cfg.compute_dtype)
    return hint(out, "batch", "seq", "embed"), new_state


def slstm_state_init(cfg: ModelConfig, batch: int, dtype=torch.float32,
                     device="cpu"):
    H = cfg.n_heads
    dh = cfg.d_model // H
    z = torch.zeros((batch, H, dh), dtype=dtype, device=device)
    return {"h": z, "c": z.clone(), "n": z.clone(),
            "m": torch.full((batch, H, dh), -30.0, dtype=dtype,
                            device=device)}
