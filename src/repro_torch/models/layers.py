"""Foundational layers: norms, RoPE, GQA attention (global/local/cross),
gated MLPs, embeddings. Pure-functional, as the JAX package's
``models/layers.py``: ``*_init`` builds ParamMeta trees (value + logical
axes) from a ``Draws``, ``*_apply`` consumes plain trees of tensors.

Dtype policy: params in cfg.param_dtype (fp32 by default), activations and
matmuls in cfg.compute_dtype (bf16), softmax/norm statistics in fp32.
Attention is plain torch ops (products, an explicit mask, an fp32
softmax), as JAX computes it outside any kernel.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .config import ModelConfig
from .partition import ParamMeta, hint

NEG_INF = -2.0 ** 30  # large-negative that stays finite in bf16


def dtype_of(name) -> torch.dtype:
    """A config's dtype name ("float32", "bfloat16") or a torch dtype."""
    return getattr(torch, name) if isinstance(name, str) else name


def gelu(x):
    """``jax.nn.gelu``'s default: the tanh approximation."""
    return F.gelu(x, approximate="tanh")


class Draws:
    """Where ``*_init`` draws its values: normals from ``generator`` on
    its own device, then moved to ``device``. On the "meta" device nothing
    is drawn or allocated (``Model.abstract_params``)."""

    def __init__(self, generator: torch.Generator | None, device):
        self.generator = generator
        self.device = torch.device(device)

    def normal(self, shape, dtype, std: float):
        if self.device.type == "meta":
            return torch.empty(shape, dtype=dtype, device="meta")
        src = self.generator.device if self.generator is not None \
            else self.device
        x = torch.randn(shape, generator=self.generator, dtype=dtype,
                        device=src) * std
        return x.to(self.device)

    def full(self, shape, value, dtype):
        return torch.full(shape, value, dtype=dtype, device=self.device)


def dense_init(draws: Draws, d_in: int, d_out: int, axes, *,
               bias: bool = False, dtype=torch.float32,
               scale: float | None = None):
    std = scale if scale is not None else d_in ** -0.5
    p = {"w": ParamMeta(draws.normal((d_in, d_out), dtype, std), axes)}
    if bias:
        p["b"] = ParamMeta(draws.full((d_out,), 0.0, dtype), (axes[-1],))
    return p


def dense(p, x, compute_dtype=torch.bfloat16):
    cd = dtype_of(compute_dtype)
    out = x.to(cd) @ p["w"].to(cd)
    if "b" in p:
        out = out + p["b"].to(cd)
    return out


def rmsnorm_init(draws: Draws, d: int, dtype=torch.float32):
    return {"scale": ParamMeta(draws.full((d,), 1.0, dtype), ("embed",))}


def rmsnorm(p, x, eps: float = 1e-6):
    xf = x.float()
    var = (xf * xf).mean(-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * p["scale"].float()).to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope(x, positions, theta: float):
    """x [B, S, H, hd], positions int [B, S]. Rotates the two halves of
    head_dim (not interleaved pairs)."""
    hd = x.shape[-1]
    half = hd // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device) / half)
    ang = positions.float()[:, :, None, None] * freqs[None, None, None, :]
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Attention (GQA; causal / bidirectional / sliding window / cross)
# ---------------------------------------------------------------------------

def attn_init(draws: Draws, cfg: ModelConfig, *, cross: bool = False):
    d, hd = cfg.d_model, cfg.head_dim
    dt = dtype_of(cfg.param_dtype)
    p = {
        "wq": ParamMeta(draws.normal((d, cfg.n_heads, hd), dt, d ** -0.5),
                        ("embed", "heads", "head_dim")),
        "wk": ParamMeta(draws.normal((d, cfg.n_kv_heads, hd), dt, d ** -0.5),
                        ("embed", "kv", "head_dim")),
        "wv": ParamMeta(draws.normal((d, cfg.n_kv_heads, hd), dt, d ** -0.5),
                        ("embed", "kv", "head_dim")),
        "wo": ParamMeta(draws.normal((cfg.n_heads, hd, d), dt,
                                     (cfg.n_heads * hd) ** -0.5),
                        ("heads", "head_dim", "embed")),
    }
    if cfg.qkv_bias:
        p["bq"] = ParamMeta(draws.full((cfg.n_heads, hd), 0.0, dt),
                            ("heads", "head_dim"))
        p["bk"] = ParamMeta(draws.full((cfg.n_kv_heads, hd), 0.0, dt),
                            ("kv", "head_dim"))
        p["bv"] = ParamMeta(draws.full((cfg.n_kv_heads, hd), 0.0, dt),
                            ("kv", "head_dim"))
    if cfg.qk_norm:
        p["q_norm"] = ParamMeta(draws.full((hd,), 1.0, dt), ("head_dim",))
        p["k_norm"] = ParamMeta(draws.full((hd,), 1.0, dt), ("head_dim",))
    return p


def _qk_norm(x, scale, eps):
    xf = x.float()
    var = (xf * xf).mean(-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)


def project_qkv(p, cfg: ModelConfig, x, positions, *, use_rope: bool = True):
    """x [B, S, D] -> q [B,S,H,hd], k/v [B,S,Hkv,hd] (RoPE'd, normed)."""
    cd = dtype_of(cfg.compute_dtype)
    xq = x.to(cd)
    q = torch.einsum("bsd,dhk->bshk", xq, p["wq"].to(cd))
    k = torch.einsum("bsd,dhk->bshk", xq, p["wk"].to(cd))
    v = torch.einsum("bsd,dhk->bshk", xq, p["wv"].to(cd))
    if "bq" in p:
        q = q + p["bq"].to(cd)
        k = k + p["bk"].to(cd)
        v = v + p["bv"].to(cd)
    if "q_norm" in p:
        q = _qk_norm(q, p["q_norm"], cfg.norm_eps)
        k = _qk_norm(k, p["k_norm"], cfg.norm_eps)
    if use_rope and not cfg.learned_pos:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    q = hint(q, "batch", "seq", "heads", None)
    k = hint(k, "batch", "seq", "kv", None)
    return q, k, v


def attention(q, k, v, cfg: ModelConfig, *, mask):
    """Grouped-query attention core (direct form).

    q [B,S,H,hd]; k/v [B,T,Hkv,hd]; mask broadcastable to [B,1,1,S,T]
    (True = attend). Softmax in fp32. For large S*T use chunked_attention.
    """
    B, S, H, hd = q.shape
    g = H // k.shape[2]
    qg = q.reshape(B, S, k.shape[2], g, hd)
    scores = torch.einsum("bsngh,btnh->bnsgt", qg.float(),
                          k.float()) * hd ** -0.5
    # scores [B, Hkv, S, g, T]
    if mask is not None:
        scores = torch.where(mask[:, None, :, None, :], scores, NEG_INF)
    w = torch.softmax(scores, dim=-1)
    out = torch.einsum("bnsgt,btnh->bsngh", w.to(k.dtype), v)
    return out.reshape(B, S, H, hd)


# Above this many score elements per head, route through the blockwise path.
CHUNKED_THRESHOLD = 1024 * 1024
CHUNK_Q = 256
CHUNK_K = 1024


def _pad_seq(x, n: int, value=0):
    """Pad dim 1 of x at its end by n entries of ``value``."""
    if not n:
        return x
    shape = list(x.shape)
    shape[1] = n
    return torch.cat([x, x.new_full(shape, value)], dim=1)


def chunked_attention(q, k, v, cfg: ModelConfig, *, positions_q,
                      positions_kv, causal: bool, window: int | None,
                      bq: int = CHUNK_Q, bk: int = CHUNK_K):
    """Blockwise online-softmax (flash-style) attention in plain torch ops.

    Never materializes the [S, T] score matrix: a loop over query blocks
    runs an inner loop over key/value blocks carrying the running (max,
    denominator, accumulator). Its masks equal ``attention``'s.

    positions_*: int [B, S] / [B, T]; padded kv positions are -1.
    """
    B, S, H, hd = q.shape
    T, n_kv = k.shape[1], k.shape[2]
    g = H // n_kv
    scale = hd ** -0.5

    pad_s = (-S) % bq
    pad_t = (-T) % bk
    qp = _pad_seq(q, pad_s)
    pq = _pad_seq(positions_q, pad_s, 0)
    kp = _pad_seq(k, pad_t)
    vp = _pad_seq(v, pad_t)
    pkv = _pad_seq(positions_kv, pad_t, -1)
    nq, nk = (S + pad_s) // bq, (T + pad_t) // bk

    # Sliding-window block skipping: with a window, q-block i only needs the
    # nw kv blocks covering [i*bq - window + 1, (i+1)*bq); masks stay exact.
    nw = min(nk, (bq + (window or 0) + bk - 1) // bk + 1) if window else nk
    skip = window is not None and causal and nw < nk
    inf = float("inf")
    outs = []
    for iq in range(nq):
        qi = qp[:, iq * bq:(iq + 1) * bq].float()          # [B,bq,H,hd]
        pqi = pq[:, iq * bq:(iq + 1) * bq]                  # [B,bq]
        m = q.new_full((B, H, bq), -inf, dtype=torch.float32)
        l = q.new_zeros((B, H, bq), dtype=torch.float32)
        acc = q.new_zeros((B, H, bq, hd), dtype=torch.float32)
        first = (min(max((iq * bq - window + 1) // bk, 0), nk - nw)
                 if skip else 0)
        for j in range(first, first + (nw if skip else nk)):
            kj = kp[:, j * bk:(j + 1) * bk]
            vj = vp[:, j * bk:(j + 1) * bk]
            pkj = pkv[:, j * bk:(j + 1) * bk]
            if g > 1:                                   # GQA group expansion
                kj = kj.repeat_interleave(g, dim=2)
                vj = vj.repeat_interleave(g, dim=2)
            s = torch.einsum("bqhd,bthd->bhqt", qi, kj.float()) * scale
            valid = pkj[:, None, :] >= 0
            if causal:
                valid = valid & (pkj[:, None, :] <= pqi[:, :, None])
            if window is not None:
                valid = valid & (pkj[:, None, :] > pqi[:, :, None] - window)
            s = torch.where(valid[:, None], s, -inf)     # [B,1,bq,bk] mask
            m_new = torch.maximum(m, s.amax(-1))
            # guard fully-masked rows (padded queries): keep m finite
            m_safe = torch.where(torch.isfinite(m_new), m_new, 0.0)
            p = torch.exp(s - m_safe[..., None])
            p = torch.where(torch.isfinite(s), p, 0.0)
            corr = torch.where(torch.isfinite(m), torch.exp(m - m_safe), 0.0)
            l = l * corr + p.sum(-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bhqt,bthd->bhqd", p, vj.float())
            m = m_new
        out = acc / torch.clamp_min(l, 1e-30)[..., None]   # [B,H,bq,hd]
        outs.append(out.transpose(1, 2))                   # [B,bq,H,hd]
    return torch.cat(outs, dim=1)[:, :S].to(v.dtype)


def attn_out(p, cfg: ModelConfig, ctx):
    cd = dtype_of(cfg.compute_dtype)
    out = torch.einsum("bshk,hkd->bsd", ctx.to(cd), p["wo"].to(cd))
    return hint(out, "batch", "seq", "embed")


def causal_mask(positions_q, positions_kv, window: int | None = None,
                kv_valid=None):
    """True where q may attend kv. positions_* int [B, S]/[B, T]."""
    m = positions_kv[:, None, :] <= positions_q[:, :, None]
    if window is not None:
        m &= positions_kv[:, None, :] > positions_q[:, :, None] - window
    if kv_valid is not None:
        m &= kv_valid[:, None, :]
    return m


def _arange(n: int, device, start: int = 0):
    return torch.arange(start, n, dtype=torch.int32, device=device)


def attn_apply(p, cfg: ModelConfig, x, positions, *, kind: str = "attn",
               cache=None, cross_kv=None):
    """One attention sub-layer (pre-norm residual handled by caller).

    kind: attn|local|enc. cache: optional dict with k/v [B, T, Hkv, hd] and
    an int32 ``pos`` (a 0-dim tensor). The cache's k/v (and a ring cache's
    kpos) are written in place; the returned cache holds those tensors and
    a new ``pos``. Returns (out [B,S,D], new_cache).
    """
    if cross_kv is not None:
        q, _, _ = project_qkv(p, cfg, x, positions, use_rope=False)
        k, v = cross_kv
        if q.shape[1] * k.shape[1] > CHUNKED_THRESHOLD:
            T = k.shape[1]
            pos_kv = _arange(T, x.device)[None].expand(x.shape[0], T)
            out = chunked_attention(q, k, v, cfg, positions_q=positions,
                                    positions_kv=pos_kv, causal=False,
                                    window=None)
        else:
            out = attention(q, k, v, cfg, mask=None)
        return attn_out(p, cfg, out), cache

    q, k, v = project_qkv(p, cfg, x, positions,
                          use_rope=not cfg.learned_pos)
    window = cfg.window if kind == "local" else None
    if cache is None:
        S = q.shape[1]
        if S * S > CHUNKED_THRESHOLD:
            out = chunked_attention(q, k, v, cfg, positions_q=positions,
                                    positions_kv=positions,
                                    causal=kind != "enc", window=window)
        elif kind == "enc":
            out = attention(q, k, v, cfg, mask=None)
        else:
            out = attention(q, k, v, cfg,
                            mask=causal_mask(positions, positions, window))
        return attn_out(p, cfg, out), None

    # cache path: S == 1 -> decode step at cache["pos"]; S > 1 -> prefill.
    # Two cache layouts:
    #  * linear (global attention): k/v [B, T, ...] indexed by position;
    #  * ring   (local attention, cache has "kpos"): fixed window-sized
    #    buffer, slot = pos % T.
    T = cache["k"].shape[1]
    S = q.shape[1]
    B = x.shape[0]
    ring = "kpos" in cache
    dev = x.device
    if S == 1:
        pos = torch.as_tensor(cache["pos"], dtype=torch.int32, device=dev)
        if ring:
            slot = torch.remainder(pos, T).reshape(1).long()
            k_all = cache["k"].index_copy_(1, slot, k.to(cache["k"].dtype))
            v_all = cache["v"].index_copy_(1, slot, v.to(cache["v"].dtype))
            kpos = cache["kpos"].index_copy_(
                1, slot, pos.reshape(1, 1).expand(B, 1).to(torch.int32))
            valid = (kpos <= pos) & (kpos >= 0)
            if window is not None:
                valid &= kpos > pos - window
            new_cache = {"k": k_all, "v": v_all, "kpos": kpos,
                         "pos": pos + 1}
        else:
            # dynamic_update_slice clamps its start so the update fits: a
            # decode at pos >= T writes the last slot
            slot = pos.clamp(0, T - 1).reshape(1).long()
            k_all = cache["k"].index_copy_(1, slot, k.to(cache["k"].dtype))
            v_all = cache["v"].index_copy_(1, slot, v.to(cache["v"].dtype))
            kv_pos = _arange(T, dev)
            valid = kv_pos[None, :] <= pos
            if window is not None:
                valid &= kv_pos[None, :] > pos - window
            valid = valid.expand(B, T)
            new_cache = {"k": k_all, "v": v_all, "pos": pos + 1}
        out = attention(q, k_all, v_all, cfg, mask=valid[:, None, :])
        return attn_out(p, cfg, out), new_cache

    # prefill: attend over the fresh keys directly (cache starts empty),
    # then write the prefix (ring: its last `window` entries) into the cache.
    if S * S > CHUNKED_THRESHOLD:
        out = chunked_attention(q, k, v, cfg, positions_q=positions,
                                positions_kv=positions, causal=True,
                                window=window)
    else:
        out = attention(q, k, v, cfg,
                        mask=causal_mask(positions, positions, window))
    pos = torch.full((), S, dtype=torch.int32, device=dev)
    if ring:
        weff = min(S, T)
        tail = _arange(S, dev, S - weff)
        slots = torch.remainder(tail, T).long()
        k_all = cache["k"].index_copy_(
            1, slots, k[:, -weff:].to(cache["k"].dtype))
        v_all = cache["v"].index_copy_(
            1, slots, v[:, -weff:].to(cache["v"].dtype))
        kpos = cache["kpos"].index_copy_(1, slots, tail.expand(B, weff))
        new_cache = {"k": k_all, "v": v_all, "kpos": kpos, "pos": pos}
    else:
        cache["k"][:, :S].copy_(k)
        cache["v"][:, :S].copy_(v)
        new_cache = {"k": cache["k"], "v": cache["v"], "pos": pos}
    return attn_out(p, cfg, out), new_cache


def cross_kv_project(p, cfg: ModelConfig, enc_out):
    """Precompute a decoder layer's cross-attention K/V from encoder output
    (done once per sequence; cached across decode steps)."""
    cd = dtype_of(cfg.compute_dtype)
    k = torch.einsum("btd,dhk->bthk", enc_out.to(cd), p["wk"].to(cd))
    v = torch.einsum("btd,dhk->bthk", enc_out.to(cd), p["wv"].to(cd))
    return k, v


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------

def mlp_init(draws: Draws, cfg: ModelConfig, d_ff: int | None = None,
             gated: bool = True):
    d_ff = d_ff or cfg.d_ff
    d = cfg.d_model
    dt = dtype_of(cfg.param_dtype)
    p = {
        "wi": ParamMeta(draws.normal((d, d_ff), dt, d ** -0.5),
                        ("embed", "ff")),
        "wo": ParamMeta(draws.normal((d_ff, d), dt, d_ff ** -0.5),
                        ("ff", "embed")),
    }
    if gated:
        p["wg"] = ParamMeta(draws.normal((d, d_ff), dt, d ** -0.5),
                            ("embed", "ff"))
    return p


def mlp_apply(p, cfg: ModelConfig, x):
    cd = dtype_of(cfg.compute_dtype)
    xc = x.to(cd)
    h = xc @ p["wi"].to(cd)
    if "wg" in p:
        h = F.silu(xc @ p["wg"].to(cd)) * h
    else:
        h = gelu(h)
    h = hint(h, "batch", "seq", "ff")
    return hint(h @ p["wo"].to(cd), "batch", "seq", "embed")


# ---------------------------------------------------------------------------
# Embeddings / logits
# ---------------------------------------------------------------------------

def embed_init(draws: Draws, cfg: ModelConfig):
    dt = dtype_of(cfg.param_dtype)
    p = {"tok": ParamMeta(draws.normal((cfg.vocab, cfg.d_model), dt, 0.02),
                          ("vocab", "embed"))}
    if cfg.learned_pos:
        p["pos"] = ParamMeta(
            draws.normal((max(cfg.enc_seq, 8192), cfg.d_model), dt, 0.02),
            (None, "embed"))
    return p


def embed_apply(p, cfg: ModelConfig, tokens, positions=None):
    cd = dtype_of(cfg.compute_dtype)
    x = p["tok"][tokens].to(cd)
    if cfg.learned_pos and positions is not None:
        x = x + p["pos"][positions].to(cd)
    return hint(x, "batch", "seq", "embed")


def logits_init(draws: Draws, cfg: ModelConfig):
    if cfg.tie_embeddings:
        return {}
    dt = dtype_of(cfg.param_dtype)
    return {"w": ParamMeta(
        draws.normal((cfg.d_model, cfg.vocab), dt, cfg.d_model ** -0.5),
        ("embed", "vocab"))}


def logits_apply(p, embed_params, cfg: ModelConfig, x):
    """Logits in compute_dtype, then cast to fp32, then softcapped."""
    cd = dtype_of(cfg.compute_dtype)
    if cfg.tie_embeddings:
        w = embed_params["tok"].to(cd).T
    else:
        w = p["w"].to(cd)
    out = (x.to(cd) @ w).float()
    if cfg.logits_softcap:
        c = cfg.logits_softcap
        out = torch.tanh(out / c) * c
    return hint(out, "batch", "seq", "vocab")
