"""Analytic FLOP/byte models per (arch x shape).

A copy of the JAX package's ``launch/analytic.py`` (pure arithmetic on a
``ModelConfig``). The JAX package uses it to correct XLA's cost analysis,
which counts a scanned layer stack's body once; the port uses it for the
least time a step could take on the card (``bytes_model`` over the card's
memory rate, ``flops_model`` over its peak).

Conventions:
  * "computed" FLOPs include causal-mask waste (both the direct and the
    blockwise attention paths compute the full S x T score matrix) — this
    is what the hardware executes;
  * "useful" FLOPs are MODEL_FLOPS = 6 N_active D (train) / 2 N_active D
    (inference) per the assignment spec;
  * matmul = 2 m n k FLOPs; backward = 2x forward; full remat = +1 forward.
"""
from __future__ import annotations

import dataclasses

from ..models.config import LAYERS_PER_KIND, ModelConfig


@dataclasses.dataclass
class FlopsBytes:
    computed_flops: float      # global, what the hardware executes
    useful_flops: float        # global, MODEL_FLOPS
    hbm_bytes: float           # global, estimated HBM traffic


def _attn_proj_flops(cfg: ModelConfig) -> float:
    """qkv + output projection FLOPs per token (forward)."""
    d, hd = cfg.d_model, cfg.head_dim
    return 2 * d * (cfg.n_heads * hd) * 2 + 2 * d * (cfg.n_kv_heads * hd) * 2


def _attn_score_flops(cfg: ModelConfig, s_ctx: int) -> float:
    """score + value einsum FLOPs per token at context length s_ctx."""
    return 2 * 2 * s_ctx * cfg.n_heads * cfg.head_dim


def _mlp_flops(cfg: ModelConfig, d_ff: int, gated: bool) -> float:
    m = 3 if gated else 2
    return 2 * cfg.d_model * d_ff * m


def _per_token_forward(cfg: ModelConfig, S: int, ctx: int | None = None):
    """(matmul flops, attention-quadratic flops) per token, forward pass.
    ctx overrides the attended context length (decode: cache length)."""
    d = cfg.d_model
    mm = 0.0
    qd = 0.0
    for kind, count in cfg.block_pattern:
        kinds = {"griffin": ("rglru", "rglru", "local"),
                 "xunit": ("mlstm", "slstm")}.get(kind, (kind,) * 1)
        if kind not in ("griffin", "xunit"):
            kinds = (kind,)
        for sub in kinds:
            n = count
            if sub in ("attn", "enc", "moe", "xdec"):
                mm += n * _attn_proj_flops(cfg)
                qd += n * _attn_score_flops(cfg, ctx if ctx else S)
                if sub == "xdec":   # cross attention over enc_seq
                    mm += n * _attn_proj_flops(cfg)
                    qd += n * _attn_score_flops(cfg, cfg.enc_seq)
                if sub == "moe":
                    e = cfg.moe
                    mm += n * 2 * d * e.n_experts          # router
                    mm += n * e.top_k * e.capacity_factor * \
                        _mlp_flops(cfg, e.d_ff_expert, True)
                    if e.shared_expert:
                        mm += n * _mlp_flops(cfg, cfg.d_ff, True)
                elif cfg.d_ff:
                    mm += n * _mlp_flops(cfg, cfg.d_ff, cfg.gated_mlp)
            elif sub == "local":
                mm += n * _attn_proj_flops(cfg)
                eff = min(cfg.window, ctx if ctx else S)
                qd += n * _attn_score_flops(cfg, eff)
                if cfg.d_ff:
                    mm += n * _mlp_flops(cfg, cfg.d_ff, cfg.gated_mlp)
            elif sub == "rglru":
                mm += n * (2 * d * d * 5 + 2 * d * 4)      # in/gate/out/a/x
                if cfg.d_ff:
                    mm += n * _mlp_flops(cfg, cfg.d_ff, cfg.gated_mlp)
            elif sub == "mlstm":
                di = 2 * d
                mm += n * (2 * d * 2 * di + 3 * 2 * di * di + 2 * di * d)
                if ctx is None:  # parallel (quadratic) training form
                    qd += n * 2 * 2 * S * di
                else:            # recurrent decode: O(di * dh) state update
                    mm += n * 2 * di * (di // max(cfg.n_heads, 1)) * 2
            elif sub == "slstm":
                dh = d // cfg.n_heads
                mm += n * (2 * d * 4 * d + 2 * 4 * d * dh + 2 * d * d)
    # logits
    mm += 2 * d * cfg.vocab
    return mm, qd


def _encoder_flops(cfg: ModelConfig) -> float:
    """Whisper-style encoder stack FLOPs per SAMPLE (enc_seq frames)."""
    if not cfg.n_enc_layers:
        return 0.0
    per_frame = (_attn_proj_flops(cfg)
                 + _attn_score_flops(cfg, cfg.enc_seq)
                 + (_mlp_flops(cfg, cfg.d_ff, cfg.gated_mlp) if cfg.d_ff
                    else 0.0))
    return cfg.n_enc_layers * per_frame * cfg.enc_seq


def flops_model(cfg: ModelConfig, mode: str, seq_len: int,
                global_batch: int) -> FlopsBytes:
    if mode == "decode":
        n_tokens = global_batch
        mm, qd = _per_token_forward(cfg, 1, ctx=seq_len)
        computed = n_tokens * (mm + qd)     # cross-KV cached: no encoder
        useful = 2.0 * cfg.active_param_count() * n_tokens
    else:
        n_tokens = global_batch * seq_len
        mm, qd = _per_token_forward(cfg, seq_len)
        fwd = n_tokens * (mm + qd) + global_batch * _encoder_flops(cfg)
        if mode == "train":
            remat = 1.0 if cfg.remat == "full" else 0.0
            computed = fwd * (3.0 + remat)
            useful = 6.0 * cfg.active_param_count() * n_tokens
        else:  # prefill
            computed = fwd
            useful = 2.0 * cfg.active_param_count() * n_tokens
    return FlopsBytes(computed, useful, bytes_model(cfg, mode, seq_len,
                                                    global_batch))


def bytes_model(cfg: ModelConfig, mode: str, seq_len: int,
                global_batch: int) -> float:
    """Coarse global HBM-traffic estimate (documented in EXPERIMENTS.md):

    train:  params read twice (fwd+bwd) + grads written + Adam read/write
            (fp32 m, v, p) + activations saved at block boundaries (remat
            'full': one [B,S,d] residual per layer, bf16, written+read).
    decode: params read once + KV-cache/state read+write once.
    prefill:params read once + activations written once + cache written.
    """
    n = cfg.param_count()
    d = cfg.d_model
    L = sum(c * LAYERS_PER_KIND.get(k, 1) for k, c in cfg.block_pattern)
    pbytes = 4  # fp32 master params
    if mode == "decode":
        n_tokens = global_batch
        cache = _cache_bytes(cfg, seq_len, global_batch)
        return n * pbytes + 2 * cache + n_tokens * d * L * 2 * 4
    n_tokens = global_batch * seq_len
    act = n_tokens * d * L * 2 * 2          # bf16 residuals, write+read
    if mode == "train":
        return (2 * n + 1 * n) * pbytes + 6 * n * 4 + 2 * act
    cache = _cache_bytes(cfg, seq_len, global_batch)
    return n * pbytes + act + cache


def _cache_bytes(cfg: ModelConfig, seq_len: int, batch: int) -> float:
    total = 0.0
    for kind, count in cfg.block_pattern:
        kinds = {"griffin": ("rglru", "rglru", "local"),
                 "xunit": ("mlstm", "slstm")}.get(kind, (kind,))
        for sub in kinds:
            if sub in ("attn", "moe", "enc", "xdec"):
                total += count * 2 * batch * seq_len * cfg.n_kv_heads * \
                    cfg.head_dim * 2
            elif sub == "local":
                w = min(cfg.window, seq_len)
                total += count * 2 * batch * w * cfg.n_kv_heads * \
                    cfg.head_dim * 2
            elif sub == "rglru":
                total += count * batch * cfg.d_model * 4 * 4
            elif sub == "mlstm":
                dh = 2 * cfg.d_model // cfg.n_heads
                total += count * batch * cfg.n_heads * (dh * dh + dh) * 4
            elif sub == "slstm":
                total += count * batch * cfg.d_model * 4 * 4
    return total
