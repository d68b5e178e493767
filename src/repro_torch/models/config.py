"""Model configuration covering every assigned architecture family.

A copy of the JAX package's ``models/config.py`` (pure Python). One
dataclass, many knobs: each ``repro_torch/configs/<arch>.py`` instantiates
it with the published numbers. ``block_pattern`` describes the layer stack
as (kind, count) segments; each segment's parameters are stacked along a
leading "layers" axis, as the JAX package stacks them for ``lax.scan``,
and the port runs a segment as a loop over that axis.

Block kinds:
  "attn"    global causal attention (+MLP)
  "local"   sliding-window causal attention (+MLP)
  "rglru"   RG-LRU recurrent block, Griffin-style (+MLP)
  "moe"     attention + mixture-of-experts MLP
  "mlstm"   xLSTM matrix-memory block
  "slstm"   xLSTM scalar-memory block
  "enc"     bidirectional encoder attention (+MLP)      [whisper encoder]
  "xdec"    causal self-attn + cross-attn (+MLP)        [whisper decoder]
  "griffin" composite unit (rglru, rglru, local)        [recurrentgemma 2:1]
  "xunit"   composite unit (mlstm, slstm)               [xlstm alternating]

Composite kinds exist so hybrid stacks keep their exact interleaving while
each segment stays one stack of one block kind.
"""
from __future__ import annotations

import dataclasses


# composite kinds expand to this many underlying layers
LAYERS_PER_KIND = {"griffin": 3, "xunit": 2}
CONV_W_APPROX = 4  # rg-lru temporal conv width (param_count estimate)


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff_expert: int
    shared_expert: bool = False
    capacity_factor: float = 1.25
    router_z_coef: float = 1e-3
    aux_coef: float = 1e-2
    # "einsum": GSPMD one-hot/scatter dispatch with GLOBAL capacity (simple,
    #   but the global cumsum over the sharded token dim costs collective-
    #   permute chains — the dry-run measured ~80 GB/layer of collectives).
    # "local": shard_map dispatch with PER-DATA-SHARD capacity — local
    #   cumsum, local scatter, one psum([T_local, D]) per layer (§Perf).
    dispatch: str = "einsum"


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int

    head_dim: int | None = None          # default d_model // n_heads
    block_pattern: tuple[tuple[str, int], ...] = ()  # default: all "attn"
    family: str = "dense"                # dense|hybrid|moe|ssm|audio|vlm

    # attention
    rope_theta: float = 10_000.0
    qk_norm: bool = False
    qkv_bias: bool = False
    window: int = 4096                   # for "local" blocks
    logits_softcap: float | None = None

    # moe
    moe: MoEConfig | None = None

    # encoder-decoder (whisper)
    n_enc_layers: int = 0
    enc_seq: int = 1500                  # frames from the (stubbed) frontend
    learned_pos: bool = False            # learned positions instead of RoPE

    # frontend stub: "text" | "audio" | "vision"
    frontend: str = "text"

    gated_mlp: bool = True               # SwiGLU vs plain GELU (whisper)

    # training
    tie_embeddings: bool = False
    norm_eps: float = 1e-6
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    remat: str = "full"                  # "none" | "full"

    # capability flags used by the launcher / dry-run
    sub_quadratic: bool = False          # can run long_500k
    has_decoder: bool = True             # encoder-only archs skip decode

    def __post_init__(self):
        if self.head_dim is None:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)
        if not self.block_pattern:
            object.__setattr__(self, "block_pattern",
                               (("attn", self.n_layers),))
        n = sum(c * LAYERS_PER_KIND.get(k, 1) for k, c in self.block_pattern)
        if n != self.n_layers:
            raise ValueError(
                f"{self.name}: block_pattern covers {n} layers, "
                f"config says {self.n_layers}")
        if self.n_heads % max(self.n_kv_heads, 1) != 0:
            raise ValueError(f"{self.name}: n_heads % n_kv_heads != 0")

    # ---------------- derived sizes ----------------
    @property
    def q_group(self) -> int:
        return self.n_heads // self.n_kv_heads

    def param_count(self) -> int:
        """Approximate parameter count (used for MODEL_FLOPS and memory
        budgeting; exact count comes from the built pytree)."""
        d, v = self.d_model, self.vocab
        total = v * d                               # embedding
        if not self.tie_embeddings:
            total += v * d
        hd = self.head_dim
        attn = d * (self.n_heads * hd) + 2 * d * (self.n_kv_heads * hd) \
            + (self.n_heads * hd) * d
        mlp = 3 * d * self.d_ff if self.d_ff else 0
        rglru_p = 3 * d * d + 2 * d * d + 4 * d * CONV_W_APPROX + 2 * d + mlp
        for kind, count in self.block_pattern:
            if kind == "griffin":
                total += count * (2 * rglru_p + attn + mlp)
            elif kind == "xunit":
                total += count * (12 * d * d + 10 * d * d)
            elif kind in ("attn", "local", "enc"):
                total += count * (attn + mlp)
            elif kind == "xdec":
                total += count * (2 * attn + mlp)
            elif kind == "moe":
                e = self.moe
                expert = 3 * d * e.d_ff_expert * e.n_experts
                shared = 3 * d * self.d_ff if e.shared_expert else 0
                total += count * (attn + expert + shared + d * e.n_experts)
            elif kind == "rglru":
                total += count * rglru_p
            elif kind == "mlstm":
                # up 2x2d, qkv+gates in 2d inner, down 2d->d (approximate)
                total += count * (12 * d * d)
            elif kind == "slstm":
                # 4 gates x (input + recurrent) + head mix (approximate)
                total += count * (10 * d * d)
        # encoder stack (whisper)
        total += self.n_enc_layers * (attn + mlp)
        return total

    def active_param_count(self) -> int:
        """Active params per token (MoE: only top_k experts count)."""
        if self.moe is None:
            return self.param_count()
        d = self.d_model
        e = self.moe
        dense_like = self.param_count()
        all_experts = 0
        active = 0
        for kind, count in self.block_pattern:
            if kind == "moe":
                all_experts += count * 3 * d * e.d_ff_expert * e.n_experts
                active += count * 3 * d * e.d_ff_expert * e.top_k
        return dense_like - all_experts + active
