"""qwen3-moe-30b-a3b [moe]: 128 experts top-8. 48L d_model=2048 32H
(GQA kv=4) d_ff=768 (per expert) vocab=151936. [hf:Qwen/Qwen3-30B-A3B; hf]

Expert parallelism: 128 experts shard 8-per-chip over the model axis.
Full attention -> long_500k skipped.
"""
from repro_torch.models import ModelConfig, MoEConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="qwen3-moe-30b-a3b",
        n_layers=48,
        d_model=2048,
        n_heads=32,
        n_kv_heads=4,
        head_dim=128,
        d_ff=768,
        vocab=151_936,
        block_pattern=(("moe", 48),),
        family="moe",
        qk_norm=True,
        rope_theta=1_000_000.0,
        moe=MoEConfig(n_experts=128, top_k=8, d_ff_expert=768),
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="qwen3-moe-smoke",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        head_dim=16,
        d_ff=32,
        vocab=512,
        block_pattern=(("moe", 2),),
        family="moe",
        qk_norm=True,
        moe=MoEConfig(n_experts=8, top_k=2, d_ff_expert=32,
                      capacity_factor=8.0),
    )
