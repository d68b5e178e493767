"""llama4-scout-17b-a16e [moe]: 16 experts top-1 + shared expert, early
fusion (vision frontend STUB). 48L d_model=5120 40H (GQA kv=8) d_ff=8192
vocab=202048. [hf:meta-llama/Llama-4-Scout-17B-16E; unverified]

Simplifications noted in DESIGN.md: iRoPE/chunked attention not modeled ->
treated as full attention, long_500k skipped.
"""
from repro_torch.models import ModelConfig, MoEConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="llama4-scout-17b-a16e",
        n_layers=48,
        d_model=5120,
        n_heads=40,
        n_kv_heads=8,
        head_dim=128,
        d_ff=8192,
        vocab=202_048,
        block_pattern=(("moe", 48),),
        family="moe",
        rope_theta=500_000.0,
        moe=MoEConfig(n_experts=16, top_k=1, d_ff_expert=8192,
                      shared_expert=True),
        frontend="vision",
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="llama4-scout-smoke",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        head_dim=16,
        d_ff=64,
        vocab=512,
        block_pattern=(("moe", 2),),
        family="moe",
        moe=MoEConfig(n_experts=4, top_k=1, d_ff_expert=64,
                      shared_expert=True,
                      capacity_factor=8.0),
        frontend="vision",
    )
