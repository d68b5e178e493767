"""recurrentgemma-2b [hybrid]: RG-LRU + local attention, 2 recurrent : 1
local-attn (Griffin pattern), 26L d_model=2560 10H (MQA kv=1) d_ff=7680
vocab=256000. [arXiv:2402.19427; hf]

26 layers = 8 griffin units (rglru, rglru, local) + 2 trailing rglru.
Sub-quadratic (window 2048 + linear recurrence) -> runs long_500k.
10 heads do not divide the model axis (16); the sharding rule engine
falls back to head_dim/replicated sharding for attention tensors.
"""
from repro_torch.models import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="recurrentgemma-2b",
        n_layers=26,
        d_model=2560,
        n_heads=10,
        n_kv_heads=1,
        head_dim=256,
        d_ff=7680,
        vocab=256_000,
        block_pattern=(("griffin", 8), ("rglru", 2)),
        family="hybrid",
        window=2048,
        logits_softcap=30.0,
        tie_embeddings=True,
        sub_quadratic=True,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="recurrentgemma-2b-smoke",
        n_layers=5,
        d_model=64,
        n_heads=2,
        n_kv_heads=1,
        head_dim=32,
        d_ff=128,
        vocab=512,
        block_pattern=(("griffin", 1), ("rglru", 2)),
        family="hybrid",
        window=16,
        logits_softcap=30.0,
        tie_embeddings=True,
        sub_quadratic=True,
    )
