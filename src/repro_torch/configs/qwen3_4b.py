"""qwen3-4b [dense]: qk_norm, GQA. 36L d_model=2560 32H (GQA kv=8)
d_ff=9728 vocab=151936. [hf:Qwen/Qwen3-8B; hf]

Full attention -> long_500k skipped.
"""
from repro_torch.models import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="qwen3-4b",
        n_layers=36,
        d_model=2560,
        n_heads=32,
        n_kv_heads=8,
        head_dim=128,
        d_ff=9728,
        vocab=151_936,
        family="dense",
        qk_norm=True,
        rope_theta=1_000_000.0,
        tie_embeddings=True,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="qwen3-4b-smoke",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        head_dim=16,
        d_ff=128,
        vocab=512,
        family="dense",
        qk_norm=True,
        tie_embeddings=True,
    )
