"""phi4-mini-3.8b [dense]: RoPE SwiGLU GQA, 32L d_model=3072 24H (GQA kv=8)
d_ff=8192 vocab=200064. [arXiv:2412.08905; hf]

Full attention -> long_500k skipped (see DESIGN.md §Arch-applicability).
"""
from repro_torch.models import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="phi4-mini-3.8b",
        n_layers=32,
        d_model=3072,
        n_heads=24,
        n_kv_heads=8,
        head_dim=128,
        d_ff=8192,
        vocab=200_064,
        family="dense",
        tie_embeddings=True,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="phi4-mini-smoke",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        head_dim=16,
        d_ff=128,
        vocab=512,
        family="dense",
        tie_embeddings=True,
    )
