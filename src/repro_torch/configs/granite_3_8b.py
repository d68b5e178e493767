"""granite-3-8b [dense]: GQA. 40L d_model=4096 32H (GQA kv=8) d_ff=12800
vocab=49155. [hf:ibm-granite/granite-3.0-2b-base; hf]

Full attention -> long_500k skipped.
"""
from repro_torch.models import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="granite-3-8b",
        n_layers=40,
        d_model=4096,
        n_heads=32,
        n_kv_heads=8,
        head_dim=128,
        d_ff=12800,
        vocab=49_155,
        family="dense",
        rope_theta=10_000.0,
        tie_embeddings=True,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="granite-3-8b-smoke",
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
