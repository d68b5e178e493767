"""qwen2.5-3b [dense]: GQA with QKV bias. 36L d_model=2048 16H (GQA kv=2)
d_ff=11008 vocab=151936. [hf:Qwen/Qwen2.5-0.5B; hf]

Full attention -> long_500k skipped.
"""
from repro_torch.models import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="qwen2.5-3b",
        n_layers=36,
        d_model=2048,
        n_heads=16,
        n_kv_heads=2,
        head_dim=128,
        d_ff=11008,
        vocab=151_936,
        family="dense",
        qkv_bias=True,
        rope_theta=1_000_000.0,
        tie_embeddings=True,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="qwen2.5-3b-smoke",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        head_dim=16,
        d_ff=128,
        vocab=512,
        family="dense",
        qkv_bias=True,
        tie_embeddings=True,
    )
