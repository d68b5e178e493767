"""qwen2-vl-7b [vlm]: M-RoPE, dynamic resolution (patch frontend STUB).
28L d_model=3584 28H (GQA kv=4) d_ff=18944 vocab=152064.
[arXiv:2409.12191; hf]

input_specs() provides precomputed patch embeddings; M-RoPE is simplified
to 1-D RoPE on the text backbone (DESIGN.md §Arch-applicability). Full
attention -> long_500k skipped.
"""
from repro_torch.models import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="qwen2-vl-7b",
        n_layers=28,
        d_model=3584,
        n_heads=28,
        n_kv_heads=4,
        head_dim=128,
        d_ff=18944,
        vocab=152_064,
        family="vlm",
        qkv_bias=True,
        rope_theta=1_000_000.0,
        frontend="vision",
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="qwen2-vl-smoke",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        head_dim=16,
        d_ff=128,
        vocab=512,
        family="vlm",
        qkv_bias=True,
        frontend="vision",
    )
