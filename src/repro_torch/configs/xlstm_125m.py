"""xlstm-125m [ssm]: sLSTM + mLSTM blocks. 12L d_model=768 4H d_ff=0
vocab=50304. [arXiv:2405.04517; unverified]

12 layers = 6 xunit composites (mlstm, slstm alternating). d_ff=0: no
separate FFN — the projection factors live inside the blocks. Linear
recurrence -> runs long_500k.
"""
from repro_torch.models import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="xlstm-125m",
        n_layers=12,
        d_model=768,
        n_heads=4,
        n_kv_heads=4,
        head_dim=192,
        d_ff=0,
        vocab=50_304,
        block_pattern=(("xunit", 6),),
        family="ssm",
        tie_embeddings=True,
        sub_quadratic=True,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="xlstm-smoke",
        n_layers=4,
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        head_dim=16,
        d_ff=0,
        vocab=512,
        block_pattern=(("xunit", 2),),
        family="ssm",
        tie_embeddings=True,
        sub_quadratic=True,
    )
