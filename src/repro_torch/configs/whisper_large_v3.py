"""whisper-large-v3 [audio]: encoder-decoder, conv frontend STUB.
32L (enc) + 32L (dec) d_model=1280 20H (kv=20, i.e. MHA) d_ff=5120
vocab=51866. [arXiv:2212.04356; unverified]

input_specs() provides precomputed frame embeddings [B, 1500, d_model]
(the conv1d+mel frontend is stubbed per the assignment). GELU (non-gated)
MLP, learned positions. Full attention -> long_500k skipped. The assigned
LM shapes exercise the DECODER backbone; enc_seq stays 1500 frames.
"""
from repro_torch.models import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="whisper-large-v3",
        n_layers=32,
        d_model=1280,
        n_heads=20,
        n_kv_heads=20,
        head_dim=64,
        d_ff=5120,
        vocab=51_866,
        block_pattern=(("xdec", 32),),
        family="audio",
        n_enc_layers=32,
        enc_seq=1500,
        learned_pos=True,
        gated_mlp=False,
        frontend="audio",
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="whisper-smoke",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        head_dim=16,
        d_ff=128,
        vocab=512,
        block_pattern=(("xdec", 2),),
        family="audio",
        n_enc_layers=2,
        enc_seq=16,
        learned_pos=True,
        gated_mlp=False,
        frontend="audio",
    )
