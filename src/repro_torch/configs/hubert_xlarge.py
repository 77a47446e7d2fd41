"""HuBERT X-Large — encoder-only audio transformer (wav2vec2 arch).

[arXiv:2106.07447; unverified] 48L d_model=1280 16H d_ff=5120 vocab=504.
Encoder-only: no decode step -> skips decode_32k and long_500k. The audio
frontend (conv feature extractor) is a STUB; input_specs() provides
precomputed frame embeddings.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="hubert-xlarge",
    family="encoder",
    num_layers=48,
    d_model=1280,
    num_heads=16,
    num_kv_heads=16,
    head_dim=80,
    d_ff=5120,
    vocab_size=504,
    causal=False,
    ffn_gated=False,  # GELU MLP
    skip_shapes=(
        ("decode_32k", "encoder-only architecture has no autoregressive decode step"),
        ("long_500k", "encoder-only architecture has no autoregressive decode step"),
    ),
    source="arXiv:2106.07447; unverified",
))
