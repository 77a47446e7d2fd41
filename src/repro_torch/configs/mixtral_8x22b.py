"""Mixtral 8x22B — sparse MoE, 8 experts top-2, GQA, sliding-window attention.

[arXiv:2401.04088; hf] 56L d_model=6144 48H (GQA kv=8) d_ff=16384 vocab=32768.
SWA makes decode KV bounded -> runs long_500k with a windowed cache.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="mixtral-8x22b",
    family="moe",
    num_layers=56,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    head_dim=128,
    d_ff=16384,
    vocab_size=32768,
    num_experts=8,
    top_k=2,
    sliding_window=4096,
    rope_theta=1_000_000.0,
    ffn_gated=True,
    microbatches=4,
    source="arXiv:2401.04088; hf",
))
