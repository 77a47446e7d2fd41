"""Zamba2 1.2B — hybrid: Mamba2 backbone + one shared attention block.

[arXiv:2411.15242; hf] 38L d_model=2048 32H (MHA kv=32) d_ff=8192 vocab=32000
ssm_state=64. A single shared (attn + MLP) block is interleaved every 6 Mamba2
layers (weights shared across invocations). Hybrid -> runs long_500k (SSD state
is O(1); the shared attention block keeps a KV cache).
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="zamba2-1.2b",
    family="hybrid",
    num_layers=38,
    d_model=2048,
    num_heads=32,
    num_kv_heads=32,
    head_dim=64,
    d_ff=8192,
    vocab_size=32000,
    ssm_state=64,
    ssm_expand=2,
    ssm_head_dim=64,
    ssm_conv=4,
    ssm_chunk=256,
    shared_attn_every=6,
    ffn_gated=True,
    source="arXiv:2411.15242; hf",
))
