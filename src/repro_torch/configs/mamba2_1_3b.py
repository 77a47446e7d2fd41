"""Mamba2 1.3B — attention-free SSD (state-space duality) backbone.

[arXiv:2405.21060; unverified] 48L d_model=2048 vocab=50280 ssm_state=128.
O(1) decode state -> runs long_500k.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="mamba2-1.3b",
    family="ssm",
    num_layers=48,
    d_model=2048,
    num_heads=1,      # unused (attn-free)
    num_kv_heads=1,
    head_dim=1,
    d_ff=0,
    vocab_size=50280,
    ssm_state=128,
    ssm_expand=2,
    ssm_head_dim=64,
    ssm_conv=4,
    ssm_chunk=256,
    ffn_gated=False,
    source="arXiv:2405.21060; unverified",
))
