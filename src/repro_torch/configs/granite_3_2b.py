"""Granite 3.0 2B — dense llama-style decoder with GQA.

[hf:ibm-granite/granite-3.0-2b-base; hf] 40L d_model=2048 32H (GQA kv=8)
d_ff=8192 vocab=49155. Full attention -> skips long_500k.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="granite-3-2b",
    family="dense",
    num_layers=40,
    d_model=2048,
    num_heads=32,
    num_kv_heads=8,
    head_dim=64,
    d_ff=8192,
    vocab_size=49155,
    ffn_gated=True,
    tie_embeddings=True,
    skip_shapes=(
        ("long_500k", "full attention (quadratic); 500k decode context infeasible"),
    ),
    source="hf:ibm-granite/granite-3.0-2b-base; hf",
))
