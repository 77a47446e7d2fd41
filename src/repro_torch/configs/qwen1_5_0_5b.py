"""Qwen1.5 0.5B — dense decoder with QKV bias and a very large vocab.

[hf:Qwen/Qwen1.5-0.5B; hf] 24L d_model=1024 16H d_ff=2816 vocab=151936.
Full attention -> skips long_500k.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="qwen1.5-0.5b",
    family="dense",
    num_layers=24,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    head_dim=64,
    d_ff=2816,
    vocab_size=151936,
    qkv_bias=True,
    ffn_gated=True,
    tie_embeddings=True,
    skip_shapes=(
        ("long_500k", "full attention (quadratic); 500k decode context infeasible"),
    ),
    seq_parallel=False,
    source="hf:Qwen/Qwen1.5-0.5B; hf",
))
