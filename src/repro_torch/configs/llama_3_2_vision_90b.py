"""Llama 3.2 Vision 90B — VLM: dense decoder + cross-attn image layers.

[hf:meta-llama/Llama-3.2-11B-Vision; unverified] 100L d_model=8192 64H
(GQA kv=8) d_ff=28672 vocab=128256. Cross-attention layers every 5 self-attn
layers (20 total) attend to image patch embeddings. The vision frontend is a
STUB: input_specs() supplies precomputed patch embeddings. Full attention ->
skips long_500k.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="llama-3.2-vision-90b",
    family="vlm",
    num_layers=100,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=28672,
    vocab_size=128256,
    cross_attn_every=5,
    num_image_tokens=1601,  # 1 tile of 1600 patches + 1 cls, ViT-H frontend stub
    rope_theta=500_000.0,
    ffn_gated=True,
    skip_shapes=(
        ("long_500k", "full attention (quadratic); 500k decode context infeasible"),
    ),
    microbatches=4,
    source="hf:meta-llama/Llama-3.2-11B-Vision; unverified",
))
