"""SmolLM 135M — small llama-arch dense decoder.

[hf:HuggingFaceTB/SmolLM-135M; hf] 30L d_model=576 9H (GQA kv=3) d_ff=1536
vocab=49152. Full attention -> skips long_500k.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="smollm-135m",
    family="dense",
    num_layers=30,
    d_model=576,
    num_heads=9,
    num_kv_heads=3,
    head_dim=64,
    d_ff=1536,
    vocab_size=49152,
    ffn_gated=True,
    tie_embeddings=True,
    skip_shapes=(
        ("long_500k", "full attention (quadratic); 500k decode context infeasible"),
    ),
    seq_parallel=False,
    source="hf:HuggingFaceTB/SmolLM-135M; hf",
))
