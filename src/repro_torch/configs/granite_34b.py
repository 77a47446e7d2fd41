"""Granite 34B Code — deep dense decoder with MQA (kv=1), ungated MLP.

[arXiv:2405.04324; hf] 88L d_model=6144 48H (MQA kv=1) d_ff=24576 vocab=49152.
The ungated 2-matrix MLP (GPT-BigCode heritage) takes the tanh-approximated
GELU. Full attention -> skips long_500k.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="granite-34b",
    family="dense",
    num_layers=88,
    d_model=6144,
    num_heads=48,
    num_kv_heads=1,
    head_dim=128,
    d_ff=24576,
    vocab_size=49152,
    ffn_gated=False,
    remat_span=4,
    skip_shapes=(
        ("long_500k", "full attention (quadratic); 500k decode context infeasible"),
    ),
    microbatches=2,
    source="arXiv:2405.04324; hf",
))
