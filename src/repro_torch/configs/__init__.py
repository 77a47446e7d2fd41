"""Architecture registry of the port: ``get_config(name)`` / ``list_archs()``.

Importing this package registers the reference's ten assigned
architectures, which the port serves (``serve_lm``, every arch with a decode
step) and trains (``lm_train``), and the paper's DLRM models (Table 6),
whose statistics the workload archetypes draw table inventories from.
"""
from repro_torch.configs.base import (  # noqa: F401
    SHAPES,
    SHAPE_ORDER,
    DLRMConfig,
    ModelConfig,
    ShapeConfig,
    get_config,
    get_dlrm_config,
    list_archs,
)
from repro_torch.configs import (  # noqa: F401
    deepseek_moe_16b,
    dlrm_models,
    granite_34b,
    granite_3_2b,
    hubert_xlarge,
    llama_3_2_vision_90b,
    mamba2_1_3b,
    mixtral_8x22b,
    qwen1_5_0_5b,
    smollm_135m,
    zamba2_1_2b,
)

ASSIGNED_ARCHS = (
    "mixtral-8x22b",
    "deepseek-moe-16b",
    "mamba2-1.3b",
    "hubert-xlarge",
    "granite-3-2b",
    "granite-34b",
    "qwen1.5-0.5b",
    "smollm-135m",
    "zamba2-1.2b",
    "llama-3.2-vision-90b",
)
DENSE_ARCHS = ("smollm-135m", "qwen1.5-0.5b", "granite-3-2b", "granite-34b")
# the archs that have a decode step: every one but the encoder
DECODE_ARCHS = DENSE_ARCHS + ("deepseek-moe-16b", "mixtral-8x22b", "mamba2-1.3b",
                              "zamba2-1.2b", "llama-3.2-vision-90b")
