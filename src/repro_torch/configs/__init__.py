"""Architecture registry of the port: ``get_config(name)`` / ``list_archs()``.

Importing this package registers the architectures the port serves so far
(``serve_lm``) and trains (``lm_train``): the dense, MoE, SSM and hybrid
families of the reference's zoo, and the paper's DLRM models (Table 6),
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
    mamba2_1_3b,
    mixtral_8x22b,
    qwen1_5_0_5b,
    smollm_135m,
    zamba2_1_2b,
)

DENSE_ARCHS = ("smollm-135m", "qwen1.5-0.5b", "granite-3-2b", "granite-34b")
# the ported archs that have a decode step
DECODE_ARCHS = DENSE_ARCHS + ("deepseek-moe-16b", "mixtral-8x22b", "mamba2-1.3b",
                              "zamba2-1.2b")
