"""Architecture registry of the port: ``get_config(name)`` / ``list_archs()``.

Importing this package registers the dense-family architectures, the ones
the port serves so far (``serve_lm``), and the paper's DLRM models (Table 6),
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
    dlrm_models,
    granite_34b,
    granite_3_2b,
    qwen1_5_0_5b,
    smollm_135m,
)

DENSE_ARCHS = ("smollm-135m", "qwen1.5-0.5b", "granite-3-2b", "granite-34b")
