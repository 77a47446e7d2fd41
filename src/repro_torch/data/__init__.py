"""Synthetic training data of the port (numpy, deterministic per (seed, step))."""
from repro_torch.data.synthetic import (  # noqa: F401
    dlrm_batch_stream,
    lm_batch_stream,
    make_dlrm_batch,
    make_features,
    make_lm_batch,
)
