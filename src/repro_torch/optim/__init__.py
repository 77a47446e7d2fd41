"""Optimizers, schedules, the train-step factory and gradient compression
of the port (``repro.optim``'s copies over trees of tensors)."""
from repro_torch.optim.optimizers import (  # noqa: F401
    AdamW,
    SGD,
    TrainState,
    apply_updates,
    clip_by_global_norm,
    cosine_schedule,
    global_norm,
    make_train_step,
)
from repro_torch.optim.compression import (  # noqa: F401
    ErrorFeedbackState,
    compress_int8,
    compressed_psum,
    decompress_int8,
)
