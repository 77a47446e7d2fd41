"""PyTorch/CUDA port of the SDM device serving path (``src/repro`` is the
JAX reference it is held against).

Entry points run on ``cuda`` unless the caller passes a CPU device; with no
GPU and no CPU device requested they raise instead of falling back.
"""
from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """The torch device an entry point runs on. ``cuda`` without a GPU
    raises: a caller that wants the CPU asks for it."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"torch device {dev} requested but CUDA is not available; "
            "pass a CPU device explicitly to run on the CPU")
    return dev
