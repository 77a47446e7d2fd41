"""Public entries of the kernels, with the dispatch rule of the port.

A CPU tensor takes the kernel's plain version (``ref.py``); any other tensor
goes to the CUDA kernel, which launches or raises -- nothing falls back.
``use_kernel=False`` selects the plain version explicitly on any device.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.kernels import cache_probe as _cache_probe
from repro_torch.kernels import gather_pool as _gather_pool
from repro_torch.kernels import ref


def embedding_gather_pool(payload: torch.Tensor, scale: torch.Tensor,
                          bias: torch.Tensor, indices: torch.Tensor, *,
                          use_kernel: bool = True) -> torch.Tensor:
    """Fused lookup+dequant+pool. payload [R, D] int8/uint8; indices [N, P]."""
    if not use_kernel or payload.device.type == "cpu":
        return ref.gather_pool_ref(payload, scale, bias, indices)
    return _gather_pool.gather_pool(payload, scale, bias, indices)


def row_cache_probe(tag_table, tag_row, data, q_table, q_row, sets, *,
                    use_kernel: bool = True):
    """Set-associative cache probe: (values [N, D], hit [N] int32)."""
    if not use_kernel or data.device.type == "cpu":
        return ref.cache_probe_ref(tag_table, tag_row, data, q_table, q_row, sets)
    return _cache_probe.cache_probe(tag_table, tag_row, data, q_table, q_row, sets)


def launch_counts() -> Dict[str, int]:
    """Kernel launches since the last :func:`reset_launch_counts`."""
    return {"gather_pool": _gather_pool.launches,
            "cache_probe": _cache_probe.launches}


def reset_launch_counts() -> None:
    _gather_pool.launches = 0
    _cache_probe.launches = 0
