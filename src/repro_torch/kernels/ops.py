"""Public entries of the kernels, with the dispatch rule of the port.

A CPU tensor takes the kernel's plain version (``ref.py``); any other tensor
goes to the CUDA kernel, which launches or raises -- nothing falls back.
``use_kernel=False`` selects the plain version explicitly on any device.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.kernels import cache_probe as _cache_probe
from repro_torch.kernels import flash_decode as _flash_decode
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


def decode_attention(q, k, v, kv_len, *, use_kernel: bool = True):
    """Flash decode attention: q [B, H, hd] vs cache k/v [B, S, K, hd] with
    valid prefix kv_len [B] int32. Returns [B, H, hd] f32. The CUDA kernel
    takes any S, so there is no fallback for an S that is not a multiple of
    a block."""
    if not use_kernel or k.device.type == "cpu":
        return ref.flash_decode_ref(q, k, v, kv_len)
    return _flash_decode.flash_decode(q, k, v, kv_len)


_WRAPPERS = {"gather_pool": _gather_pool, "cache_probe": _cache_probe,
             "flash_decode": _flash_decode}


def launch_counts() -> Dict[str, int]:
    """Kernel launches since the last :func:`reset_launch_counts`."""
    return {name: w.launches for name, w in _WRAPPERS.items()}


def reset_launch_counts() -> None:
    for w in _WRAPPERS.values():
        w.launches = 0
