"""Wrapper of the CUDA ``gather_pool`` kernel (``csrc/gather_pool.cu``): fused
gather + row-wise dequant + sum pool over a row-quantized store.

It takes CUDA tensors only and raises on anything the kernel does not take;
``ops.embedding_gather_pool`` routes CPU tensors to the plain version.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

_ENTRIES = {torch.uint8: "gather_pool_u8", torch.int8: "gather_pool_i8"}
_SIGNATURE = [ctypes.c_void_p] * 5 + [ctypes.c_int64] * 4 + [ctypes.c_void_p]

launches = 0          # kernel launches since the last reset


def gather_pool(payload: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                indices: torch.Tensor) -> torch.Tensor:
    """payload [R, D] uint8/int8; scale/bias [R] f32; indices [N, P] int32
    in [0, R). Returns pooled bags [N, D] f32, summed over P in order."""
    global launches
    if payload.dtype not in _ENTRIES:
        raise TypeError(f"gather_pool: payload must be uint8 or int8, got {payload.dtype}")
    if scale.dtype != torch.float32 or bias.dtype != torch.float32:
        raise TypeError("gather_pool: scale and bias must be float32")
    if indices.dtype != torch.int32:
        raise TypeError(f"gather_pool: indices must be int32, got {indices.dtype}")
    if payload.dim() != 2 or indices.dim() != 2:
        raise ValueError("gather_pool: payload must be [R, D] and indices [N, P]")
    R, D = payload.shape
    N, P = indices.shape
    if tuple(scale.shape) != (R,) or tuple(bias.shape) != (R,):
        raise ValueError(f"gather_pool: scale and bias must be [{R}]")
    device = build.check_cuda_operands("gather_pool", payload, scale, bias, indices)
    out = torch.empty((N, D), dtype=torch.float32, device=device)
    if N == 0 or D == 0:
        return out
    lib = build.load("gather_pool", {e: _SIGNATURE for e in _ENTRIES.values()})
    with torch.cuda.device(device):
        err = getattr(lib, _ENTRIES[payload.dtype])(
            payload.data_ptr(), scale.data_ptr(), bias.data_ptr(),
            indices.data_ptr(), out.data_ptr(), N, P, D, R,
            torch.cuda.current_stream(device).cuda_stream)
    build.check_launch("gather_pool", err)
    launches += 1
    return out
