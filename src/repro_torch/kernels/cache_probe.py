"""Wrapper of the CUDA ``cache_probe`` kernel (``csrc/cache_probe.cu``): the
set-associative row-cache probe.

It takes CUDA tensors only and raises on anything the kernel does not take;
``ops.row_cache_probe`` routes CPU tensors to the plain version.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

_SIGNATURE = [ctypes.c_void_p] * 8 + [ctypes.c_int64] * 4 + [ctypes.c_void_p]
MAX_WAYS = 32          # one lane per way

launches = 0          # kernel launches since the last reset


def cache_probe(tag_table: torch.Tensor, tag_row: torch.Tensor,
                data: torch.Tensor, q_table: torch.Tensor, q_row: torch.Tensor,
                sets: torch.Tensor):
    """tag_table/tag_row [S, W] int32; data [S, W, D] f32; q_table/q_row/sets
    [N] int32 with sets in [0, S). Returns (values [N, D] f32 -- the sum of
    the matching ways' rows, zeros on a miss -- and hit [N] int32)."""
    global launches
    for t in (tag_table, tag_row, q_table, q_row, sets):
        if t.dtype != torch.int32:
            raise TypeError(f"cache_probe: tags, queries and sets must be int32, got {t.dtype}")
    if data.dtype != torch.float32:
        raise TypeError(f"cache_probe: data must be float32, got {data.dtype}")
    if data.dim() != 3:
        raise ValueError("cache_probe: data must be [S, W, D]")
    S, W, D = data.shape
    if tuple(tag_table.shape) != (S, W) or tuple(tag_row.shape) != (S, W):
        raise ValueError(f"cache_probe: tag planes must be [{S}, {W}]")
    if W > MAX_WAYS:
        raise ValueError(f"cache_probe: at most {MAX_WAYS} ways, got {W}")
    if q_table.dim() != 1 or q_row.shape != q_table.shape or sets.shape != q_table.shape:
        raise ValueError("cache_probe: q_table, q_row and sets must be [N]")
    N = q_table.shape[0]
    device = build.check_cuda_operands("cache_probe", tag_table, tag_row,
                                       data, q_table, q_row, sets)
    values = torch.empty((N, D), dtype=torch.float32, device=device)
    hit = torch.empty((N,), dtype=torch.int32, device=device)
    if N == 0:
        return values, hit
    lib = build.load("cache_probe", {"cache_probe_f32": _SIGNATURE})
    with torch.cuda.device(device):
        err = lib.cache_probe_f32(
            tag_table.data_ptr(), tag_row.data_ptr(), data.data_ptr(),
            q_table.data_ptr(), q_row.data_ptr(), sets.data_ptr(),
            values.data_ptr(), hit.data_ptr(), N, S, W, D,
            torch.cuda.current_stream(device).cuda_stream)
    build.check_launch("cache_probe", err)
    launches += 1
    return values, hit
