"""Wrapper of the CUDA ``densify`` kernel (``csrc/densify.cu``): a columnar
(CSR) chunk's keys into the padded ``[N, P]`` key block, its valid mask and
the count of keys outside their tables.

It takes CUDA tensors only and raises on anything the kernel does not take;
``ops.csr_densify`` routes CPU tensors to the plain version.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

_SIGNATURE = [ctypes.c_void_p] * 7 + [ctypes.c_int64] * 3 + [ctypes.c_void_p]

launches = 0          # kernel launches since the last reset


def densify(values: torch.Tensor, row_seg: torch.Tensor, seg_offsets: torch.Tensor,
            rows_per_table: torch.Tensor, P: int):
    """values [K] int64, the chunk's keys in CSR order; row_seg [N]
    int32, the segment row r holds (-1: none); seg_offsets [S+1] int32,
    each segment's keys from 0; rows_per_table [T] int64; P a power of two.
    Returns (idx [N, P] int32, valid [N, P] bool, bad [] int32: the keys v
    of row r with v < 0 or v >= rows_per_table[r % T]). The segment ids
    and offsets are the caller's to keep consistent (``engine.block_inputs``
    builds them): the kernel reads them unchecked."""
    global launches
    if values.dtype != torch.int64:
        raise TypeError(f"densify: values must be int64, got {values.dtype}")
    if row_seg.dtype != torch.int32 or seg_offsets.dtype != torch.int32:
        raise TypeError("densify: row_seg and seg_offsets must be int32")
    if rows_per_table.dtype != torch.int64:
        raise TypeError("densify: rows_per_table must be int64")
    if any(t.dim() != 1 for t in (values, row_seg, seg_offsets, rows_per_table)):
        raise ValueError("densify: every operand must be 1-D")
    if seg_offsets.shape[0] < 1 or rows_per_table.shape[0] < 1:
        raise ValueError("densify: need seg_offsets [S+1] and at least one table")
    if P < 1 or P & (P - 1):
        raise ValueError(f"densify: P must be a power of two, got {P}")
    device = build.check_cuda_operands("densify", values, row_seg, seg_offsets,
                                       rows_per_table)
    N = row_seg.shape[0]
    idx = torch.empty((N, P), dtype=torch.int32, device=device)
    valid = torch.empty((N, P), dtype=torch.bool, device=device)
    bad = torch.empty((), dtype=torch.int32, device=device)
    lib = build.load("densify", {"densify_i64": _SIGNATURE})
    with torch.cuda.device(device):
        err = lib.densify_i64(
            values.data_ptr(), row_seg.data_ptr(), seg_offsets.data_ptr(),
            rows_per_table.data_ptr(), idx.data_ptr(), valid.data_ptr(),
            bad.data_ptr(), N, rows_per_table.shape[0], P.bit_length() - 1,
            torch.cuda.current_stream(device).cuda_stream)
    build.check_launch("densify", err)
    launches += 1
    return idx, valid, bad
