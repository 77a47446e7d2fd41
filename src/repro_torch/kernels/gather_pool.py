"""Wrapper of the CUDA ``gather_pool`` kernel (``csrc/gather_pool.cu``): fused
gather + row-wise dequant + sum pool over a row-quantized store.

It takes CUDA tensors only and raises on anything the kernel does not take;
``ops.embedding_gather_pool`` routes CPU tensors to the plain version. The
launch plan is chosen here in plain Python (:func:`launch_plan`) and handed
to the kernel, which refuses a plan it cannot run.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from repro_torch.kernels import build

_ENTRIES = {torch.uint8: "gather_pool_u8", torch.int8: "gather_pool_i8"}
_SIGNATURE = [ctypes.c_void_p] * 5 + [ctypes.c_int64] * 7 + [ctypes.c_void_p]
VEC_BYTES = (16, 8, 4, 2, 1)   # row vector widths, widest first
SLICE_BYTES = 128              # bytes of a row one warp covers (kMaxSliceBytes)
MAX_WARPS = 4                  # warps of a block (kMaxWarpsPerBlock)
CHUNK = 32                     # indices of one coalesced load, one per lane
SM_COUNT = 132                 # the H100 SXM's SMs
MIN_BLOCKS = 2 * SM_COUNT      # blocks a plan keeps, where the bags allow it

launches = 0          # kernel launches since the last reset


class Plan(NamedTuple):
    vec: int              # bytes each lane loads of a row
    bags_per_block: int
    warps_per_bag: int    # warps splitting one row, each up to SLICE_BYTES
    chunks: int           # coalesced loads of CHUNK indices per bag


def launch_plan(D: int, itemsize: int, base: int, N: int, P: int) -> Plan:
    """The launch of ``gather_pool`` for N bags of P rows of D elements of
    ``itemsize`` bytes, the store starting at address ``base``. Rows move in
    the widest vector that divides both the row's bytes and the base; a warp
    covers up to ``SLICE_BYTES`` of a row in at most 32 vectors; and a block
    takes as many bags (up to ``MAX_WARPS`` warps) as still leave
    ``MIN_BLOCKS`` blocks, so a small batch spreads over every SM while a
    large one gets fewer, fuller blocks."""
    row = D * itemsize
    vec = next(v for v in VEC_BYTES if row % v == 0 and base % v == 0)
    cols = min(32, SLICE_BYTES // vec)
    warps_per_bag = max(1, -(-(row // vec) // cols))
    bags_per_block = 1
    for b in (4, 2):
        if b * warps_per_bag <= MAX_WARPS and -(-N // b) >= MIN_BLOCKS:
            bags_per_block = b
            break
    return Plan(vec, bags_per_block, warps_per_bag, -(-P // CHUNK))


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
    plan = launch_plan(D, payload.element_size(), payload.data_ptr(), N, P)
    lib = build.load("gather_pool", {e: _SIGNATURE for e in _ENTRIES.values()})
    with torch.cuda.device(device):
        err = getattr(lib, _ENTRIES[payload.dtype])(
            payload.data_ptr(), scale.data_ptr(), bias.data_ptr(),
            indices.data_ptr(), out.data_ptr(), N, P, D, R, plan.vec,
            plan.bags_per_block, plan.warps_per_bag,
            torch.cuda.current_stream(device).cuda_stream)
    build.check_launch("gather_pool", err)
    launches += 1
    return out
