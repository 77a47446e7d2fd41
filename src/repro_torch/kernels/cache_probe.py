"""Wrapper of the CUDA ``cache_probe`` kernel (``csrc/cache_probe.cu``): the
set-associative row-cache probe.

It takes CUDA tensors only and raises on anything the kernel does not take;
``ops.row_cache_probe`` routes CPU tensors to the plain version. The launch
plan is chosen here in plain Python (:func:`launch_plan`) and handed to the
kernel, which refuses a plan it cannot run.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from repro_torch.kernels import build

_SIGNATURE = [ctypes.c_void_p] * 8 + [ctypes.c_int64] * 6 + [ctypes.c_void_p]
MAX_WAYS = 32          # one lane per way
SM_COUNT = 132         # the H100 SXM's SMs
MIN_WARPS = 4 * SM_COUNT   # warps a plan keeps, where the queries allow it

launches = 0          # kernel launches since the last reset


class Plan(NamedTuple):
    queries_per_warp: int
    probes_at_once: int   # queries a warp's lane groups probe in one round
    vec: int              # floats each lane moves of a row


def launch_plan(W: int, D: int, N: int, base: int = 0) -> Plan:
    """The launch of ``cache_probe`` for N probes into W ways of D floats,
    the data starting at address ``base``. Lane groups of W rounded up to
    a power of two probe 32 // that queries at once; a warp owns 32 queries,
    or fewer (down to one round) while that leaves fewer than ``MIN_WARPS``
    warps, so a small batch still spreads over every SM; rows move in the
    widest float vector (4, 2, 1) that divides D and the base."""
    if W > MAX_WAYS:
        raise ValueError(f"cache_probe: at most {MAX_WAYS} ways, got {W}")
    lanes = 1
    while lanes < W:
        lanes *= 2
    at_once = 32 // lanes
    per_warp = 32
    while per_warp > at_once and -(-N // per_warp) < MIN_WARPS:
        per_warp //= 2
    vec = next(v for v in (4, 2, 1) if D % v == 0 and base % (4 * v) == 0)
    return Plan(per_warp, at_once, vec)


def cache_probe(tag_table: torch.Tensor, tag_row: torch.Tensor,
                data: torch.Tensor, q_table: torch.Tensor, q_row: torch.Tensor,
                sets: torch.Tensor):
    """tag_table/tag_row [S, W] int32; data [S, W, D] f32; q_table/q_row/sets
    [N] int32 with sets in [0, S). Returns (values [N, D] f32 -- the sum of
    the matching ways' rows in way order, zeros on a miss -- and hit [N]
    int32)."""
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
    if q_table.dim() != 1 or q_row.shape != q_table.shape or sets.shape != q_table.shape:
        raise ValueError("cache_probe: q_table, q_row and sets must be [N]")
    N = q_table.shape[0]
    plan = launch_plan(W, D, N, data.data_ptr())
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
            plan.queries_per_warp, plan.vec,
            torch.cuda.current_stream(device).cuda_stream)
    build.check_launch("cache_probe", err)
    launches += 1
    return values, hit
