"""Wrapper of the CUDA ``flash_decode`` kernel (``csrc/flash_decode.cu``):
GQA decode attention of one query token against a KV cache, in one launch
that splits the cache length over blocks and merges the splits in the last
block of each row.

It takes CUDA tensors only and raises on anything the kernel does not take;
``ops.decode_attention`` routes CPU tensors to the plain version.
"""
from __future__ import annotations

import ctypes
import math
from typing import Dict, Tuple

import torch

from repro_torch.kernels import build

_DTYPES = {torch.float32: "f32", torch.bfloat16: "bf16"}
_ENTRY_SIGNATURE = ([ctypes.c_void_p] * 7 + [ctypes.c_int64] * 7
                    + [ctypes.c_float, ctypes.c_void_p])
_SIGNATURES = {f"flash_decode_{a}_{b}": _ENTRY_SIGNATURE
               for a in _DTYPES.values() for b in _DTYPES.values()}
_SIGNATURES["flash_decode_smem_bytes"] = [ctypes.c_int64] * 3
_SIGNATURES["flash_decode_tile_positions"] = [ctypes.c_int64]
MAX_SMEM_BYTES = 232_448   # the opt-in shared memory of one Hopper block
MAX_HEADS = 8              # query heads per block (kMaxHeads in the kernel)
MIN_SPAN = 256             # fewest positions a split walks (kMinSpan)
BLOCKS_PER_SM = 4          # splits are chosen for about this many blocks per SM

launches = 0          # kernel launches since the last reset

_SM_COUNT: Dict[int, int] = {}
_COUNTERS: Dict[Tuple[torch.device, int], torch.Tensor] = {}


def head_tiles(G: int) -> Tuple[int, int]:
    """(tiles, heads per tile): the G query heads of a KV head in as few
    blocks of at most ``MAX_HEADS`` as fit, spread evenly."""
    tiles = -(-G // MAX_HEADS)
    return tiles, -(-G // tiles)


def split_count(B: int, K: int, S: int, sm_count: int, tiles: int = 1) -> int:
    """Splits of the cache length per (sequence, KV head, head tile): enough
    blocks for ``BLOCKS_PER_SM`` per SM, and no more than S holds spans of
    ``MIN_SPAN`` positions."""
    want = -(-BLOCKS_PER_SM * sm_count // max(1, B * K * tiles))
    return max(1, min(want, S // MIN_SPAN))


def tile_positions(hd: int) -> int:
    """Cache positions per tile at head dim ``hd`` (the kernel's rule): four
    warps of 32 x 32 / w positions, w being hd rounded up to 8 times a power
    of two (at least 16), so each lane holds 32 elements of a tile's keys."""
    w = 16
    while w < hd:
        w *= 2
    return 4 * 32 * 32 // w


def busy_splits(kv_len: int, S: int, n_split: int, hd: int) -> int:
    """Splits that walk part of a row (the kernel's span rule): its walked
    length min(kv_len, S), or all S when kv_len <= 0, shared by as many of
    the ``n_split`` splits as get ``MIN_SPAN`` positions each (at least
    one), in spans of a whole number of tiles."""
    n_walk = min(kv_len, S) if kv_len > 0 else S
    tile = tile_positions(hd)
    n_use = max(1, min(n_walk // MIN_SPAN, n_split))
    span = -(-(-(-n_walk // n_use)) // tile) * tile
    return -(-n_walk // span)


def counter_buffer(device: torch.device, stream: int, n: int) -> torch.Tensor:
    """The int32 arrival counters of (device, stream), at least ``n`` long.
    Zeroed once when created or grown; each launch leaves them at 0."""
    key = (device, stream)
    buf = _COUNTERS.get(key)
    if buf is None or buf.numel() < n:
        buf = torch.zeros(n, dtype=torch.int32, device=device)
        _COUNTERS[key] = buf
    return buf


def flash_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 kv_len: torch.Tensor) -> torch.Tensor:
    """q [B, H, hd] f32/bf16; k/v [B, S, K, hd] f32/bf16 (one dtype); kv_len
    [B] int32, the valid prefix of each row's cache. H a multiple of K, hd a
    multiple of 8 in [16, 128]. Returns [B, H, hd] f32; query head h reads KV
    head h // (H // K)."""
    global launches
    if q.dtype not in _DTYPES or k.dtype not in _DTYPES:
        raise TypeError(f"flash_decode: q, k, v must be float32 or bfloat16, "
                        f"got {q.dtype}, {k.dtype}")
    if v.dtype != k.dtype:
        raise TypeError(f"flash_decode: k is {k.dtype} but v is {v.dtype}")
    if kv_len.dtype != torch.int32:
        raise TypeError(f"flash_decode: kv_len must be int32, got {kv_len.dtype}")
    if q.dim() != 3 or k.dim() != 4 or v.shape != k.shape or kv_len.dim() != 1:
        raise ValueError("flash_decode: q must be [B, H, hd], k and v "
                         "[B, S, K, hd], kv_len [B]")
    B, H, hd = q.shape
    _, S, K, _ = k.shape
    if k.shape[0] != B or kv_len.shape[0] != B or k.shape[3] != hd:
        raise ValueError(f"flash_decode: q {tuple(q.shape)}, k {tuple(k.shape)} "
                         f"and kv_len {tuple(kv_len.shape)} disagree")
    if K == 0 or H % K:
        raise ValueError(f"flash_decode: H = {H} is not a multiple of K = {K}")
    if hd % 8 or not 16 <= hd <= 128:
        raise ValueError(f"flash_decode: head dim {hd} is not a multiple of 8 "
                         "in [16, 128]")
    if S == 0:
        raise ValueError("flash_decode: the cache has no positions")
    device = build.check_cuda_operands("flash_decode", q, k, v, kv_len)
    if k.data_ptr() % 16 or v.data_ptr() % 16:
        raise ValueError("flash_decode: k and v must start 16-byte aligned")
    lib = build.load("flash_decode", _SIGNATURES)
    tiles, gt = head_tiles(H // K)
    if lib.flash_decode_smem_bytes(gt, hd, k.element_size()) > MAX_SMEM_BYTES:
        raise ValueError(f"flash_decode: {gt} query heads per block at head "
                         f"dim {hd} do not fit one block's shared memory")
    out = torch.empty((B, H, hd), dtype=torch.float32, device=device)
    if B == 0:
        return out
    index = device.index if device.index is not None else torch.cuda.current_device()
    if index not in _SM_COUNT:
        _SM_COUNT[index] = torch.cuda.get_device_properties(index).multi_processor_count
    n_split = split_count(B, K, S, _SM_COUNT[index], tiles)
    stream = torch.cuda.current_stream(device).cuda_stream
    part_ptr = counters_ptr = None
    if n_split > 1:
        # [m | l | acc] of every (sequence, KV head, head tile, split, head)
        n_part = B * K * tiles * n_split * gt
        part = torch.empty(n_part * (hd + 2), dtype=torch.float32, device=device)
        part_ptr = part.data_ptr()
        counters_ptr = counter_buffer(device, stream, B * K * tiles).data_ptr()
    entry = getattr(lib, f"flash_decode_{_DTYPES[q.dtype]}_{_DTYPES[k.dtype]}")
    with torch.cuda.device(device):
        err = entry(q.data_ptr(), k.data_ptr(), v.data_ptr(), kv_len.data_ptr(),
                    out.data_ptr(), part_ptr, counters_ptr, B, S, H, K, hd, gt,
                    n_split, 1.0 / math.sqrt(hd), stream)
    build.check_launch("flash_decode", err)
    launches += 1
    return out
