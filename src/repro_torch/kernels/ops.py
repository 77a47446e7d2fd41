"""Public entries of the kernels, with the dispatch rule of the port.

Each kernel is an operator of the ``repro_torch`` library
(``torch.ops.repro_torch.gather_pool``, ``cache_probe``, ``flash_decode``,
``flash_decode_lse``, ``densify``), registered with the dispatcher at the
C++ level (``torch.library.Library``): a CPU tensor takes the kernel's plain version
(``ref.py``); a CUDA tensor goes to the CUDA kernel, which launches or
raises -- nothing falls back; a fake tensor (``FakeTensorMode``, the launch
tooling's traces) takes the registered fake implementation, which gives the
outputs' shapes and dtypes and runs nothing. Each operator that computes
has a FLOP formula (``torch.utils.flop_counter``), so a traced step counts
its work; ``densify`` only moves keys.
``use_kernel=False`` selects the plain version explicitly on any device.
"""
from __future__ import annotations

from typing import Dict

import torch
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels import cache_probe as _cache_probe
from repro_torch.kernels import densify as _densify
from repro_torch.kernels import flash_decode as _flash_decode
from repro_torch.kernels import gather_pool as _gather_pool
from repro_torch.kernels import ref

_LIB = torch.library.Library("repro_torch", "DEF")
_LIB.define("gather_pool(Tensor payload, Tensor scale, Tensor bias, Tensor indices) -> Tensor")
_LIB.define("cache_probe(Tensor tag_table, Tensor tag_row, Tensor data, Tensor q_table, "
            "Tensor q_row, Tensor sets) -> (Tensor, Tensor)")
_LIB.define("flash_decode(Tensor q, Tensor k, Tensor v, Tensor kv_len) -> Tensor")
_LIB.define("flash_decode_lse(Tensor q, Tensor k, Tensor v, Tensor kv_len) -> (Tensor, Tensor)")
_LIB.define("densify(Tensor values, Tensor row_seg, Tensor seg_offsets, "
            "Tensor rows_per_table, int P) -> (Tensor, Tensor, Tensor)")

for _name, _plain, _kernel in (
        ("gather_pool", ref.gather_pool_ref, _gather_pool.gather_pool),
        ("cache_probe", ref.cache_probe_ref, _cache_probe.cache_probe),
        ("flash_decode", ref.flash_decode_ref, _flash_decode.flash_decode),
        ("flash_decode_lse",
         lambda q, k, v, kv_len: ref.flash_decode_ref(q, k, v, kv_len, return_lse=True),
         lambda q, k, v, kv_len: _flash_decode.flash_decode(q, k, v, kv_len, return_lse=True)),
        ("densify", ref.densify_ref, _densify.densify)):
    _LIB.impl(_name, _plain, "CPU")
    _LIB.impl(_name, _kernel, "CUDA")


@torch.library.register_fake("repro_torch::gather_pool", lib=_LIB)
def _gather_pool_fake(payload, scale, bias, indices):
    return payload.new_empty((indices.shape[0], payload.shape[1]), dtype=torch.float32)


@torch.library.register_fake("repro_torch::cache_probe", lib=_LIB)
def _cache_probe_fake(tag_table, tag_row, data, q_table, q_row, sets):
    n = q_table.shape[0]
    return (data.new_empty((n, data.shape[2]), dtype=torch.float32),
            q_table.new_empty((n,), dtype=torch.int32))


@torch.library.register_fake("repro_torch::flash_decode", lib=_LIB)
def _flash_decode_fake(q, k, v, kv_len):
    return q.new_empty(q.shape, dtype=torch.float32)


@torch.library.register_fake("repro_torch::flash_decode_lse", lib=_LIB)
def _flash_decode_lse_fake(q, k, v, kv_len):
    return (q.new_empty(q.shape, dtype=torch.float32),
            q.new_empty(q.shape[:2], dtype=torch.float32))


@torch.library.register_fake("repro_torch::densify", lib=_LIB)
def _densify_fake(values, row_seg, seg_offsets, rows_per_table, P):
    n = row_seg.shape[0]
    return (row_seg.new_empty((n, P), dtype=torch.int32),
            row_seg.new_empty((n, P), dtype=torch.bool),
            row_seg.new_empty((), dtype=torch.int32))


# FLOP formulas, from shapes: a multiply-add counts two
@register_flop_formula(torch.ops.repro_torch.gather_pool)
def _gather_pool_flops(payload, scale, bias, indices, **kwargs) -> int:
    return 3 * indices[0] * indices[1] * payload[1]      # x * s + b, then the sum


@register_flop_formula(torch.ops.repro_torch.cache_probe)
def _cache_probe_flops(tag_table, tag_row, data, *args, **kwargs) -> int:
    n = args[0][0]
    return 2 * n * data[1] * data[2]                      # the ways' one-hot sum


@register_flop_formula([torch.ops.repro_torch.flash_decode,
                        torch.ops.repro_torch.flash_decode_lse])
def _flash_decode_flops(q, k, *args, **kwargs) -> int:
    B, H, hd = q
    return 4 * B * H * k[1] * hd                          # q.k and p.v over S


def embedding_gather_pool(payload: torch.Tensor, scale: torch.Tensor,
                          bias: torch.Tensor, indices: torch.Tensor, *,
                          use_kernel: bool = True) -> torch.Tensor:
    """Fused lookup+dequant+pool. payload [R, D] int8/uint8; indices [N, P]."""
    if not use_kernel:
        return ref.gather_pool_ref(payload, scale, bias, indices)
    return torch.ops.repro_torch.gather_pool(payload, scale, bias, indices)


def row_cache_probe(tag_table, tag_row, data, q_table, q_row, sets, *,
                    use_kernel: bool = True):
    """Set-associative cache probe: (values [N, D], hit [N] int32)."""
    if not use_kernel:
        return ref.cache_probe_ref(tag_table, tag_row, data, q_table, q_row, sets)
    return torch.ops.repro_torch.cache_probe(tag_table, tag_row, data, q_table, q_row, sets)


def decode_attention(q, k, v, kv_len, *, use_kernel: bool = True, return_lse: bool = False):
    """Flash decode attention: q [B, H, hd] vs cache k/v [B, S, K, hd] with
    valid prefix kv_len [B] int32. Returns [B, H, hd] f32, and with
    ``return_lse`` also each (row, head)'s log-sum-exp of its scaled scores
    [B, H] f32. The CUDA kernel takes any S, so there is no fallback for an
    S that is not a multiple of a block."""
    if not use_kernel:
        return ref.flash_decode_ref(q, k, v, kv_len, return_lse=return_lse)
    if return_lse:
        return torch.ops.repro_torch.flash_decode_lse(q, k, v, kv_len)
    return torch.ops.repro_torch.flash_decode(q, k, v, kv_len)


def csr_densify(values, row_seg, seg_offsets, rows_per_table, P: int, *,
                use_kernel: bool = True):
    """A CSR chunk's padded key block: (idx [N, P] int32, valid [N, P] bool,
    bad [] int32, the keys outside their tables). values [K] int64;
    row_seg [N] int32, the segment each block row holds (-1: none);
    seg_offsets [S+1] int32 from 0; rows_per_table [T] int64; P a power of
    two for the kernel."""
    if not use_kernel:
        return ref.densify_ref(values, row_seg, seg_offsets, rows_per_table, P)
    return torch.ops.repro_torch.densify(values, row_seg, seg_offsets, rows_per_table, P)


_WRAPPERS = {"gather_pool": _gather_pool, "cache_probe": _cache_probe,
             "flash_decode": _flash_decode, "densify": _densify}


def launch_counts() -> Dict[str, int]:
    """Kernel launches since the last :func:`reset_launch_counts`."""
    return {name: w.launches for name, w in _WRAPPERS.items()}


def reset_launch_counts() -> None:
    for w in _WRAPPERS.values():
        w.launches = 0
