"""Plain PyTorch versions of the CUDA kernels.

They are what a CPU tensor runs through, what ``use_kernels=False`` selects,
and what each kernel is held against on the card.
"""
from __future__ import annotations

import torch


def gather_pool_ref(payload: torch.Tensor, scale: torch.Tensor,
                    bias: torch.Tensor, indices: torch.Tensor) -> torch.Tensor:
    """payload [R, D] int; scale/bias [R]; indices [N, P] -> [N, D] f32."""
    idx = indices.long()
    rows = payload[idx].to(torch.float32)                     # [N, P, D]
    rows = rows * scale[idx][..., None] + bias[idx][..., None]
    return rows.sum(dim=1)


def cache_probe_ref(tag_table, tag_row, data, q_table, q_row, sets):
    """Set-associative probe. Returns (values [N, D] f32, hit [N] i32).

    ``values`` is the sum over every matching way (zeros on a miss), as the
    reference's one-hot contraction computes it."""
    s = sets.long()
    match = ((tag_table[s] == q_table[:, None]) &
             (tag_row[s] == q_row[:, None]))                  # [N, W]
    hit = match.any(dim=1)
    onehot = match.to(torch.float32)
    values = torch.einsum("nw,nwd->nd", onehot, data[s].to(torch.float32))
    return values, hit.to(torch.int32)
