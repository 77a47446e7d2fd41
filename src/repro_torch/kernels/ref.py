"""Plain PyTorch versions of the CUDA kernels.

They are what a CPU tensor runs through, what ``use_kernels=False`` selects,
and what each kernel is held against on the card.
"""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30     # the mask value of the reference (not -inf)


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


def densify_ref(values: torch.Tensor, row_seg: torch.Tensor,
                seg_offsets: torch.Tensor, rows_per_table: torch.Tensor, P: int):
    """values [K] int64, a chunk's keys in CSR order; row_seg [N] int32,
    the segment row r holds (-1: none); seg_offsets [S+1] int32, each
    segment's keys from 0; rows_per_table [T] int64. Returns (idx [N, P]
    int32: row r's keys, then zeros; valid [N, P] bool; bad [] int32: the
    keys v of row r with v < 0 or v >= rows_per_table[r % T], each compared
    as an int64 before it is narrowed to int32)."""
    N, T = row_seg.shape[0], rows_per_table.shape[0]
    off = seg_offsets.long()
    none = off.new_zeros(1)
    seg = row_seg.long()
    seg = torch.where(seg >= 0, seg, off.shape[0] - 1)    # S: no segment, no keys
    start = torch.cat([off[:-1], none])[seg]
    length = torch.cat([off[1:] - off[:-1], none])[seg]
    pos = torch.arange(P, device=values.device)
    valid = pos < length[:, None]
    # a padded slot reads the zero appended past the keys: no masked gather
    src = torch.where(valid, start[:, None] + pos, values.shape[0])
    keys = torch.cat([values, values.new_zeros(1)])[src]
    limit = rows_per_table[torch.arange(N, device=values.device) % T][:, None]
    bad = (valid & ((keys < 0) | (keys >= limit))).sum().to(torch.int32)
    return keys.to(torch.int32), valid, bad


def flash_decode_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     kv_len: torch.Tensor, return_lse: bool = False):
    """q [B, H, hd]; k/v [B, S, K, hd]; kv_len [B]. Returns [B, H, hd] f32,
    and with ``return_lse`` also the log-sum-exp of each (row, head)'s
    scaled, masked scores [B, H] f32 (what merges attention over disjoint
    key ranges).

    Query head h reads KV head h // (H // K). Positions at or past
    ``kv_len`` score -1e30, so a row with ``kv_len == 0`` averages v over
    all S, and ``kv_len > S`` behaves as S."""
    B, H, hd = q.shape
    S, K = k.shape[1], k.shape[2]
    G = H // K
    kr = k.repeat_interleave(G, dim=2).to(torch.float32)     # [B, S, H, hd]
    vr = v.repeat_interleave(G, dim=2).to(torch.float32)
    scores = torch.einsum("bhd,bshd->bhs", q.to(torch.float32), kr) / math.sqrt(hd)
    mask = torch.arange(S, device=k.device)[None, :] < kv_len[:, None]   # [B, S]
    scores = scores.masked_fill(~mask[:, None, :], NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhs,bshd->bhd", probs, vr)
    return (out, torch.logsumexp(scores, dim=-1)) if return_lse else out
