"""Access-locality modeling (paper §4.2, Fig. 4–5).

Embedding accesses follow a power law per table; we generate Zipf(alpha)
traces (alpha sampled per table), compute CDF curves (Fig. 4), the
unique-index/unique-block spatial-locality proxy (Fig. 5), and the host-sticky
routing effect (Fig. 4c): routing a user's queries to a sticky host shrinks
the per-host working set and raises cache hit rates.

A copy of ``repro.core.locality``; the uint64 rank permutation wraps as
numpy's does (``tests/test_torch_workloads.py``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np


@dataclasses.dataclass(frozen=True)
class TableMeta:
    table_id: int
    num_rows: int
    dim_bytes: int          # quantized row payload bytes (incl. 8B header)
    pooling_factor: int
    zipf_alpha: float       # temporal locality strength
    kind: str               # 'user' | 'item'
    pruned_frac: float = 0.0


def zipf_indices(rng: np.random.Generator, num_rows: int, alpha: float,
                 size: int) -> np.ndarray:
    """Zipf-distributed row ids in [0, num_rows). Rank-permuted so hot rows are
    scattered across the id space (no spatial locality, matching Fig. 5)."""
    ranks = rng.zipf(alpha, size=size)
    ranks = np.minimum(ranks, num_rows) - 1
    # hash-permute rank -> row id
    x = ranks.astype(np.uint64)
    x = (x * np.uint64(0x9E3779B97F4A7C15)) >> np.uint64(17)
    return (x % np.uint64(num_rows)).astype(np.int64)


def access_cdf(trace: np.ndarray, num_rows: int, points: int = 100) -> np.ndarray:
    """Cumulative fraction of accesses vs fraction of (sorted-hot) rows."""
    counts = np.bincount(trace, minlength=num_rows).astype(np.float64)
    counts[::-1].sort()
    cdf = np.cumsum(counts) / max(1.0, counts.sum())
    idx = np.linspace(0, num_rows - 1, points).astype(int)
    return cdf[idx]


def spatial_locality(trace: np.ndarray, row_bytes: int, block_bytes: int = 4096,
                     window: int = 1_000_000) -> float:
    """Fig. 5 proxy: mean over windows of
    (unique 4K blocks / unique indices) normalized by rows-per-block.
    1.0 = perfectly dense blocks; ~1/rows_per_block = no spatial locality."""
    rows_per_block = max(1, block_bytes // row_bytes)
    vals = []
    for s in range(0, len(trace), window):
        w = trace[s:s + window]
        u_idx = len(np.unique(w))
        u_blk = len(np.unique(w // rows_per_block))
        # min possible blocks = ceil(u_idx / rows_per_block)
        min_blk = -(-u_idx // rows_per_block)
        vals.append(min_blk / u_blk if u_blk else 1.0)
    return float(np.mean(vals))


def sticky_route(user_ids: np.ndarray, num_hosts: int) -> np.ndarray:
    """User->host sticky policy: hash users to hosts. Returns host id per query."""
    x = user_ids.astype(np.uint64) * np.uint64(0xD6E8FEB86659FD93)
    return (x >> np.uint64(33)).astype(np.int64) % num_hosts


def sample_table_metas(rng: np.random.Generator, *, num_user: int, num_item: int,
                       user_dim_bytes, item_dim_bytes,
                       user_pool: int, item_pool: int,
                       total_bytes: float,
                       user_byte_frac: float = 0.7,
                       alpha_range=(1.05, 1.5),
                       item_alpha_boost: float = 0.25) -> Sequence[TableMeta]:
    """Synthesize a model's table inventory matching Table 6 statistics.

    Sizes are log-normal (matching Fig. 1's skew); user tables get ~2/3 of
    capacity (§2.2); item tables get higher alpha (more locality, Fig. 4b).
    """
    metas = []
    sizes = rng.lognormal(mean=0.0, sigma=1.6, size=num_user + num_item)
    user_sizes = sizes[:num_user] / sizes[:num_user].sum() * total_bytes * user_byte_frac
    item_sizes = sizes[num_user:] / sizes[num_user:].sum() * total_bytes * (1 - user_byte_frac)
    tid = 0
    for n, dims, pool, kind, szs, aboost in (
            (num_user, user_dim_bytes, user_pool, "user", user_sizes, 0.0),
            (num_item, item_dim_bytes, item_pool, "item", item_sizes, item_alpha_boost)):
        for i in range(n):
            db = int(rng.integers(dims[0], dims[1] + 1))
            rows = max(64, int(szs[i] / db))
            pf = max(1, int(rng.poisson(pool)))
            alpha = float(rng.uniform(*alpha_range)) + aboost
            metas.append(TableMeta(tid, rows, db, pf, alpha, kind))
            tid += 1
    return metas
