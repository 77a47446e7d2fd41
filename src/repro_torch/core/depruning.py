"""De-pruning at load time (paper §4.5, Algorithm 2).

Pruned tables ship as (pruned_values, mapper) where mapper maps unpruned ->
pruned row ids (-1 = pruned away). Serving with the pruned form costs FM bytes
for the mapper (4–8 B per unpruned row); de-pruning rematerializes a dense
table on SM (zeros for pruned rows) so the mapper memory returns to the FM
cache. Cost: more SM capacity, ~2.5% extra SM accesses (pruned rows now
fetched); benefit: up to 2x cache -> up to 48% perf in SM-bound configs (§4.5).

A copy of ``repro.core.depruning`` (``tests/test_torch_power.py``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


@dataclasses.dataclass
class PrunedTable:
    values: np.ndarray      # [R_pruned, D] (quantized payload bytes as uint8)
    mapper: np.ndarray      # [R_unpruned] int -> pruned row id, -1 if pruned
    idx_bytes: int = 4      # mapper entry size {4, 8}

    @property
    def mapper_bytes(self) -> int:
        return self.mapper.shape[0] * self.idx_bytes

    @property
    def pruned_rows(self) -> int:
        return int((self.mapper < 0).sum())


def prune_table(rng: np.random.Generator, table: np.ndarray, keep_frac: float,
                idx_bytes: int = 4) -> PrunedTable:
    """Heuristic near-zero-row pruning stand-in: keep a random keep_frac."""
    r = table.shape[0]
    keep = rng.random(r) < keep_frac
    mapper = np.full(r, -1, np.int64)
    mapper[keep] = np.arange(int(keep.sum()))
    return PrunedTable(values=table[keep], mapper=mapper, idx_bytes=idx_bytes)


def deprune(pt: PrunedTable) -> np.ndarray:
    """Algorithm 2: dense table with zero rows where pruned."""
    r = pt.mapper.shape[0]
    out = np.zeros((r,) + pt.values.shape[1:], pt.values.dtype)
    kept = pt.mapper >= 0
    out[kept] = pt.values[pt.mapper[kept]]
    return out


def lookup_pruned(pt: PrunedTable, indices: np.ndarray) -> np.ndarray:
    """Two-step lookup: mapper (FM) then pruned values (SM).
    Pruned indices return zero rows."""
    m = pt.mapper[indices]
    out = np.zeros((len(indices),) + pt.values.shape[1:], pt.values.dtype)
    ok = m >= 0
    out[ok] = pt.values[m[ok]]
    return out


def depruning_accounting(pt: PrunedTable, trace: np.ndarray) -> dict:
    """Paper's §4.5 trade: extra accesses fraction + FM bytes freed."""
    extra = float((pt.mapper[trace] < 0).mean())
    return {
        "fm_bytes_freed": pt.mapper_bytes,
        "extra_access_frac": extra,
        "sm_extra_bytes": pt.pruned_rows * int(np.prod(pt.values.shape[1:])),
    }
