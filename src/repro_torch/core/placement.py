"""Tiered placement policies (paper §4.6, Table 5).

Decides, per table: FM-direct, SM-with-cache, or SM-cache-bypass. All
policies respect a configurable FM (DRAM) budget; the Tuning API allows an
explicit force-FM list for offline placement solvers.

A copy of ``repro.core.placement`` (``tests/test_torch_power.py``).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence

from repro_torch.core.locality import TableMeta

FM_DIRECT = "fm_direct"
SM_CACHED = "sm_cached"
SM_UNCACHED = "sm_uncached"


@dataclasses.dataclass(frozen=True)
class PlacementConfig:
    policy: str = "sm_only_with_cache"   # Table 5 row 1
    fm_budget_bytes: int = 0             # budget for FM-direct tables
    cache_bypass_alpha: float = 1.02     # tables below this locality bypass cache
    force_fm: tuple = ()                 # explicit table-id list (Tuning API)
    item_tables_on_fm: bool = True       # items are the high-BW side (§2.2)


def table_bytes(m: TableMeta) -> int:
    return m.num_rows * m.dim_bytes


def assign(metas: Sequence[TableMeta], cfg: PlacementConfig) -> Dict[int, str]:
    """Returns {table_id: placement} under the FM byte budget."""
    out: Dict[int, str] = {}
    budget = cfg.fm_budget_bytes

    # Item tables: high BW per query (batched) -> FM when requested.
    for m in metas:
        if m.kind == "item" and cfg.item_tables_on_fm:
            out[m.table_id] = FM_DIRECT

    if cfg.policy == "fm_only":
        # DRAM-only host (Table 7's HW-L): the whole model lives in FM; no
        # table ever touches SM. The cluster simulator's baseline tier.
        for m in metas:
            out[m.table_id] = FM_DIRECT
        return out

    if cfg.policy == "sm_only_with_cache":
        for m in metas:
            out.setdefault(m.table_id, SM_CACHED)
        return out

    if cfg.policy == "fixed_fm_sm_cache":
        # Greedy: place highest (BW density = pooling/size) user tables on FM
        # until the budget runs out; rest go to SM with cache.
        user = [m for m in metas if out.get(m.table_id) is None]
        for tid in cfg.force_fm:
            m = next((x for x in user if x.table_id == tid), None)
            if m and budget >= table_bytes(m):
                out[m.table_id] = FM_DIRECT
                budget -= table_bytes(m)
        user.sort(key=lambda m: m.pooling_factor / max(1, table_bytes(m)), reverse=True)
        for m in user:
            if out.get(m.table_id) is not None:
                continue
            b = table_bytes(m)
            if b <= budget:
                out[m.table_id] = FM_DIRECT
                budget -= b
            else:
                out[m.table_id] = SM_CACHED
        return out

    if cfg.policy == "per_table_cache":
        # Table 5 row 3: low-temporal-locality tables bypass the cache
        # (a miss would evict hotter rows for no future benefit).
        for m in metas:
            if out.get(m.table_id) is not None:
                continue
            out[m.table_id] = (SM_CACHED if m.zipf_alpha >= cfg.cache_bypass_alpha
                               else SM_UNCACHED)
        return out

    raise ValueError(f"unknown policy {cfg.policy!r}")


def fm_bytes_used(metas: Sequence[TableMeta], placement: Dict[int, str]) -> int:
    return sum(table_bytes(m) for m in metas if placement[m.table_id] == FM_DIRECT)


def sm_bytes_used(metas: Sequence[TableMeta], placement: Dict[int, str]) -> int:
    return sum(table_bytes(m) for m in metas if placement[m.table_id] != FM_DIRECT)
