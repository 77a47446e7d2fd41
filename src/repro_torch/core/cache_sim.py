"""Composite row-cache keys of the host cache simulators.

Only the key layout is here so far: the columnar plane builds every
element's ``(table, row)`` key with it. The batched host row cache
(``BatchedRowCache``) comes with the host serving plane. A copy of
``repro.core.cache_sim`` (``tests/test_torch_workloads.py``).
"""
from __future__ import annotations

import numpy as np


def make_row_keys(table_id, rows: np.ndarray) -> np.ndarray:
    """Composite (table, row) -> int64 key shared by every host cache sim.
    ``table_id`` may be a scalar or an array aligned with ``rows`` (the
    columnar plane builds all tables' keys in one call)."""
    return (np.asarray(table_id).astype(np.int64) << np.int64(40)) \
        | rows.astype(np.int64)


def row_key_sets(keys: np.ndarray, num_sets: int) -> np.ndarray:
    """SplitMix-style key -> set-id hash shared by every host cache sim."""
    h = (keys.astype(np.uint64) * np.uint64(0x9E3779B97F4A7C15)) >> np.uint64(33)
    return (h % np.uint64(num_sets)).astype(np.int64)
