"""Hash mixers of the pooled-embedding cache (paper §4.4, Algorithm 1).

Only the mixers are here so far: the columnar plane's order-invariant
segment hashes use them. The pooled cache itself comes with the host
serving plane. A copy of ``repro.core.pooled_cache``; uint64 arithmetic
wraps as numpy's does (``tests/test_torch_workloads.py``).
"""
from __future__ import annotations

import numpy as np


def _splitmix(x: np.ndarray) -> np.ndarray:
    x = x + np.uint64(0x9E3779B97F4A7C15)
    x = (x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    x = (x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    return x ^ (x >> np.uint64(31))


def table_mix(table_id) -> np.ndarray:
    """The table-id mixer every order-invariant hash xors in. Accepts a
    scalar or an array of table ids (uint64 multiply wraps, intended)."""
    with np.errstate(over="ignore"):
        return np.asarray(table_id).astype(np.uint64) \
            * np.uint64(0xD6E8FEB86659FD93)
