"""Pooled-embedding cache (paper §4.4, Algorithm 1).

Caches the *output* of lookup->dequant->pool for a whole embedding-bag
request, keyed by an order-invariant hash of the index multiset (c = P
scheme: only full-sequence hits). A hit skips IO, dequantization and pooling
entirely. ``LenThreshold`` gates which requests participate (Table 4). The
columnar plane's segment hashes use the same mixers.

A copy of ``repro.core.pooled_cache``; uint64 arithmetic wraps as numpy's
does (``tests/test_torch_host_cache.py``).
"""
from __future__ import annotations

import collections
from typing import Optional, Tuple

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


def order_invariant_hash(table_id: int, indices: np.ndarray) -> int:
    """Commutative 64-bit hash over the index multiset.

    Per-element SplitMix64 finalizer, combined with + (order-invariant, and
    multiset-sensitive unlike XOR, which would cancel duplicated indices).
    """
    x = _splitmix(indices.astype(np.uint64))
    h = np.uint64(np.sum(x, dtype=np.uint64))
    return int(h ^ table_mix(table_id))


def order_invariant_hash_batch(table_id: int, cat_indices: np.ndarray,
                               offsets: np.ndarray) -> np.ndarray:
    """Vectorized :func:`order_invariant_hash` over many requests at once.

    ``cat_indices`` concatenates the requests' index arrays; ``offsets`` holds
    each request's start position. Returns one uint64 key per request, equal
    to the scalar hash of each segment (uint64 addition wraps identically).
    Empty segments are not supported (reduceat would mis-sum them).
    """
    x = _splitmix(cat_indices.astype(np.uint64))
    sums = np.add.reduceat(x, offsets.astype(np.intp)) if len(x) else \
        np.zeros(len(offsets), np.uint64)
    return sums ^ table_mix(table_id)


class PooledEmbeddingCache:
    """LRU, byte-budgeted cache of pooled embedding vectors."""

    def __init__(self, capacity_bytes: int, len_threshold: int = 1):
        self.capacity = capacity_bytes
        self.len_threshold = len_threshold
        self.used = 0
        self.store: "collections.OrderedDict[int, Tuple[np.ndarray, int]]" = \
            collections.OrderedDict()
        self.hits = 0
        self.misses = 0
        self.skipped = 0           # requests below LenThreshold
        self.hit_len_sum = 0       # total indices saved by hits (Table 4)

    def lookup(self, table_id: int, indices: np.ndarray) -> Optional[np.ndarray]:
        if len(indices) <= self.len_threshold:
            self.skipped += 1
            return None
        return self.lookup_hashed(order_invariant_hash(table_id, indices),
                                  len(indices))

    def lookup_hashed(self, key: int, length: int) -> Optional[np.ndarray]:
        """Lookup with a precomputed key (batch path; same counting as
        :meth:`lookup`, threshold already applied by the caller)."""
        entry = self.store.get(key)
        if entry is not None:
            self.store.move_to_end(key)
            self.hits += 1
            self.hit_len_sum += length
            return entry[0]
        self.misses += 1
        return None

    def note_pending_hit(self, length: int) -> None:
        """Count a hit on an entry an earlier request of the same batch is
        about to insert (the batch path probes before it fills)."""
        self.hits += 1
        self.hit_len_sum += length

    def insert(self, table_id: int, indices: np.ndarray, pooled: np.ndarray) -> None:
        if len(indices) <= self.len_threshold:
            return
        self.insert_hashed(order_invariant_hash(table_id, indices), pooled)

    def insert_hashed(self, key: int, pooled: np.ndarray) -> None:
        cost = pooled.nbytes + 24  # key + sizes metadata
        while self.used + cost > self.capacity and self.store:
            _, (_, old) = self.store.popitem(last=False)
            self.used -= old
        if cost <= self.capacity:
            self.store[key] = (pooled, cost)
            self.used += cost

    @property
    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0

    @property
    def avg_hit_len(self) -> float:
        return self.hit_len_sum / self.hits if self.hits else 0.0
