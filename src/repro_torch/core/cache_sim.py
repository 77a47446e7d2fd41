"""Host-side row-cache simulators of the serving plane (paper §4.3).

``BatchedRowCache`` is the host serving plane's FM row cache (the
probe -> miss-IO -> fill contract of Algorithm 1, with the columnar plane's
``batch_plan``/``commit``); ``SimRowCache`` and ``PerTableCaches`` are the
exact-LRU unified and per-table organizations (Fig. 6); ``SetAssocSimCache``
is the vectorized set-associative LRU with the device cache's geometry
(``core/cache.TorchRowCache``). The composite ``(table, row)`` key helpers
are shared with the columnar plane.

A copy of ``repro.core.cache_sim``, array for array
(``tests/test_torch_host_cache.py``).
"""
from __future__ import annotations

import collections
from typing import Dict, Iterable, Optional, Tuple

import numpy as np

from repro_torch.core.cache import (CPU_OPT_METADATA_B,
                                    MEM_OPT_METADATA_B, MEM_OPT_ROW_LIMIT)


class SimRowCache:
    """Exact-LRU, byte-budgeted unified row cache."""

    def __init__(self, capacity_bytes: int, metadata_bytes: Optional[int] = None):
        self.capacity = capacity_bytes
        self.metadata_bytes = metadata_bytes
        self.used = 0
        self.lru: "collections.OrderedDict[Tuple[int, int], int]" = collections.OrderedDict()
        self.hits = 0
        self.misses = 0

    def _row_cost(self, row_bytes: int) -> int:
        if self.metadata_bytes is not None:
            return row_bytes + self.metadata_bytes
        meta = MEM_OPT_METADATA_B if row_bytes <= MEM_OPT_ROW_LIMIT else CPU_OPT_METADATA_B
        return row_bytes + meta

    def access(self, table_id: int, row_id: int, row_bytes: int) -> bool:
        """Touch one row; returns hit?"""
        key = (table_id, row_id)
        if key in self.lru:
            self.lru.move_to_end(key)
            self.hits += 1
            return True
        self.misses += 1
        cost = self._row_cost(row_bytes)
        while self.used + cost > self.capacity and self.lru:
            _, old = self.lru.popitem(last=False)
            self.used -= old
        if cost <= self.capacity:
            self.lru[key] = cost
            self.used += cost
        return False

    def access_batch(self, table_id: int, rows: np.ndarray, row_bytes: int) -> int:
        """Returns number of hits for a batch of row ids.

        Same sequential semantics as per-row :meth:`access` (a repeated row
        hits after its first miss inserts it), with the dict/LRU operations
        hoisted out of the per-row attribute-lookup path. Exact LRU cannot be
        numpy-vectorized; the serving data plane uses
        :class:`BatchedRowCache` instead.
        """
        lru = self.lru
        move = lru.move_to_end
        pop = lru.popitem
        capacity = self.capacity
        cost = self._row_cost(row_bytes)
        used = self.used
        h = 0
        for r in np.asarray(rows).tolist():
            key = (table_id, r)
            if key in lru:
                move(key)
                h += 1
                continue
            while used + cost > capacity and lru:
                _, old = pop(last=False)
                used -= old
            if cost <= capacity:
                lru[key] = cost
                used += cost
        n = len(rows)
        self.used = used
        self.hits += h
        self.misses += n - h
        return h

    @property
    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0

    def reset_stats(self):
        self.hits = 0
        self.misses = 0


EMPTY_TAG = np.int64(-1)


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


def rank_within_set(sets_sorted: np.ndarray) -> np.ndarray:
    """Occurrence rank of each element within its (already sorted) set group."""
    pos = np.arange(len(sets_sorted), dtype=np.int64)
    return pos - np.searchsorted(sets_sorted, sets_sorted)


class BatchedRowCache:
    """Byte-budgeted, set-associative unified row cache with the batched
    probe -> miss-IO -> fill contract of Algorithm 1 (paper §4.3/§4.4).

    This is the serving data plane's row cache: one embedding-bag request is
    probed as a whole (vectorized tag compare), the unique missed rows become
    one batched SM IO, and the fetched rows are filled afterwards. Duplicated
    indices inside one request therefore all probe as misses but cost a
    single IO — matching what a real batched io_uring submission does.
    Geometry mirrors :class:`repro_torch.core.cache.TorchRowCache`
    (set-associative, LRU-within-set) so host simulation and the device
    cache agree.
    """

    def __init__(self, capacity_bytes: int, row_bytes: int, ways: int = 8,
                 metadata_bytes: Optional[int] = None):
        if metadata_bytes is None:
            metadata_bytes = (MEM_OPT_METADATA_B if row_bytes <= MEM_OPT_ROW_LIMIT
                              else CPU_OPT_METADATA_B)
        slot_bytes = row_bytes + metadata_bytes
        rows = max(ways, capacity_bytes // max(1, slot_bytes))
        self.capacity = capacity_bytes
        self.row_bytes = row_bytes
        self.num_sets = max(1, int(rows) // ways)
        self.ways = ways
        self.tags = np.full((self.num_sets, ways), EMPTY_TAG, np.int64)
        # np.full (not np.zeros) so the pages are touched now, not faulted in
        # one scatter at a time on the serving path
        self.stamp = np.full((self.num_sets, ways), 0, np.int64)
        self.clock = 0
        self.hits = 0
        self.misses = 0
        self.filled = 0          # resident rows (monotone until first eviction)
        self.evictions = 0       # lines overwritten by fill() — while this is
        #                          unchanged, residency and way placement are
        #                          monotone (commit() never evicts), which the
        #                          columnar plane's resident-chunk plan cache
        #                          relies on

    # -- key / set hashing (module-level helpers, shared with SetAssocSimCache)

    @staticmethod
    def _key(table_id: int, rows: np.ndarray) -> np.ndarray:
        return make_row_keys(table_id, rows)

    def _sets(self, keys: np.ndarray) -> np.ndarray:
        return row_key_sets(keys, self.num_sets)

    # -- request-level contract ----------------------------------------------

    def probe(self, table_id: int, rows: np.ndarray) -> np.ndarray:
        """Vectorized presence probe. Returns per-element hit mask; refreshes
        the LRU stamp of every hit line. No fills happen here."""
        rows = np.asarray(rows)
        if len(rows) == 0:
            return np.zeros(0, bool)
        keys = self._key(table_id, rows)
        sets = self._sets(keys)
        match = self.tags[sets] == keys[:, None]             # [N, W]
        hit = match.any(axis=1)
        self.clock += 1
        hs, hw = sets[hit], match[hit].argmax(axis=1)
        self.stamp[hs, hw] = self.clock
        self.hits += int(hit.sum())
        self.misses += int(len(rows) - hit.sum())
        return hit

    def fill(self, table_id: int, rows: np.ndarray) -> None:
        """Insert the (deduplicated) rows fetched from SM, evicting the
        LRU way of each full set. Vectorized in set-conflict rounds."""
        rows = np.asarray(rows)
        if len(rows) == 0:
            return
        keys = np.unique(self._key(table_id, rows))
        sets = self._sets(keys)
        self.clock += 1
        order = np.argsort(sets, kind="stable")
        rank = rank_within_set(sets[order])
        for r in range(int(rank.max()) + 1):
            sel = order[rank == r]                           # <=1 per set
            ss = sets[sel]
            kk = keys[sel]
            match = self.tags[ss] == kk[:, None]
            already = match.any(axis=1)
            way = np.where(already, match.argmax(axis=1),
                           self.stamp[ss].argmin(axis=1))
            was_empty = self.tags[ss, way] == EMPTY_TAG
            self.filled += int((~already & was_empty).sum())
            self.evictions += int((~already & ~was_empty).sum())
            self.tags[ss, way] = kk
            self.stamp[ss, way] = self.clock
        # rows evicted to make room are simply overwritten (tags replaced)

    def access_batch(self, table_id: int, rows: np.ndarray):
        """One embedding-bag request: probe, then fill the unique misses.
        Returns (hit mask [N], number of unique missed rows == SM IOs)."""
        rows = np.asarray(rows)
        hit = self.probe(table_id, rows)
        miss_rows = np.unique(rows[~hit])
        self.fill(table_id, miss_rows)
        return hit, int(len(miss_rows))

    def batch_plan(self, keys: np.ndarray):
        """Probe a multiset of composite keys (:meth:`make_keys`) against the
        current state *without mutating it*.

        This is the cross-query fast path: the caller concatenates every
        request of a whole serving batch (any mix of tables — the table id is
        encoded in the key), plans once, decides per-request hit/miss
        attribution itself, then applies the state change with
        :meth:`commit`. Returns ``None`` when filling all absent keys could
        evict a resident line — eviction order is arrival-dependent, so the
        caller must fall back to the exact per-request path. Since nothing
        has been mutated at that point, the fallback is bit-exact.

        Returns a plan dict: ``uniq`` (sorted unique keys), ``inv`` (key id
        per input element), ``present`` (resident at plan time, per unique
        key), plus the probe/fill way bookkeeping ``commit`` consumes.
        """
        uniq, inv = np.unique(keys, return_inverse=True)
        return self.plan_from_unique(uniq, inv)

    def plan_from_unique(self, uniq: np.ndarray, inv: np.ndarray):
        """:meth:`batch_plan` with the key factorization precomputed.

        ``uniq`` must be the sorted unique keys and ``inv`` the per-element
        index into it (exactly ``np.unique(keys, return_inverse=True)``).
        The columnar trace plane precomputes this factorization once per
        (trace, chunk size) — it is state-independent — so the per-chunk
        plan costs only the probe, not a sort.
        """
        u_sets = self._sets(uniq)
        match = self.tags[u_sets] == uniq[:, None]           # [U, W]
        present = match.any(axis=1)
        way = match.argmax(axis=1)                           # hit way (if any)
        new_ids = np.nonzero(~present)[0]
        if len(new_ids):
            new_sets = u_sets[new_ids]
            order = np.argsort(new_sets, kind="stable")
            s_sorted = new_sets[order]
            rank = rank_within_set(s_sorted)                  # occurrence/set
            empty = self.tags[s_sorted] == EMPTY_TAG          # [M, W]
            slot = empty.cumsum(axis=1) == (rank + 1)[:, None]
            if not slot.any(axis=1).all():
                return None                                   # would evict
            # way for each absent key = its rank-th empty way, exactly the
            # way sequential LRU fills would pick (empty lines carry stamp 0)
            w = np.empty(len(new_ids), np.int64)
            w[order] = slot.argmax(axis=1)
            way[new_ids] = w
        return {"uniq": uniq, "inv": inv, "sets": u_sets,
                "present": present, "way": way}

    def commit(self, plan: dict, used_ids: np.ndarray,
               events: Optional[np.ndarray] = None) -> None:
        """Apply a :meth:`batch_plan`: refresh the LRU stamp of every used
        resident key and fill every used absent key (eviction-free by the
        plan's guard). ``used_ids`` indexes ``plan["uniq"]`` — keys belonging
        to requests that were served from the pooled cache are not used and
        leave the row cache untouched, as they would sequentially.

        ``events`` (aligned with ``used_ids``) ranks each key's *last* touch
        in sequential arrival order — (query, table position, probe-vs-fill).
        Stamps become ``clock + 1 + event``, reproducing exactly the relative
        recency a sequential run would leave behind, so later evictions pick
        the same victims and cross-batch stats stay bit-identical. Without
        ``events`` all touched lines share one clock tick (batch-granular
        recency)."""
        sets, way = plan["sets"], plan["way"]
        ev = np.zeros(len(used_ids), np.int64) if events is None else events
        stamp_vals = self.clock + 1 + ev
        self.stamp[sets[used_ids], way[used_ids]] = stamp_vals
        if not plan.get("all_present"):     # resident-chunk plans never fill
            present = plan["present"][used_ids]
            new_ids = used_ids[~present]
            if len(new_ids):
                self.tags[sets[new_ids], way[new_ids]] = plan["uniq"][new_ids]
                self.filled += len(new_ids)
        self.clock += 1 + (int(ev.max()) if len(ev) else 0)

    def make_keys(self, table_id: int, rows: np.ndarray) -> np.ndarray:
        """Composite (table, row) keys for :meth:`batch_plan`."""
        return self._key(table_id, np.asarray(rows))

    @property
    def capacity_rows(self) -> int:
        return self.num_sets * self.ways

    @property
    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0

    def reset_stats(self):
        self.hits = 0
        self.misses = 0


class PerTableCaches:
    """Per-table cache organization (the losing design in Fig. 6): the FM
    budget is statically partitioned across tables."""

    def __init__(self, capacity_bytes: int, table_ids: Iterable[int],
                 weights: Optional[Dict[int, float]] = None):
        ids = list(table_ids)
        if weights is None:
            weights = {t: 1.0 for t in ids}
        wsum = sum(weights[t] for t in ids)
        self.caches = {
            t: SimRowCache(int(capacity_bytes * weights[t] / wsum)) for t in ids}

    def access(self, table_id: int, row_id: int, row_bytes: int) -> bool:
        return self.caches[table_id].access(table_id, row_id, row_bytes)

    @property
    def hit_rate(self) -> float:
        hits = sum(c.hits for c in self.caches.values())
        total = hits + sum(c.misses for c in self.caches.values())
        return hits / total if total else 0.0


class SetAssocSimCache:
    """Vectorized set-associative LRU cache over numpy arrays — fast enough to
    replay multi-million-access traces; mirrors TorchRowCache geometry."""

    def __init__(self, num_sets: int, ways: int):
        self.num_sets = num_sets
        self.ways = ways
        self.tags = np.full((num_sets, ways), -1, np.int64)
        self.stamp = np.zeros((num_sets, ways), np.int64)
        self.clock = 0
        self.hits = 0
        self.misses = 0

    @staticmethod
    def _key(table_id: int, rows: np.ndarray) -> np.ndarray:
        return make_row_keys(table_id, rows)

    def _sets(self, keys: np.ndarray) -> np.ndarray:
        return row_key_sets(keys, self.num_sets)

    def access_batch(self, table_id: int, rows: np.ndarray) -> np.ndarray:
        """Sequential LRU semantics, numpy-vectorized.

        Accesses to different sets commute, so the batch is processed in
        conflict rounds: round ``r`` handles the ``r``-th access landing in
        each set (at most one access per set per round), fully vectorized.
        Stamps carry the original access position, so the result is
        bit-identical to :meth:`access_scalar` applied row by row.
        """
        rows = np.asarray(rows)
        n = len(rows)
        if n == 0:
            return np.zeros(0, bool)
        keys = self._key(table_id, rows)
        sets = self._sets(keys)
        order = np.argsort(sets, kind="stable")  # stable group-by-set
        rank = rank_within_set(sets[order])      # occurrence index within set
        hit = np.zeros(n, bool)
        base = self.clock
        for r in range(int(rank.max()) + 1):
            sel = order[rank == r]               # original positions, <=1/set
            ss = sets[sel]
            kk = keys[sel]
            match = self.tags[ss] == kk[:, None]             # [m, W]
            h = match.any(axis=1)
            way = np.where(h, match.argmax(axis=1),
                           self.stamp[ss].argmin(axis=1))    # hit way | LRU victim
            self.tags[ss, way] = kk
            self.stamp[ss, way] = base + sel + 1
            hit[sel] = h
        self.clock = base + n
        self.hits += int(hit.sum())
        self.misses += int(n - hit.sum())
        return hit

    def access_scalar(self, table_id: int, row: int) -> bool:
        """One access, reference semantics for the vectorized batch path."""
        keys = self._key(table_id, np.array([row]))
        return self.access_in_set(int(self._sets(keys)[0]), keys[0])

    @property
    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0

    def access_in_set(self, set_id: int, key: int) -> bool:
        """One access of composite ``key`` to set ``set_id``; returns hit?
        The caller chooses the set, so the host mirror of a device cache
        whose set hash (``core/cache.set_index``) is not
        :func:`row_key_sets` uses it directly."""
        line = self.tags[set_id]
        self.clock += 1
        w = np.nonzero(line == key)[0]
        if w.size:
            self.stamp[set_id, w[0]] = self.clock
            self.hits += 1
            return True
        victim = int(np.argmin(self.stamp[set_id]))
        self.tags[set_id, victim] = key
        self.stamp[set_id, victim] = self.clock
        self.misses += 1
        return False
