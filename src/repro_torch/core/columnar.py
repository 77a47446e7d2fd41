"""Columnar (CSR) query-batch representation — the serving hot path's
native trace format.

A batch of embedding-bag queries is stored as one flat ``values`` index
array plus CSR offsets, instead of ``List[Dict[int, np.ndarray]]``:

* ``values``       [nnz]  — every request's indices, query-major;
* ``seg_offsets``  [S+1]  — one *segment* per (query, table) request;
* ``seg_table``    [S]    — global table id per segment (dict key order);
* ``query_seg``    [N+1]  — query ``q`` owns segments
  ``query_seg[q]:query_seg[q+1]``.

The serving engines never walk queries in Python. :meth:`ColumnarQueries.
group` runs **one stable argsort by table over the whole trace** and caches
a :class:`_Grouping`: segments (and their elements, composite row-cache
keys and order-invariant pooled-cache hashes) laid out contiguously per
table, in query order within each table. A :class:`ColumnarChunk` —
what ``DeviceServingEngine.serve_columnar`` consumes — is then pure slicing:
each table's share of a query range ``[qs, qe)`` is one contiguous span of
the grouped arrays (found by ``searchsorted``), so per-chunk per-table
grouping costs O(tables), not O(batch x tables) Python.

``requests()`` materializes the dict-of-arrays view once (arrays are views
into ``values``) — the compatibility adapter for the dict entry points and
the exact-sequential fallback path.

Segments within one query carry distinct table ids (the dict-equivalent
contract); dict -> columnar -> dict is the identity.

A copy of the reference's numpy module (``repro.core.columnar``), array for
array; ``tests/test_torch_columnar.py`` holds it to the original.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch.core.cache_sim import make_row_keys
from repro_torch.core.pooled_cache import _splitmix, table_mix


@dataclasses.dataclass(frozen=True)
class TableView:
    """One table's share of a chunk, sliced out of the grouped arrays.

    All arrays are aligned per segment (``qid``/``tpos``/``lens``, query ids
    local to the chunk and ascending) or per element (``vals``/``keys``,
    with ``eoff`` the local CSR offsets). ``hashes`` is present only when
    the caller asked for pooled-cache keys.
    """
    tid: int
    qid: np.ndarray                  # [Sl] local query id, ascending
    tpos: np.ndarray                 # [Sl] segment position within its query
    lens: np.ndarray                 # [Sl] indices per segment
    eoff: np.ndarray                 # [Sl+1] local element offsets
    vals: np.ndarray                 # [nnz_t] concatenated indices
    keys: np.ndarray                 # [nnz_t] composite (table, row) keys
    hashes: Optional[np.ndarray]     # [Sl] uint64 order-invariant hashes


class _Grouping:
    """Once-per-trace table grouping of a :class:`ColumnarQueries`."""

    def __init__(self, cq: "ColumnarQueries"):
        n = cq.n_queries
        s = len(cq.seg_table)
        lens = np.diff(cq.seg_offsets)
        seg_query = np.repeat(np.arange(n, dtype=np.int64), cq.nseg)
        order = np.argsort(cq.seg_table, kind="stable")
        t_sorted = cq.seg_table[order]
        self.table_ids, starts = np.unique(t_sorted, return_index=True)
        self.t_spans = np.concatenate([starts, [s]]).astype(np.int64)
        self.q_g = seg_query[order]
        pos_in_query = np.arange(s, dtype=np.int64) - cq.query_seg[seg_query]
        self.tpos_g = pos_in_query[order]
        self.lens_g = lens[order]
        self.eoff_g = np.concatenate([[0], np.cumsum(self.lens_g)]).astype(np.int64)
        # gather elements into table-grouped order (query order within table)
        base = np.repeat(cq.seg_offsets[order] - self.eoff_g[:-1], self.lens_g)
        self.vals_g = cq.values[base + np.arange(len(base), dtype=np.int64)]
        self._t_sorted = t_sorted
        # globally nondecreasing (table rank, query) key: one vectorized
        # searchsorted pair per chunk finds every table's span at once
        t_rank = np.repeat(np.arange(len(self.table_ids), dtype=np.int64),
                           np.diff(self.t_spans))
        self.comb = t_rank * np.int64(n + 1) + self.q_g
        self._n_queries = n
        self._keys_g: Optional[np.ndarray] = None
        self._hash_g: Optional[np.ndarray] = None
        self._bounds: Dict[int, np.ndarray] = {}

    def chunk_bounds(self, csize: int) -> np.ndarray:
        """Grouped-array spans of every uniform chunk of stride ``csize``:
        ``[T, nchunks+1]`` where chunk ``k`` of table rank ``i`` is the span
        ``bounds[i, k]:bounds[i, k+1]``. One vectorized ``searchsorted`` over
        all chunk boundaries replaces the per-chunk pair, so slicing a whole
        trace into chunks is cache lookups only."""
        b = self._bounds.get(csize)
        if b is None:
            n = self._n_queries
            edges = np.append(np.arange(0, n, csize, dtype=np.int64), n)
            t = np.arange(len(self.table_ids), dtype=np.int64) * np.int64(n + 1)
            b = np.searchsorted(
                self.comb, (t[:, None] + edges[None, :]).ravel()
            ).reshape(len(t), len(edges))
            self._bounds[csize] = b
        return b

    def keys_g(self) -> np.ndarray:
        """Composite row-cache keys per element (``cache_sim.make_row_keys``,
        the layout every host cache sim shares), computed vectorized over
        the whole trace once."""
        if self._keys_g is None:
            self._keys_g = make_row_keys(
                np.repeat(self._t_sorted, self.lens_g), self.vals_g)
        return self._keys_g

    def hash_g(self) -> np.ndarray:
        """Order-invariant pooled-cache hash per segment, equal bit-for-bit
        to ``pooled_cache.order_invariant_hash`` of each segment."""
        if self._hash_g is None:
            s = len(self.lens_g)
            if int(self.eoff_g[-1]) == 0:
                sums = np.zeros(s, np.uint64)
            else:
                x = _splitmix(self.vals_g.astype(np.uint64))
                # zero pad: trailing empty segments index one past the data
                # (uint64 + 0 keeps every real sum exact)
                xp = np.concatenate([x, np.zeros(1, np.uint64)])
                sums = np.add.reduceat(xp, self.eoff_g[:-1].astype(np.intp))
                # reduceat yields x[start] (not 0) for interior empty
                # segments; the oracle sums nothing there
                sums[self.lens_g == 0] = np.uint64(0)
            self._hash_g = sums ^ table_mix(self._t_sorted)
        return self._hash_g


class ColumnarQueries:
    """A set of N embedding-bag queries in columnar (CSR) form."""

    def __init__(self, values: np.ndarray, seg_offsets: np.ndarray,
                 seg_table: np.ndarray, query_seg: np.ndarray,
                 requests: Optional[List[Dict[int, np.ndarray]]] = None):
        self.values = np.asarray(values)
        self.seg_offsets = np.asarray(seg_offsets, np.int64)
        self.seg_table = np.asarray(seg_table, np.int64)
        self.query_seg = np.asarray(query_seg, np.int64)
        self._requests = requests
        self._group: Optional[_Grouping] = None
        self._factors: Dict[tuple, Dict[int, tuple]] = {}
        # cache-effectiveness counter: how many plan factorizations were
        # actually computed (vs served from ``_factors``) — regression tests
        # assert replays/repeated cluster runs do not grow it
        self.factor_builds = 0

    # -- construction ---------------------------------------------------------

    @classmethod
    def from_requests(cls, requests: Sequence[Dict[int, np.ndarray]]
                      ) -> "ColumnarQueries":
        """Compatibility adapter: dict-of-arrays -> columnar (identity on
        round trip; the original dicts back ``requests()``)."""
        vals: List[np.ndarray] = []
        tids: List[int] = []
        nseg = np.empty(len(requests), np.int64)
        for q, req in enumerate(requests):
            nseg[q] = len(req)
            for tid, idx in req.items():
                tids.append(tid)
                vals.append(np.asarray(idx))
        values = (np.concatenate(vals).astype(np.int64, copy=False)
                  if vals else np.zeros(0, np.int64))
        lens = np.fromiter((len(v) for v in vals), np.int64, count=len(vals))
        seg_offsets = np.concatenate([[0], np.cumsum(lens)])
        query_seg = np.concatenate([[0], np.cumsum(nseg)])
        return cls(values, seg_offsets, np.asarray(tids, np.int64),
                   query_seg, requests=list(requests))

    # -- basic shape ----------------------------------------------------------

    @property
    def n_queries(self) -> int:
        return len(self.query_seg) - 1

    @property
    def nseg(self) -> np.ndarray:
        """Segments (= tables) per query."""
        return np.diff(self.query_seg)

    def __len__(self) -> int:
        return self.n_queries

    # -- views ----------------------------------------------------------------

    def group(self) -> _Grouping:
        """The cached table grouping (one stable argsort per trace)."""
        if self._group is None:
            self._group = _Grouping(self)
        return self._group

    def whole(self) -> "ColumnarChunk":
        return self.chunk(0, self.n_queries, self.n_queries or 1)

    def chunk(self, qs: int, qe: int,
              csize: Optional[int] = None) -> "ColumnarChunk":
        """View of queries ``[qs, qe)``. ``csize`` is the uniform chunking
        stride the caller iterates with (``trace.chunks(batch)``); it keys
        the cached probe factorization."""
        return ColumnarChunk(self, qs, qe, csize)


    def requests(self) -> List[Dict[int, np.ndarray]]:
        """Dict-of-arrays view (cached; arrays are views into ``values``)."""
        if self._requests is None:
            self._requests = self.build_requests(0, self.n_queries)
        return self._requests

    def build_requests(self, qs: int, qe: int) -> List[Dict[int, np.ndarray]]:
        """Dict views for queries ``[qs, qe)`` only (uncached)."""
        so, st, v = self.seg_offsets, self.seg_table, self.values
        return [{int(st[s]): v[so[s]:so[s + 1]]
                 for s in range(self.query_seg[q], self.query_seg[q + 1])}
                for q in range(qs, qe)]

    def subset(self, idx: np.ndarray) -> "ColumnarQueries":
        """The queries at ``idx`` (order preserved) as a new columnar set —
        pure array gathers, O(segments) and zero dict copies."""
        idx = np.asarray(idx, np.int64)
        cnt = self.query_seg[idx + 1] - self.query_seg[idx]
        seg_sel = (np.repeat(self.query_seg[idx] - (np.cumsum(cnt) - cnt), cnt)
                   + np.arange(int(cnt.sum()), dtype=np.int64))
        lens = np.diff(self.seg_offsets)[seg_sel]
        eoff = np.concatenate([[0], np.cumsum(lens)]).astype(np.int64)
        elem = (np.repeat(self.seg_offsets[seg_sel] - eoff[:-1], lens)
                + np.arange(int(eoff[-1]), dtype=np.int64))
        return ColumnarQueries(self.values[elem], eoff,
                               self.seg_table[seg_sel],
                               np.concatenate([[0], np.cumsum(cnt)]))


class ColumnarChunk:
    """Query range ``[qs, qe)`` of a :class:`ColumnarQueries`, exposing the
    per-table views the serving engine consumes. Construction is O(tables):
    every table's segments for the range are one contiguous span of the
    parent's grouped arrays."""

    def __init__(self, parent: ColumnarQueries, qs: int, qe: int,
                 csize: Optional[int] = None):
        self._p = parent
        self._qs = qs
        self._qe = qe
        self._csize = csize
        g = parent.group()
        n = parent.n_queries
        if (csize is not None and 0 < csize and qs % csize == 0
                and qe == min(qs + csize, n) and n > 0):
            # uniform chunking: spans come from the whole-trace boundary
            # table (one searchsorted for every chunk of this stride)
            b = g.chunk_bounds(csize)
            k = qs // csize
            self._lo = b[:, k]
            self._hi = b[:, k + 1]
        else:
            t = np.arange(len(g.table_ids), dtype=np.int64) * np.int64(n + 1)
            self._lo = np.searchsorted(g.comb, t + qs)
            self._hi = np.searchsorted(g.comb, t + qe)

    @property
    def parent(self) -> ColumnarQueries:
        return self._p

    @property
    def start(self) -> int:
        return self._qs

    @property
    def csize(self) -> Optional[int]:
        return self._csize

    @property
    def n_queries(self) -> int:
        return self._qe - self._qs

    @property
    def table_ids(self) -> np.ndarray:
        """Every table id of the parent trace (not just this chunk's)."""
        return self._p.group().table_ids

    def plan_factor(self, ctids: tuple, keys_fn) -> Optional[dict]:
        """This chunk's cached state-independent plan inputs: ``uniq`` /
        ``inv`` — exactly ``np.unique(keys_fn(), return_inverse=True)`` —
        plus whatever chunk-constant scratch the serving engine parks under
        other keys (segment concatenations, event widths). Cached on the
        parent trace, so every warmup / self-consistency replay after the
        first reuses it for free. Returns ``None`` for ad-hoc ranges
        (single-chunk batches would pay the sort with no reuse; callers
        fall back to a live plan)."""
        c = self._csize
        if (c is None or self._qs % c or self._p.n_queries <= c
                or self._qe != min(self._qs + c, self._p.n_queries)):
            return None
        per_chunk = self._p._factors.setdefault((c, ctids), {})
        fact = per_chunk.get(self._qs)
        if fact is None:
            uniq, inv = np.unique(keys_fn(), return_inverse=True)
            fact = {"uniq": uniq, "inv": inv}
            per_chunk[self._qs] = fact
            self._p.factor_builds += 1
        return fact

    def plan_factor_peek(self, ctids: tuple) -> Optional[dict]:
        """The cached :meth:`plan_factor` entry, or ``None`` when this chunk
        has never been factored (never computes anything — the fused serve
        tiers use it to decide whether a precomputed replay is possible)."""
        c = self._csize
        if (c is None or self._qs % c or self._p.n_queries <= c
                or self._qe != min(self._qs + c, self._p.n_queries)):
            return None
        per_chunk = self._p._factors.get((c, ctids))
        return None if per_chunk is None else per_chunk.get(self._qs)

    @property
    def max_segs(self) -> int:
        """Most tables any query of the chunk touches (event-rank width)."""
        nseg = self._p.nseg[self._qs:self._qe]
        return int(nseg.max()) if len(nseg) else 0

    def table_views(self, with_hashes: bool = False) -> List[TableView]:
        g = self._p.group()
        keys = g.keys_g()
        hashes = g.hash_g() if with_hashes else None
        out = []
        for i, tid in enumerate(g.table_ids.tolist()):
            lo, hi = int(self._lo[i]), int(self._hi[i])
            if lo == hi:
                continue
            e0, e1 = int(g.eoff_g[lo]), int(g.eoff_g[hi])
            out.append(TableView(
                tid=tid, qid=g.q_g[lo:hi] - self._qs, tpos=g.tpos_g[lo:hi],
                lens=g.lens_g[lo:hi], eoff=g.eoff_g[lo:hi + 1] - e0,
                vals=g.vals_g[e0:e1], keys=keys[e0:e1],
                hashes=hashes[lo:hi] if with_hashes else None))
        return out

    def requests(self) -> List[Dict[int, np.ndarray]]:
        """Dict views for this chunk (exact-sequential fallback path).
        Built for the chunk's range only unless the parent has already
        materialized its full dict view."""
        if self._p._requests is not None:
            return self._p._requests[self._qs:self._qe]
        return self._p.build_requests(self._qs, self._qe)
