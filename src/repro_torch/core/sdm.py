"""SDM embedding store — the serving data plane (paper §4, Algorithm 1).

Ties together placement (§4.6), the unified FM row cache (§4.3), the pooled
embedding cache (§4.4), de-pruning (§4.5), quantized row storage and the
IO engine (§4.1). One query flows:

    per table: pooled-cache probe -> row-cache probe (vectorized) -> one
    batched SM IO for the unique misses -> row-cache fill -> dequant+pool
    (numpy here; the device engine does it on the card through the
    ``gather_pool`` kernel) -> pooled-cache fill -> output dense vectors for
    the interaction.

The row cache is the set-associative :class:`~repro_torch.core.cache_sim.
BatchedRowCache`: a whole request is probed with one vectorized tag compare
and its unique misses become a single batched IO — the host-side mirror of
the device cache (``cache.TorchRowCache`` + the ``cache_probe`` kernel).

``serve_query`` handles one query. ``serve_columnar`` is the batched data
plane: it consumes a columnar (CSR) chunk — per-table segment views sliced
from the trace-level grouping (``core/columnar.py``) — probes each table
once across the whole batch, and submits the per-query IO counts through
one coalesced ``IOEngine.submit_batch_multi`` call. ``serve_batch`` is the
dict-of-arrays compatibility wrapper around it. All paths produce
bit-identical ``QueryStats`` (the columnar path falls back to exact
per-request processing whenever a cache eviction — whose order is
arrival-dependent — would occur mid-batch).

Latency accounting mirrors Eq. 3/4: user-side SM time is overlapped with
item-side FM compute and only the excess surfaces in query latency.

A copy of ``repro.core.sdm``, every path and replay tier, float64 and integer
arithmetic in the same order (``tests/test_torch_sdm.py``). ``last_tier``
names the tier that served the last chunk ("" before the first).
"""
from __future__ import annotations

import dataclasses
import weakref
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core import placement as plc
from repro_torch.core.cache_sim import BatchedRowCache
from repro_torch.core.columnar import ColumnarChunk, ColumnarQueries, TableView
from repro_torch.core.io_sim import DeviceModel, IOEngine, IOQueueConfig
from repro_torch.core.locality import TableMeta, zipf_indices
from repro_torch.core.pooled_cache import (PooledEmbeddingCache,
                                           order_invariant_hash_batch)


@dataclasses.dataclass
class SDMConfig:
    fm_cache_bytes: int = 4 << 30
    pooled_cache_bytes: int = 0          # 0 = disabled
    pooled_len_threshold: int = 4
    placement: plc.PlacementConfig = dataclasses.field(
        default_factory=plc.PlacementConfig)
    io_queue: IOQueueConfig = dataclasses.field(default_factory=IOQueueConfig)
    num_devices: int = 2
    item_time_us: float = 200.0          # item-side (FM/accelerator) per-query time
    row_cache_ways: int = 8              # set-associativity of the FM row cache
    # -- device-plane latency mode (src/repro/devices/) ----------------------
    # "analytic": closed-form loaded-latency means (the default; bit-stable).
    # "sampled": event-driven DeviceSim queues — per-wave sampled service,
    # write-plane interference, §4.1 tuning knobs; seeded by ``sim_seed``.
    latency_mode: str = "analytic"
    tuning: object = None                # devices.DeviceTuning (sampled mode)
    update: object = None                # devices.UpdateSpec (write plane)
    sim_seed: int = 0
    # -- data-integrity plane (devices/integrity.py + runtime/redundancy.py) --
    # Either field non-None attaches a RedundancyPlane to the IO engine:
    # media-error injection + ECC retry ladders (IntegritySpec) and k-way
    # replication / hedged reads / rebuild-after-loss (ReplicationSpec).
    # None/None (the default) leaves the IO path untouched, bit for bit.
    integrity: object = None             # devices.IntegritySpec
    redundancy: object = None            # runtime.redundancy.ReplicationSpec


@dataclasses.dataclass
class QueryStats:
    latency_us: float = 0.0
    sm_ios: int = 0
    row_hits: int = 0
    row_lookups: int = 0
    pooled_hits: int = 0
    pooled_lookups: int = 0
    sm_time_us: float = 0.0              # slowest SM IO batch (pre-overlap)
    # data-integrity plane counters (zero unless a RedundancyPlane is
    # attached; mirrored from IntegrityStats so they roll up through
    # HostReport/ClusterReport)
    corrupt_reads: int = 0
    retry_steps: int = 0
    hedged_reads: int = 0
    repair_ios: int = 0


class SDMEmbeddingStore:
    """Host-side serving store over synthetic quantized tables."""

    def __init__(self, metas: Sequence[TableMeta], device: DeviceModel,
                 cfg: SDMConfig, *, seed: int = 0, materialize_dim: int = 0):
        self.metas = {m.table_id: m for m in metas}
        self.cfg = cfg
        self.placement = plc.assign(list(metas), cfg.placement)
        # Geometry is sized for the largest row so the byte budget holds for
        # every table sharing the unified cache.
        row_b = max(m.dim_bytes for m in metas)
        self.row_cache = BatchedRowCache(cfg.fm_cache_bytes, row_b,
                                         ways=cfg.row_cache_ways)
        self.pooled_cache = (PooledEmbeddingCache(cfg.pooled_cache_bytes,
                                                  cfg.pooled_len_threshold)
                             if cfg.pooled_cache_bytes else None)
        if cfg.latency_mode == "sampled":
            from repro_torch.devices import DEFAULT_TUNING, DeviceSim
            sim = DeviceSim(device, cfg.num_devices, cfg.io_queue,
                            cfg.tuning or DEFAULT_TUNING, cfg.update,
                            seed=cfg.sim_seed)
        elif cfg.latency_mode == "analytic":
            sim = None
        else:
            raise ValueError(f"unknown latency_mode {cfg.latency_mode!r}")
        self.io = IOEngine(device, cfg.num_devices, cfg.io_queue, sim=sim)
        if cfg.integrity is not None or cfg.redundancy is not None:
            # call-time import: runtime/__init__ imports this module back
            from repro_torch.runtime.redundancy import RedundancyPlane
            total = int(sum(m.num_rows for m in metas
                            if self.placement[m.table_id] != plc.FM_DIRECT))
            self.io.integrity = RedundancyPlane(
                cfg.integrity, cfg.redundancy, device, cfg.num_devices,
                max(total, 1), seed=cfg.sim_seed, sim=sim)
        self.rng = np.random.default_rng(seed)
        self.stats = QueryStats()
        self.telemetry = None      # obs handle; None = bit-invisible
        self.last_tier = ""        # data-plane tier that served the last chunk
        self.batch_fallbacks = 0   # columnar path dropped to the exact slow path
        self._pooled_touch: list = []  # pooled-LRU replay scratch
        self._chunk_plans: Dict = {}   # resident-chunk plan cache (columnar)
        self.chunk_plan_hits = 0       # chunks served by a fused replay tier
        self._tmeta: Dict = {}         # trace -> placement split + replay sig
        self._virgin: Optional[tuple] = None   # virgin-sequence cursor
        self._key_events: Optional[np.ndarray] = None  # legacy dict-plane
        self._io_req: list = []                        # scratch
        self._tpos: Dict = {}
        self._ev_width = 1
        # Tiny materialized payloads for numeric paths (tests/examples);
        # production tables stay virtual (metadata-only) for the big models.
        self.payloads: Dict[int, np.ndarray] = {}
        if materialize_dim:
            for m in metas:
                self.payloads[m.table_id] = self.rng.standard_normal(
                    (min(m.num_rows, 4096), materialize_dim)).astype(np.float32)

    # -- query path ----------------------------------------------------------

    def lookup_pool(self, table_id: int, indices: np.ndarray,
                    bg_iops: float = 0.0, at_us: float = None) -> dict:
        """One embedding-bag request (Algorithm 1). Returns accounting dict;
        the pooled vector too when payloads are materialized. ``at_us`` is
        the arrival time the sampled device plane queues against (ignored —
        and harmless — in analytic mode)."""
        self._virgin = None            # sequential serving ends the replayable
        #                                virgin chunk sequence (if any)
        m = self.metas[table_id]
        place = self.placement[table_id]
        st = self.stats
        indices = np.asarray(indices)

        pooled_vec = None
        if self.pooled_cache is not None and place != plc.FM_DIRECT:
            st.pooled_lookups += 1
            hit = self.pooled_cache.lookup(table_id, indices)
            if hit is not None:
                st.pooled_hits += 1
                return {"latency_us": 0.0, "ios": 0, "pooled_hit": True,
                        "vector": hit}

        ios = 0
        lat = 0.0
        if place == plc.FM_DIRECT:
            pass  # FM gather; counted on the item/FM side
        else:
            if place == plc.SM_CACHED:
                st.row_lookups += len(indices)
                hit, ios = self.row_cache.access_batch(table_id, indices)
                st.row_hits += int(hit.sum())
            else:  # SM_UNCACHED: every lookup is an IO
                ios = len(indices)
            lat, _ = self.io.submit(ios, m.dim_bytes, bg_iops, at_us=at_us)
            st.sm_ios += ios

        vec = None
        if table_id in self.payloads:
            tbl = self.payloads[table_id]
            vec = tbl[indices % tbl.shape[0]].sum(axis=0)
            integ = self.io.integrity
            if integ is not None and not integ.integrity.checksums:
                # detection disabled: corrupt rows were served as-is — the
                # undetected count perturbs the pooled vector, proving the
                # injection reaches real data (the checksum-oracle tests
                # pin that with checksums on, this perturbation vanishes)
                u = integ.take_undetected()
                if u:
                    vec = vec + np.float32(u)
            if self.pooled_cache is not None and place != plc.FM_DIRECT:
                self.pooled_cache.insert(table_id, indices, vec)
        elif self.pooled_cache is not None and place != plc.FM_DIRECT:
            self.pooled_cache.insert(table_id, indices,
                                     np.zeros(1, np.float32))  # metadata-only

        return {"latency_us": lat, "ios": ios, "pooled_hit": False, "vector": vec}

    def serve_query(self, requests: Dict[int, np.ndarray], bg_iops: float = 0.0,
                    at_us: float = None) -> QueryStats:
        """requests: {table_id: indices}. User-side tables execute against SM
        in parallel with the item-side FM compute (Eq. 3): query latency is
        max(item_time, slowest SM batch). ``at_us`` feeds the sampled device
        queues; analytic mode ignores it."""
        sm_lat = 0.0
        ios = 0
        integ = self.io.integrity
        if integ is not None:
            ps = integ.stats
            c0 = (ps.corrupt_reads, ps.retry_steps, ps.hedged_reads,
                  ps.repair_ios)
        for tid, idx in requests.items():
            r = self.lookup_pool(tid, idx, bg_iops, at_us=at_us)
            sm_lat = max(sm_lat, r["latency_us"])
            ios += r["ios"]
        q = QueryStats(latency_us=max(self.cfg.item_time_us, sm_lat), sm_ios=ios,
                       sm_time_us=sm_lat)
        if integ is not None:
            ps = integ.stats
            q.corrupt_reads = ps.corrupt_reads - c0[0]
            q.retry_steps = ps.retry_steps - c0[1]
            q.hedged_reads = ps.hedged_reads - c0[2]
            q.repair_ios = ps.repair_ios - c0[3]
            self._sync_integrity()
        self.stats.latency_us += q.latency_us
        return q

    def _sync_integrity(self) -> None:
        """Mirror the integrity plane's counters into the aggregate
        ``QueryStats`` (plane stats are the source of truth; both reset
        together at measurement boundaries)."""
        integ = self.io.integrity
        if integ is None:
            return
        s, ps = self.stats, integ.stats
        s.corrupt_reads = ps.corrupt_reads
        s.retry_steps = ps.retry_steps
        s.hedged_reads = ps.hedged_reads
        s.repair_ios = ps.repair_ios

    # -- batched (columnar) query path ----------------------------------------

    def serve_columnar(self, chunk: ColumnarChunk, bg_iops: float = 0.0,
                       arrivals_us: Optional[np.ndarray] = None
                       ) -> Tuple[np.ndarray, np.ndarray]:
        """Serve a columnar (CSR) chunk — the vectorized data plane.

        ``chunk`` carries per-table segment views sliced from the trace-level
        grouping (one stable argsort per trace, see ``core/columnar.py``):
        every cached table's pre-concatenated keys go through one row-cache
        ``batch_plan``, pooled-cache hashes are precomputed slices, the
        sequential-arrival event ranking comes straight from the CSR
        query/position arrays, and one ``submit_batch_multi`` covers all
        tables. Returns ``(sm_time_us [nq] f64, sm_ios [nq] i64)``.

        Stats totals are bit-identical to calling :meth:`serve_query` on each
        request in arrival order. Chunks that could evict (row or pooled
        cache) before all probes complete fall back to exactly that
        sequential path — the pre-flight plan mutates nothing, so the
        fallback is exact (see ``batch_fallbacks``).

        ``arrivals_us`` (aligned with the chunk's queries) carries the trace
        arrival times into the sampled device plane, where each query's IO
        submissions queue at its own arrival; analytic mode ignores it.
        """
        nq = chunk.n_queries
        if nq == 0:
            return np.zeros(0, np.float64), np.zeros(0, np.int64)
        pc = self.pooled_cache
        st = self.stats
        meta = None
        if pc is None:
            # fused replay tiers: when everything the live pipeline would
            # derive for this chunk is already known (precomputed replay
            # state on the trace + this store's state signature), skip the
            # pipeline wholesale — bit-identical by construction
            meta = self._chunk_meta(chunk)
            fused = self._serve_fused(chunk, meta, bg_iops, arrivals_us)
            if fused is not None:
                return fused
        views = chunk.table_views(with_hashes=pc is not None)
        if not self._pooled_headroom(views):
            return self._serve_fallback(chunk, bg_iops, arrivals_us)

        # Pre-flight row-cache plan over every cached table's keys (a
        # superset of what the row phase will touch: pooled hits drop out
        # later, which only makes the eviction guard conservative). This
        # runs before the pooled probes so the eviction fallback still sees
        # a completely untouched store. The sorted-unique/inverse
        # factorization is state-independent and comes precomputed per
        # (trace, chunk stride) when available.
        cached = [v for v in views if self.placement[v.tid] == plc.SM_CACHED]
        plan = None
        plan_inv = None
        fact = None
        mark_fact = None
        cap = None
        if meta is not None:
            # factor even keyless chunks: the capture below parks this
            # chunk's replay state on the factorization entry
            fact = chunk.plan_factor(meta[0], lambda: np.concatenate(
                [v.keys for v in cached] or [np.zeros(0, np.int64)]))
            if fact is not None:
                cap = {"sig": meta[2], "clock0": self.row_cache.clock,
                       "fill0": self.row_cache.filled,
                       "virgin": (self.row_cache.evictions == 0
                                  and self._virgin_at(chunk)),
                       "ios0": st.sm_ios, "lk0": st.row_lookups,
                       "hits0": st.row_hits}
        if any(len(v.keys) for v in cached):
            if fact is None and meta is None:
                ctids = tuple(t for t in chunk.table_ids.tolist()
                              if self.placement[t] == plc.SM_CACHED)
                fact = chunk.plan_factor(
                    ctids, lambda: np.concatenate([v.keys for v in cached]))
            if fact is not None:
                plan_inv = fact["inv"]
                # resident-chunk plan cache: once this chunk has been served
                # with every key resident afterwards, residency and way
                # placement are monotone until the next eviction anywhere
                # (``row_cache.evictions``) — replays skip the tag probe
                lite = self._chunk_plans.get(id(fact))
                if lite is not None and \
                        lite[1] == self.row_cache.evictions:
                    plan = lite[0]
                else:
                    plan = self.row_cache.plan_from_unique(fact["uniq"],
                                                           plan_inv)
                    mark_fact = fact
            else:
                plan = self.row_cache.batch_plan(
                    np.concatenate([v.keys for v in cached]))
                plan_inv = None if plan is None else plan["inv"]
            if plan is None:     # an eviction would occur; nothing mutated yet
                return self._serve_fallback(chunk, bg_iops, arrivals_us)

        # Phase A — pooled-cache probes per table (a Python segment loop
        # only when the pooled cache exists; pure slicing otherwise).
        # c_all: every cached view (its elements occupy the plan regardless
        # of pooled hits); c_act / u_act: views with active segments.
        self._pooled_touch = []
        c_all = []
        c_act = []
        u_act = []
        fills = []
        for v in views:
            place = self.placement[v.tid]
            if place == plc.FM_DIRECT:
                continue  # FM gather; no SM IO, no pooled participation
            if pc is not None:
                a_pos, keys_fill = self._pooled_probe(v)
                active = a_pos is None or len(a_pos) > 0
            else:
                a_pos, keys_fill = None, None
                active = len(v.qid) > 0
            if place == plc.SM_CACHED:
                c_all.append((v, a_pos, active))
                if active:
                    c_act.append((v, a_pos))
            elif active:
                u_act.append((v, a_pos))
            if pc is not None and active:
                fills.append((v, a_pos, keys_fill))

        sm_lat = np.zeros(nq, np.float64)
        ios_q = np.zeros(nq, np.int64)
        io_aq, io_ios, io_rb = [], [], []

        # Phase B — one global row-attribution pass across all cached
        # tables: keys are unique per table, so per-key first/last touches
        # resolve in (table, query)-ordered segment space without any
        # per-table regrouping. A key is an SM IO only for the first segment
        # that misses it; every later segment hits the just-filled line.
        if c_act:
            partial = any(a is not None and len(a) != len(v.qid)
                          for v, a, _ in c_all)
            seg_meta = None if (partial or fact is None) \
                else fact.get("seg")
            if seg_meta is None:
                aq_c = np.concatenate([v.qid if a is None else v.qid[a]
                                       for v, a in c_act])
                lens_c = np.concatenate([v.lens if a is None else v.lens[a]
                                         for v, a in c_act])
                tpos_c = np.concatenate([v.tpos if a is None else v.tpos[a]
                                         for v, a in c_act])
                seg_id = np.repeat(np.arange(len(aq_c), dtype=np.int64),
                                   lens_c)
                ev_width = 1 + chunk.max_segs
                if not partial and fact is not None:
                    # chunk-constant (state-independent): cache for replays
                    fact["seg"] = (aq_c, lens_c, tpos_c, seg_id, ev_width)
            else:
                aq_c, lens_c, tpos_c, seg_id, ev_width = seg_meta
            if partial:
                keep = []
                for v, a, _ in c_all:
                    if a is None:
                        keep.append(np.ones(len(v.keys), bool))
                    elif len(a) == len(v.qid):
                        keep.append(np.ones(len(v.keys), bool))
                    else:
                        m = np.zeros(len(v.qid), bool)
                        m[a] = True
                        keep.append(np.repeat(m, v.lens))
                inv_k = plan_inv[np.concatenate(keep)]
            elif plan_inv is not None:
                inv_k = plan_inv
            else:                   # cached tables whose requests are empty
                inv_k = np.zeros(0, np.int64)
            ek = len(inv_k)
            ns = len(aq_c)
            ids = np.zeros(0, np.int64)
            events = np.zeros(0, np.int64)
            tot_c_ios = 0
            if ek:
                # sequential-arrival event ranking: (query, table position
                # within the query, probe-vs-fill). Row-cache stamps and the
                # pooled LRU order are replayed in this order after the
                # batch, so the state left behind is exactly what a
                # sequential run would leave.
                u = len(plan["uniq"])
                # scatter: duplicate indices -> last write wins, and seg_id
                # is nondecreasing, so these are per-key first/last touches
                last = np.empty(u, np.int64)
                last[inv_k] = seg_id
                if partial:
                    used = np.zeros(u, bool)
                    used[inv_k] = True
                    ids = np.nonzero(used)[0]
                else:       # every unique key appears in inv_k
                    used = None
                    ids = np.arange(u, dtype=np.int64)
                all_hit = plan.get("all_present", False)
                if not all_hit:
                    pk = plan["present"][inv_k]
                    all_hit = bool(pk.all())
                if all_hit:
                    # warm steady state: every element hits, nothing fills —
                    # the miss attribution collapses away (same values)
                    nh = ek
                    ios_seg = np.zeros(ns, np.int64)
                    events = (aq_c[last[ids]] * ev_width
                              + tpos_c[last[ids]]) * 2
                else:
                    present = plan["present"]
                    first = np.empty(u, np.int64)
                    first[inv_k[::-1]] = seg_id[::-1]
                    elem_hit = pk | (seg_id > first[inv_k])
                    nh = int(elem_hit.sum())
                    miss = ~present if used is None else used & ~present
                    ios_seg = np.bincount(first[miss], minlength=ns)
                    tot_c_ios = int(ios_seg.sum())
                    fill_last = miss & (last == first)
                    events = ((aq_c[last[ids]] * ev_width
                               + tpos_c[last[ids]]) * 2 + fill_last[ids])
                st.row_lookups += ek
                st.row_hits += nh
                self.row_cache.hits += nh
                self.row_cache.misses += ek - nh
            else:
                ios_seg = np.zeros(ns, np.int64)
            st.sm_ios += tot_c_ios
            if tot_c_ios:       # all-hit chunks contribute no IO anywhere
                s0 = 0
                for v, a in c_act:
                    na = len(v.qid) if a is None else len(a)
                    aq_t = aq_c[s0:s0 + na]
                    ios_t = ios_seg[s0:s0 + na]
                    s0 += na
                    ios_q[aq_t] += ios_t    # aq is unique per table: plain
                    io_aq.append(aq_t)      # fancy indexing works
                    io_ios.append(ios_t)
                    io_rb.append(np.full(na, self.metas[v.tid].dim_bytes,
                                         np.int64))
        n_cached_io = len(io_aq)        # uncached entries start here
        for v, a in u_act:              # SM_UNCACHED: every lookup is an IO
            aq_t = v.qid if a is None else v.qid[a]
            ios_t = v.lens if a is None else v.lens[a]
            st.sm_ios += int(ios_t.sum())
            ios_q[aq_t] += ios_t
            io_aq.append(aq_t)
            io_ios.append(ios_t)
            io_rb.append(np.full(len(aq_t), self.metas[v.tid].dim_bytes,
                                 np.int64))

        # IO is coalesced across tables too: one submit_batch_multi covers
        # the whole chunk (latency is per-request, independent of grouping in
        # analytic mode; the sampled device queues serve it in arrival order)
        cat_aq = cat_ios = cat_rb = None
        if io_aq:
            cat_aq = np.concatenate(io_aq)
            cat_ios = np.concatenate(io_ios)
            cat_rb = np.concatenate(io_rb)
            at = (None if arrivals_us is None
                  else np.asarray(arrivals_us, np.float64)[cat_aq])
            lats, _ = self.io.submit_batch_multi(cat_ios, cat_rb, bg_iops,
                                                 at_us=at)
            np.maximum.at(sm_lat, cat_aq, lats)
        if plan is not None:
            if c_act:
                self.row_cache.commit(plan, ids, events)
            else:
                self.row_cache.commit(plan, np.zeros(0, np.int64),
                                      np.zeros(0, np.int64))
            if mark_fact is not None and (
                    pc is None or bool(plan["present"].all())):
                # every key of this chunk is now resident (pooled off: all
                # keys were used and committed; else nothing was absent), so
                # replays can skip the tag probe until the next eviction
                if len(self._chunk_plans) > 4096:
                    self._chunk_plans.clear()
                self._chunk_plans[id(mark_fact)] = (
                    {"uniq": plan["uniq"], "sets": plan["sets"],
                     "way": plan["way"], "all_present": True},
                    self.row_cache.evictions, mark_fact,
                    plan["sets"] * np.int64(self.row_cache.ways)
                    + plan["way"])
        if cap is not None:
            self._fused_capture(chunk, fact, cap, plan,
                                events if plan is not None else None,
                                io_aq, io_ios, io_rb, n_cached_io,
                                cat_aq, cat_ios, cat_rb, ios_q, nq)

        # Phase C — pooled-cache fills (+ pooled vectors when payloads are
        # materialized), then the pooled LRU replay in arrival order
        for v, a_pos, keys_fill in fills:
            self._pooled_fill(v, a_pos, keys_fill)
        if pc is not None and self._pooled_touch:
            store = pc.store
            for _, _, k in sorted(self._pooled_touch):
                if k in store:
                    store.move_to_end(k)
        self._pooled_touch = []

        self._note_tier("live")
        self._acc_latency(sm_lat)
        return sm_lat, ios_q

    def _note_tier(self, tier: str) -> None:
        """Record which data-plane tier served the chunk. Counted under the
        ``diag.`` namespace: tier engagement depends on replay-cache
        topology (streamed serving drops plan caches per piece), so it is
        excluded from the streamed == materialized registry parity contract
        while results stay bit-identical. ``last_tier`` is kept with or
        without a handle (``HostPlaneResult.tiers`` reads it)."""
        self.last_tier = tier
        if self.telemetry is not None:
            self.telemetry.registry.inc("diag.tier." + tier)

    # -- fused replay tiers ---------------------------------------------------
    #
    # Replays dominate steady-state serving: cluster warmup passes, repeated
    # benchmark reps and self-consistency runs all re-serve chunk sequences
    # whose per-chunk derivations — plan factorization, way placement, event
    # ranking, IO shapes — are already known. Three tiers skip the live
    # pipeline wholesale while leaving bit-identical state and stats behind
    # (all require the pooled cache to be off: pooled LRU state is
    # arrival-history-dependent and is not captured):
    #
    # * trivial — the trace touches no SM tables (FM_DIRECT only); serving
    #   affects nothing but the latency accumulator;
    # * resident replay — every key of the chunk is resident and no eviction
    #   has intervened (the resident-chunk plan cache): one precomputed stamp
    #   scatter reproduces ``commit`` exactly, uncached-table IO comes from
    #   cached shape arrays;
    # * virgin replay — a fresh store serving the exact chunk prefix another
    #   fresh store served (every benchmark rep / warmup pass builds its
    #   hosts from scratch): the first pass captures each chunk's state
    #   transition (stamp/tag scatters, counter deltas, IO shapes) keyed by
    #   a (geometry, placement, row-size) signature, and replays apply it
    #   directly, guarded by the (clock, filled, evictions) state signature —
    #   every mutating row-cache operation bumps the clock, so a matching
    #   signature implies the exact captured pre-state.

    def drop_plan_caches(self) -> None:
        """Forget the per-chunk replay caches (resident plans, fused
        captures, trace metadata, virgin cursor). Purely a memory valve —
        the caches only accelerate re-serving the *same* chunk objects, so
        dropping them never changes results. Streamed serving
        (``ClusterSim.run_stream``) calls this after each flushed batch:
        its chunk objects are served exactly once, so the entries (which
        pin the chunk's factorization arrays alive) are pure retention and
        would otherwise grow O(trace), not O(piece)."""
        self._chunk_plans.clear()
        self._tmeta.clear()
        self._virgin = None

    def _chunk_meta(self, chunk: ColumnarChunk):
        """Per-trace placement split + replay signature, cached: ``(cached
        tids, uncached tids, sig)``. ``sig`` pins everything a captured
        replay depends on besides row-cache state: cache geometry and every
        table's placement and row size."""
        cq = chunk.parent
        ent = self._tmeta.get(id(cq))
        if ent is not None and ent[0]() is cq:
            return ent[1]
        tids = chunk.table_ids.tolist()
        ctids = tuple(t for t in tids
                      if self.placement[t] == plc.SM_CACHED)
        usig = tuple(t for t in tids
                     if self.placement[t] == plc.SM_UNCACHED)
        rc = self.row_cache
        sig = (rc.num_sets, rc.ways,
               tuple((t, self.placement[t], self.metas[t].dim_bytes)
                     for t in tids))
        meta = (ctids, usig, sig)
        if len(self._tmeta) > 64:
            self._tmeta.clear()
        self._tmeta[id(cq)] = (weakref.ref(cq), meta)
        return meta

    def _virgin_at(self, chunk: ColumnarChunk) -> bool:
        """True when ``chunk`` is the next step of this store's virgin chunk
        sequence: the cursor points at it and nothing else has touched the
        row cache since (cursor carries the expected clock/filled), or the
        store is literally fresh — clock, filled and evictions all zero —
        and the chunk starts the trace."""
        rc = self.row_cache
        v = self._virgin
        if (v is not None and v[0]() is chunk.parent and v[1] == chunk.csize
                and v[2] == chunk.start and v[3] == rc.clock
                and v[4] == rc.filled and rc.evictions == 0):
            return True
        return (chunk.start == 0 and rc.clock == 0 and rc.filled == 0
                and rc.evictions == 0)

    def _acc_latency(self, sm_lat: np.ndarray) -> None:
        """Fold the chunk's SM times into the latency accumulator in arrival
        order. Float addition is not associative, but ``np.cumsum`` is the
        same strict left-to-right fold as ``serve_query``'s running sum, so
        the total matches the sequential path bit for bit."""
        self.stats.latency_us = float(np.cumsum(np.concatenate(
            [[self.stats.latency_us],
             np.maximum(sm_lat, self.cfg.item_time_us)]))[-1])
        if self.io.integrity is not None:
            self._sync_integrity()

    def _serve_fused(self, chunk: ColumnarChunk, meta, bg_iops: float,
                     arrivals_us) -> Optional[Tuple[np.ndarray, np.ndarray]]:
        """Try the fused replay tiers; ``None`` means take the live path."""
        ctids, usig, sig = meta
        nq = chunk.n_queries
        if not ctids and not usig:
            # trivial tier: FM_DIRECT-only trace — no SM IO, no cache state
            sm_lat = np.zeros(nq, np.float64)
            self._note_tier("trivial")
            self._acc_latency(sm_lat)
            return sm_lat, np.zeros(nq, np.int64)
        fact = chunk.plan_factor_peek(ctids)
        if fact is None:
            return None
        rc = self.row_cache
        lite = self._chunk_plans.get(id(fact))
        if lite is not None and lite[1] == rc.evictions:
            out = self._serve_resident(chunk, fact, lite, sig,
                                       bg_iops, arrivals_us)
            if out is not None:
                return out
        e = fact.get(("virgin", sig))
        if (e is not None and rc.evictions == 0
                and rc.clock == e["clock0"] and rc.filled == e["fill0"]
                and self._virgin_at(chunk)):
            return self._virgin_replay(chunk, fact, e, bg_iops, arrivals_us)
        return None

    def _serve_resident(self, chunk: ColumnarChunk, fact: dict, lite, sig,
                        bg_iops: float, arrivals_us):
        """Warm steady state: every key resident, no eviction since the plan
        was cached — replay ``commit``'s stamp scatter from precomputed flat
        indices and all-hit events; IO only for uncached tables (cached
        shape arrays)."""
        try:
            uio = fact[("uio", sig)]
        except KeyError:
            return None                  # uncached IO shapes not cached yet
        evc = fact.get("evh")
        if evc is None:
            seg = fact.get("seg")
            if seg is None:
                return None
            # all-hit event ranks (state-independent): each key's stamp is
            # its last touch in sequential arrival order
            aq_c, lens_c, tpos_c, seg_id, ev_width = seg
            last = np.empty(len(lite[0]["uniq"]), np.int64)
            last[fact["inv"]] = seg_id
            ev = (aq_c[last] * ev_width + tpos_c[last]) * 2
            evc = (ev, int(ev.max()) if len(ev) else 0)
            fact["evh"] = evc
        ev, ev_max = evc
        rc = self.row_cache
        st = self.stats
        ek = len(fact["inv"])
        st.row_lookups += ek
        st.row_hits += ek
        rc.hits += ek
        rc.stamp.reshape(-1)[lite[3]] = rc.clock + 1 + ev
        rc.clock += 1 + ev_max
        nq = chunk.n_queries
        sm_lat = np.zeros(nq, np.float64)
        if uio is None:
            ios_q = np.zeros(nq, np.int64)
        else:
            u_aq, u_ios, u_rb, uq_ios, tot = uio
            st.sm_ios += tot
            at = (None if arrivals_us is None
                  else np.asarray(arrivals_us, np.float64)[u_aq])
            lats, _ = self.io.submit_batch_multi(u_ios, u_rb, bg_iops,
                                                 at_us=at)
            np.maximum.at(sm_lat, u_aq, lats)
            ios_q = uq_ios.copy()
        self.chunk_plan_hits += 1
        self._note_tier("resident")
        self._acc_latency(sm_lat)
        return sm_lat, ios_q

    def _virgin_replay(self, chunk: ColumnarChunk, fact: dict, e: dict,
                       bg_iops: float, arrivals_us):
        """Apply a captured cold-chunk state transition to a store whose
        row-cache state signature matches the capture's exactly."""
        rc = self.row_cache
        st = self.stats
        ek = e["ek"]
        if ek:
            st.row_lookups += ek
            st.row_hits += e["nh"]
            rc.hits += e["nh"]
            rc.misses += ek - e["nh"]
        if e["has_plan"]:
            rc.stamp.reshape(-1)[e["flat"]] = rc.clock + 1 + e["ev"]
            if e["n_new"]:
                rc.tags.reshape(-1)[e["new_flat"]] = e["new_keys"]
                rc.filled += e["n_new"]
            rc.clock += 1 + e["ev_max"]
        st.sm_ios += e["sm_ios"]
        nq = chunk.n_queries
        sm_lat = np.zeros(nq, np.float64)
        if e["cat_aq"] is None:
            ios_q = np.zeros(nq, np.int64)
        else:
            at = (None if arrivals_us is None
                  else np.asarray(arrivals_us, np.float64)[e["cat_aq"]])
            lats, _ = self.io.submit_batch_multi(e["cat_ios"], e["cat_rb"],
                                                 bg_iops, at_us=at)
            np.maximum.at(sm_lat, e["cat_aq"], lats)
            ios_q = e["ios_q"].copy()
        if e["lite"] is not None:       # all keys resident now: warm replays
            if len(self._chunk_plans) > 4096:
                self._chunk_plans.clear()
            self._chunk_plans[id(fact)] = (e["lite"], rc.evictions, fact,
                                           e["flat"])
        self._virgin = (weakref.ref(chunk.parent), chunk.csize,
                        chunk.start + chunk.csize, rc.clock, rc.filled)
        self.chunk_plan_hits += 1
        self._note_tier("virgin")
        self._acc_latency(sm_lat)
        return sm_lat, ios_q

    def _fused_capture(self, chunk: ColumnarChunk, fact: dict, cap: dict,
                       plan, events, io_aq, io_ios, io_rb, n_cached_io: int,
                       cat_aq, cat_ios, cat_rb, ios_q: np.ndarray,
                       nq: int) -> None:
        """Park this live serve's replay state on the chunk's factorization
        entry: the uncached-IO shapes always (state-independent, feeds the
        resident tier), and — when the serve extended this store's virgin
        sequence — the full state transition for the virgin tier."""
        sig = cap["sig"]
        if ("uio", sig) not in fact:
            if len(io_aq) > n_cached_io:
                u_aq = np.concatenate(io_aq[n_cached_io:])
                u_ios = np.concatenate(io_ios[n_cached_io:])
                u_rb = np.concatenate(io_rb[n_cached_io:])
                uq_ios = np.zeros(nq, np.int64)
                np.add.at(uq_ios, u_aq, u_ios)
                fact[("uio", sig)] = (u_aq, u_ios, u_rb, uq_ios,
                                      int(u_ios.sum()))
            else:
                fact[("uio", sig)] = None
        if not cap["virgin"]:
            self._virgin = None
            return
        st = self.stats
        e = {"clock0": cap["clock0"], "fill0": cap["fill0"],
             "ek": st.row_lookups - cap["lk0"],
             "nh": st.row_hits - cap["hits0"],
             "sm_ios": st.sm_ios - cap["ios0"],
             "has_plan": plan is not None, "lite": None,
             "cat_aq": cat_aq, "cat_ios": cat_ios, "cat_rb": cat_rb,
             "ios_q": ios_q.copy() if cat_aq is not None else None}
        if plan is not None:
            flat = (plan["sets"] * np.int64(self.row_cache.ways)
                    + plan["way"])
            absent = (np.zeros(len(plan["uniq"]), bool)
                      if plan.get("all_present") else ~plan["present"])
            e.update(
                flat=flat, ev=events,
                ev_max=int(events.max()) if len(events) else 0,
                new_flat=flat[absent], new_keys=plan["uniq"][absent],
                n_new=int(absent.sum()),
                lite={"uniq": plan["uniq"], "sets": plan["sets"],
                      "way": plan["way"], "all_present": True})
        fact[("virgin", sig)] = e
        rc = self.row_cache
        self._virgin = (weakref.ref(chunk.parent), chunk.csize,
                        chunk.start + chunk.csize, rc.clock, rc.filled)

    def serve_batch(self, requests_list: Sequence[Dict[int, np.ndarray]],
                    bg_iops: float = 0.0,
                    arrivals_us: Optional[np.ndarray] = None
                    ) -> List[QueryStats]:
        """Dict-of-arrays compatibility wrapper: converts the batch to
        columnar form and serves it through :meth:`serve_columnar`.
        Bit-identical to calling :meth:`serve_query` per request in order."""
        nq = len(requests_list)
        if nq == 0:
            return []
        chunk = ColumnarQueries.from_requests(requests_list).whole()
        sm_lat, ios_q = self.serve_columnar(chunk, bg_iops, arrivals_us)
        item = self.cfg.item_time_us
        out = []
        for q in range(nq):
            t = float(sm_lat[q])
            out.append(QueryStats(latency_us=max(item, t),
                                  sm_ios=int(ios_q[q]), sm_time_us=t))
        return out

    # -- legacy dict-of-arrays data plane --------------------------------------
    #
    # The pre-columnar batched implementation, kept verbatim: it re-derives
    # per-table groupings from the request dicts with O(batch x tables)
    # Python loops on every call. It serves two purposes: (a) the baseline
    # ``benchmarks/perf_trace.py`` times the columnar plane against, and
    # (b) a third, independently-implemented oracle for the differential
    # test suites (sequential serve_query == serve_batch_dict ==
    # serve_columnar, bit for bit).

    def serve_batch_dict(self, requests_list: Sequence[Dict[int, np.ndarray]],
                         bg_iops: float = 0.0,
                         arrivals_us: Optional[np.ndarray] = None
                         ) -> List[QueryStats]:
        """Serve a batch of query dicts through the legacy dict plane.
        Bit-identical to :meth:`serve_query` per request in order (and so to
        :meth:`serve_columnar` on the same queries)."""
        nq = len(requests_list)
        if nq == 0:
            return []
        self._virgin = None
        seen = set()
        table_order = [tid for req in requests_list for tid in req
                       if not (tid in seen or seen.add(tid))]
        per_table = {}           # tid -> (qids, all_idx, lens)
        for tid in table_order:
            qids = [q for q, req in enumerate(requests_list) if tid in req]
            all_idx = [np.asarray(requests_list[q][tid]) for q in qids]
            lens = np.array([len(i) for i in all_idx], np.int64)
            per_table[tid] = (qids, all_idx, lens)
        if not self._pooled_headroom_dict(per_table):
            self.batch_fallbacks += 1
            if arrivals_us is None:
                return [self.serve_query(r, bg_iops) for r in requests_list]
            return [self.serve_query(r, bg_iops, at_us=float(at))
                    for r, at in zip(requests_list, arrivals_us)]

        # pre-flight row-cache plan over every cached table's keys
        spans = {}
        key_parts = []
        ofs = 0
        for tid in table_order:
            if self.placement[tid] != plc.SM_CACHED:
                continue
            _, all_idx, lens = per_table[tid]
            n = int(lens.sum())
            if n:
                key_parts.append(self.row_cache.make_keys(
                    tid, np.concatenate(all_idx)))
            spans[tid] = (ofs, ofs + n)
            ofs += n
        plan = None
        if ofs:
            plan = self.row_cache.batch_plan(np.concatenate(key_parts))
            if plan is None:     # an eviction would occur; nothing mutated yet
                self.batch_fallbacks += 1
                return [self.serve_query(r, bg_iops) for r in requests_list]
            self._key_events = np.full(len(plan["uniq"]), -1, np.int64)

        # sequential-arrival event ranking: (query, table position within
        # the query, probe-vs-fill)
        self._tpos = {(q, tid): p for q, req in enumerate(requests_list)
                      for p, tid in enumerate(req)}
        self._ev_width = 1 + max(len(req) for req in requests_list)
        self._pooled_touch = []
        self._io_req = []

        sm_lat = np.zeros(nq, np.float64)
        ios_q = np.zeros(nq, np.int64)
        for tid in table_order:
            self._serve_table_dict(tid, per_table[tid], plan,
                                   spans.get(tid), sm_lat, ios_q)
        if self._io_req:
            cat_aq = np.concatenate([r[0] for r in self._io_req])
            cat_ios = np.concatenate([r[1] for r in self._io_req])
            cat_rb = np.concatenate([np.full(len(r[1]), r[2], np.int64)
                                     for r in self._io_req])
            at = (None if arrivals_us is None
                  else np.asarray(arrivals_us, np.float64)[cat_aq])
            lats, _ = self.io.submit_batch_multi(cat_ios, cat_rb, bg_iops,
                                                 at_us=at)
            np.maximum.at(sm_lat, cat_aq, lats)
        self._io_req = []
        if plan is not None:
            used = np.nonzero(self._key_events >= 0)[0]
            self.row_cache.commit(plan, used, self._key_events[used])
            self._key_events = None
        if self.pooled_cache is not None and self._pooled_touch:
            store = self.pooled_cache.store
            for _, _, k in sorted(self._pooled_touch):
                if k in store:
                    store.move_to_end(k)
        self._pooled_touch = []

        out = []
        for q in range(nq):
            qs = QueryStats(latency_us=max(self.cfg.item_time_us, sm_lat[q]),
                            sm_ios=int(ios_q[q]), sm_time_us=float(sm_lat[q]))
            self.stats.latency_us += qs.latency_us
            out.append(qs)
        if self.io.integrity is not None:
            self._sync_integrity()
        return out

    def _pooled_headroom_dict(self, per_table) -> bool:
        if self.pooled_cache is None:
            return True
        thr = self.pooled_cache.len_threshold
        worst = 0
        for tid, (_, _, lens) in per_table.items():
            if self.placement[tid] == plc.FM_DIRECT:
                continue
            dim = (self.payloads[tid].shape[1] if tid in self.payloads else 1)
            worst += int((lens > thr).sum()) * (dim * 4 + 24)
        return self.pooled_cache.used + worst <= self.pooled_cache.capacity

    def _serve_table_dict(self, tid: int, table_data, plan, span,
                          sm_lat: np.ndarray, ios_q: np.ndarray) -> None:
        qids, all_idx, all_lens = table_data
        m = self.metas[tid]
        place = self.placement[tid]
        st = self.stats
        if place == plc.FM_DIRECT:
            return  # FM gather; no SM IO, no pooled participation

        # pooled-cache probe, in arrival order
        active: List[int] = []          # query id per active request
        a_pos: List[int] = []           # position among this table's requests
        idxs: List[np.ndarray] = []
        keys: List[Optional[int]] = []
        if self.pooled_cache is not None:
            pc = self.pooled_cache
            offs = np.zeros(len(qids), np.int64)
            np.cumsum(all_lens[:-1], out=offs[1:])
            np.minimum(offs, max(int(all_lens.sum()) - 1, 0), out=offs)
            hashes = order_invariant_hash_batch(
                tid, np.concatenate(all_idx) if len(all_idx) else
                np.zeros(0, np.int64), offs)
            pending = set()
            hlist = hashes.tolist()
            llist = all_lens.tolist()
            thr = pc.len_threshold
            for i, q in enumerate(qids):
                st.pooled_lookups += 1
                if llist[i] <= thr:
                    pc.skipped += 1
                    active.append(q)
                    a_pos.append(i)
                    idxs.append(all_idx[i])
                    keys.append(None)
                    continue
                k = hlist[i]
                if k in pending:
                    pc.note_pending_hit(llist[i])
                    st.pooled_hits += 1
                    self._pooled_touch.append((q, self._tpos[(q, tid)], k))
                elif pc.lookup_hashed(k, llist[i]) is not None:
                    st.pooled_hits += 1
                    self._pooled_touch.append((q, self._tpos[(q, tid)], k))
                else:
                    pending.add(k)
                    active.append(q)
                    a_pos.append(i)
                    idxs.append(all_idx[i])
                    keys.append(k)
                    self._pooled_touch.append((q, self._tpos[(q, tid)], k))
        else:
            active = list(qids)
            a_pos = list(range(len(qids)))
            idxs = all_idx
        if not active:
            return

        na = len(active)
        lens = all_lens[a_pos]
        if place == plc.SM_CACHED and int(lens.sum()) == 0:
            ios = np.zeros(na, np.int64)
        elif place == plc.SM_CACHED:
            inv_sub = plan["inv"][span[0]:span[1]]
            if na != len(qids):
                active_mask = np.zeros(len(qids), bool)
                active_mask[a_pos] = True
                inv_sub = inv_sub[np.repeat(active_mask, all_lens)]
            labels = np.repeat(np.arange(na, dtype=np.int64), lens)
            ids, first_pos = np.unique(inv_sub, return_index=True)
            first_lab = labels[first_pos]
            present = plan["present"]
            loc = np.searchsorted(ids, inv_sub)
            elem_hit = present[inv_sub] | (labels > first_lab[loc])
            nh = int(elem_hit.sum())
            st.row_lookups += len(inv_sub)
            st.row_hits += nh
            self.row_cache.hits += nh
            self.row_cache.misses += len(inv_sub) - nh
            miss = ~present[ids]
            ios = np.bincount(first_lab[miss], minlength=na)
            last_lab = np.zeros(len(ids), np.int64)
            last_lab[loc] = labels
            fill_last = miss & (last_lab == first_lab)
            aq = np.asarray(active)
            tpos = np.array([self._tpos[(q, tid)] for q in active], np.int64)
            self._key_events[ids] = ((aq[last_lab] * self._ev_width
                                      + tpos[last_lab]) * 2 + fill_last)
        else:  # SM_UNCACHED: every lookup is an IO
            ios = lens
        st.sm_ios += int(ios.sum())

        aq = np.asarray(active)
        self._io_req.append((aq, ios, m.dim_bytes))
        ios_q[aq] += ios

        # pooled-cache fill (+ pooled vectors when payloads are materialized)
        if tid in self.payloads:
            tbl = self.payloads[tid]
            cat = np.concatenate(idxs)
            offs = np.zeros(na, np.int64)
            np.cumsum(lens[:-1], out=offs[1:])
            np.minimum(offs, max(cat.size - 1, 0), out=offs)
            vecs = (np.add.reduceat(tbl[cat % tbl.shape[0]], offs, axis=0)
                    if cat.size else np.zeros((na, tbl.shape[1]), np.float32))
            if self.pooled_cache is not None:
                for i, k in enumerate(keys):
                    if k is not None:
                        self.pooled_cache.insert_hashed(k, vecs[i])
        elif self.pooled_cache is not None:
            for k in keys:
                if k is not None:
                    self.pooled_cache.insert_hashed(k, np.zeros(1, np.float32))

    def _serve_fallback(self, chunk: ColumnarChunk, bg_iops: float,
                        arrivals_us: Optional[np.ndarray] = None
                        ) -> Tuple[np.ndarray, np.ndarray]:
        """Exact sequential path for eviction-bound chunks (nothing has been
        mutated when this is taken, so it is bit-exact)."""
        self.batch_fallbacks += 1
        self._note_tier("fallback")
        if arrivals_us is None:
            stats = [self.serve_query(r, bg_iops) for r in chunk.requests()]
        else:
            stats = [self.serve_query(r, bg_iops, at_us=float(at))
                     for r, at in zip(chunk.requests(), arrivals_us)]
        return (np.array([s.sm_time_us for s in stats], np.float64),
                np.array([s.sm_ios for s in stats], np.int64))

    def _pooled_headroom(self, views: Sequence[TableView]) -> bool:
        """True when the pooled cache cannot evict during this chunk (so the
        per-table processing order is exactly equivalent to arrival order)."""
        if self.pooled_cache is None:
            return True
        thr = self.pooled_cache.len_threshold
        worst = 0
        for v in views:
            if self.placement[v.tid] == plc.FM_DIRECT:
                continue
            cnt = int((v.lens > thr).sum())
            if cnt:
                dim = (self.payloads[v.tid].shape[1]
                       if v.tid in self.payloads else 1)
                worst += cnt * (dim * 4 + 24)
        return self.pooled_cache.used + worst <= self.pooled_cache.capacity

    def _pooled_probe(self, v: TableView):
        """Pooled-cache probe for one table's chunk segments, in arrival
        order (hashes are precomputed trace slices; a request whose key an
        earlier chunk request will fill is a "pending hit", exactly as it
        would hit sequentially). Returns ``(a_pos, keys_fill)``: the active
        (missed / below-threshold) segment positions — ``None`` when every
        segment stays active — and the pooled key to fill per active
        segment (``None`` entries are below ``LenThreshold``)."""
        pc = self.pooled_cache
        st = self.stats
        thr = pc.len_threshold
        nseg = len(v.qid)
        hlist = v.hashes.tolist()          # python ints: cheap loop below
        llist = v.lens.tolist()
        qlist = v.qid.tolist()
        plist = v.tpos.tolist()
        touch = self._pooled_touch
        pending = set()
        act: List[int] = []                # position among this table's segs
        keys_fill: List[Optional[int]] = []
        for i in range(nseg):
            st.pooled_lookups += 1
            ln = llist[i]
            if ln <= thr:
                pc.skipped += 1
                act.append(i)
                keys_fill.append(None)     # below threshold: no pooled fill
                continue
            k = hlist[i]
            if k in pending:               # a pending key is never in store
                pc.note_pending_hit(ln)
                st.pooled_hits += 1
                touch.append((qlist[i], plist[i], k))
            elif pc.lookup_hashed(k, ln) is not None:
                st.pooled_hits += 1
                touch.append((qlist[i], plist[i], k))
            else:
                pending.add(k)
                act.append(i)
                keys_fill.append(k)
                touch.append((qlist[i], plist[i], k))
        if len(act) == nseg:
            return None, keys_fill
        return np.asarray(act, np.int64), keys_fill

    def _pooled_fill(self, v: TableView, a_pos: Optional[np.ndarray],
                     keys_fill: List[Optional[int]]) -> None:
        """Insert the pooled vectors (real when payloads are materialized,
        metadata-only otherwise) for one table's active segments."""
        if v.tid in self.payloads:
            tbl = self.payloads[v.tid]
            if a_pos is None:
                cat, lens, na = v.vals, v.lens, len(v.qid)
            else:
                mask = np.zeros(len(v.qid), bool)
                mask[a_pos] = True
                cat = v.vals[np.repeat(mask, v.lens)]
                lens = v.lens[a_pos]
                na = len(a_pos)
            offs = np.zeros(na, np.int64)
            np.cumsum(lens[:-1], out=offs[1:])
            np.minimum(offs, max(cat.size - 1, 0), out=offs)
            vecs = (np.add.reduceat(tbl[cat % tbl.shape[0]], offs, axis=0)
                    if cat.size else np.zeros((na, tbl.shape[1]), np.float32))
            for i, k in enumerate(keys_fill):
                if k is not None:
                    self.pooled_cache.insert_hashed(k, vecs[i])
        else:
            for k in keys_fill:
                if k is not None:
                    self.pooled_cache.insert_hashed(k, np.zeros(1, np.float32))

    # -- trace helpers --------------------------------------------------------

    def synth_query(self, *, user_only: bool = True) -> Dict[int, np.ndarray]:
        out = {}
        for m in self.metas.values():
            if user_only and m.kind != "user":
                continue
            out[m.table_id] = zipf_indices(self.rng, m.num_rows, m.zipf_alpha,
                                           m.pooling_factor)
        return out

    @property
    def row_hit_rate(self) -> float:
        s = self.stats
        return s.row_hits / s.row_lookups if s.row_lookups else 0.0

    @property
    def pooled_hit_rate(self) -> float:
        s = self.stats
        return s.pooled_hits / s.pooled_lookups if s.pooled_lookups else 0.0
