"""Serving scheduler: inter-op parallelism + IO/compute overlap (App. A.2).

The paper's observation: embedding ops whose tables live on SM *block on IO*;
executing them asynchronously alongside (a) other embedding ops and (b) the
dense compute hides SM latency under item-side time (Eq. 3) — they report 20%
latency reduction -> 20% QPS at iso-latency for M1.

This scheduler models a host serving loop: per query it issues all SM-table
IO batches up front (async, io_uring-style), runs FM-side work while they are
in flight, and completes pooling as each IO batch lands. Admission control
bounds in-flight IOs by the device's IOPS envelope (§4.1 Tuning API) with an
event-driven ledger: every admitted query pushes a completion event at
``now + sm_time`` onto a heap, queries arrive ``arrival_gap_us`` apart, and
events that have landed by a query's arrival drain the in-flight counter
first. Time is simulated from the analytic device model — the same code path
a real host would drive with actual completions.

``serve`` handles one query; ``serve_columnar`` pushes a columnar (CSR)
chunk through the vectorized ``SDMEmbeddingStore.serve_columnar`` data plane
and then retires the admission ledger *vectorized per chunk*: pending
completion events live in a sorted array, one ``searchsorted`` per chunk
finds how many have landed by each arrival, and the whole chunk commits at
once when no query would be deferred (the rare saturated chunk replays
through the exact per-query ledger — nothing has been mutated at that
point). ``serve_trace`` drives a whole trace through it chunk by chunk;
``serve_batch`` is the dict-of-arrays wrapper. All paths yield identical
results, bit for bit.

A copy of ``repro.runtime.serve_sched`` (``tests/test_torch_sdm.py``).
"""
from __future__ import annotations

import dataclasses
import heapq
from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch.core.columnar import ColumnarChunk
from repro_torch.core.sdm import QueryStats, SDMEmbeddingStore


@dataclasses.dataclass
class ServeConfig:
    inter_op_parallel: bool = True        # A.2: async embedding ops
    max_inflight_ios: int = 1 << 16       # admission control (Tuning API)
    item_compute_us: float = 200.0        # dense/FM side per query
    latency_target_us: float = 10_000.0
    arrival_gap_us: Optional[float] = None  # None -> item_compute_us


@dataclasses.dataclass
class QueryResult:
    latency_us: float
    sm_ios: int
    admitted: bool = True


class ServeScheduler:
    def __init__(self, store: SDMEmbeddingStore, cfg: ServeConfig):
        self.store = store
        self.cfg = cfg
        self.now_us = 0.0
        self.inflight = 0
        self.deferred = 0                      # admission-control rejections
        self._events: List[tuple] = []         # (completion_time_us, ios)
        self.p_lat: List[float] = []
        self.telemetry = None                  # obs handle; None = invisible

    # -- event-driven in-flight ledger ---------------------------------------

    def _advance(self, at_us: Optional[float] = None) -> None:
        """One arrival tick: move the clock and retire completed IO batches.

        Without ``at_us`` the clock steps by the configured arrival gap
        (synthetic constant-rate traffic); with it the clock jumps to the
        query's absolute trace arrival time (trace-driven traffic — the
        clock never moves backwards, so a burst of queries arriving closer
        together than IOs complete genuinely accumulates in-flight IOs)."""
        if at_us is None:
            gap = self.cfg.arrival_gap_us
            self.now_us += self.cfg.item_compute_us if gap is None else gap
        else:
            self.now_us = max(self.now_us, float(at_us))
        while self._events and self._events[0][0] <= self.now_us:
            _, ios = heapq.heappop(self._events)
            self.inflight -= ios

    def _admit(self, qs: QueryStats, at_us: Optional[float] = None) -> QueryResult:
        """Admission + latency assembly for one query's data-plane stats."""
        cfg = self.cfg
        self._advance(at_us)
        if self.inflight + qs.sm_ios > cfg.max_inflight_ios:
            # admission control: defer (counted as one queueing delay unit)
            self.deferred += 1
            return QueryResult(latency_us=cfg.latency_target_us,
                               sm_ios=qs.sm_ios, admitted=False)
        if qs.sm_ios:
            heapq.heappush(self._events, (self.now_us + qs.sm_time_us, qs.sm_ios))
            self.inflight += qs.sm_ios
        if cfg.inter_op_parallel:
            # all embedding-op IO batches fly concurrently and overlap the
            # dense compute: latency = max(compute, slowest IO) (Eq. 3)
            lat = max(cfg.item_compute_us, qs.sm_time_us)
        else:
            # without inter-op async execution the embedding ops' IO is
            # exposed serially after compute (the pre-A.2 operator runtime)
            lat = cfg.item_compute_us + qs.sm_time_us
        self.p_lat.append(lat)
        if self.telemetry is not None:
            self.telemetry.registry.observe("serve.latency_us", lat)
        return QueryResult(latency_us=lat, sm_ios=qs.sm_ios)

    # -- serving entry points -------------------------------------------------

    def serve(self, requests: Dict[int, np.ndarray], bg_iops: float = 0.0,
              at_us: Optional[float] = None) -> QueryResult:
        """requests: {table_id: indices} for the user-side tables.
        ``at_us``: optional absolute arrival time (trace-driven traffic)."""
        return self._admit(self.store.serve_query(requests, bg_iops), at_us)

    def serve_batch(self, requests_list: Sequence[Dict[int, np.ndarray]],
                    bg_iops: float = 0.0,
                    arrivals_us: Optional[Sequence[float]] = None
                    ) -> List[QueryResult]:
        """Batched serving: one vectorized data-plane pass for the whole
        batch, then the admission ledger in arrival order. Produces the same
        results as calling :meth:`serve` per query. ``arrivals_us`` (aligned
        with ``requests_list``) drives the ledger from trace arrival times
        instead of the synthetic constant gap."""
        if arrivals_us is not None and len(arrivals_us) != len(requests_list):
            raise ValueError(
                f"arrivals_us has {len(arrivals_us)} entries for "
                f"{len(requests_list)} requests")
        stats = self.store.serve_batch(requests_list, bg_iops,
                                       arrivals_us=arrivals_us)
        if arrivals_us is None:
            return [self._admit(qs) for qs in stats]
        return [self._admit(qs, at) for qs, at in zip(stats, arrivals_us)]

    def serve_batch_dict(self, requests_list: Sequence[Dict[int, np.ndarray]],
                         bg_iops: float = 0.0,
                         arrivals_us: Optional[Sequence[float]] = None
                         ) -> List[QueryResult]:
        """:meth:`serve_batch` through the legacy dict data plane
        (``SDMEmbeddingStore.serve_batch_dict``) with the per-query ledger —
        the pre-columnar serving path, kept as the perf baseline and as an
        independent differential oracle. Results are bit-identical to every
        other path."""
        if arrivals_us is not None and len(arrivals_us) != len(requests_list):
            raise ValueError(
                f"arrivals_us has {len(arrivals_us)} entries for "
                f"{len(requests_list)} requests")
        stats = self.store.serve_batch_dict(requests_list, bg_iops,
                                            arrivals_us=arrivals_us)
        if arrivals_us is None:
            return [self._admit(qs) for qs in stats]
        return [self._admit(qs, at) for qs, at in zip(stats, arrivals_us)]

    def serve_columnar(self, chunk: ColumnarChunk, bg_iops: float = 0.0,
                       arrivals_us: Optional[np.ndarray] = None,
                       collect: bool = True) -> Optional[List[QueryResult]]:
        """Columnar fast path: the CSR chunk goes through
        ``SDMEmbeddingStore.serve_columnar`` and the admission ledger retires
        vectorized (:meth:`_admit_chunk`). Identical results to
        :meth:`serve_batch` on the chunk's dict view; ``collect=False``
        skips building the per-query ``QueryResult`` list. ``arrivals_us``
        also flows into the data plane, where the sampled device queues
        (``latency_mode="sampled"``) serve each query's IO at its real
        arrival (the analytic plane ignores it)."""
        if arrivals_us is not None and len(arrivals_us) != chunk.n_queries:
            raise ValueError(
                f"arrivals_us has {len(arrivals_us)} entries for "
                f"{chunk.n_queries} requests")
        sm_time, sm_ios = self.store.serve_columnar(chunk, bg_iops,
                                                    arrivals_us=arrivals_us)
        return self._admit_chunk(sm_time, sm_ios, arrivals_us, collect)

    def serve_trace(self, trace, chunk: int = 32, bg_iops: float = 0.0,
                    collect: bool = False) -> Optional[List[QueryResult]]:
        """Serve a whole :class:`~repro_torch.workloads.trace.Trace` through the
        columnar plane in arrival-order chunks (the trace-level per-table
        grouping is computed once and sliced per chunk)."""
        out: Optional[List[QueryResult]] = [] if collect else None
        for ch in trace.chunks(chunk):
            res = self.serve_columnar(ch.columnar, bg_iops,
                                      arrivals_us=ch.arrival_us,
                                      collect=collect)
            if collect:
                out.extend(res)
        return out

    def _admit_chunk(self, sm_time: np.ndarray, sm_ios: np.ndarray,
                     arrivals_us: Optional[np.ndarray],
                     collect: bool) -> Optional[List[QueryResult]]:
        """Vectorized admission for one chunk, bit-identical to per-query
        :meth:`_admit` calls.

        The in-flight trajectory under the no-deferral assumption is exact:
        events retired before query ``q`` = (pending events with completion
        <= arrival_q, via one searchsorted over the sorted event array) +
        (earlier chunk queries whose completion lands before ``arrival_q``).
        If any query would then exceed ``max_inflight_ios``, nothing has
        been committed and the chunk replays through the sequential ledger
        (deferrals change every later admission decision, so only the exact
        path is correct there)."""
        cfg = self.cfg
        n = len(sm_time)
        if n == 0:
            return [] if collect else None
        t0 = self.now_us
        ios = np.asarray(sm_ios, np.int64)
        stime = np.asarray(sm_time, np.float64)
        if not self._events and self.inflight == 0 and not ios.any():
            # idle-ledger shortcut (warm all-hit chunks): nothing in flight,
            # nothing to push or retire — the admission walk collapses to
            # the clock advance and the latency samples. Bit-identical: the
            # generic path below would compute zero retirements everywhere.
            if arrivals_us is None:
                gap = (cfg.item_compute_us if cfg.arrival_gap_us is None
                       else cfg.arrival_gap_us)
                self.now_us = float(np.cumsum(np.concatenate(
                    [[self.now_us], np.full(n, gap)]))[-1])
            else:
                self.now_us = float(np.maximum(
                    np.asarray(arrivals_us, np.float64), self.now_us).max())
            if cfg.inter_op_parallel:
                lat = np.maximum(cfg.item_compute_us, stime)
            else:
                lat = cfg.item_compute_us + stime
            lat_list = lat.tolist()
            self.p_lat.extend(lat_list)
            if self.telemetry is not None:
                self._telemetry_chunk(t0, n, lat, 0)
            if collect:
                return [QueryResult(latency_us=lat_list[q], sm_ios=0)
                        for q in range(n)]
            return None
        if arrivals_us is None:
            gap = (cfg.item_compute_us if cfg.arrival_gap_us is None
                   else cfg.arrival_gap_us)
            # cumsum accumulates left-to-right: identical rounding to the
            # sequential now += gap walk
            now_q = np.cumsum(np.concatenate([[self.now_us],
                                              np.full(n, gap)]))[1:]
        else:
            now_q = np.maximum.accumulate(np.maximum(
                np.asarray(arrivals_us, np.float64), self.now_us))
        # pending completion events retired by each arrival
        if self._events:
            ev = sorted(self._events)
            et = np.array([e[0] for e in ev], np.float64)
            cei = np.cumsum(np.array([e[1] for e in ev], np.int64))
            k = np.searchsorted(et, now_q, side="right")
            retired_prev = np.where(k > 0, cei[np.maximum(k - 1, 0)], 0)
        else:
            ev = []
            et = np.zeros(0, np.float64)
            cei = np.zeros(0, np.int64)
            retired_prev = np.zeros(n, np.int64)
        # within-chunk completions (no-deferral assumption). A query's own
        # event can only retire strictly after its arrival (sm_time > 0
        # whenever sm_ios > 0), so "completion <= arrival_q" implies the
        # pushing query precedes q.
        has = ios > 0
        comp = now_q[has] + stime[has]
        order = np.argsort(comp, kind="stable")
        comp_s = comp[order]
        ios_s = ios[has][order]
        if len(comp_s):
            cis = np.cumsum(ios_s)
            j = np.searchsorted(comp_s, now_q, side="right")
            retired_chunk = np.where(j > 0, cis[np.maximum(j - 1, 0)], 0)
        else:
            retired_chunk = np.zeros(n, np.int64)
        pushed_before = np.concatenate([[0], np.cumsum(ios)[:-1]])
        inflight = (self.inflight + pushed_before
                    - retired_prev - retired_chunk)
        if np.any(inflight + ios > cfg.max_inflight_ios):
            # saturation: replay through the exact per-query ledger (no
            # state has been touched yet)
            at = None if arrivals_us is None else np.asarray(arrivals_us)
            results = [self._admit(
                QueryStats(sm_ios=int(ios[q]), sm_time_us=float(stime[q])),
                None if at is None else float(at[q])) for q in range(n)]
            if self.telemetry is not None:
                # latencies already observed per query inside _admit
                self._telemetry_chunk(t0, n, None, ios)
            return results if collect else None
        # no deferrals: commit the whole chunk at once
        last_now = float(now_q[-1])
        self.now_us = last_now
        self.inflight += int(ios.sum()) - int(retired_prev[-1] if len(et)
                                              else 0)
        if len(comp_s):
            self.inflight -= int(retired_chunk[-1])
        keep = comp_s > last_now
        rem = ([(t, i) for t, i in ev
                if t > last_now] if ev else [])
        rem += list(zip(comp_s[keep].tolist(), ios_s[keep].tolist()))
        rem.sort()                      # a sorted list is a valid heap
        self._events = rem
        if cfg.inter_op_parallel:
            lat = np.maximum(cfg.item_compute_us, stime)
        else:
            lat = cfg.item_compute_us + stime
        lat_list = lat.tolist()
        self.p_lat.extend(lat_list)
        if self.telemetry is not None:
            self._telemetry_chunk(t0, n, lat, ios)
        if collect:
            return [QueryResult(latency_us=lat_list[q], sm_ios=int(ios[q]))
                    for q in range(n)]
        return None

    def _telemetry_chunk(self, t0: float, n: int, lat, ios) -> None:
        """Per-chunk telemetry: chunk latencies into the histogram (``lat``
        is None when the saturated replay already observed them per query),
        the in-flight gauge/track, and a sampled serve span tagged with the
        data-plane tier that handled the chunk. ``ios`` may be an array —
        its sum (span decoration only) is deferred behind the sampling
        gate."""
        tel = self.telemetry
        reg = tel.registry
        if lat is not None:
            reg.hist("serve.latency_us").observe_many(lat)
        reg.hist("sched.inflight_ios").observe(self.inflight)
        tr = tel.tracer
        tr.counter("sched.inflight", self.now_us, self.inflight)
        if tr.want("serve.chunk"):
            ios_total = int(ios.sum()) if isinstance(ios, np.ndarray) else ios
            tr.record("serve.chunk", "serve", t0,
                      max(self.now_us - t0, 0.0), n=n, ios=ios_total,
                      tier=getattr(self.store, "last_tier", ""))

    # -- reporting ------------------------------------------------------------

    def percentile(self, p: float) -> float:
        """Latency percentile over the sample buffer; defined (0.0) when no
        query has been admitted yet — an idle host reports zeros, it does not
        raise. ``len()`` (not truthiness) so a numpy-array buffer works too."""
        if len(self.p_lat) == 0:
            return 0.0
        return float(np.percentile(np.asarray(self.p_lat), p))

    def qps_at_latency(self, target_us: Optional[float] = None,
                       at_percentile: Optional[float] = None) -> float:
        """Feasible QPS: fraction of queries meeting the latency target scaled
        by the ideal service rate (simulation-level Eq. 5). Defined (0.0) on
        an empty sample buffer. ``at_percentile`` judges the service rate at
        that latency percentile instead of the mean — feasibility at p99
        prices the tail a mean-based Eq. 5 cannot see (sampled device plane)."""
        target = target_us or self.cfg.latency_target_us
        if len(self.p_lat) == 0:
            return 0.0
        lat = np.asarray(self.p_lat)
        meeting = (lat <= target).mean()
        ref_lat = (lat.mean() if at_percentile is None
                   else float(np.percentile(lat, at_percentile)))
        return float(meeting * 1e6 / max(ref_lat, 1.0))
