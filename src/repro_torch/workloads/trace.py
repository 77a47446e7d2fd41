"""Trace objects + arrival/index processes for the workload engine.

A :class:`Trace` is the unit the serving layer consumes: per query an
absolute arrival time, a tenant id and an embedding-bag request over the
user-side tables. Requests are stored **columnar** (one flat index array +
CSR offsets per (query, table) segment — :class:`~repro_torch.core.columnar.
ColumnarQueries`), so chunking, route-splitting and the per-table grouping
the serving engine needs are array slices, not Python list/dict copies; the
``requests`` property is the dict-of-arrays compatibility view. Traces are
fully determined by their spec + seed — building the same spec twice yields
bit-identical arrays — so every benchmark and differential test can replay
them.

Arrival processes (all times in microseconds):

* :func:`poisson_arrivals` — constant-rate Poisson (exponential gaps).
* :func:`nonhomogeneous_arrivals` — thinning against a peak rate; the
  diurnal archetype passes a sinusoidal rate function (day-shaped traffic).
* :func:`mmpp_arrivals` — 2-state Markov-modulated Poisson (quiet/burst),
  the standard bursty-traffic model; long-run rate matches ``rate_qps``.

:func:`zipf_indices_drift` generalizes ``locality.zipf_indices`` with an
epoch term in the rank permutation: advancing the epoch rotates which rows
are hot (temporal popularity drift) while preserving the Zipf shape.

A copy of ``repro.workloads.trace`` (``tests/test_torch_workloads.py``).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Iterator, List, Sequence, Tuple

import numpy as np

from repro_torch.core.columnar import ColumnarChunk, ColumnarQueries
from repro_torch.core.locality import TableMeta

_DRIFT_SALT = np.uint64(0xA24BAED4963EE407)
_PERM_MULT = np.uint64(0x9E3779B97F4A7C15)


# -- index processes ----------------------------------------------------------


def zipf_indices_drift(rng: np.random.Generator, num_rows: int, alpha: float,
                       size: int, epoch: int = 0,
                       blend: float = 0.0) -> np.ndarray:
    """Zipf-distributed row ids whose hot set rotates with ``epoch``.

    Epoch 0 reproduces ``locality.zipf_indices`` exactly. ``blend`` in [0, 1)
    sends that fraction of draws through the *next* epoch's permutation, so
    popularity shifts smoothly instead of jumping at epoch boundaries.
    """
    ranks = np.minimum(rng.zipf(alpha, size=size), num_rows) - 1
    e = np.full(size, epoch, np.uint64)
    if blend > 0.0:
        e += rng.random(size) < blend
    x = ranks.astype(np.uint64) + e * _DRIFT_SALT
    x = (x * _PERM_MULT) >> np.uint64(17)
    return (x % np.uint64(num_rows)).astype(np.int64)


def zipf_indices_drift_flat(rng: np.random.Generator, num_rows: int,
                            alpha: float, sizes: np.ndarray,
                            epochs: np.ndarray,
                            blend: float = 0.0) -> np.ndarray:
    """Vectorized :func:`zipf_indices_drift` over many segments at once.

    Segment ``i`` draws ``sizes[i]`` row ids at drift epoch ``epochs[i]``;
    the result is the flat concatenation (CSR value stream). One ``rng.zipf``
    call covers the whole batch — the per-block form the streaming trace
    generator uses instead of ``build_trace``'s per-segment calls (same
    permutation math, different RNG consumption order).
    """
    sizes = np.asarray(sizes, np.int64)
    tot = int(sizes.sum())
    if tot == 0:
        return np.zeros(0, np.int64)
    ranks = np.minimum(rng.zipf(alpha, size=tot), num_rows) - 1
    e = np.repeat(np.asarray(epochs, np.uint64), sizes)
    if blend > 0.0:
        e = e + (rng.random(tot) < blend)
    x = ranks.astype(np.uint64) + e * _DRIFT_SALT
    x = (x * _PERM_MULT) >> np.uint64(17)
    return (x % np.uint64(num_rows)).astype(np.int64)


# -- arrival processes --------------------------------------------------------


def poisson_arrivals(rng: np.random.Generator, n: int,
                     rate_qps: float) -> np.ndarray:
    """Constant-rate Poisson arrivals: n cumulative exponential gaps (us)."""
    return np.cumsum(rng.exponential(1e6 / rate_qps, size=n))


def nonhomogeneous_arrivals(rng: np.random.Generator, n: int, peak_qps: float,
                            rate_fn: Callable[[np.ndarray], np.ndarray]
                            ) -> np.ndarray:
    """Nonhomogeneous Poisson via thinning: candidates at ``peak_qps`` are
    kept with probability ``rate_fn(t) / peak_qps``. ``rate_fn`` maps
    absolute time (us) to instantaneous rate and must stay <= ``peak_qps``."""
    if n <= 0:
        return np.empty(0, np.float64)
    out: List[np.ndarray] = []
    got, t0 = 0, 0.0
    while got < n:
        m = max(64, int((n - got) * 1.8))
        cand = t0 + np.cumsum(rng.exponential(1e6 / peak_qps, size=m))
        keep = cand[rng.random(m) * peak_qps < rate_fn(cand)]
        out.append(keep)
        got += len(keep)
        t0 = float(cand[-1])
    return np.concatenate(out)[:n]


def mmpp_arrivals(rng: np.random.Generator, n: int, rate_qps: float,
                  burst_mult: float = 8.0, mean_burst_us: float = 2e4,
                  mean_quiet_us: float = 8e4) -> np.ndarray:
    """2-state MMPP (quiet <-> burst). The quiet-state rate is solved so the
    long-run average equals ``rate_qps``; burst intervals run at
    ``burst_mult`` times that rate. Starts in the burst state so even short
    traces exhibit at least one burst."""
    if n <= 0:
        return np.empty(0, np.float64)
    span = mean_quiet_us + mean_burst_us
    quiet_rate = rate_qps * span / (mean_quiet_us + burst_mult * mean_burst_us)
    rates = (quiet_rate, quiet_rate * burst_mult)
    means = (mean_quiet_us, mean_burst_us)
    out: List[np.ndarray] = []
    got, t0, state = 0, 0.0, 1
    while got < n:
        dur = rng.exponential(means[state])
        # arrivals inside this interval: exponential gaps until the interval
        # ends (cap generously; excess is trimmed below)
        m = max(16, int(dur * rates[state] / 1e6 * 2) + 16)
        gaps = rng.exponential(1e6 / rates[state], size=m)
        ts = t0 + np.cumsum(gaps)
        ts = ts[ts < t0 + dur]
        out.append(ts)
        got += len(ts)
        t0 += dur
        state ^= 1
    return np.concatenate(out)[:n]


# -- the trace object ---------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class TraceChunk:
    """One vectorized serving batch sliced out of a trace.

    ``columnar`` is the CSR view the fast path consumes
    (``DeviceServingEngine.serve_columnar``); ``requests``
    materializes the dict-of-arrays compatibility view on demand.
    """
    start: int
    columnar: ColumnarChunk
    arrival_us: np.ndarray
    tenant: np.ndarray

    @property
    def requests(self) -> List[Dict[int, np.ndarray]]:
        return self.columnar.requests()


@dataclasses.dataclass
class Trace:
    """A replayable stream of timed, tenant-tagged embedding-bag queries."""
    name: str
    seed: int
    arrival_us: np.ndarray                    # [N] f64, nondecreasing
    tenant: np.ndarray                        # [N] i64 -> index into tenant_names
    tenant_names: Tuple[str, ...]
    queries: ColumnarQueries                  # columnar (CSR) request store
    metas: Dict[str, List[TableMeta]]         # per-tenant inventory, global ids

    @classmethod
    def from_requests(cls, name: str, seed: int, arrival_us: np.ndarray,
                      tenant: np.ndarray, tenant_names: Tuple[str, ...],
                      requests: Sequence[Dict[int, np.ndarray]],
                      metas: Dict[str, List[TableMeta]]) -> "Trace":
        """Build a trace from per-query request dicts (compat constructor)."""
        return cls(name, seed, arrival_us, tenant, tenant_names,
                   ColumnarQueries.from_requests(requests), metas)

    @property
    def requests(self) -> List[Dict[int, np.ndarray]]:
        """Dict-of-arrays view of the columnar store (cached)."""
        return self.queries.requests()

    def __len__(self) -> int:
        return len(self.arrival_us)

    @property
    def duration_us(self) -> float:
        return float(self.arrival_us[-1]) if len(self.arrival_us) else 0.0

    @property
    def offered_qps(self) -> float:
        d = self.duration_us
        return len(self) / d * 1e6 if d > 0 else 0.0

    def all_metas(self) -> List[TableMeta]:
        """The union inventory (global table ids are disjoint by tenant)."""
        return [m for ms in self.metas.values() for m in ms]

    def chunks(self, batch: int) -> Iterator[TraceChunk]:
        """Arrival-order batches; each chunk's columnar view slices the
        trace-level table grouping (computed once, cached on ``queries``)."""
        for s in range(0, len(self), batch):
            e = min(s + batch, len(self))
            yield TraceChunk(s, self.queries.chunk(s, e, batch),
                             self.arrival_us[s:e], self.tenant[s:e])

    def subset(self, mask: np.ndarray) -> "Trace":
        """Route-split view: the queries where ``mask`` is True (arrival
        order preserved). Pure array slicing — O(segments), no dict copies;
        metas are shared, not copied. A subset selecting every query (the
        single-host route split) shares the columnar store itself, so its
        cached grouping and plan factorizations survive across repeated
        serving runs over the same trace."""
        idx = np.nonzero(np.asarray(mask))[0]
        if len(idx) == len(self):
            return Trace(self.name, self.seed, self.arrival_us, self.tenant,
                         self.tenant_names, self.queries, self.metas)
        return Trace(self.name, self.seed, self.arrival_us[idx],
                     self.tenant[idx], self.tenant_names,
                     self.queries.subset(idx), self.metas)


def slice_trace(tr: Trace, a: int, b: int) -> Trace:
    """Contiguous query-range ``[a, b)`` of a trace as a standalone trace
    (metas/tenant names shared; the columnar store is gathered)."""
    return Trace(tr.name, tr.seed, tr.arrival_us[a:b], tr.tenant[a:b],
                 tr.tenant_names, tr.queries.subset(np.arange(a, b)),
                 tr.metas)


def concat_traces(parts: Sequence[Trace]) -> Trace:
    """Concatenate traces with the same tenancy/metas along the query axis
    — the streaming plane's piece-assembly primitive. O(total) array
    concatenation; CSR offsets are rebased, never recomputed."""
    if not parts:
        raise ValueError("concat_traces needs at least one trace")
    if len(parts) == 1:
        return parts[0]
    head = parts[0]
    qs = [p.queries for p in parts]
    voff = np.cumsum([0] + [len(q.values) for q in qs])
    soff = np.cumsum([0] + [len(q.seg_table) for q in qs])
    seg_offsets = np.concatenate(
        [qs[0].seg_offsets] + [q.seg_offsets[1:] + voff[i]
                               for i, q in enumerate(qs) if i])
    query_seg = np.concatenate(
        [qs[0].query_seg] + [q.query_seg[1:] + soff[i]
                             for i, q in enumerate(qs) if i])
    cq = ColumnarQueries(np.concatenate([q.values for q in qs]), seg_offsets,
                         np.concatenate([q.seg_table for q in qs]), query_seg)
    return Trace(head.name, head.seed,
                 np.concatenate([p.arrival_us for p in parts]),
                 np.concatenate([p.tenant for p in parts]),
                 head.tenant_names, cq, head.metas)


def windowed_qps(arrival_us: np.ndarray, duration_us: float,
                 windows: int = 16) -> np.ndarray:
    """Arrival rate (QPS) per equal time window over ``[0, duration_us]``."""
    width = duration_us / windows
    counts, _ = np.histogram(arrival_us, bins=windows, range=(0.0, duration_us))
    return counts / width * 1e6


def interleave_arrivals(parts: Sequence[np.ndarray]) -> Tuple[np.ndarray, np.ndarray]:
    """Merge per-stream arrival arrays into one sorted stream.

    Returns (merged times, source id per merged element). Stable for ties.
    """
    times = np.concatenate(parts)
    src = np.concatenate([np.full(len(p), i, np.int64)
                          for i, p in enumerate(parts)])
    order = np.argsort(times, kind="stable")
    return times[order], src[order]
