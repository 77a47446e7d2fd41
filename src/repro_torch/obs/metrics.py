"""Metrics registry: named counters, gauges, log2-bucket latency histograms.

The telemetry plane's numeric half. Three design constraints drive it:

* **mergeable + deterministic** — per-host registries produced by thread or
  process workers (and by streamed pieces) merge into the fleet registry by
  plain integer/bucket addition in host order, so the repo's parity oracles
  (serial == thread == process, streamed == materialized) extend to the
  merged telemetry bit for bit. Nothing here consumes RNG or wallclock.
* **bounded hot-path cost** — a histogram observation is one ``frexp`` +
  ``bincount`` over the chunk's latency array; counters are dict adds.
* **picklable** — registries ride back from spawn-context process pools
  inside ``_host_passes`` results (plain dicts + numpy arrays only).

Histogram buckets are fixed powers of two: bucket 0 holds ``[0, 1)`` µs and
bucket ``i`` holds ``[2^(i-1), 2^i)`` µs, so two histograms always share one
geometry and merge by summing counts. Percentiles derived from buckets carry
*bounded bucket error*: :meth:`LatencyHistogram.percentile_bounds` returns
the ``[lo, hi)`` interval the exact order statistic provably lies in.

A copy of ``repro.obs.metrics`` (``tests/test_torch_obs.py``).

This module is also the **canonical counter catalog**: ``HOST_COUNTERS``
maps every control-plane and data-integrity counter to its ``HostReport``
field, its ``ClusterReport`` rollup name, and its registry metric name —
``cluster.py`` generates its sum rollups from it, and
``LINT_FIELD_ALLOWLIST`` lists the exact counter fields each report
dataclass may carry.
"""
from __future__ import annotations

import math
from typing import Dict, Iterable, Sequence, Tuple

import numpy as np

N_BUCKETS = 64          # bucket 63 tops out at 2^63 us (~292k years): plenty


class LatencyHistogram:
    """Fixed-geometry log2 histogram (values in µs, but unit-agnostic).

    ``observe_many`` is lazy: it only appends a copy of the batch (the
    serve hot path pays one array copy, not six numpy kernel launches) and
    the pending batches fold into the buckets on first read — merge,
    export, or percentile. Flush points sit outside the serve loop in every
    execution mode, so the concatenated value sequence (and therefore every
    folded float) is identical across serial/thread/process and
    streamed/materialized runs.
    """

    __slots__ = ("_buckets", "_count", "_sum", "_min", "_max", "_pending",
                 "_pending_s")

    def __init__(self):
        self._buckets = np.zeros(N_BUCKETS, np.int64)
        self._count = 0
        self._sum = 0.0
        self._min = math.inf
        self._max = -math.inf
        self._pending: list = []        # arrays from observe_many
        self._pending_s: list = []      # scalars from observe

    @staticmethod
    def bucket_lo(i: int) -> float:
        return 0.0 if i <= 0 else float(2.0 ** (i - 1))

    @staticmethod
    def bucket_hi(i: int) -> float:
        return math.inf if i >= N_BUCKETS - 1 else float(2.0 ** i)

    def observe(self, value: float) -> None:
        self._pending_s.append(value)

    def observe_many(self, values) -> None:
        # own copy: the caller may mutate its array after observing
        if isinstance(values, np.ndarray) and values.dtype == np.float64:
            v = values.copy()
        else:
            v = np.array(values, np.float64)
        if v.size:
            self._pending.append(v)

    def _flush(self) -> None:
        pend = self._pending
        if self._pending_s:
            # scalars always fold after the array batches: one fixed,
            # mode-invariant order keeps the float sums bit-reproducible
            pend.append(np.asarray(self._pending_s, np.float64))
            self._pending_s = []
        if not pend:
            return
        v = np.concatenate(pend) if len(pend) > 1 else pend[0]
        self._pending = []
        v = np.maximum(v, 0.0)
        # frexp: v = m * 2^e with m in [0.5, 1) -> v in [2^(e-1), 2^e)
        idx = np.clip(np.frexp(v)[1], 0, N_BUCKETS - 1)
        self._buckets += np.bincount(idx, minlength=N_BUCKETS)
        self._count += int(v.size)
        self._sum += float(v.sum())
        self._min = min(self._min, float(v.min()))
        self._max = max(self._max, float(v.max()))

    @property
    def buckets(self) -> np.ndarray:
        self._flush()
        return self._buckets

    @property
    def count(self) -> int:
        self._flush()
        return self._count

    @property
    def sum(self) -> float:
        self._flush()
        return self._sum

    @property
    def min(self) -> float:
        self._flush()
        return self._min

    @property
    def max(self) -> float:
        self._flush()
        return self._max

    def merge(self, other: "LatencyHistogram") -> None:
        self._flush()
        other._flush()
        self._buckets += other._buckets
        self._count += other._count
        self._sum += other._sum
        self._min = min(self._min, other._min)
        self._max = max(self._max, other._max)

    # -- percentile estimates (bounded bucket error) -------------------------

    def percentile_bounds(self, p: float) -> Tuple[float, float]:
        """``[lo, hi)`` interval containing the exact linear-interpolated
        percentile (``np.percentile`` semantics): the interpolation sits
        between the floor- and ceil-rank order statistics, each bounded by
        its bucket."""
        if self.count == 0:
            return (0.0, 0.0)
        cum = np.cumsum(self.buckets)
        q = p / 100.0 * (self.count - 1)
        lo_b = int(np.searchsorted(cum, int(math.floor(q)) + 1))
        hi_b = int(np.searchsorted(cum, int(math.ceil(q)) + 1))
        lo = max(self.bucket_lo(lo_b), 0.0 if self.min is math.inf
                 else self.min)
        hi = min(self.bucket_hi(hi_b), self.max) if self.max >= lo \
            else self.bucket_hi(hi_b)
        return (lo, hi)

    def percentile(self, p: float) -> float:
        """Point estimate: midpoint of the bounding bucket interval."""
        lo, hi = self.percentile_bounds(p)
        if not math.isfinite(hi):
            return self.max if math.isfinite(self.max) else lo
        return (lo + hi) / 2.0

    @property
    def mean(self) -> float:
        return self.sum / self.count if self.count else 0.0

    def as_dict(self) -> dict:
        self._flush()
        nz = np.nonzero(self.buckets)[0]
        return {
            "count": self.count,
            "sum": self.sum,
            "min": self.min if self.count else 0.0,
            "max": self.max if self.count else 0.0,
            # sparse {bucket_index: count} keeps exports small
            "buckets": {int(i): int(self.buckets[i]) for i in nz},
        }


class MetricsRegistry:
    """Named counters (ints), gauges (floats) and histograms.

    Naming convention: dotted lowercase, ``plane.metric`` (e.g.
    ``serve.latency_us``, ``control.crashes``). The ``diag.`` prefix marks
    cache-/replay-topology diagnostics (fused-tier engagement, plan hits)
    that are *excluded* from the streamed == materialized parity contract:
    streamed serving drops replay caches per piece, so tier engagement
    legitimately differs while every served result stays bit-identical.
    Everything else must match across all execution modes.
    """

    __slots__ = ("counters", "gauges", "hists")

    def __init__(self):
        self.counters: Dict[str, int] = {}
        self.gauges: Dict[str, float] = {}
        self.hists: Dict[str, LatencyHistogram] = {}

    # -- write side ----------------------------------------------------------

    def inc(self, name: str, by: int = 1) -> None:
        self.counters[name] = self.counters.get(name, 0) + int(by)

    def set(self, name: str, value: int) -> None:
        self.counters[name] = int(value)

    def gauge(self, name: str, value: float) -> None:
        self.gauges[name] = float(value)

    def hist(self, name: str) -> LatencyHistogram:
        h = self.hists.get(name)
        if h is None:
            h = self.hists[name] = LatencyHistogram()
        return h

    def observe(self, name: str, value: float) -> None:
        self.hist(name).observe(value)

    def observe_many(self, name: str, values) -> None:
        self.hist(name).observe_many(values)

    # -- merge / read side ---------------------------------------------------

    def merge(self, other: "MetricsRegistry") -> "MetricsRegistry":
        """Fold ``other`` in: counters and histograms add, gauges take the
        max (per-host absolute values survive in the per-host registries and
        ``HostReport`` fields). Deterministic given a deterministic merge
        order — ``merge_telemetry`` always folds hosts in host-index
        order."""
        for k, v in other.counters.items():
            self.counters[k] = self.counters.get(k, 0) + v
        for k, v in other.gauges.items():
            self.gauges[k] = max(self.gauges.get(k, -math.inf), v)
        for k, h in other.hists.items():
            self.hist(k).merge(h)
        return self

    def as_dict(self, drop_prefixes: Sequence[str] = ()) -> dict:
        def keep(name: str) -> bool:
            return not any(name.startswith(p) for p in drop_prefixes)
        return {
            "counters": {k: v for k, v in sorted(self.counters.items())
                         if keep(k)},
            "gauges": {k: v for k, v in sorted(self.gauges.items())
                       if keep(k)},
            "histograms": {k: h.as_dict()
                           for k, h in sorted(self.hists.items())
                           if keep(k)},
        }


# -- canonical counter catalog -------------------------------------------------

# (HostReport field, ClusterReport rollup name, registry metric name, plane).
# The two renamed rollups (failed_over / replayed) predate the catalog and
# stay for API compatibility; everything else maps 1:1.
HOST_COUNTERS: Tuple[Tuple[str, str, str, str], ...] = (
    ("crashes", "crashes", "control.crashes", "control"),
    ("failed_over_in", "failed_over", "control.failed_over_in", "control"),
    ("replayed_in", "replayed", "control.replayed_in", "control"),
    ("stale_served", "stale_served", "control.stale_served", "control"),
    ("shed_queries", "shed_queries", "control.shed_queries", "control"),
    ("io_error_retries", "io_error_retries", "control.io_error_retries",
     "control"),
    ("degraded_chunks", "degraded_chunks", "control.degraded_chunks",
     "control"),
    ("corrupt_reads", "corrupt_reads", "integrity.corrupt_reads",
     "integrity"),
    ("retry_steps", "retry_steps", "integrity.retry_steps", "integrity"),
    ("hedged_reads", "hedged_reads", "integrity.hedged_reads", "integrity"),
    ("repair_ios", "repair_ios", "integrity.repair_ios", "integrity"),
    ("rows_lost", "rows_lost", "integrity.rows_lost", "integrity"),
    ("rows_rebuilt", "rows_rebuilt", "integrity.rows_rebuilt", "integrity"),
)


def host_counter_metric(field: str) -> str:
    """Registry metric name for a catalogued ``HostReport`` counter field."""
    for f, _, metric, _ in HOST_COUNTERS:
        if f == field:
            return metric
    raise KeyError(field)


# Exact field inventories of the report/stat dataclasses: a counter field
# added to one of these classes must be registered here — new counters
# belong on the registry (or, if a legacy view is genuinely needed, here).
LINT_FIELD_ALLOWLIST: Dict[str, frozenset] = {
    "HostReport": frozenset({
        "name", "queries", "p50_us", "p95_us", "p99_us", "deferred",
        "sm_ios", "achieved_iops", "iops_occupancy", "feasible_qps",
        "power", "batch_fallbacks", "feasible_qps_p99",
        "mesh_devices", "engine_hit_rate",
    } | {f for f, _, _, _ in HOST_COUNTERS}),
    "QueryStats": frozenset({
        "latency_us", "sm_ios", "row_hits", "row_lookups", "pooled_hits",
        "pooled_lookups", "sm_time_us", "corrupt_reads", "retry_steps",
        "hedged_reads", "repair_ios",
    }),
    "IntegrityStats": frozenset({
        "corrupt_reads", "retry_steps", "hedged_reads", "repair_ios",
        "retry_recovered", "replica_reads", "refetch_reads", "hedge_wins",
        "undetected", "rows_lost", "rows_rebuilt",
    }),
}
