"""Cluster-level event-driven serving simulator (Tables 8/9/11 from traffic).

Runs N simulated hosts, each a full SDM serving stack
(``SDMEmbeddingStore`` + ``ServeScheduler``) over a heterogeneous device
plan — Nand, 3DXP or DRAM-only (``fm_only`` placement: the whole model in
FM, Table 7's HW-L) — routes a :class:`~repro_torch.workloads.trace.Trace`'s
queries to hosts, and aggregates:

* latency percentiles (p50/p95/p99) per host and fleet-wide,
* SM IOPS occupancy against each host's device envelope,
* fleet power, by scaling the simulated cluster until it meets a fleet QPS
  demand at the measured per-host feasible QPS (Eq. 5-7 driven by simulated
  traffic rather than closed-form feasibility).

Per-host compute pacing comes from the same component model the closed-form
scenarios use (``core/power.py``): a host's item-side service time is
``1e6 / compute_qps`` so a 2-socket HW-L turns queries around ~2x faster
than a 1-socket HW-SS — the tradeoff Table 8 prices against host power.

The background IOPS each device model sees can be made *self-consistent*:
pass 1 measures each host's achieved IOPS with an unloaded device, pass 2
replays the trace with that load applied (``passes=2``).

A copy of ``repro.runtime.cluster``, held bit for bit against it
(``tests/test_torch_cluster.py``), with two departures on the device plane:

* ``HostSim.attach_engine`` builds the port's engines on ``torch_device``
  (``cuda`` unless the caller asks for the CPU), and its default
  ``EngineConfig`` sets ``use_kernels=True``: a card runs the CUDA
  ``cache_probe`` and ``gather_pool`` kernels, while CPU tensors take their
  plain versions, so CPU results equal the reference's ``use_kernels=False``
  engines. A mesh host's shards go on an explicit ``devices`` list when one
  is given (several shards may share one card), else on
  ``make_embed_mesh(n)``.
* The process pool spawns its workers because a forked child cannot
  re-initialise CUDA; the workers run the numpy host plane only.
"""
from __future__ import annotations

import collections
import dataclasses
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core import placement as plc
from repro_torch.core.io_sim import DEVICES
from repro_torch.core.locality import TableMeta, sticky_route
from repro_torch.core.power import HostConfig
from repro_torch.core.sdm import QueryStats, SDMConfig, SDMEmbeddingStore
from repro_torch.obs import HOST_COUNTERS, make_telemetry, merge_telemetry
from repro_torch.runtime.control import (ControlledHost, DegradePolicy,
                                         HostControl, build_controls,
                                         rewrite_assignment)
from repro_torch.runtime.serve_sched import ServeConfig, ServeScheduler
from repro_torch.workloads.failures import FailureSpec
from repro_torch.workloads.trace import Trace, concat_traces, slice_trace


def host_compute_qps(host: HostConfig) -> float:
    """Compute-bound QPS of a host (Eq. 5's compute term)."""
    return host.accel_qps if host.accel else host.sockets * host.socket_qps


@dataclasses.dataclass(frozen=True)
class HostSpec:
    """One host flavor in the simulated cluster."""
    name: str
    host: HostConfig                       # power/compute component model
    device: Optional[str] = "nand_flash"   # DEVICES key; None => DRAM-only
    num_devices: int = 2
    fm_cache_bytes: int = 64 << 20
    pooled_cache_bytes: int = 0
    count: int = 1                         # replicas of this flavor
    # The simulated inventory is a 1/k scale model of the real model's SM
    # table count (e.g. 12 of M2's 450 user tables); per-query IO demand is
    # multiplied by k in the device-feasibility leg so the feasible QPS
    # prices the *full* model while the traffic (hit rates, latency shape)
    # still comes from simulation.
    demand_scale: float = 1.0
    # Device-plane latency mode: "analytic" (closed-form means, bit-stable
    # default) or "sampled" (event-driven DeviceSim queues). ``tuning`` is a
    # devices.DeviceTuning (§4.1 knobs), ``update`` a devices.UpdateSpec
    # (background model-refresh write plane) — both sampled-mode only.
    latency_mode: str = "analytic"
    tuning: object = None
    update: object = None
    # Device plane (runtime/engine.py + runtime/sharded_engine.py): a host
    # may *be* a mesh slice — ``mesh_shape=(8,)`` serves its routed queries
    # through a ShardedServingEngine of 8 shards instead of the
    # single-device engine. None/(1,) means one device. ``shard_layout``
    # picks the store partitioning ("row" | "table", launch/sharding.py).
    mesh_shape: Optional[Tuple[int, ...]] = None
    shard_layout: str = "row"
    # Data-integrity plane (devices/integrity.py + runtime/redundancy.py):
    # ``integrity`` a devices.IntegritySpec (media-error model + retry
    # ladder), ``redundancy`` a runtime.redundancy.ReplicationSpec (k-way
    # replication, hedged reads, rebuild-after-loss). Either non-None
    # attaches a RedundancyPlane to the host's IO engine; None/None is the
    # exact vanilla IO path, bit for bit.
    integrity: object = None
    redundancy: object = None
    # Telemetry plane (repro_torch/obs/): None (default) is bit-invisible —
    # no registry, no spans, zero RNG consumed, reports byte-identical.
    # True enables with the default ObsConfig; an obs.ObsConfig sets knobs.
    telemetry: object = None

    @property
    def mesh_devices(self) -> int:
        """Number of shards this host's engine spans (1 = unsharded)."""
        n = 1
        for d in (self.mesh_shape or ()):
            n *= int(d)
        return max(1, n)


@dataclasses.dataclass(frozen=True)
class ClusterConfig:
    hosts: Tuple[HostSpec, ...]
    routing: str = "tenant_sticky"         # tenant_sticky | round_robin | per_tenant
    chunk: int = 32                        # serve_batch chunk size
    latency_target_us: float = 10_000.0
    seed: int = 0
    # Cluster-level telemetry default: applied to every HostSpec whose own
    # ``telemetry`` is None (a spec-level setting wins). Same values as
    # HostSpec.telemetry.
    telemetry: object = None


@dataclasses.dataclass
class HostReport:
    name: str
    queries: int
    p50_us: float
    p95_us: float
    p99_us: float
    deferred: int
    sm_ios: int
    achieved_iops: float                   # SM IOs / simulated wall time
    iops_occupancy: float                  # vs device envelope (0 for DRAM)
    feasible_qps: float                    # simulation-level Eq. 5
    power: float                           # normalized host power
    batch_fallbacks: int = 0               # exact-sequential chunk fallbacks
    # Eq. 5 judged at the p99 latency instead of the mean: the feasible QPS
    # once the tail (sampled device plane: queueing collapse, GC/write
    # interference) is what must clear the budget. Equals feasible_qps's
    # shape in analytic mode, where the latency samples carry no tail.
    feasible_qps_p99: float = 0.0
    # Control-plane counters (runtime/control.py); all zero when no
    # FailureSpec/DegradePolicy is active.
    crashes: int = 0                       # restarts this host performed
    failed_over_in: int = 0                # downtime arrivals re-routed here
    replayed_in: int = 0                   # in-flight ledger replays here
    stale_served: int = 0                  # queries served from stale rows
    shed_queries: int = 0                  # queries with pooled lookups shed
    io_error_retries: int = 0              # transient-error retries paid
    degraded_chunks: int = 0               # chunks served in degraded mode
    # Data-integrity plane counters (runtime/redundancy.py); all zero when
    # the host has no IntegritySpec/ReplicationSpec attached.
    corrupt_reads: int = 0                 # rows failing checksum on read
    retry_steps: int = 0                   # ECC read-retry ladder steps paid
    hedged_reads: int = 0                  # duplicate reads fired at replicas
    repair_ios: int = 0                    # retries + replica + refetch + hedges
    rows_lost: int = 0                     # rows losing a copy to device_loss
    rows_rebuilt: int = 0                  # rows re-replicated by the rebuild
    # Device-plane (torch engine) fields; zero unless the host served through
    # an attached DeviceServingEngine / ShardedServingEngine.
    mesh_devices: int = 0                  # shards the engine spanned
    engine_hit_rate: float = 0.0           # HBM row-cache hit rate


@dataclasses.dataclass
class FleetEstimate:
    """The simulated cluster scaled until it meets a fleet QPS demand."""
    hosts: float
    power: float


@dataclasses.dataclass
class ClusterReport:
    name: str
    hosts: List[HostReport]
    p50_us: float
    p95_us: float
    p99_us: float
    p999_us: float = 0.0                   # p99.9 — the planner's SLO knob
    # Merged per-host obs.Telemetry (None when no host had telemetry
    # enabled). Deterministic: hosts fold in host-index order, so the
    # merged registry is bit-equal across serial/thread/process runs.
    telemetry: object = None

    @property
    def queries(self) -> int:
        return sum(h.queries for h in self.hosts)

    @property
    def fleet_feasible_qps(self) -> float:
        return sum(h.feasible_qps for h in self.hosts)

    @property
    def sim_power(self) -> float:
        return sum(h.power for h in self.hosts)

    @property
    def deferred(self) -> int:
        return sum(h.deferred for h in self.hosts)

    # Control-plane and data-integrity counter rollups (crashes,
    # failed_over, replayed, stale_served, ..., rows_rebuilt — zero when no
    # plane is active) are generated below from the obs.HOST_COUNTERS
    # catalog: one definition drives the HostReport field, the rollup here,
    # and the registry metric name.

    def fleet_power(self, demand_qps: float,
                    tail: bool = False) -> FleetEstimate:
        """Eq. 7 from measured traffic: scale the simulated cluster until
        its feasible QPS covers ``demand_qps``. Hosts the routing left idle
        carry no measured capacity and are excluded from the scaled fleet
        (an all-idle or empty fleet prices to zero rather than dividing by
        its missing capacity). ``tail=True`` judges capacity at the p99
        feasible QPS — the planner's SLO-aware scaling."""
        active = [h for h in self.hosts if h.queries > 0]
        if not active:
            return FleetEstimate(hosts=0.0, power=0.0)
        cap = sum((h.feasible_qps_p99 if tail else h.feasible_qps)
                  for h in active)
        k = demand_qps / max(cap, 1e-9)
        return FleetEstimate(hosts=k * len(active),
                             power=k * sum(h.power for h in active))


def _install_counter_rollups() -> None:
    """Generate ClusterReport's per-counter sum rollups from the obs
    catalog (replacing thirteen hand-written properties): every catalogued
    HostReport counter gets a fleet-sum property under its rollup name."""
    def _make(field):
        def _get(self) -> int:
            return sum(getattr(h, field) for h in self.hosts)
        return _get
    for field, rollup, _, _ in HOST_COUNTERS:
        setattr(ClusterReport, rollup, property(_make(field)))


_install_counter_rollups()


class HostSim:
    """One simulated host: an SDM store + scheduler over a table inventory."""

    def __init__(self, spec: HostSpec, metas: Sequence[TableMeta],
                 latency_target_us: float, seed: int = 0):
        self.spec = spec
        dram_only = spec.device is None
        place = plc.PlacementConfig(policy="fm_only" if dram_only
                                    else "sm_only_with_cache")
        item_us = 1e6 / host_compute_qps(spec.host)
        self.store = SDMEmbeddingStore(
            list(metas), DEVICES[spec.device or "nand_flash"],
            SDMConfig(fm_cache_bytes=spec.fm_cache_bytes,
                      pooled_cache_bytes=spec.pooled_cache_bytes,
                      placement=place, num_devices=spec.num_devices,
                      item_time_us=item_us,
                      latency_mode="analytic" if dram_only
                      else spec.latency_mode,
                      tuning=spec.tuning, update=spec.update, sim_seed=seed,
                      integrity=None if dram_only else spec.integrity,
                      redundancy=None if dram_only else spec.redundancy),
            seed=seed)
        self.sched = ServeScheduler(self.store, ServeConfig(
            item_compute_us=item_us, latency_target_us=latency_target_us))
        self.engine = None               # device plane, see attach_engine
        self.telemetry = make_telemetry(spec.telemetry, host=spec.name)
        self._attach_telemetry()

    def _attach_telemetry(self) -> None:
        """Point every plane of this host at the (single) telemetry handle.
        A None handle leaves all attributes None — every hook disabled."""
        tel = self.telemetry
        if tel is None:
            return
        self.store.telemetry = tel
        self.sched.telemetry = tel
        self.store.io.telemetry = tel
        if self.store.io.sim is not None:
            self.store.io.sim.telemetry = tel
        if self.store.io.integrity is not None:
            self.store.io.integrity.telemetry = tel
        if self.engine is not None:
            self.engine.telemetry = tel

    def attach_engine(self, tables: Dict[int, object], engine_cfg=None, *,
                      torch_device="cuda", devices: Optional[Sequence] = None):
        """Build this host's *device-plane* engine over ``tables``
        ({table_id: [rows, dim] float array or tensor}).

        ``mesh_shape=None``/``(1,)`` attaches the single-device
        :class:`~repro_torch.runtime.engine.DeviceServingEngine` on
        ``torch_device``; anything larger attaches a
        :class:`~repro_torch.runtime.sharded_engine.ShardedServingEngine` of
        ``prod(mesh_shape)`` shards in the spec's ``shard_layout``, shard k
        on ``devices[k]`` when a device list is given, else on
        ``make_embed_mesh(n, torch_device)``. Engine defaults mirror the
        host's simulated store (FM cache budget -> HBM row-cache budget,
        device count, item time) and run the kernels (``use_kernels=True``;
        CPU tensors take the kernels' plain versions). Imports are lazy so
        hosts that never touch the device plane never pull in the engines.
        Returns (and stores) the engine as ``self.engine``.
        """
        from repro_torch.runtime.engine import (DeviceServingEngine,
                                                EngineConfig)
        spec = self.spec
        if engine_cfg is None:
            engine_cfg = EngineConfig(
                hbm_cache_bytes=spec.fm_cache_bytes,
                num_devices=spec.num_devices,
                item_time_us=1e6 / host_compute_qps(spec.host),
                use_kernels=True)
        dev = DEVICES[spec.device or "nand_flash"]
        n = spec.mesh_devices
        if n <= 1:
            self.engine = DeviceServingEngine(tables, dev, engine_cfg,
                                              torch_device=torch_device)
        else:
            from repro_torch.launch.mesh import make_embed_mesh
            from repro_torch.runtime.sharded_engine import \
                ShardedServingEngine
            self.engine = ShardedServingEngine(
                tables, dev, engine_cfg,
                mesh=make_embed_mesh(n, torch_device, devices=devices),
                layout=spec.shard_layout)
        if self.telemetry is not None:
            self.engine.telemetry = self.telemetry
            self.engine.io.telemetry = self.telemetry
        return self.engine

    def run_trace(self, trace: Trace, chunk: int, bg_iops: float,
                  columnar: bool = True) -> None:
        """Replay a trace. The columnar path slices the trace's cached
        per-table grouping per chunk (so warmup + multi-pass replays pay the
        argsort once); ``columnar=False`` replays through the legacy dict
        plane (per-chunk Python grouping, per-query ledger) for differential
        testing."""
        if columnar:
            self.sched.serve_trace(trace, chunk, bg_iops)
            return
        for ch in trace.chunks(chunk):
            self.sched.serve_batch_dict(ch.requests, bg_iops,
                                        arrivals_us=ch.arrival_us)

    def snapshot(self) -> dict:
        """Copy of the store's serving state (row/pooled caches, IO
        counters, stats). The data-plane state a trace replay leaves behind
        is independent of the device background load — bg only enters
        latency — so the pass-1 post-warmup snapshot is bit-identical to
        what pass 2's warmup would recompute, and ``ClusterSim.run`` reuses
        it instead of replaying the warmup on every self-consistency pass."""
        s = self.store
        rc = s.row_cache
        snap = {
            "tags": rc.tags.copy(), "stamp": rc.stamp.copy(),
            "clock": rc.clock, "hits": rc.hits, "misses": rc.misses,
            "filled": rc.filled, "evictions": rc.evictions,
            "stats": dataclasses.replace(s.stats),
            "fallbacks": s.batch_fallbacks,
            "chunk_plans": dict(s._chunk_plans),
            "io": (s.io.total_ios, s.io.total_bus_bytes,
                   s.io.total_wanted_bytes),
        }
        if s.pooled_cache is not None:
            pc = s.pooled_cache
            snap["pooled"] = (dict(pc.store), pc.used, pc.hits, pc.misses,
                              pc.skipped, pc.hit_len_sum)
        return snap

    def restore(self, snap: dict) -> None:
        """Restore a :meth:`snapshot` (see there for the exactness
        argument)."""
        s = self.store
        rc = s.row_cache
        rc.tags = snap["tags"].copy()
        rc.stamp = snap["stamp"].copy()
        rc.clock, rc.hits, rc.misses, rc.filled = (
            snap["clock"], snap["hits"], snap["misses"], snap["filled"])
        rc.evictions = snap["evictions"]
        s.stats = dataclasses.replace(snap["stats"])
        s.batch_fallbacks = snap["fallbacks"]
        s._chunk_plans = dict(snap["chunk_plans"])
        s.io.total_ios, s.io.total_bus_bytes, s.io.total_wanted_bytes = \
            snap["io"]
        if s.pooled_cache is not None:
            pc = s.pooled_cache
            store, pc.used, pc.hits, pc.misses, pc.skipped, pc.hit_len_sum = \
                snap["pooled"]
            pc.store = collections.OrderedDict(store)

    def reset_measurement(self) -> None:
        """Zero the accumulated stats but keep all cache state — the next
        ``run_trace`` measures the *steady-state* (warm) regime, the one the
        paper's cache-hit-rate numbers (96% M1, 90% M2) refer to."""
        self.store.stats = QueryStats()
        self.store.row_cache.hits = self.store.row_cache.misses = 0
        self.store.batch_fallbacks = 0
        if self.store.pooled_cache is not None:
            self.store.pooled_cache.hits = self.store.pooled_cache.misses = 0
        if self.store.io.sim is not None:
            # sampled device plane: the measurement replay starts at the
            # trace's first arrival again, so the queues must not carry the
            # warmup pass's clock (cache state above is kept, as always)
            self.store.io.sim.reset_clock()
        if self.store.io.integrity is not None:
            # integrity counters reset with the other stats; plane *state*
            # (wear, disturb, rebuild progress, RNG position) persists —
            # same contract as reset_clock above not rewinding RNGs
            self.store.io.integrity.reset_stats()
        self.sched = ServeScheduler(self.store, self.sched.cfg)
        if self.telemetry is not None:
            # only the measurement replay lands in the run's telemetry;
            # the fresh scheduler needs the handle re-attached
            self.telemetry.reset()
            self.sched.telemetry = self.telemetry

    def report(self, duration_us: float) -> HostReport:
        ios = self.store.stats.sm_ios
        iops = ios / duration_us * 1e6 if duration_us > 0 else 0.0
        spec = self.spec
        queries = len(self.sched.p_lat) + self.sched.deferred
        lat_based = self.sched.qps_at_latency()
        p99_based = self.sched.qps_at_latency(at_percentile=99.0)
        if spec.device is None or ios == 0 or queries == 0:
            occ = 0.0
            feasible = lat_based
            feasible_p99 = p99_based
        else:
            dev = DEVICES[spec.device]
            envelope = dev.iops_max * spec.num_devices
            occ = iops / envelope
            # Eq. 5's device leg from measured traffic: per-query IO demand
            # (cache effects folded in) against the max device load at which
            # ~2 serial IO waves still clear the latency budget — the QPS an
            # overloaded host would throttle itself to (§4.1 burst smoothing)
            # instead of queueing unboundedly.
            budget = self.sched.cfg.latency_target_us
            rho_max = max(0.0, 1.0 - (2.0 * dev.base_latency_us / budget)
                          ** (1.0 / dev.alpha))
            cap = rho_max * envelope / (ios / queries * spec.demand_scale)
            compute = host_compute_qps(spec.host)
            feasible = min(cap, compute) if lat_based <= 0 \
                else min(lat_based, cap)
            feasible_p99 = min(cap, compute) if p99_based <= 0 \
                else min(p99_based, cap)
        rep = HostReport(
            name=spec.name, queries=queries,
            p50_us=self.sched.percentile(50), p95_us=self.sched.percentile(95),
            p99_us=self.sched.percentile(99), deferred=self.sched.deferred,
            sm_ios=ios, achieved_iops=iops, iops_occupancy=occ,
            feasible_qps=feasible, power=spec.host.power,
            batch_fallbacks=self.store.batch_fallbacks,
            feasible_qps_p99=feasible_p99)
        integ = self.store.io.integrity
        if integ is not None:
            # fold end-of-trace rebuild progress in before reading counters
            # (a rebuild wave due before the trace end may not have been
            # popped if no foreground read followed it)
            integ.advance(duration_us)
            ps = integ.stats
            rep.corrupt_reads = ps.corrupt_reads
            rep.retry_steps = ps.retry_steps
            rep.hedged_reads = ps.hedged_reads
            rep.repair_ios = ps.repair_ios
            rep.rows_lost = ps.rows_lost
            rep.rows_rebuilt = ps.rows_rebuilt
        if self.telemetry is not None:
            self._publish_telemetry(rep)
        return rep

    def _publish_telemetry(self, rep: HostReport) -> None:
        """Finalize-time registry publication. Everything here is absolute
        (``set``/``gauge``, not ``inc``) so a repeated ``report()`` call is
        idempotent; hot-path histograms, spans and tier counters were
        recorded live during the replay."""
        reg = self.telemetry.registry
        s = self.store
        reg.set("serve.queries", rep.queries)
        reg.set("serve.deferred", rep.deferred)
        reg.set("serve.sm_ios", rep.sm_ios)
        reg.set("serve.batch_fallbacks", rep.batch_fallbacks)
        reg.set("diag.chunk_plan_hits", s.chunk_plan_hits)
        st = s.stats
        reg.set("cache.row_hits", st.row_hits)
        reg.set("cache.row_lookups", st.row_lookups)
        reg.set("cache.pooled_hits", st.pooled_hits)
        reg.set("cache.pooled_lookups", st.pooled_lookups)
        if st.row_lookups:
            reg.gauge("cache.row_hit_rate", st.row_hits / st.row_lookups)
        if st.pooled_lookups:
            reg.gauge("cache.pooled_hit_rate",
                      st.pooled_hits / st.pooled_lookups)
        reg.set("io.total_ios", s.io.total_ios)
        reg.set("io.bus_bytes", s.io.total_bus_bytes)
        reg.gauge("host.achieved_iops", rep.achieved_iops)
        reg.gauge("host.iops_occupancy", rep.iops_occupancy)
        reg.gauge("host.feasible_qps", rep.feasible_qps)
        reg.gauge("host.power", rep.power)
        sim = s.io.sim
        if sim is not None:
            reg.set("device.read_waves", sim.read_waves)
            reg.set("device.read_ios", sim.read_ios)
            reg.set("device.depth_collapses", sim.depth_collapses)
            reg.set("device.smoothing_delay_us",
                    int(sim.smoothing_delay_us))
            if sim.update is not None:
                reg.set("device.write_waves", sim.update.waves)
                reg.set("device.gc_events", sim.update.gc_events)
            read_u, write_u = sim.utilization()
            reg.gauge("device.read_utilization", read_u)
            reg.gauge("device.write_utilization", write_u)
        integ = s.io.integrity
        if integ is not None:
            ps = integ.stats
            reg.set("integrity.corrupt_reads", ps.corrupt_reads)
            reg.set("integrity.retry_steps", ps.retry_steps)
            reg.set("integrity.hedged_reads", ps.hedged_reads)
            reg.set("integrity.repair_ios", ps.repair_ios)
            reg.set("integrity.rows_lost", ps.rows_lost)
            reg.set("integrity.rows_rebuilt", ps.rows_rebuilt)
            reg.set("integrity.retry_recovered", ps.retry_recovered)
            reg.set("integrity.replica_reads", ps.replica_reads)
            reg.set("integrity.refetch_reads", ps.refetch_reads)
            reg.set("integrity.hedge_wins", ps.hedge_wins)
            reg.set("integrity.undetected", ps.undetected)


def _host_passes(spec: HostSpec, subset: Trace, metas: Sequence[TableMeta],
                 chunk: int, latency_target_us: float, seed: int,
                 n_passes: int, warmup: bool, ext_bg: float, columnar: bool,
                 duration_us: float,
                 ctl: Optional[HostControl] = None,
                 replay_at: Optional[np.ndarray] = None
                 ) -> Tuple[HostReport, np.ndarray, object]:
    """All self-consistency passes for one host.

    Hosts are independent given routing: a pass feeds back only the host's
    *own* measured IOPS as the next pass's background load, so the whole
    multi-pass loop factors per host — this is what makes
    ``ClusterSim.run(parallel=...)`` bit-identical to the serial walk. A
    module-level function (not a closure) so the process pool can pickle it.
    Returns the final pass's report + latency samples.

    ``ctl`` (a compiled :class:`~repro_torch.runtime.control.HostControl`) routes
    every replay through a :class:`ControlledHost` instead of the plain
    ``run_trace`` walk — crashes, slow windows, error bursts and degrade
    policy applied per chunk. Failures stay per-host too (the failover
    rewrite already happened in the routing), so the parallel modes remain
    bit-identical with a control program active."""
    bg = ext_bg
    warm_snap = None
    sim = None
    chost = None
    for p in range(n_passes):
        sim = HostSim(spec, metas, latency_target_us, seed=seed)
        chost = ControlledHost(sim, ctl) if ctl is not None else None

        def _replay():
            if chost is not None:
                chost.begin_replay()
                chost.serve(subset, chunk, bg, columnar,
                            replay_at=replay_at)
            else:
                sim.run_trace(subset, chunk, bg, columnar)

        if warmup:
            # warmup leaves bg-independent state: later passes restore the
            # pass-1 snapshot instead of replaying (analytic only —
            # snapshots don't carry DeviceSim queue/RNG state, so sampled
            # hosts replay the warmup; control programs make the ledger —
            # and through degrade triggers, the caches — bg-dependent, so
            # controlled hosts always replay too; integrity planes carry
            # RNG/wear/rebuild state snapshots don't capture, so those
            # hosts replay as well)
            if warm_snap is not None:
                sim.restore(warm_snap)
            else:
                _replay()
                if columnar and n_passes > 1 and ctl is None and \
                        spec.latency_mode != "sampled" and \
                        spec.integrity is None and spec.redundancy is None:
                    warm_snap = sim.snapshot()
            sim.reset_measurement()
        _replay()
        if p < n_passes - 1:
            # sampled hosts already queue their own load in DeviceSim —
            # feeding it back as background would double-count it, so
            # self-consistency passes only apply to analytic hosts
            bg = ext_bg + (0.0 if spec.latency_mode == "sampled"
                           else sim.report(duration_us).achieved_iops)
    rep = sim.report(duration_us)
    if chost is not None:
        rep = chost.finalize_report(rep)
    return (rep, np.asarray(sim.sched.p_lat, np.float64), sim.telemetry)


def _map_hosts(jobs: List[Tuple[int, tuple]], mode,
               max_workers: Optional[int]) -> Dict[int, tuple]:
    """Run ``_host_passes`` jobs across a pool, keyed by host index.

    ``mode`` is ``"thread"``/``True`` (numpy releases the GIL across the
    vectorized serve sweeps, and nothing is pickled) or ``"process"``
    (spawn context — a forked child cannot re-initialise CUDA once the
    parent has touched the card; the workers serve the numpy host plane and
    never touch it).
    Results are reassembled by host index, so report order and the fleet
    percentile concatenation are independent of completion order."""
    import concurrent.futures as cf
    n = max_workers or min(len(jobs), os.cpu_count() or 1)
    if mode == "process":
        import multiprocessing as mp
        pool = cf.ProcessPoolExecutor(max_workers=n,
                                      mp_context=mp.get_context("spawn"))
    else:
        pool = cf.ThreadPoolExecutor(max_workers=n)
    with pool:
        futs = {pool.submit(_host_passes, *args): h for h, args in jobs}
        return {futs[f]: f.result() for f in cf.as_completed(futs)}


class ClusterSim:
    """Route a trace across simulated hosts and aggregate fleet metrics."""

    def __init__(self, cfg: ClusterConfig):
        self.cfg = cfg
        self.specs: List[HostSpec] = []
        for spec in cfg.hosts:
            if spec.telemetry is None and cfg.telemetry is not None:
                # cluster-level default; a spec-level setting (including
                # False = explicitly off) wins over it
                spec = dataclasses.replace(spec, telemetry=cfg.telemetry)
            for i in range(spec.count):
                name = spec.name if spec.count == 1 else f"{spec.name}#{i}"
                self.specs.append(dataclasses.replace(spec, name=name, count=1))

    # -- routing --------------------------------------------------------------

    def route(self, trace: Trace, start: int = 0) -> np.ndarray:
        """host id per query. ``start`` is the global index of the trace's
        first query — streamed pieces pass their offset so position-based
        policies (round_robin) route a piece exactly as the materialized
        trace would; content-based policies ignore it."""
        n_hosts = len(self.specs)
        if self.cfg.routing == "tenant_sticky":
            # a tenant's traffic pins to one host: the working set per host
            # shrinks (Fig. 4c's sticky-routing effect, at tenant granularity)
            return sticky_route(trace.tenant, n_hosts)
        if self.cfg.routing == "round_robin":
            return (start + np.arange(len(trace), dtype=np.int64)) % n_hosts
        if self.cfg.routing == "per_tenant":
            # dedicated hosts: tenant i owns host i (mod N) — the
            # no-co-location baseline of Table 11 (each experimental model
            # needs its own memory-capacity-provisioned host group)
            return trace.tenant % n_hosts
        raise ValueError(f"unknown routing {self.cfg.routing!r}")

    # -- simulation -----------------------------------------------------------

    def run(self, trace: Trace, *, passes: int = 1, warmup: bool = False,
            bg_iops: Optional[Dict[str, float]] = None,
            columnar: bool = True, parallel=None,
            max_workers: Optional[int] = None,
            failures: Optional[FailureSpec] = None,
            degrade: Optional[DegradePolicy] = None,
            assign: Optional[np.ndarray] = None) -> ClusterReport:
        """Simulate the trace. ``passes=2`` makes the device background load
        self-consistent (pass 1 measures per-host IOPS, pass 2 replays with
        that load). ``warmup`` replays the trace once before measuring, so
        hit rates and feasible QPS reflect the steady-state (warm-cache)
        regime. ``bg_iops`` is per-host *external* background load (other
        tenants, maintenance IO); measurement passes add the host's own
        measured IOPS on top of it. ``columnar`` selects the CSR fast path
        (bit-identical to the dict path; route-split subsets are built once,
        so every warmup/pass replay reuses each subset's cached grouping).

        ``parallel`` runs hosts concurrently (``"thread"``/``True`` or
        ``"process"``) — bit-identical to the serial walk, because the
        self-consistency feedback is per-host (see :func:`_host_passes`).

        Control plane: ``failures`` (a ``FailureSpec``) rewrites the
        routing so crashed hosts' queries fail over to replicas — their
        in-flight ledger replayed, no query lost — and compiles per-host
        control programs (crash restarts, slow windows, IO-error bursts);
        ``degrade`` arms degraded-mode serving on every host. A spec with
        no events and no policy takes the exact pre-existing code path.
        ``assign`` overrides the router's host assignment (the autoscaler
        routes over a time-varying active set); it must map each query to
        a valid host index. An empty fleet or empty trace returns a
        well-formed all-idle report instead of raising."""
        if not self.specs or len(trace) == 0:
            return self._fleet_report(trace.name, {})
        if assign is None:
            assign = self.route(trace)
        else:
            assign = np.asarray(assign, np.int64)
            if len(assign) != len(trace):
                raise ValueError(
                    f"assign has {len(assign)} entries for "
                    f"{len(trace)} queries")
        names = [s.name for s in self.specs]
        fo: Dict[str, int] = {}
        rp: Dict[str, int] = {}
        replay_at = None
        active_ctl = (failures is not None and failures.events) \
            or degrade is not None
        if failures is not None and failures.events:
            plan = rewrite_assignment(assign, trace.arrival_us, names,
                                      failures)
            assign, fo, rp = plan.assign, plan.failed_over_in, \
                plan.replayed_in
            replay_at = plan.replay_at_us
        controls = build_controls(names, failures, degrade, self.cfg.seed) \
            if active_ctl else [None] * len(names)
        metas = trace.all_metas()
        subsets = [trace.subset(assign == h) for h in range(len(self.specs))]
        ext = dict(bg_iops or {})
        n_passes = max(1, passes)
        jobs = [(h, (self.specs[h], subsets[h], metas, self.cfg.chunk,
                     self.cfg.latency_target_us, self.cfg.seed, n_passes,
                     warmup, ext.get(self.specs[h].name, 0.0), columnar,
                     trace.duration_us, controls[h],
                     None if replay_at is None else replay_at[assign == h]))
                for h in range(len(self.specs)) if len(subsets[h])]
        if parallel and len(jobs) > 1:
            results = _map_hosts(jobs, parallel, max_workers)
        else:
            results = {h: _host_passes(*args) for h, args in jobs}
        report = self._fleet_report(trace.name, results)
        self._stamp_failover(report, fo, rp)
        return report

    @staticmethod
    def _stamp_failover(report: ClusterReport, fo: Dict[str, int],
                        rp: Dict[str, int]) -> None:
        """Failover attribution lives in the routing rewrite, not the host
        replay — stamp it onto the host reports after the fleet merge, and
        mirror it into the merged registry (per-host registries cannot see
        it, so the merge step owns these two counters)."""
        for hr in report.hosts:
            hr.failed_over_in = fo.get(hr.name, 0)
            hr.replayed_in = rp.get(hr.name, 0)
        if report.telemetry is not None:
            reg = report.telemetry.registry
            reg.set("control.failed_over_in", sum(fo.values()))
            reg.set("control.replayed_in", sum(rp.values()))

    def run_stream(self, stream, *, passes: int = 1, warmup: bool = False,
                   bg_iops: Optional[Dict[str, float]] = None,
                   columnar: bool = True,
                   failures: Optional[FailureSpec] = None,
                   degrade: Optional[DegradePolicy] = None) -> ClusterReport:
        """:meth:`run` for a :class:`~repro_torch.workloads.stream.TraceStream`:
        serve the spec's queries piece by piece in O(piece) memory, never
        materializing the trace. Each warmup/measurement replay re-iterates
        the stream (bit-identical regeneration); hosts advance in lockstep
        over pieces, each serving its routed slice of the piece.

        Reports are bit-identical to ``run(stream.materialize(), ...)``:
        pieces preserve each host's query subsequence, the columnar serve
        plane is chunking-invariant (any chunk split equals the sequential
        walk exactly), and the trace duration is the last piece's last
        arrival — the same scalar the materialized trace would report.
        That parity extends to the control plane: the failover rewrite is
        content/arrival-based (applied per piece it equals the whole-trace
        rewrite), and each host's control program triggers at chunk
        boundaries the remainder buffers keep identical."""
        n_hosts = len(self.specs)
        if n_hosts == 0:
            return self._fleet_report(stream.name, {})
        names = [s.name for s in self.specs]
        active_ctl = (failures is not None and failures.events) \
            or degrade is not None
        controls = build_controls(names, failures, degrade, self.cfg.seed) \
            if active_ctl else [None] * n_hosts
        fspec = failures if failures is not None and failures.events \
            else None
        metas = stream.all_metas()
        ext = dict(bg_iops or {})
        bg = dict(ext)
        n_passes = max(1, passes)
        warm_snaps: List[Optional[dict]] = [None] * n_hosts
        duration = 0.0
        sims: List[HostSim] = []
        chosts: List[Optional[ControlledHost]] = [None] * n_hosts
        fo: Dict[str, int] = {}
        rp: Dict[str, int] = {}
        for p in range(n_passes):
            sims = [HostSim(spec, metas, self.cfg.latency_target_us,
                            seed=self.cfg.seed) for spec in self.specs]
            chosts = [ControlledHost(sims[h], controls[h])
                      if controls[h] is not None else None
                      for h in range(n_hosts)]
            if warmup:
                # same restore-vs-replay split as _host_passes: hosts with a
                # pass-1 snapshot restore it; the rest (pass 1, sampled
                # hosts, and controlled hosts on every pass) replay the
                # warmup stream
                need = [h for h in range(n_hosts) if warm_snaps[h] is None]
                for h in range(n_hosts):
                    if warm_snaps[h] is not None:
                        sims[h].restore(warm_snaps[h])
                if need:
                    self._stream_replay(stream, sims, need, bg, columnar,
                                        chosts, fspec)
                    if columnar and n_passes > 1:
                        for h in need:
                            if self.specs[h].latency_mode != "sampled" \
                                    and controls[h] is None \
                                    and self.specs[h].integrity is None \
                                    and self.specs[h].redundancy is None:
                                warm_snaps[h] = sims[h].snapshot()
                for sim in sims:
                    sim.reset_measurement()
            fo, rp = {}, {}
            duration = self._stream_replay(stream, sims, range(n_hosts),
                                           bg, columnar, chosts, fspec,
                                           fo, rp)
            if p < n_passes - 1:
                bg = {spec.name: ext.get(spec.name, 0.0)
                      + (0.0 if spec.latency_mode == "sampled"
                         else sims[h].report(duration).achieved_iops)
                      for h, spec in enumerate(self.specs)}
        results = {}
        for h, sim in enumerate(sims):
            if len(sim.sched.p_lat) + sim.sched.deferred == 0:
                continue                       # idle host -> placeholder
            rep = sim.report(duration)
            if chosts[h] is not None:
                rep = chosts[h].finalize_report(rep)
            results[h] = (rep, np.asarray(sim.sched.p_lat, np.float64),
                          sim.telemetry)
        report = self._fleet_report(stream.name, results)
        self._stamp_failover(report, fo, rp)
        return report

    def _stream_replay(self, stream, sims: List[HostSim], hosts,
                       bg: Dict[str, float], columnar: bool,
                       chosts: Optional[List] = None,
                       failures: Optional[FailureSpec] = None,
                       fo: Optional[Dict[str, int]] = None,
                       rp: Optional[Dict[str, int]] = None) -> float:
        """One replay of the stream for the given host subset. Returns the
        stream duration (last arrival).

        Each host carries a sub-chunk remainder buffer across pieces, so
        its serve-chunk boundaries land exactly where a materialized
        route-split would put them (multiples of ``cfg.chunk`` from the
        host's first query). Serve *results* are chunking-invariant anyway;
        the buffer makes boundary-sensitive diagnostics (the
        ``batch_fallbacks`` counter) match bit-for-bit too. Pending state
        is O(hosts * (chunk + piece)) — the bounded-memory claim stands.

        ``failures`` applies the failover rewrite to each piece's routing
        (content-based: equals the materialized whole-trace rewrite);
        ``fo``/``rp`` accumulate the per-host failover/replay counters.
        ``chosts`` routes a host's serving through its ControlledHost."""
        last = 0.0
        chunk = self.cfg.chunk
        active = list(hosts)
        names = [s.name for s in self.specs]

        def _serve(h: int, part: Trace,
                   floors: Optional[np.ndarray] = None) -> None:
            host_bg = bg.get(self.specs[h].name, 0.0)
            if chosts is not None and chosts[h] is not None:
                chosts[h].serve(part, chunk, host_bg, columnar,
                                replay_at=floors)
            else:
                sims[h].run_trace(part, chunk, host_bg, columnar)
            # streamed chunks are served once — drop the replay caches
            # keyed by them or memory grows O(trace), not O(piece)
            sims[h].store.drop_plan_caches()

        if chosts is not None:
            for h in active:
                if chosts[h] is not None:
                    chosts[h].begin_replay()
        pend: Dict[int, List[Trace]] = {h: [] for h in active}
        # replayed-query arrival floors, buffered in lockstep with pend so
        # streamed chunk cuts slice them exactly like the trace pieces
        pendf: Dict[int, List[np.ndarray]] = {h: [] for h in active}
        npend: Dict[int, int] = {h: 0 for h in active}
        for piece in stream.pieces():
            assign = self.route(piece.trace, piece.start)
            ra = None
            if failures is not None:
                plan = rewrite_assignment(assign, piece.trace.arrival_us,
                                          names, failures)
                assign = plan.assign
                ra = plan.replay_at_us
                if fo is not None:
                    for k, v in plan.failed_over_in.items():
                        fo[k] = fo.get(k, 0) + v
                if rp is not None:
                    for k, v in plan.replayed_in.items():
                        rp[k] = rp.get(k, 0) + v
            for h in active:
                mask = assign == h
                sub = piece.trace.subset(mask)
                if not len(sub):
                    continue
                pend[h].append(sub)
                if failures is not None:
                    pendf[h].append(ra[mask])
                npend[h] += len(sub)
                if npend[h] < chunk:
                    continue
                merged = concat_traces(pend[h])
                mergedf = np.concatenate(pendf[h]) if pendf[h] else None
                cut = (npend[h] // chunk) * chunk
                ready = merged if cut == npend[h] \
                    else slice_trace(merged, 0, cut)
                readyf = None if mergedf is None else mergedf[:cut]
                _serve(h, ready, readyf)
                pend[h] = [] if cut == npend[h] \
                    else [slice_trace(merged, cut, npend[h])]
                pendf[h] = [] if mergedf is None or cut == len(mergedf) \
                    else [mergedf[cut:]]
                npend[h] -= cut
            if len(piece.trace):
                last = float(piece.trace.arrival_us[-1])
        for h in active:                       # flush the final short chunk
            if npend[h]:
                _serve(h, concat_traces(pend[h]),
                       np.concatenate(pendf[h]) if pendf[h] else None)
        return last

    def run_device_plane(self, trace: Trace,
                         tables: Dict[int, object], *,
                         engine_cfg=None, bg_iops: float = 0.0,
                         chunk: Optional[int] = None, torch_device="cuda",
                         devices: Optional[Sequence] = None
                         ) -> ClusterReport:
        """Route the trace across hosts and serve each host's subset through
        its *device-plane* engine (``HostSim.attach_engine``): hosts whose
        spec carries a ``mesh_shape`` become sharded mesh slices
        (:class:`~repro_torch.runtime.sharded_engine.ShardedServingEngine`), the
        rest run the single-device engine. Per-query latency is the engine's
        Eq. 3 composition (``max(item_time, sm_time)``), so reports are
        comparable with :meth:`run`'s host-plane numbers on the same trace;
        ``mesh_devices``/``engine_hit_rate`` carry the device-plane extras.

        ``tables`` maps table_id -> [rows, dim] float array or tensor and
        must cover every table id the trace touches. Every engine lives on
        ``torch_device``; a mesh host's shards go on ``devices`` when given
        (``attach_engine``), so one card can hold every shard."""
        if not self.specs or len(trace) == 0:
            return self._fleet_report(trace.name, {})
        assign = self.route(trace)
        metas = trace.all_metas()
        chunk = chunk or self.cfg.chunk
        results: Dict[int, tuple] = {}
        for h, spec in enumerate(self.specs):
            subset = trace.subset(assign == h)
            if not len(subset):
                continue
            sim = HostSim(spec, metas, self.cfg.latency_target_us,
                          seed=self.cfg.seed)
            eng = sim.attach_engine(tables, engine_cfg,
                                    torch_device=torch_device,
                                    devices=devices)
            tel = sim.telemetry
            lats = []
            for ch in subset.chunks(chunk):
                _, sm_t, _ = eng.serve_columnar(ch.columnar, bg_iops)
                lats.append(np.maximum(eng.cfg.item_time_us, sm_t))
            lat = (np.concatenate(lats) if lats
                   else np.zeros(0, np.float64))
            ios = eng.stats.sm_ios
            dur = trace.duration_us
            iops = ios / dur * 1e6 if dur > 0 else 0.0
            occ = 0.0
            if spec.device is not None and ios:
                occ = iops / (DEVICES[spec.device].iops_max
                              * spec.num_devices)
            rep = HostReport(
                name=spec.name, queries=len(subset),
                p50_us=float(np.percentile(lat, 50)) if lat.size else 0.0,
                p95_us=float(np.percentile(lat, 95)) if lat.size else 0.0,
                p99_us=float(np.percentile(lat, 99)) if lat.size else 0.0,
                deferred=0, sm_ios=ios, achieved_iops=iops,
                iops_occupancy=occ, feasible_qps=0.0,
                power=spec.host.power, mesh_devices=spec.mesh_devices,
                engine_hit_rate=eng.hit_rate)
            if tel is not None:
                reg = tel.registry
                reg.set("serve.queries", rep.queries)
                reg.set("serve.sm_ios", rep.sm_ios)
                reg.set("engine.mesh_devices", rep.mesh_devices)
                reg.gauge("engine.hit_rate", rep.engine_hit_rate)
                reg.gauge("host.achieved_iops", rep.achieved_iops)
                reg.gauge("host.iops_occupancy", rep.iops_occupancy)
                reg.observe_many("serve.latency_us", lat)
            results[h] = (rep, lat, tel)
        return self._fleet_report(trace.name, results)

    def _fleet_report(self, name: str,
                      results: Dict[int, tuple]) -> ClusterReport:
        """Assemble per-host ``(report, p_lat[, telemetry])`` results (keyed
        by host index) into a ClusterReport; idle hosts get a zero
        placeholder. Per-host telemetry merges in host-index order, so the
        merged registry is deterministic across execution modes."""
        reports = [results[h][0] if h in results
                   else HostReport(spec.name, 0, 0.0, 0.0, 0.0, 0, 0, 0.0,
                                   0.0, 0.0, spec.host.power)
                   for h, spec in enumerate(self.specs)]
        lat = np.concatenate([results[h][1] for h in sorted(results)
                              if results[h][1].size] or [np.zeros(1)])
        tel = merge_telemetry(
            [(self.specs[h].name, results[h][2])
             for h in sorted(results) if len(results[h]) > 2])
        return ClusterReport(
            name=name, hosts=reports,
            p50_us=float(np.percentile(lat, 50)),
            p95_us=float(np.percentile(lat, 95)),
            p99_us=float(np.percentile(lat, 99)),
            p999_us=float(np.percentile(lat, 99.9)),
            telemetry=tel)


def homogeneous_cluster(spec: HostSpec, *, count: int = 1,
                        routing: str = "tenant_sticky", chunk: int = 32,
                        latency_target_us: float = 10_000.0) -> ClusterSim:
    """Convenience: a cluster of ``count`` identical hosts — the shape every
    single-model scenario (Tables 8/9) uses."""
    return ClusterSim(ClusterConfig(
        hosts=(dataclasses.replace(spec, count=count),), routing=routing,
        chunk=chunk, latency_target_us=latency_target_us))
