"""Fleet control plane: failover, degraded serving, autoscaling, planning.

`ClusterSim` *measures* fleet feasibility (Eq. 5 at p99, Eq. 7 power);
this module *acts* on it, in four layers that compose with the existing
run/run_stream replay machinery without perturbing it when inactive:

* **Failover** — :func:`rewrite_assignment` takes the routing-produced
  host assignment and a :class:`~repro_torch.workloads.failures.FailureSpec`
  and re-routes every query that would land on a crashed host: queries
  arriving during the downtime window fail over to the first healthy
  replica (scanning ring order from the failed host), and queries that
  arrived within the event's ``inflight_window_us`` *before* the crash —
  the host's in-flight ledger at the moment of failure — are replayed on
  the replica, so no query is lost. The rewrite is a pure function of
  (assignment, arrival times, schedule): hosts stay independent given the
  rewritten routing, which is exactly why ``parallel="thread"`` /
  ``"process"`` cluster runs stay bit-identical to the serial walk with
  failures active, and why streamed pieces can be rewritten one piece at
  a time and still match the materialized trace.
* **Host control programs** — :func:`build_controls` compiles the
  schedule into one picklable :class:`HostControl` per host;
  :class:`ControlledHost` interprets it chunk by chunk during the replay:
  crash restarts (ledger wipe + optional cold-cache restart) at the first
  chunk boundary past the crash, slow windows (extra background IOPS +
  a degraded `DeviceTuning` swap on sampled hosts), seeded IO-error
  bursts (per-event RNG consumed in arrival order, so retries are
  identical across serial/parallel and streamed/materialized runs), and
  **degraded-mode serving** behind a :class:`DegradePolicy` — shed pooled
  lookups or serve stale rows when the admission ledger crosses a
  hysteresis threshold or a replica is absorbing failover traffic.
  Chunks outside every window serve through the exact vanilla calls, so
  an empty schedule is bit-identical to no control plane at all.
* **Autoscaler** — :func:`autoscale_schedule` is a reactive controller
  (scale-to-target with a hysteresis dead band and a cooldown) over
  windowed arrival rates; :func:`autoscale_run` routes the trace over the
  time-varying active set and reports host-seconds against the static
  fleet.
* **Capacity planner** — :func:`plan_capacity` searches the minimum-power
  device mix meeting a p99/p99.9 SLO at a fleet QPS demand, turning the
  Table 8/9 sweeps into an optimizer (power is linear in the demand
  split, so the optimum sits at a corner — the mix grid documents it).

A copy of ``repro.runtime.control``, held bit for bit against it
(``tests/test_torch_cluster.py``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.cache_sim import EMPTY_TAG
from repro_torch.workloads.failures import FailureEvent, FailureSpec


# -- failover: routing rewrite ------------------------------------------------

@dataclasses.dataclass
class FailoverPlan:
    """Result of :func:`rewrite_assignment`. ``failed_over_in`` /
    ``replayed_in`` count queries re-routed *to* each host (keyed by host
    name): arrivals inside the downtime window vs. in-flight ledger
    replays from just before it. ``stranded`` counts queries that found no
    healthy replica and stay queued on the crashed host (served after
    recovery — still never lost). ``replay_at_us`` is the per-query
    *effective service time* floor: a replayed in-flight query physically
    re-executes on the replica at the crash instant, not at its original
    arrival — time-window triggers (IO-error bursts) must judge it by
    ``max(arrival, replay_at)``. Zero for queries that were never
    replayed."""
    assign: np.ndarray
    failed_over_in: Dict[str, int]
    replayed_in: Dict[str, int]
    stranded: int = 0
    replay_at_us: Optional[np.ndarray] = None


def rewrite_assignment(assign: np.ndarray, arrival_us: np.ndarray,
                       host_names: Sequence[str],
                       failures: Optional[FailureSpec]) -> FailoverPlan:
    """Re-route queries assigned to crashed hosts (see module docstring).

    Content-based and arrival-based only — no positional state — so
    applying it piece-by-piece over a stream equals applying it to the
    materialized trace. Events are processed in global start order; a
    replica that later crashes itself hands the affected queries on when
    its own event is processed. A candidate is ineligible for a query when
    the query's arrival falls inside the candidate's own *extended* crash
    window ``[start - inflight_window, end)``: re-routing into a window the
    replica will itself lose would drop the query twice."""
    assign = np.asarray(assign, np.int64).copy()
    fo: Dict[str, int] = {}
    rp: Dict[str, int] = {}
    n_hosts = len(host_names)
    replay_at = np.zeros(len(assign), np.float64)
    if failures is None or n_hosts <= 1:
        return FailoverPlan(assign, fo, rp, 0, replay_at)
    idx = {name: i for i, name in enumerate(host_names)}
    crashes = [e for e in failures.sorted_events()
               if e.kind == "crash" and e.host in idx]
    if not crashes:
        return FailoverPlan(assign, fo, rp, 0, replay_at)
    arr = np.asarray(arrival_us, np.float64)
    down: Dict[int, List[Tuple[float, float]]] = {}
    for e in crashes:
        down.setdefault(idx[e.host], []).append(
            (e.start_us - e.inflight_window_us, e.end_us))
    stranded = 0
    for e in crashes:
        h = idx[e.host]
        s_in = e.start_us - e.inflight_window_us
        qs = np.nonzero((assign == h) & (arr >= s_in)
                        & (arr < e.end_us))[0]
        for d in range(1, n_hosts):
            if not qs.size:
                break
            c = (h + d) % n_hosts
            bad = np.zeros(qs.size, bool)
            for ws, we in down.get(c, ()):
                bad |= (arr[qs] >= ws) & (arr[qs] < we)
            ok = qs[~bad]
            if ok.size:
                assign[ok] = c
                name = host_names[c]
                replayed = ok[arr[ok] < e.start_us]
                n_down = ok.size - replayed.size
                fo[name] = fo.get(name, 0) + n_down
                rp[name] = rp.get(name, 0) + replayed.size
                # in-flight replays physically re-execute at the crash
                # instant: that is when later time-window triggers (error
                # bursts) must see them
                if replayed.size:
                    replay_at[replayed] = np.maximum(replay_at[replayed],
                                                     e.start_us)
            qs = qs[bad]
        stranded += int(qs.size)
    return FailoverPlan(assign, fo, rp, stranded, replay_at)


# -- degraded-mode serving ----------------------------------------------------

@dataclasses.dataclass(frozen=True)
class DegradePolicy:
    """When and how a host sheds work instead of queueing it.

    ``mode="stale"`` serves last-known rows from a local stale copy —
    queries complete at the item-compute floor with zero SM IO (the
    recommendation is computed on slightly old embeddings).
    ``mode="shed"`` drops the pooled SM lookups outright (the query is
    answered without the SM-side embedding contribution). Both are
    mechanically identical to the scheduler — no SM IO enters the ledger —
    and are told apart by which counter they bump
    (``stale_served`` vs ``shed_queries``).

    A host enters degraded mode when its admission ledger's in-flight IOs
    cross ``inflight_hi`` and leaves it again below ``inflight_lo``
    (hysteresis, evaluated at chunk boundaries on the freshened ledger).
    ``degrade_on_failover`` additionally degrades any chunk arriving while
    *another* host is down — replicas absorbing failover traffic
    pre-emptively shed rather than discovering overload from the queue."""
    mode: str = "stale"                   # stale | shed
    inflight_hi: int = 1 << 14
    inflight_lo: int = 1 << 12
    degrade_on_failover: bool = True

    def __post_init__(self):
        if self.mode not in ("stale", "shed"):
            raise ValueError(f"unknown degrade mode {self.mode!r}")
        if self.inflight_lo > self.inflight_hi:
            raise ValueError("inflight_lo must be <= inflight_hi")


@dataclasses.dataclass(frozen=True)
class HostControl:
    """One host's compiled control program: its own failure events, the
    degrade policy, and the crash windows of *other* hosts (failover
    pressure). Frozen + built from frozen parts so the process pool can
    pickle it inside a ``_host_passes`` job."""
    host_index: int
    events: Tuple[FailureEvent, ...] = ()
    degrade: Optional[DegradePolicy] = None
    pressure_windows: Tuple[Tuple[float, float], ...] = ()
    seed: int = 0


def build_controls(host_names: Sequence[str],
                   failures: Optional[FailureSpec],
                   degrade: Optional[DegradePolicy],
                   seed: int = 0) -> List[Optional[HostControl]]:
    """Compile a fleet schedule into per-host control programs. A host
    with no events and no degrade policy gets ``None`` — its replay takes
    the exact pre-existing code path (the zero-failure oracle)."""
    controls: List[Optional[HostControl]] = []
    evs_all = failures.sorted_events() if failures is not None else ()
    for i, name in enumerate(host_names):
        mine = tuple(e for e in evs_all if e.host == name)
        if not mine and degrade is None:
            controls.append(None)
            continue
        pressure = tuple((e.start_us, e.end_us) for e in evs_all
                         if e.kind == "crash" and e.host != name)
        controls.append(HostControl(host_index=i, events=mine,
                                    degrade=degrade,
                                    pressure_windows=pressure,
                                    seed=seed))
    return controls


class ControlledHost:
    """Interpret a :class:`HostControl` over one host's trace replay.

    Wraps a ``HostSim`` and replaces its ``run_trace`` walk with a
    chunk-by-chunk drive that injects the control program. Chunk
    classification happens at chunk boundaries (a chunk's first arrival),
    which are identical between ``ClusterSim.run`` and ``run_stream`` (the
    stream's remainder buffers guarantee it) — so every trigger fires at
    the same query in both, and with the per-event seeded error RNGs
    consumed in arrival order the whole degraded replay is bit-reproducible
    across serial/thread/process and streamed/materialized runs.

    ``begin_replay`` must run before *every* replay (warmup and
    measurement): it rewinds the control state — crash latches, degrade
    hysteresis, error RNGs, counters, the base tuning — so each replay of
    the same trace is identical, which is what lets multi-pass
    self-consistency runs converge deterministically."""

    def __init__(self, sim, ctl: HostControl):
        self.sim = sim
        self.ctl = ctl
        dev = sim.store.io.sim
        self._base_tuning = dev.tuning if dev is not None else None
        self.begin_replay()

    def begin_replay(self) -> None:
        self.crashes = 0
        self.stale_served = 0
        self.shed_queries = 0
        self.io_error_retries = 0
        self.degraded_chunks = 0
        self._degraded = False
        self._deg_serving = False
        tel = getattr(self.sim, "telemetry", None)
        if tel is not None:
            # failover-pressure windows are known up front (crashes on
            # peer hosts); spans recorded after the warmup replay's reset
            # land in the measurement telemetry
            for ws, we in self.ctl.pressure_windows:
                tel.tracer.span("control.failover_window", "control",
                                ws, we - ws)
        self._crash_done: set = set()
        self._loss_done: set = set()
        self._err_rng: Dict[int, np.random.Generator] = {}
        for k, e in enumerate(self.ctl.events):
            if e.kind == "io_errors":
                self._err_rng[k] = np.random.default_rng(
                    np.random.SeedSequence(
                        [self.ctl.seed, 0xE7707, self.ctl.host_index, k]))
        if self._base_tuning is not None:
            self.sim.store.io.sim.tuning = self._base_tuning
        integ = self.sim.store.io.integrity
        if integ is not None:
            # the data-integrity plane replays from scratch too: fresh RNG,
            # wear state, rebuild stream — every replay of the same trace
            # is bit-identical
            integ.begin_replay()

    def serve(self, trace, chunk: int, bg_iops: float,
              columnar: bool = True, replay_at=None) -> None:
        """Drop-in for ``HostSim.run_trace`` with the control program
        applied. A chunk outside every window goes through the exact calls
        ``serve_trace`` / the dict plane would make. ``replay_at`` (aligned
        with the trace) carries the failover plan's per-query effective
        service-time floors — replayed in-flight queries re-execute at the
        crash instant, and IO-error bursts must judge them there."""
        if replay_at is None:
            for ch in trace.chunks(chunk):
                self._serve_chunk(ch, bg_iops, columnar)
            return
        ra = np.asarray(replay_at, np.float64)
        off = 0
        for ch in trace.chunks(chunk):
            n = len(ch.arrival_us)
            self._serve_chunk(ch, bg_iops, columnar, ra[off:off + n])
            off += n

    # -- one chunk -----------------------------------------------------------

    def _serve_chunk(self, ch, bg: float, columnar: bool,
                     floors: Optional[np.ndarray] = None) -> None:
        sched = self.sim.sched
        arr = np.asarray(ch.arrival_us, np.float64)
        t0, t1 = float(arr[0]), float(arr[-1])
        tel = getattr(self.sim, "telemetry", None)
        for k, e in enumerate(self.ctl.events):
            if e.kind == "crash" and k not in self._crash_done \
                    and t0 >= e.start_us:
                self._crash_done.add(k)
                self._crash_restart(e.cold_restart)
                if tel is not None:
                    tel.recorder.record(e.start_us, "crash_restart",
                                        cold=e.cold_restart)
                    tel.tracer.span("control.crash_window", "control",
                                    e.start_us, e.end_us - e.start_us,
                                    cold=e.cold_restart)
            elif e.kind == "device_loss" and k not in self._loss_done \
                    and t0 >= e.start_us:
                self._loss_done.add(k)
                self._device_loss(e.start_us)
                if tel is not None:
                    tel.recorder.record(e.start_us, "device_loss")
        bg_eff = bg
        swap = None
        for e in self.ctl.events:
            if e.kind == "slow" and e.start_us <= t0 < e.end_us:
                bg_eff += e.slow_bg_iops
                if e.slow_tuning is not None and \
                        self.sim.store.io.sim is not None:
                    swap = e.slow_tuning
        if self._degrade_chunk(sched, arr, t0):
            return
        # replay floors can push a query's effective service time past the
        # chunk's raw arrival span — the burst-overlap test must see that
        t1_eff = t1 if floors is None else max(t1, float(floors.max()))
        errs = [(k, e) for k, e in enumerate(self.ctl.events)
                if e.kind == "io_errors"
                and e.start_us <= t1_eff and e.end_us > t0]
        if swap is not None:
            self.sim.store.io.sim.tuning = swap
        try:
            if errs:
                self._serve_with_errors(sched, ch, arr, bg_eff, columnar,
                                        errs, floors)
            elif columnar:
                sched.serve_columnar(ch.columnar, bg_eff, arrivals_us=arr,
                                     collect=False)
            else:
                sched.serve_batch_dict(ch.requests, bg_eff, arrivals_us=arr)
        finally:
            if swap is not None:
                self.sim.store.io.sim.tuning = self._base_tuning

    def _degrade_chunk(self, sched, arr: np.ndarray, t0: float) -> bool:
        """Hysteresis + failover-pressure check; serves the chunk degraded
        (zero SM IO through the real admission ledger) when triggered."""
        deg = self.ctl.degrade
        if deg is None:
            return False
        # freshen the ledger to the chunk's first arrival before reading
        # it — the serve path below performs the same clock advance, so
        # results are unchanged (the ledger retire is idempotent)
        sched._advance(t0)
        if not self._degraded and sched.inflight >= deg.inflight_hi:
            self._degraded = True
        elif self._degraded and sched.inflight <= deg.inflight_lo:
            self._degraded = False
        pressure = deg.degrade_on_failover and any(
            ws <= t0 < we for ws, we in self.ctl.pressure_windows)
        serving_degraded = self._degraded or pressure
        tel = getattr(self.sim, "telemetry", None)
        if tel is not None and serving_degraded != self._deg_serving:
            tel.recorder.record(
                t0, "degrade_enter" if serving_degraded else "degrade_exit",
                mode=deg.mode,
                cause="failover_pressure" if pressure else "queue_depth")
        self._deg_serving = serving_degraded
        if not serving_degraded:
            return False
        n = len(arr)
        self.degraded_chunks += 1
        if deg.mode == "stale":
            self.stale_served += n
        else:
            self.shed_queries += n
        sched._admit_chunk(np.zeros(n), np.zeros(n, np.int64), arr, False)
        return True

    def _serve_with_errors(self, sched, ch, arr: np.ndarray, bg: float,
                           columnar: bool, errs,
                           floors: Optional[np.ndarray] = None) -> None:
        """Serve a chunk overlapped by IO-error bursts: the data plane runs
        unchanged (collect=True to learn each query's admission), then each
        in-window query retries with ``error_rate`` probability, paying
        ``retry_penalty_us`` on its recorded latency sample. Draws come
        from the event's seeded RNG in arrival order, so the burst is
        reproducible wherever the chunk is served. Deferred queries carry
        no latency sample, so only admitted hits are adjusted (their
        retry happens after re-admission, outside this model).

        ``floors`` are the failover plan's replay floors: a query replayed
        into a failover window re-executes at the crash instant, so the
        burst-window test judges it at ``max(arrival, floor)`` — raw
        arrivals alone would silently skip the penalty for replayed-in
        queries whose original arrival predates the burst."""
        p0 = len(sched.p_lat)
        if columnar:
            results = sched.serve_columnar(ch.columnar, bg, arrivals_us=arr,
                                           collect=True)
        else:
            results = sched.serve_batch_dict(ch.requests, bg,
                                             arrivals_us=arr)
        admitted = np.array([r.admitted for r in results], bool)
        rank = np.cumsum(admitted) - admitted   # admitted-rank per query
        eff = arr if floors is None else np.maximum(arr, floors)
        for k, e in errs:
            rng = self._err_rng[k]
            inw = np.nonzero((eff >= e.start_us) & (eff < e.end_us))[0]
            if not inw.size:
                continue
            hits = inw[rng.random(inw.size) < e.error_rate]
            retried = 0
            for q in hits:
                if admitted[q]:
                    sched.p_lat[p0 + int(rank[q])] += e.retry_penalty_us
                    self.io_error_retries += 1
                    retried += 1
            if retried:
                tel = getattr(self.sim, "telemetry", None)
                if tel is not None:
                    tel.recorder.record(float(eff[hits[0]]),
                                        "io_error_retries", n=retried)

    def _crash_restart(self, cold: bool) -> None:
        """The host restarts: in-flight IOs and the admission ledger are
        lost (the rewritten routing already replayed those queries on a
        replica); a cold restart additionally loses the FM-resident caches
        — wiped exactly the way a fresh ``BatchedRowCache`` starts, with an
        ``evictions`` bump + ``drop_plan_caches`` so every fused replay
        tier re-derives its plans against the post-crash state."""
        sched = self.sim.sched
        sched._events = []
        sched.inflight = 0
        self.crashes += 1
        if not cold:
            return
        s = self.sim.store
        rc = s.row_cache
        rc.tags[:] = EMPTY_TAG
        rc.stamp[:] = 0
        rc.filled = 0
        rc.evictions += 1
        s.drop_plan_caches()
        if s.pooled_cache is not None:
            s.pooled_cache.store.clear()
            s.pooled_cache.used = 0

    def _device_loss(self, at_us: float) -> None:
        """One of the host's SM devices died: its share of rows loses a
        copy. The integrity plane (when attached) starts serving those rows
        from replicas and arms the background rebuild stream; with no plane
        attached the event is recorded but costless (data is assumed
        re-fetchable from the SM catalog). Either way the fused replay
        tiers are invalidated — captured plans assume stable row placement,
        and an ``evictions`` bump + ``drop_plan_caches`` forces the live
        pipeline to re-derive (the caches only accelerate identical
        re-serves, so this is correct by construction, exactly as in
        :meth:`_crash_restart`)."""
        s = self.sim.store
        integ = s.io.integrity
        if integ is not None:
            integ.device_loss(at_us)
        s.row_cache.evictions += 1
        s.drop_plan_caches()

    def finalize_report(self, report):
        """Stamp this replay's control-plane counters onto the report (and,
        when telemetry is enabled, onto the registry — the HostReport
        fields stay as views over the same numbers)."""
        tel = getattr(self.sim, "telemetry", None)
        if tel is not None:
            reg = tel.registry
            reg.set("control.crashes", self.crashes)
            reg.set("control.stale_served", self.stale_served)
            reg.set("control.shed_queries", self.shed_queries)
            reg.set("control.io_error_retries", self.io_error_retries)
            reg.set("control.degraded_chunks", self.degraded_chunks)
        return dataclasses.replace(
            report, crashes=self.crashes, stale_served=self.stale_served,
            shed_queries=self.shed_queries,
            io_error_retries=self.io_error_retries,
            degraded_chunks=self.degraded_chunks)


# -- reactive autoscaler ------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class AutoscalePolicy:
    """Reactive scale-to-target controller. ``host_capacity_qps`` is one
    host's serving capacity (measure it with a single-host run, or use
    ``feasible_qps_p99``); each window the controller looks at the
    *previous* window's measured arrival rate and resizes so utilization
    lands on ``target_util``. The ``[low_util, target_util]`` dead band is
    the hysteresis (no resize while inside it) and ``cooldown_us`` is the
    minimum time between resizes — together they keep bursty arrivals from
    thrashing the fleet."""
    host_capacity_qps: float
    window_us: float = 50_000.0
    target_util: float = 0.7
    low_util: float = 0.35
    cooldown_us: float = 100_000.0
    min_hosts: int = 1
    max_hosts: int = 8
    initial_hosts: Optional[int] = None

    def __post_init__(self):
        if self.host_capacity_qps <= 0 or self.window_us <= 0:
            raise ValueError("capacity and window must be positive")
        if not (0.0 < self.low_util <= self.target_util <= 1.0):
            raise ValueError("need 0 < low_util <= target_util <= 1")
        if not (1 <= self.min_hosts <= self.max_hosts):
            raise ValueError("need 1 <= min_hosts <= max_hosts")


def autoscale_schedule(arrival_us: np.ndarray, duration_us: float,
                       policy: AutoscalePolicy) -> np.ndarray:
    """Active host count per window (int64, one entry per
    ``policy.window_us``). Purely reactive: window ``w``'s decision sees
    only window ``w-1``'s measured rate, so the schedule is a pure
    function of the arrival vector — seeded traces give seeded schedules."""
    arr = np.asarray(arrival_us, np.float64)
    n_w = max(1, int(math.ceil(duration_us / policy.window_us))) \
        if duration_us > 0 else 1
    counts, _ = np.histogram(arr, bins=n_w,
                             range=(0.0, n_w * policy.window_us))
    rate = counts / policy.window_us * 1e6
    active = np.zeros(n_w, np.int64)
    init = policy.min_hosts if policy.initial_hosts is None \
        else policy.initial_hosts
    active[0] = int(np.clip(init, policy.min_hosts, policy.max_hosts))
    last_change = -math.inf
    cap = policy.host_capacity_qps
    for w in range(1, n_w):
        cur = int(active[w - 1])
        r = float(rate[w - 1])
        util = r / (cur * cap)
        desired = cur
        if util > policy.target_util or util < policy.low_util:
            desired = int(math.ceil(r / (policy.target_util * cap))) \
                if r > 0 else policy.min_hosts
        desired = int(np.clip(desired, policy.min_hosts, policy.max_hosts))
        t = w * policy.window_us
        if desired != cur and t - last_change >= policy.cooldown_us:
            active[w] = desired
            last_change = t
        else:
            active[w] = cur
    return active


_STICKY_MULT = np.uint64(0xD6E8FEB86659FD93)   # core.locality.sticky_route


def autoscale_assign(trace, schedule: np.ndarray, policy: AutoscalePolicy,
                     routing: str = "tenant_sticky") -> np.ndarray:
    """Host id per query over the time-varying active set. The sticky
    policies reuse ``sticky_route``'s mix hash with a per-query modulus
    (the window's active count), so while the fleet size is constant the
    assignment matches the static router exactly; round_robin restarts its
    cycle at each window boundary."""
    arr = np.asarray(trace.arrival_us, np.float64)
    schedule = np.asarray(schedule, np.int64)
    w = np.minimum((arr // policy.window_us).astype(np.int64),
                   len(schedule) - 1)
    n_active = schedule[w]
    if routing == "round_robin":
        first = np.searchsorted(w, w, side="left")
        seq = np.arange(len(arr), dtype=np.int64) - first
        return seq % n_active
    if routing == "per_tenant":
        return trace.tenant % n_active
    if routing == "tenant_sticky":
        x = trace.tenant.astype(np.uint64) * _STICKY_MULT
        return ((x >> np.uint64(33)) % n_active.astype(np.uint64)) \
            .astype(np.int64)
    raise ValueError(f"unknown routing {routing!r}")


@dataclasses.dataclass
class AutoscaleResult:
    report: object                        # ClusterReport
    schedule: np.ndarray                  # active hosts per window
    window_us: float
    host_seconds: float                   # sum(active) * window
    static_host_seconds: float            # full fleet up the whole time

    @property
    def host_seconds_saved(self) -> float:
        return self.static_host_seconds - self.host_seconds


def autoscale_run(cluster, trace, policy: AutoscalePolicy, *,
                  passes: int = 1, warmup: bool = False,
                  bg_iops: Optional[Dict[str, float]] = None,
                  columnar: bool = True, parallel=None,
                  failures: Optional[FailureSpec] = None,
                  degrade: Optional[DegradePolicy] = None) -> AutoscaleResult:
    """Run a trace through ``cluster`` under the autoscaler: build the
    reactive schedule, route over the active set, and account
    host-seconds against the static fleet (every host up for the whole
    windowed duration). ``cluster`` must provision ``policy.max_hosts``
    replicas — the schedule only decides how many of them take traffic."""
    if len(cluster.specs) < policy.max_hosts:
        raise ValueError(
            f"cluster has {len(cluster.specs)} hosts; the policy scales "
            f"to {policy.max_hosts}")
    schedule = autoscale_schedule(trace.arrival_us, trace.duration_us,
                                  policy)
    assign = autoscale_assign(trace, schedule, policy,
                              cluster.cfg.routing)
    report = cluster.run(trace, passes=passes, warmup=warmup,
                         bg_iops=bg_iops, columnar=columnar,
                         parallel=parallel, failures=failures,
                         degrade=degrade, assign=assign)
    host_seconds = float(schedule.sum()) * policy.window_us / 1e6
    static = float(len(cluster.specs) * len(schedule)) \
        * policy.window_us / 1e6
    return AutoscaleResult(report=report, schedule=schedule,
                           window_us=policy.window_us,
                           host_seconds=host_seconds,
                           static_host_seconds=static)


# -- capacity planner ---------------------------------------------------------

@dataclasses.dataclass
class PlanOption:
    """One candidate fleet, measured then scaled to the demand (Eq. 7
    judged at the tail: ``feasible_qps_p99``)."""
    name: str
    tail_us: float
    deferred: int
    meets_slo: bool
    fleet_hosts: float
    fleet_power: float


@dataclasses.dataclass
class CapacityPlan:
    slo_us: float
    percentile: float
    demand_qps: float
    options: List[PlanOption]
    best: Optional[str]                   # min-power SLO-meeting candidate
    best_mix: Dict[str, float]            # demand split at mix_step grid
    best_power: float

    def option(self, name: str) -> PlanOption:
        return next(o for o in self.options if o.name == name)


def _simplex(k: int, steps: int) -> Iterator[Tuple[int, ...]]:
    """All compositions of ``steps`` into ``k`` non-negative parts."""
    if k == 1:
        yield (steps,)
        return
    for first in range(steps + 1):
        for rest in _simplex(k - 1, steps - first):
            yield (first,) + rest


def plan_capacity(trace, candidates: Dict[str, "HostSpec"],
                  demand_qps: float, slo_us: float, *,
                  percentile: float = 99.0, count: int = 2,
                  routing: str = "tenant_sticky", chunk: int = 32,
                  passes: int = 2, warmup: bool = True, parallel=None,
                  failures=None, degrade: Optional[DegradePolicy] = None,
                  bg_iops: Optional[Dict[str, float]] = None,
                  mix_step: float = 0.25) -> CapacityPlan:
    """Search the minimum-power candidate mix meeting the SLO.

    Each candidate (a ``HostSpec`` — e.g. HW-SS + Nand, HW-SS + Optane,
    HW-L DRAM-only) is simulated as a ``count``-host homogeneous fleet on
    the trace; it meets the SLO when its measured tail latency
    (``percentile``: 99.0 or 99.9) clears ``slo_us`` with zero deferrals.
    Meeting fleets are scaled to ``demand_qps`` at their tail-judged
    feasible QPS (Eq. 7) and priced; fleet power is linear in how the
    demand is split across candidates, so the cheapest mix is a corner of
    the simplex — the ``mix_step`` grid search reports it (and documents
    the corner-optimality rather than assuming it).

    ``failures`` may be a :class:`FailureSpec` or a callable
    ``host_names -> FailureSpec`` (the homogeneous fleet's replica names
    are only known here); planning *with* failures prices the fleet that
    still meets the SLO while crashing and failing over."""
    from repro_torch.runtime.cluster import homogeneous_cluster
    options: List[PlanOption] = []
    for name, spec in candidates.items():
        sim = homogeneous_cluster(spec, count=count, routing=routing,
                                  chunk=chunk, latency_target_us=slo_us)
        fspec = failures([s.name for s in sim.specs]) \
            if callable(failures) else failures
        rep = sim.run(trace, passes=passes, warmup=warmup,
                      bg_iops=bg_iops, parallel=parallel,
                      failures=fspec, degrade=degrade)
        tail = rep.p999_us if percentile >= 99.9 else rep.p99_us
        deferred = sum(h.deferred for h in rep.hosts)
        meets = tail <= slo_us and deferred == 0
        est = rep.fleet_power(demand_qps, tail=True)
        options.append(PlanOption(name=name, tail_us=tail,
                                  deferred=deferred, meets_slo=meets,
                                  fleet_hosts=est.hosts,
                                  fleet_power=est.power))
    feasible = [o for o in options if o.meets_slo]
    best_mix: Dict[str, float] = {}
    best_power = math.inf
    best = None
    if feasible:
        steps = max(1, int(round(1.0 / mix_step)))
        for combo in _simplex(len(feasible), steps):
            power = sum(f / steps * o.fleet_power
                        for f, o in zip(combo, feasible))
            if power < best_power - 1e-12:
                best_power = power
                best_mix = {o.name: f / steps
                            for f, o in zip(combo, feasible) if f}
        best = min(feasible, key=lambda o: o.fleet_power).name
    return CapacityPlan(slo_us=slo_us, percentile=percentile,
                        demand_qps=demand_qps, options=options, best=best,
                        best_mix=best_mix,
                        best_power=best_power if feasible else 0.0)
