"""Event-driven SCM device simulator — the sampled latency plane.

The analytic path (``core/io_sim.IOEngine``) prices every IO batch with one
closed-form mean, so tail latency is shaped only by arrival times. This
module replaces that mean with a queueing simulation per device plane:

* each of the ``num_devices`` devices exposes ``DeviceModel.channels``
  parallel service slots (NVMe channel/die parallelism). A submission fans
  its IOs out across devices exactly like the analytic path (``per_dev =
  ceil(n / num_devices)``, queue depth capped by the §4.1 tuning knobs),
  and each device share executes as ``ceil(per_dev / outstanding)`` serial
  *waves* on the earliest-free slot — arrivals that cluster faster than
  slots drain genuinely queue;
* per-wave service times are sampled from a lognormal whose mean is the
  device's analytic ``loaded_latency_us`` at the *external* background load
  and the wave's queue depth — a wave's sample stands for the completion of
  its critical (slowest) IO at that depth. Calibration is by construction:
  with idle queues the sampled mean reproduces the analytic curve, and the
  device-specific dispersion ``service_cv`` shapes the tail (Nand
  heavy-tailed, 3DXP tight);
* the *depth knee*: when the device plane's aggregate outstanding IOs (all
  concurrent submissions' device-visible depth) cross ``num_devices *
  DeviceModel.max_outstanding``, service inflates superlinearly — the same
  ``(depth / knee)^2`` collapse the analytic model applies per submission,
  now driven by measured concurrency. This is where Fig. 3's dynamic
  difference lives: Nand's knee (64/device) is crossed by modest bursts,
  Optane's (1024/device) almost never — and it is what the
  ``max_outstanding`` throttle controls;
* the write plane (``devices/writes.py``) interleaves endurance-bounded
  model-update write waves into the same slots — program+GC service on Nand
  is long and occasionally collected, so concurrent reads queue behind it;
  3DXP writes are short and GC-free (§3's interference asymmetry). The
  ``read_priority`` knob moves writes out of the reads' way;
* ``smoothing_window_us`` paces admissions through a token bucket
  (``smoothing_iops``) so arrival bursts spread out instead of slamming the
  queues at one instant.

Everything is seeded and bit-reproducible: service and GC draws are consumed
in submission order, so the same trace through the same-seeded simulator
yields identical latencies. ``IOEngine`` routes its submissions here when
constructed with ``sim=`` (``SDMConfig(latency_mode="sampled")``); without
it the analytic formulas run untouched, bit for bit.

A copy of ``repro.devices.sim``: the generators are seeded as the
reference's, and draws are consumed in the same order
(``tests/test_torch_devices.py``).
"""
from __future__ import annotations

import heapq
import math
from typing import List, Optional, Tuple

import numpy as np

from repro_torch.core.io_sim import DeviceModel, IOQueueConfig
from repro_torch.devices.tuning import DEFAULT_TUNING, DeviceTuning
from repro_torch.devices.writes import UpdateSpec, UpdateStream


class DeviceSim:
    """Queueing simulator for one host's SM device plane."""

    def __init__(self, device: DeviceModel, num_devices: int = 1,
                 queue: Optional[IOQueueConfig] = None,
                 tuning: DeviceTuning = DEFAULT_TUNING,
                 update: Optional[UpdateSpec] = None, seed: int = 0):
        self.device = device
        self.num_devices = num_devices
        self.queue = queue or IOQueueConfig()
        self.tuning = tuning
        self.rng = np.random.default_rng(
            np.random.SeedSequence([seed, 0xD54E]))
        self.update = (UpdateStream(update, device, num_devices,
                                    np.random.default_rng(
                                        np.random.SeedSequence([seed, 0x3417])))
                       if update is not None else None)
        self.slot_free_us = np.zeros(num_devices * device.channels, np.float64)
        self._rr = 0      # data-residency rotation: which channel serves next
        self.now_us = 0.0
        # additional background write-shaped streams (rebuild/scrub planes):
        # any object with the UpdateStream pop_until contract. Admitted into
        # the same channel-slot ledger as model-refresh writes, so rebuild
        # traffic competes with foreground reads identically.
        self.extra_streams: List = []
        self.repair_busy_us = 0.0
        # aggregate depth ledger: (completion_us, device-visible IOs)
        self._depth_events: List[tuple] = []
        self._depth = 0
        self._knee = num_devices * device.max_outstanding
        # slot-seconds per IO at full throughput: all slots busy <=> the
        # device plane sustains its IOPS ceiling
        self._io_interval_us = device.channels / device.iops_max * 1e6
        # lognormal dispersion: cv^2 = exp(sigma^2) - 1
        self._sigma = math.sqrt(math.log(1.0 + device.service_cv ** 2))
        # burst-smoothing token bucket
        self._pace_rate = (tuning.smoothing_iops or
                           num_devices * device.iops_max) / 1e6  # IOs per us
        self._tokens = self._pace_depth = (
            tuning.smoothing_window_us * self._pace_rate)
        self._tok_t = 0.0
        # accounting
        self.read_waves = 0
        self.read_ios = 0
        self.read_busy_us = 0.0
        self.write_busy_us = 0.0
        self.smoothing_delay_us = 0.0
        self.depth_collapses = 0      # submissions priced past the knee
        self.telemetry = None         # obs handle; None = bit-invisible

    # -- internals -----------------------------------------------------------

    def _sample_chain(self, n_waves: int, mean_wave_us: float) -> float:
        """Total service of one device share: ``n_waves`` serial waves, each
        sampled lognormal with mean ``mean_wave_us`` (the critical IO of an
        ``outstanding``-deep wave). E[chain] == n_waves * mean_wave_us."""
        if self.device.service_cv <= 0.0:
            return n_waves * mean_wave_us
        mu = math.log(mean_wave_us) - 0.5 * self._sigma ** 2
        return float(self.rng.lognormal(mu, self._sigma, n_waves).sum())

    def _admit_writes(self, t_us: float) -> None:
        """Fold every write wave due by ``t_us`` into the slot queues."""
        if self.update is None and not self.extra_streams:
            return
        free = self.slot_free_us
        read_priority = self.tuning.read_priority
        tel = self.telemetry
        if self.update is not None:
            for at, service in self.update.pop_until(t_us):
                self.write_busy_us += service
                if tel is not None:
                    tel.tracer.span("io.write_wave", "io", at, service,
                                    gc=bool(service > self.update.service_us))
                if read_priority:
                    # §4.1 read-priority: programs are suspendable — update
                    # writes reclaim read-idle channel time and never block a
                    # read (their throughput cost is theirs alone)
                    continue
                # firmware default: the program occupies the die the data
                # lands on — the same residency rotation reads follow, so
                # subsequent reads on that channel queue behind the program
                # (+GC)
                slot = self._rr % len(free)
                self._rr += 1
                free[slot] = max(at, free[slot]) + service
        # rebuild/scrub streams share the ledger; their programs are never
        # read-priority-suspendable (they ARE the recovery path) but they
        # follow the same residency rotation.
        for stream in self.extra_streams:
            for at, service in stream.pop_until(t_us):
                self.repair_busy_us += service
                if tel is not None:
                    tel.tracer.span("io.rebuild_wave", "io", at, service)
                slot = self._rr % len(free)
                self._rr += 1
                free[slot] = max(at, free[slot]) + service

    def _smooth(self, t_us: float, num_ios: int) -> float:
        """Token-bucket admission pacing; returns the admission time."""
        if self._pace_depth <= 0.0:
            return t_us
        self._tokens = min(self._pace_depth,
                           self._tokens + (t_us - self._tok_t) * self._pace_rate)
        self._tok_t = t_us
        if self._tokens >= num_ios:
            self._tokens -= num_ios
            return t_us
        wait = (num_ios - self._tokens) / self._pace_rate
        self._tokens = 0.0
        self._tok_t = t_us + wait
        self.smoothing_delay_us += wait
        return t_us + wait

    def _retire_depth(self, t_us: float) -> None:
        while self._depth_events and self._depth_events[0][0] <= t_us:
            _, ios = heapq.heappop(self._depth_events)
            self._depth -= ios

    # -- submission API ------------------------------------------------------

    def submit(self, at_us: float, num_ios: int, bg_iops: float = 0.0) -> float:
        """One coalesced read submission of ``num_ios`` row reads arriving at
        ``at_us`` (clock never moves backwards). Returns its latency: queue
        wait + sampled service, measured from the arrival."""
        t = max(self.now_us, float(at_us))
        self.now_us = t
        self._admit_writes(t)
        if num_ios <= 0:
            return 0.0
        t_adm = self._smooth(t, num_ios)
        self._retire_depth(t_adm)
        dev = self.device
        per_dev = -(-num_ios // self.num_devices)
        outstanding = self.tuning.effective_outstanding(
            per_dev, self.queue.max_outstanding_per_table)
        n_waves = -(-per_dev // outstanding)
        ndev = -(-num_ios // per_dev)
        # device-visible depth: only `outstanding` IOs per device share sit
        # in the device queues at a time (the rest wait host-side), held for
        # the share's slot occupancy
        visible = outstanding * ndev
        depth = self._depth + visible
        # slot occupancy is throughput-conserving: per_dev IOs cost per_dev
        # IO-intervals of slot time no matter how deep they were submitted
        # (external background load shrinks the available throughput)
        rho = min((bg_iops / self.num_devices) / dev.iops_max, 0.999)
        hold = per_dev * self._io_interval_us / (1.0 - rho)
        # completion latency: ceil(per_dev/outstanding) serial waves, each a
        # loaded-latency sample — the depth/latency tradeoff the throttle
        # buys (more waves = slower completion, same slot occupancy)
        mean_wave = dev.loaded_latency_us(bg_iops / self.num_devices,
                                          outstanding)
        service = self._sample_chain(n_waves, mean_wave)
        if depth > self._knee:
            # aggregate outstanding past the device knee: the superlinear
            # collapse the analytic model prices per submission, driven here
            # by measured concurrency — what the max_outstanding throttle
            # keeps bounded. The thrash prices THIS submission's completion;
            # occupancy and the depth ledger stay at the base service rate
            # (a real controller's queues are finite — feeding the inflation
            # back into occupancy would death-spiral the whole plane).
            service *= (depth / self._knee) ** 2
            self.depth_collapses += 1
        # the submission's device shares are statistically identical: each
        # occupies a slot for the same hold. The slot is chosen by data
        # residency (a rotating channel pointer), NOT earliest-free — a read
        # must be served by the channel its row lives on, which is what lets
        # a long write/GC program genuinely block reads behind it
        free = self.slot_free_us
        slots = (self._rr + np.arange(ndev)) % len(free)
        self._rr = (self._rr + ndev) % len(free)
        starts = np.maximum(t_adm, free[slots])
        free[slots] = starts + hold
        start_max = float(starts.max())
        heapq.heappush(self._depth_events, (start_max + hold, visible))
        self._depth += visible
        self.read_waves += ndev * n_waves
        self.read_ios += num_ios
        self.read_busy_us += ndev * hold
        tel = self.telemetry
        if tel is not None:
            tel.registry.observe("device.queue_wait_us", start_max - t_adm)
            tel.registry.observe("device.service_us", service)
            tel.tracer.counter("device.depth", t_adm, self._depth)
            tel.tracer.span("io.read_wave", "io", t_adm,
                            start_max + service - t_adm,
                            ios=num_ios, waves=int(ndev * n_waves))
        return start_max + service - t

    def submit_batch(self, at_us: np.ndarray, num_ios: np.ndarray,
                     bg_iops: float = 0.0) -> np.ndarray:
        """Vectorized entry: many submissions with per-element arrival times,
        processed in arrival order (stable for ties) so the queue dynamics —
        and the RNG draw order — are independent of input layout within a
        timestamp. Returns latencies aligned to the inputs."""
        at = np.asarray(at_us, np.float64)
        n = np.asarray(num_ios, np.int64)
        lat = np.zeros(len(n), np.float64)
        order = np.argsort(at, kind="stable")
        for i in order.tolist():
            if n[i] > 0:
                lat[i] = self.submit(float(at[i]), int(n[i]), bg_iops)
        return lat

    def reset_clock(self) -> None:
        """Rewind simulated time to 0 with empty queues (a measurement pass
        replaying a trace from its first arrival must not queue behind the
        warmup pass's end time). RNG streams are NOT rewound — draws continue
        in submission order, so a fixed seed still fully determines a run —
        and the write stream re-schedules its first wave from t=0."""
        self.slot_free_us[:] = 0.0
        self._rr = 0
        self.now_us = 0.0
        self._depth_events = []
        self._depth = 0
        self._tokens = self._pace_depth
        self._tok_t = 0.0
        if self.update is not None and np.isfinite(self.update.mean_gap_us):
            self.update.next_us = self.update._gap()
        for stream in self.extra_streams:
            stream.reset_clock()

    # -- reporting -----------------------------------------------------------

    def utilization(self) -> Tuple[float, float]:
        """(read, write) slot-time utilization over the simulated span."""
        span = max(self.now_us, 1e-9) * len(self.slot_free_us)
        return self.read_busy_us / span, self.write_busy_us / span
