"""SM device models and IO-path pricing (paper Table 1, Fig. 3, §4.1).

A copy of the reference's numpy accounting (``repro.core.io_sim``), kept
float64 operation for operation so per-query latencies are bit-equal to it.
Two latency modes share every other piece of accounting (bus bytes, read
amplification, IO counters): the *analytic* mode prices each submission with
the closed-form loaded-latency mean, and the *sampled* mode, when the engine
is built with a ``devices.sim.DeviceSim``, routes submissions with their
arrival times (``at_us``) through the event-driven device queues. An attached
data-integrity plane (``runtime/redundancy.RedundancyPlane``) adds rebuild
background load before the latency and corruption, retries and hedging after
it.

The loaded-latency curve follows an M/M/c-like server: latency rises as
rho -> 1 (Optane stays flat; Nand collapses early and needs outstanding-IO
throttling).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict

import numpy as np


@dataclasses.dataclass(frozen=True)
class DeviceModel:
    name: str
    iops_max: float            # random-read IOPS ceiling (per device)
    base_latency_us: float     # unloaded access latency
    access_granularity: int    # bytes per native read
    endurance_dwpd: float      # physical drive writes per day (0 = n/a)
    cost_rel_dram: float       # $/GB relative to DDR4
    power_w: float             # active device power (W)
    sourcing: str              # 'multi' | 'single'
    write_bw_gbs: float = 1.0
    capacity_gb: float = 2000.0
    # latency curve shape: lat = base / (1 - rho)^alpha, clipped
    alpha: float = 1.0
    # burst sensitivity: queue depth above which latency degrades superlinearly
    max_outstanding: int = 256
    # -- event-driven simulator shape (devices/sim.py) -----------------------
    # parallel service channels per device: how many IO waves the device can
    # execute concurrently before queueing sets in
    channels: int = 8
    # dispersion of sampled service times (coefficient of variation): Nand is
    # heavy-tailed (program/erase interference), 3DXP is tight
    service_cv: float = 0.3
    # GC under writes: probability a program triggers a collection pause, and
    # the service-time multiplier when it does (0/1 = no GC)
    gc_prob: float = 0.0
    gc_factor: float = 1.0

    def loaded_latency_us(self, iops: float, outstanding: int = 32) -> float:
        rho = min(iops / self.iops_max, 0.999)
        lat = self.base_latency_us / (1.0 - rho) ** self.alpha
        if outstanding > self.max_outstanding:
            lat *= (outstanding / self.max_outstanding) ** 2  # burst collapse
        return lat

    def read_amplification(self, row_bytes: int, small_granularity: bool) -> float:
        """Bytes moved / bytes wanted. §4.1.1's DWORD reads -> amplification 1."""
        if small_granularity:
            return 1.0
        return max(1.0, self.access_granularity / row_bytes)

    def update_interval_days(self, model_size_gb: float, capacity_gb: float = None) -> float:
        """Endurance -> min full-model update interval (§3):
        interval = model_size / (DWPD * capacity) days."""
        cap = capacity_gb or self.capacity_gb
        if not self.endurance_dwpd:
            return 0.0
        return model_size_gb / (self.endurance_dwpd * cap)


# Table 1 (public-information constants). Latency O(100)/O(10)/O(0.1) us.
DEVICES: Dict[str, DeviceModel] = {
    "nand_flash": DeviceModel(
        name="PCIe Nand Flash", iops_max=0.5e6, base_latency_us=90.0,
        access_granularity=4096, endurance_dwpd=5, cost_rel_dram=1 / 30,
        power_w=10.0, sourcing="multi", capacity_gb=2000, alpha=1.6,
        max_outstanding=64,
        channels=4, service_cv=0.85, gc_prob=0.06, gc_factor=8.0),
    "optane_ssd": DeviceModel(
        name="PCIe 3DXP (Optane)", iops_max=4.0e6, base_latency_us=9.0,
        access_granularity=512, endurance_dwpd=100, cost_rel_dram=1 / 5,
        power_w=14.0, sourcing="single", capacity_gb=400, alpha=0.7,
        max_outstanding=1024, write_bw_gbs=2.2,
        channels=16, service_cv=0.2),
    "zssd": DeviceModel(
        name="PCIe ZSSD", iops_max=1.0e6, base_latency_us=30.0,
        access_granularity=4096, endurance_dwpd=5, cost_rel_dram=1 / 10,
        power_w=10.0, sourcing="single", capacity_gb=800, alpha=1.3,
        max_outstanding=128, write_bw_gbs=1.5,
        channels=8, service_cv=0.5, gc_prob=0.04, gc_factor=5.0),
    "optane_dimm": DeviceModel(
        name="DIMM 3DXP (Optane)", iops_max=40e6, base_latency_us=0.3,
        access_granularity=64, endurance_dwpd=0, cost_rel_dram=1 / 3,
        power_w=15.0, sourcing="single", capacity_gb=512, alpha=0.5,
        channels=64, service_cv=0.05),
    "cxl_3dxp": DeviceModel(
        name="CXL 3DXP", iops_max=12e6, base_latency_us=0.6,
        access_granularity=128, endurance_dwpd=0, cost_rel_dram=1 / 4,
        power_w=15.0, sourcing="single", capacity_gb=1024, alpha=0.5,
        channels=32, service_cv=0.05),
}


@dataclasses.dataclass
class IOQueueConfig:
    """§4.1 Tuning API: outstanding IOs per table / tables in flight."""
    max_outstanding_per_table: int = 32
    max_tables_in_flight: int = 16
    small_granularity: bool = True  # §4.1.1 DWORD reads enabled


class IOEngine:
    """Batched async IO pricing (io_uring analogue): submit a query's misses,
    receive per-batch latency + bus bytes from the device model.

    With ``sim=None`` (analytic mode) the ``at_us`` arguments are ignored and
    each submission is priced with the closed-form loaded-latency mean; with
    a ``devices.sim.DeviceSim`` (sampled mode) submissions queue in its
    device queues at their arrival times. ``integrity`` (a
    ``runtime.redundancy.RedundancyPlane``, None by default) is consulted
    for rebuild background load before the latency and for corruption,
    retries and hedging after it; None leaves every path bit for bit as
    without it."""

    def __init__(self, device: DeviceModel, num_devices: int = 1,
                 queue: IOQueueConfig = IOQueueConfig(), sim=None):
        self.device = device
        self.num_devices = num_devices
        self.queue = queue
        self.sim = sim          # devices.sim.DeviceSim when latency_mode="sampled"
        self.integrity = None   # runtime.redundancy.RedundancyPlane, if any
        self.telemetry = None   # obs handle; None leaves every path untouched
        self.total_ios = 0
        self.total_bus_bytes = 0
        self.total_wanted_bytes = 0

    def submit(self, num_ios: int, row_bytes: int, bg_iops: float,
               at_us: float = None):
        """One batched submission of ``num_ios`` row reads while the device
        sustains ``bg_iops`` background load, arriving at ``at_us`` (sampled
        mode and the integrity plane's clock). Returns (latency_us,
        bus_bytes): IOs fan out across devices; latency is the slowest
        device's latency for its share of the batch."""
        if num_ios == 0:
            return 0.0, 0
        integ = self.integrity
        if self.sim is not None:
            at = self.sim.now_us if at_us is None else at_us
            lat = self.sim.submit(at, num_ios, bg_iops)
        else:
            at = 0.0 if at_us is None else at_us
            if integ is not None:
                extra = integ.extra_bg_iops(at)
                if extra:
                    bg_iops = bg_iops + extra
            per_dev = math.ceil(num_ios / self.num_devices)
            outstanding = min(per_dev, self.queue.max_outstanding_per_table)
            waves = math.ceil(per_dev / max(1, outstanding))
            lat = waves * self.device.loaded_latency_us(
                bg_iops / self.num_devices, outstanding)
        if integ is not None:
            lat = integ.apply_scalar(at, num_ios, lat)
        amp = self.device.read_amplification(row_bytes, self.queue.small_granularity)
        bus = int(num_ios * row_bytes * amp)
        self.total_ios += num_ios
        self.total_bus_bytes += bus
        self.total_wanted_bytes += num_ios * row_bytes
        if self.telemetry is not None:
            self.telemetry.registry.inc("io.submissions")
            self.telemetry.registry.observe("io.lat_us", lat)
        return lat, bus

    def _latencies(self, n: np.ndarray, nz: np.ndarray, bg_iops: float,
                   at_us) -> np.ndarray:
        """Latency of every submission of ``n`` (0 where ``n`` is 0).
        Analytic mode: ``loaded_latency_us`` vectorized over the nonzero
        submissions (rho shared), the same double-precision sequence as
        ``submit``; sampled mode: the device queues at ``at_us``. Then the
        integrity plane, if attached."""
        integ = self.integrity
        if self.sim is not None:
            at = (np.full(n.shape, self.sim.now_us) if at_us is None
                  else np.asarray(at_us, np.float64))
            lat = self.sim.submit_batch(at, n, bg_iops)
        else:
            at = (np.zeros(n.shape) if at_us is None
                  else np.asarray(at_us, np.float64))
            if integ is not None:
                extra = integ.extra_bg_iops(float(at.max()))
                if extra:
                    bg_iops = bg_iops + extra
            per_dev = -(-n[nz] // self.num_devices)
            outstanding = np.minimum(per_dev,
                                     self.queue.max_outstanding_per_table)
            waves = -(-per_dev // np.maximum(1, outstanding))
            rho = min((bg_iops / self.num_devices) / self.device.iops_max,
                      0.999)
            base = self.device.base_latency_us / (1.0 - rho) ** self.device.alpha
            l = np.full(per_dev.shape, base, np.float64)
            burst = outstanding > self.device.max_outstanding
            l[burst] *= (outstanding[burst] / self.device.max_outstanding) ** 2
            lat = np.zeros(n.shape, np.float64)
            lat[nz] = waves * l
        if integ is not None:
            lat = integ.apply(at, n, lat)
        return lat

    def submit_batch(self, num_ios: np.ndarray, row_bytes: int, bg_iops: float,
                     at_us: np.ndarray = None):
        """Vectorized :meth:`submit` for many independent submissions (one per
        query) against one table/device. Returns (latency_us [Q] f64,
        bus_bytes [Q] i64), bit-identical to element-wise ``submit``."""
        n = np.asarray(num_ios, np.int64)
        bus = np.zeros(n.shape, np.int64)
        nz = n > 0
        if not nz.any():
            return np.zeros(n.shape, np.float64), bus
        lat = self._latencies(n, nz, bg_iops, at_us)
        amp = self.device.read_amplification(row_bytes, self.queue.small_granularity)
        b = (n[nz] * row_bytes * amp).astype(np.int64)
        bus[nz] = b
        self.total_ios += int(n.sum())
        self.total_bus_bytes += int(b.sum())
        self.total_wanted_bytes += int(n.sum()) * row_bytes
        if self.telemetry is not None:
            self.telemetry.registry.inc("io.submissions", int(nz.sum()))
            self.telemetry.registry.observe_many("io.lat_us", lat[nz])
        return lat, bus

    def submit_batch_multi(self, num_ios: np.ndarray, row_bytes: np.ndarray,
                           bg_iops: float, at_us: np.ndarray = None):
        """One coalesced submission covering many (table, query) pairs with
        per-element row sizes. Latency depends only on the IO count (row size
        enters via bus bytes), so this is bit-identical to per-element
        ``submit`` calls. In sampled mode ``at_us`` carries each element's
        arrival time into the device queues (served in arrival order)."""
        n = np.asarray(num_ios, np.int64)
        rb = np.asarray(row_bytes, np.int64)
        bus = np.zeros(n.shape, np.int64)
        nz = n > 0
        if not nz.any():
            return np.zeros(n.shape, np.float64), bus
        lat = self._latencies(n, nz, bg_iops, at_us)
        if self.queue.small_granularity:
            amp = 1.0
        else:
            amp = np.maximum(1.0, self.device.access_granularity / rb[nz])
        b = (n[nz] * rb[nz] * amp).astype(np.int64)
        bus[nz] = b
        self.total_ios += int(n.sum())
        self.total_bus_bytes += int(b.sum())
        self.total_wanted_bytes += int((n * rb).sum())
        if self.telemetry is not None:
            self.telemetry.registry.inc("io.submissions", int(nz.sum()))
            self.telemetry.registry.observe_many("io.lat_us", lat[nz])
        return lat, bus

    @property
    def bus_overhead(self) -> float:
        if not self.total_wanted_bytes:
            return 0.0
        return self.total_bus_bytes / self.total_wanted_bytes - 1.0


def required_iops(qps: float, tables: int, avg_pooling: float, miss_rate: float = 1.0) -> float:
    """Eq. 8: IOPS ∝ QPS * Σ p_i (over SM tables), scaled by cache miss rate."""
    return qps * tables * avg_pooling * miss_rate


def bw_per_query_bytes(batch: int, tables: int, avg_pooling: float, row_bytes: float) -> float:
    """Eq. 2 inner term for one side (user or item)."""
    return batch * tables * avg_pooling * row_bytes
