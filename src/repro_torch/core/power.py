"""Warehouse-scale power/TCO model (paper §2.3 Eq. 5–7, §5 Tables 8/9/11).

Normalized component power model calibrated once against the paper's host
descriptions (Table 7/8):  HW-L (2 sockets, 256 GB) := 1.0.  Scenario engines
then *derive* QPS-per-host from Eq. 5 (min of compute / memory-BW / SM-IOPS
feasibility at the latency target), host counts from Eq. 7, and fleet power —
so the paper's 20% / 5% / 29% results come out of the model rather than being
hard-coded.

A copy of ``repro.core.power`` (``tests/test_torch_power.py``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

from repro_torch.core.io_sim import DEVICES, DeviceModel, required_iops

# Normalized component powers, calibrated so HW-L == 1.0 and HW-SS == 0.4
# (Table 8's reported normalized host powers):
#   2*s + 4*d = 1.0        (HW-L: 2 sockets, 256 GB)
#   s + d + 2*ssd = 0.4    (HW-SS: 1 socket, 64 GB, 2 Nand SSDs)
P_SOCKET = 0.26          # one CPU socket, loaded
P_DRAM_PER_64GB = 0.12
P_SSD = 0.01             # NVMe Nand device
P_OPTANE_SSD = 0.015
P_ACCEL = 1.20           # inference accelerator card(s), loaded


@dataclasses.dataclass(frozen=True)
class HostConfig:
    name: str
    sockets: int
    dram_gb: int
    ssds: int = 0
    ssd_kind: str = "nand_flash"
    accel: bool = False
    # relative compute throughput (QPS scale) per socket / accel
    socket_qps: float = 120.0
    accel_qps: float = 450.0

    @property
    def power(self) -> float:
        p = self.sockets * P_SOCKET + (self.dram_gb / 64) * P_DRAM_PER_64GB
        p += self.ssds * (P_OPTANE_SSD if "optane" in self.ssd_kind else P_SSD)
        if self.accel:
            p += P_ACCEL
        return p

    @property
    def device(self) -> Optional[DeviceModel]:
        return DEVICES[self.ssd_kind] if self.ssds else None


# Paper Table 7 hosts.
HW_L = HostConfig("HW-L", sockets=2, dram_gb=256)
HW_S = HostConfig("HW-S", sockets=1, dram_gb=64)
HW_SS = HostConfig("HW-SS", sockets=1, dram_gb=64, ssds=2, ssd_kind="nand_flash")
HW_AN = HostConfig("HW-AN", sockets=1, dram_gb=64, ssds=2, ssd_kind="nand_flash", accel=True)
HW_AO = HostConfig("HW-AO", sockets=1, dram_gb=64, ssds=2, ssd_kind="optane_ssd", accel=True)


@dataclasses.dataclass(frozen=True)
class Workload:
    """Per-query demand for Eq. 5/6."""
    name: str
    sm_tables: int               # user tables on SM
    avg_pool: int
    row_bytes: int
    cache_hit_rate: float        # steady-state FM cache hit rate
    compute_qps_scale: float = 1.0   # model compute heaviness vs baseline host
    latency_budget_us: float = 10_000.0
    total_qps: float = 288_000.0     # fleet demand


def qps_per_host(host: HostConfig, w: Workload, *, use_sdm: bool) -> float:
    """Eq. 5: min(compute-bound QPS, SM-latency-feasible QPS)."""
    compute = (host.accel_qps if host.accel else host.sockets * host.socket_qps)
    compute *= w.compute_qps_scale
    if not use_sdm or host.ssds == 0:
        return compute
    dev = host.device
    # Find the max QPS at which the user-embedding SM path still clears the
    # latency budget (Eq. 3/4: SM time must hide under item-side time).
    lo, hi = 1.0, compute
    for _ in range(40):
        mid = (lo + hi) / 2
        iops = required_iops(mid, w.sm_tables, w.avg_pool, 1 - w.cache_hit_rate)
        if iops >= dev.iops_max * host.ssds * 0.95:
            hi = mid
            continue
        lat = dev.loaded_latency_us(iops / host.ssds, outstanding=32)
        # a query needs ~avg_pool lookups/table pipelined; batched submission
        # completes in a handful of waves — model 2 serial waves
        if 2 * lat <= w.latency_budget_us:
            lo = mid
        else:
            hi = mid
    return min(compute, lo)


@dataclasses.dataclass(frozen=True)
class ScenarioResult:
    name: str
    qps_per_host: float
    host_power: float
    hosts: float
    total_power: float

    def row(self):
        return (self.name, round(self.qps_per_host, 1), round(self.host_power, 3),
                math.ceil(self.hosts), round(self.total_power, 1))


def run_scenario(name: str, host: HostConfig, w: Workload, *, use_sdm: bool,
                 remote_hosts_per: float = 0.0, remote: Optional[HostConfig] = None,
                 qps_override: Optional[float] = None) -> ScenarioResult:
    """Eq. 7: hosts = total / per-host QPS; power = hosts * host power
    (+ scale-out remote tier if configured)."""
    qps = qps_override if qps_override is not None else qps_per_host(host, w, use_sdm=use_sdm)
    hosts = w.total_qps / qps
    power = hosts * host.power
    if remote_hosts_per and remote is not None:
        power += hosts * remote_hosts_per * remote.power
    return ScenarioResult(name, qps, host.power, hosts, power)


def normalize(results, baseline: str):
    """Scale powers so the named baseline scenario == its host count * 1.0
    (the paper normalizes per-host power to the baseline host)."""
    base = next(r for r in results if r.name == baseline)
    scale = 1.0 / base.host_power
    out = []
    for r in results:
        out.append(ScenarioResult(r.name, r.qps_per_host, r.host_power * scale,
                                  r.hosts, r.total_power * scale))
    return out


# --- Multi-tenancy roofline (Table 10/11) ----------------------------------


def multitenancy_power(*, base_util: float = 0.63, sdm_util: float = 0.90,
                       extra_host_power_frac: float = 0.01) -> dict:
    """Table 11: fleet power scales inversely with achieved utilization;
    SDM hosts pay a small SSD power adder but co-locate experimental models
    (no memory-capacity bound), raising utilization."""
    base_fleet = 1.0
    sdm_fleet = (base_util / sdm_util) * (1.0 + extra_host_power_frac)
    return {
        "HW-FA": {"power": 1.0, "utilization": base_util, "fleet_power": base_fleet},
        "HW-FAO + SDM": {"power": 1.0 + extra_host_power_frac, "utilization": sdm_util,
                         "fleet_power": round(sdm_fleet, 3)},
        "saving": round(1.0 - sdm_fleet, 3),
    }


def m3_ssd_provisioning(*, qps: float = 3150, tables: int = 2000, pool: int = 30,
                        hit_rate: float = 0.80, device: str = "optane_ssd") -> dict:
    """Table 10: #SSDs from the IOPS the user-embedding path needs."""
    dev = DEVICES[device]
    miss_iops = required_iops(qps, tables, pool, 1 - hit_rate)
    return {
        "required_miops": miss_iops / 1e6,
        "num_ssds": math.ceil(miss_iops / dev.iops_max),
    }
