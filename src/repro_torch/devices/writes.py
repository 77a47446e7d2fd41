"""Write plane: background model-update streams (§3 endurance math).

Serving is not read-only: embedding tables are periodically refreshed from
training, and the refresh cadence is *endurance-bounded* —
``DeviceModel.update_interval_days`` says how often a full-model rewrite can
be sustained at the device's DWPD rating. An :class:`UpdateSpec` describes
the refresh workload (model size, optional cadence override, write chunk
size); :class:`UpdateStream` compiles it against a device into a
deterministic stream of write *waves* the event-driven simulator interleaves
with reads:

* wave arrival gaps are exponential around the mean implied by the update
  bandwidth (model bytes / interval), seeded and reproducible;
* wave service time is ``chunk_bytes / write_bw`` — and on GC devices
  (Nand: ``gc_prob > 0``) a sampled fraction of programs triggers a
  collection pause that multiplies service by ``gc_factor``. 3DXP writes in
  place (``gc_prob == 0``) and at higher bandwidth, so the same update
  stream barely perturbs its read tail — the paper's read/write-interference
  asymmetry (§3).

A copy of ``repro.devices.writes`` (``tests/test_torch_devices.py``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from repro_torch.core.io_sim import DeviceModel


@dataclasses.dataclass(frozen=True)
class UpdateSpec:
    """A background model-refresh workload."""
    model_size_gb: float = 1000.0
    # None = refresh as often as endurance allows (update_interval_days);
    # an explicit value models a fixed training-push cadence.
    interval_days: Optional[float] = None
    chunk_bytes: int = 1 << 20          # write-wave granularity (1 MiB)

    def interval_for(self, device: DeviceModel) -> float:
        """Refresh interval in days (endurance-bounded unless overridden)."""
        if self.interval_days is not None:
            return self.interval_days
        days = device.update_interval_days(self.model_size_gb)
        return days if days > 0 else float("inf")

    def write_bytes_per_us(self, device: DeviceModel) -> float:
        interval_us = self.interval_for(device) * 86_400.0 * 1e6
        if not np.isfinite(interval_us) or interval_us <= 0:
            return 0.0
        return self.model_size_gb * 2.0**30 / interval_us


class UpdateStream:
    """Deterministic write-wave generator for one simulated device plane."""

    def __init__(self, spec: UpdateSpec, device: DeviceModel,
                 num_devices: int, rng: np.random.Generator):
        self.spec = spec
        self.device = device
        self.rng = rng
        rate = spec.write_bytes_per_us(device) / max(1, num_devices)
        # mean gap between chunk-sized write waves on ONE device (us)
        self.mean_gap_us = (spec.chunk_bytes / rate) if rate > 0 else float("inf")
        # service: chunk over the device's write bandwidth (GB/s ~ bytes/us
        # x 1e3); GB here is 2**30 to match the capacity/endurance units
        bw_bytes_per_us = device.write_bw_gbs * 2.0**30 / 1e6
        self.service_us = spec.chunk_bytes / bw_bytes_per_us
        self.next_us = self._gap() if np.isfinite(self.mean_gap_us) else np.inf
        self.waves = 0
        self.gc_events = 0

    def _gap(self) -> float:
        return float(self.rng.exponential(self.mean_gap_us))

    def pop_until(self, t_us: float):
        """Yield ``(arrival_us, service_us)`` for every write wave due by
        ``t_us``, advancing the stream. GC pauses are sampled here so the
        draw order (and thus the whole simulation) is reproducible."""
        while self.next_us <= t_us:
            at = self.next_us
            service = self.service_us
            if self.device.gc_prob > 0 and \
                    self.rng.random() < self.device.gc_prob:
                service *= self.device.gc_factor
                self.gc_events += 1
            self.waves += 1
            self.next_us = at + self._gap()
            yield at, service
