"""§4.1 Tuning API — the SDM knobs exposed to serving operators.

The paper's SDM layer exposes device-level controls that trade a little mean
latency for a lot of tail latency on burst-sensitive technologies (Nand):

* **outstanding-IO throttling** (``max_outstanding``): cap the queue depth a
  single submission may put on one device. The device's aggregate knee is
  ``DeviceModel.max_outstanding`` IOs per device — when the *sum* of
  concurrently outstanding IOs crosses it, service collapses superlinearly
  (Fig. 3's loaded knee). Throttling trades extra serial waves for staying
  under the knee during bursts: slightly worse unloaded mean, far better
  loaded p99 on Nand; a no-op on 3DXP, whose knee is ~16x higher.
* **burst smoothing** (``smoothing_window_us``, ``smoothing_iops``): a token
  bucket pacing IO admission at ``smoothing_iops`` (default: the device
  plane's IOPS envelope); the window sizes the bucket, i.e. the burst
  allowance before pacing kicks in.
* **read-priority scheduling** (``read_priority``): background model-update
  programs become suspendable — they reclaim read-idle channel time and
  never block a read. The firmware default instead programs the die the
  data lands on, so reads to that channel queue behind the program (and its
  occasional GC), which is what collapses the Nand read tail during updates.

`DeviceTuning` is consumed by :class:`repro_torch.devices.sim.DeviceSim`; the
analytic latency path ignores it (its only burst control is the
`IOQueueConfig.max_outstanding_per_table` cap both modes share).

A copy of ``repro.devices.tuning`` (``tests/test_torch_devices.py``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class DeviceTuning:
    """Knob settings for one device plane (see module docstring)."""
    max_outstanding: Optional[int] = None   # None = no SDM throttle
    smoothing_window_us: float = 0.0        # 0 = smoothing off
    smoothing_iops: Optional[float] = None  # None = device-plane envelope
    read_priority: bool = False             # False = firmware FCFS (untuned)

    def effective_outstanding(self, per_dev: int, per_table_cap: int) -> int:
        """Queue depth one submission puts on one device after every cap."""
        out = min(per_dev, per_table_cap)
        if self.max_outstanding is not None:
            out = min(out, self.max_outstanding)
        return max(1, out)

    def degraded(self, max_outstanding: int = 1) -> "DeviceTuning":
        """The slow-host knob set the control plane swaps in mid-trace
        (``FailureEvent.slow_tuning``): the §4.1 throttle driven to
        ``max_outstanding`` (near-serial IO waves — a dying device that
        still answers, slowly), smoothing and read-priority kept as
        configured. ``DeviceSim`` reads throttle and read-priority per
        submission, so the swap takes effect at the next IO; the smoothing
        token bucket is sized at construction and keeps its original rate."""
        if max_outstanding < 1:
            raise ValueError("max_outstanding must be >= 1")
        return dataclasses.replace(self, max_outstanding=max_outstanding)


#: The untuned default: no throttle, no smoothing, firmware-FCFS writes.
DEFAULT_TUNING = DeviceTuning()
