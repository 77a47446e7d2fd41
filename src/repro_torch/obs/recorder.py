"""Bounded flight recorder for control-plane events.

A fixed-capacity ring (``collections.deque(maxlen=...)``) of the most
recent notable events — crash/restart latches, failover windows, degrade
transitions, retry-ladder escalations, rebuild lifecycle — kept cheap
enough to run always-on when telemetry is enabled. On an anomaly (any
crash, device loss, or data loss in the run) the report CLI dumps the ring
for post-mortem; otherwise it stays silent.

Events carry the simulated timestamp, a kind tag, the host, a per-recorder
monotone sequence number (for a stable sort among same-µs events), and
free-form details. Like the rest of the obs plane it consumes no RNG and
no wallclock. A copy of ``repro.obs.recorder``.
"""
from __future__ import annotations

from collections import deque
from typing import List, Optional

# Kinds considered anomalous enough to trigger a post-mortem dump.
ANOMALY_KINDS = frozenset({
    "crash_restart", "device_loss", "rebuild_start", "retry_ladder",
})


class FlightRecorder:
    __slots__ = ("ring", "capacity", "_seq", "host")

    def __init__(self, capacity: int = 512, host: str = ""):
        self.capacity = int(capacity)
        self.ring: deque = deque(maxlen=self.capacity)
        self._seq = 0
        self.host = host

    def record(self, at_us: float, kind: str, **details) -> None:
        self.ring.append((float(at_us), self.host, self._seq, kind,
                          dict(details)))
        self._seq += 1

    def absorb(self, other: "FlightRecorder",
               host: Optional[str] = None) -> None:
        label = host if host is not None else other.host
        for at_us, h, seq, kind, details in other.ring:
            self.ring.append((at_us, label or h, seq, kind, details))

    def reset(self) -> None:
        self.ring.clear()
        self._seq = 0

    # -- read side -----------------------------------------------------------

    def dump(self) -> List[dict]:
        """Events sorted by (time, host, seq) as plain dicts."""
        return [
            {"at_us": at_us, "host": h, "seq": seq, "kind": kind,
             "details": details}
            for at_us, h, seq, kind, details in
            sorted(self.ring, key=lambda e: (e[0], e[1], e[2]))
        ]

    @property
    def anomalous(self) -> bool:
        return any(e[3] in ANOMALY_KINDS for e in self.ring)

    def dump_text(self) -> str:
        lines = []
        for ev in self.dump():
            det = " ".join(f"{k}={v}" for k, v in sorted(
                ev["details"].items()))
            lines.append(f"{ev['at_us']:14.1f}us  {ev['host']:<12} "
                         f"{ev['kind']:<18} {det}")
        return "\n".join(lines)
