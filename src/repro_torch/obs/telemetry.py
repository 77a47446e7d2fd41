"""The telemetry handle: one object bundling registry + tracer + recorder.

The whole obs plane hangs off a single ``telemetry`` attribute threaded
through the serving stack (`ServeScheduler`, `SDMEmbeddingStore`,
`IOEngine`, `DeviceSim`, `ControlledHost`, `RedundancyPlane`, the serving
engines, `ClusterSim`). The contract:

* ``None`` (the default everywhere) is **bit-invisible**: every hook in
  the hot path is guarded by ``if tel is not None``, no RNG is consumed,
  no report field changes — vanilla runs stay byte-identical.
* An enabled handle records into plain picklable state so per-host
  telemetry rides back from spawn-context process workers, and
  :func:`merge_telemetry` folds host handles in the given (host-index)
  order so merged registries are bit-equal across serial / thread /
  process execution.

A copy of ``repro.obs.telemetry``.
"""
from __future__ import annotations

import dataclasses
from typing import Iterable, Optional, Sequence, Tuple

from .metrics import MetricsRegistry
from .recorder import FlightRecorder
from .tracing import SpanRecorder


@dataclasses.dataclass(frozen=True)
class ObsConfig:
    """Knobs for an enabled telemetry handle (frozen → hashable, safe to
    share inside ``HostSpec``)."""

    span_sample_every: int = 16     # record every k-th occurrence per name
    max_spans: int = 65536          # recorder hard cap (excess -> dropped)
    flight_capacity: int = 512     # flight-recorder ring size


class Telemetry:
    """Per-host telemetry bundle. Construct via :func:`make_telemetry`."""

    __slots__ = ("registry", "tracer", "recorder", "host", "config")

    def __init__(self, config: ObsConfig = ObsConfig(), host: str = ""):
        self.config = config
        self.host = host
        self.registry = MetricsRegistry()
        self.tracer = SpanRecorder(sample_every=config.span_sample_every,
                                   max_events=config.max_spans, host=host)
        self.recorder = FlightRecorder(capacity=config.flight_capacity,
                                       host=host)

    def reset(self) -> None:
        """Drop everything recorded so far (used by ``reset_measurement``
        so only the measured replay lands in the run's telemetry)."""
        self.registry = MetricsRegistry()
        self.tracer.reset()
        self.recorder.reset()


def make_telemetry(flag, host: str = "") -> Optional[Telemetry]:
    """Resolve a ``HostSpec.telemetry`` value into a handle.

    ``None`` / ``False`` → ``None`` (disabled, bit-invisible).
    ``True`` → enabled with default :class:`ObsConfig`.
    An :class:`ObsConfig` → enabled with those knobs.
    An existing :class:`Telemetry` is taken as a prototype (its config is
    reused; state is never shared between hosts).
    """
    if flag is None or flag is False:
        return None
    if flag is True:
        return Telemetry(host=host)
    if isinstance(flag, ObsConfig):
        return Telemetry(config=flag, host=host)
    if isinstance(flag, Telemetry):
        return Telemetry(config=flag.config, host=host)
    raise TypeError(f"unsupported telemetry flag: {flag!r}")


def merge_telemetry(
    parts: Sequence[Tuple[str, Optional[Telemetry]]],
) -> Optional[Telemetry]:
    """Fold per-host telemetry into one fleet handle, in the given order.

    Callers pass hosts in host-index order so the merge is deterministic
    across execution modes. Returns ``None`` when no host had telemetry
    enabled (the fleet report then carries no telemetry either).
    """
    live = [(name, t) for name, t in parts if t is not None]
    if not live:
        return None
    merged = Telemetry(config=live[0][1].config, host="fleet")
    for name, tel in live:
        merged.registry.merge(tel.registry)
        merged.tracer.absorb(tel.tracer, host=name)
        merged.recorder.absorb(tel.recorder, host=name)
    return merged
