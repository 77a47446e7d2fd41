"""Timed fleet-failure schedules — the workload side of the control plane.

A :class:`FailureSpec` is a list of timed events against named hosts,
exactly like a trace is a list of timed queries: fully determined by its
fields (plus a seed for the generated form), so every degraded-path run is
bit-reproducible and every failover decision can be differential-tested
against the healthy run. Three event kinds:

* ``crash`` — the host is down during ``[start_us, end_us)``. Queries that
  would arrive there are re-routed to a healthy replica, and queries that
  arrived within ``inflight_window_us`` *before* the crash (its in-flight
  ledger at the moment of failure) are replayed on the replica so no query
  is lost. ``cold_restart`` wipes the host's row/pooled caches on recovery
  (a crash loses FM-resident state).
* ``slow`` — a degraded host (thermal throttling, noisy neighbor, a dying
  device): during the window the host's device plane sees
  ``slow_bg_iops`` of extra background load, and — on sampled-mode hosts —
  ``slow_tuning`` (a :class:`repro_torch.devices.tuning.DeviceTuning`) replaces
  the host's knob settings.
* ``io_errors`` — a transient error burst (link flaps, media retries):
  during the window each of the host's queries fails and retries with
  probability ``error_rate``, paying ``retry_penalty_us`` extra latency.
  Draws come from a seeded per-event stream consumed in arrival order, so
  serial/thread/process cluster runs and streamed/materialized traces see
  identical retries.
* ``device_loss`` — one of the host's SM devices dies at ``start_us``
  (``end_us`` bounds the event for scheduling; the data is gone until
  rebuilt). With a data-integrity plane attached
  (``HostSpec.integrity``/``redundancy``) the affected rows are served
  from their replicas while a background rebuild stream re-replicates
  them; without one the event only invalidates the host's replay caches.

:func:`seeded_failures` draws a whole fleet's crash/repair history from
exponential MTBF/MTTR clocks — the generated schedule is a pure function of
its arguments, like every trace in this package.

Events are *consumed* by :mod:`repro_torch.runtime.control`, which compiles
them into per-host control programs and a failover-rewritten routing
assignment. A copy of ``repro.workloads.failures``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np

VALID_KINDS = ("crash", "slow", "io_errors", "device_loss")


@dataclasses.dataclass(frozen=True)
class FailureEvent:
    """One timed event against one host (see module docstring)."""
    host: str                         # HostSpec name after replica expansion
    kind: str                         # crash | slow | io_errors
    start_us: float
    end_us: float
    # crash
    inflight_window_us: float = 0.0   # ledger lookback replayed on failover
    cold_restart: bool = True         # recovery loses FM cache state
    # slow
    slow_bg_iops: float = 0.0
    slow_tuning: object = None        # devices.DeviceTuning (sampled hosts)
    # io_errors
    error_rate: float = 0.0
    retry_penalty_us: float = 0.0

    def __post_init__(self):
        if self.kind not in VALID_KINDS:
            raise ValueError(f"unknown failure kind {self.kind!r}")
        if not (self.end_us > self.start_us):
            raise ValueError(
                f"empty failure window [{self.start_us}, {self.end_us})")
        if self.inflight_window_us < 0:
            raise ValueError("inflight_window_us must be >= 0")
        if not (0.0 <= self.error_rate <= 1.0):
            raise ValueError("error_rate must be in [0, 1]")


@dataclasses.dataclass(frozen=True)
class FailureSpec:
    """A fleet's failure schedule. ``events=()`` is the healthy fleet — a
    run with an empty spec is bit-identical to a run without one (the
    zero-failure oracle the fault-injection suite pins)."""
    events: Tuple[FailureEvent, ...] = ()
    seed: int = 0

    def for_host(self, name: str) -> Tuple[FailureEvent, ...]:
        """This host's events, in deterministic (start, kind) order."""
        return tuple(sorted((e for e in self.events if e.host == name),
                            key=lambda e: (e.start_us, e.kind, e.end_us)))

    def sorted_events(self) -> Tuple[FailureEvent, ...]:
        return tuple(sorted(self.events,
                            key=lambda e: (e.start_us, e.host, e.kind)))


def seeded_failures(host_names: Sequence[str], duration_us: float, *,
                    seed: int = 0, mtbf_us: float = 2e6, mttr_us: float = 1e5,
                    inflight_window_us: float = 5_000.0,
                    kind: str = "crash", error_rate: float = 0.1,
                    retry_penalty_us: float = 1_000.0,
                    slow_bg_iops: float = 0.0,
                    max_events_per_host: int = 16) -> FailureSpec:
    """Draw a seeded crash/repair (or slow/error-burst) history per host.

    Each host runs an independent alternating-renewal clock: exponential
    time-to-failure (``mtbf_us``) then exponential repair (``mttr_us``),
    truncated to the trace duration. Same arguments, same schedule — the
    generated spec composes with every differential oracle in the suite.

    Inputs are validated eagerly: a non-positive or NaN MTBF/MTTR would
    otherwise surface as an opaque numpy error (or an infinite loop) deep
    inside the exponential draws.
    """
    def _need_pos(name, v):
        if not (isinstance(v, (int, float)) and np.isfinite(v) and v > 0.0):
            raise ValueError(f"{name} must be finite and > 0, got {v!r}")

    def _need_nonneg(name, v):
        if not (isinstance(v, (int, float)) and np.isfinite(v) and v >= 0.0):
            raise ValueError(f"{name} must be finite and >= 0, got {v!r}")

    _need_pos("mtbf_us", mtbf_us)
    _need_pos("mttr_us", mttr_us)
    _need_nonneg("duration_us", duration_us)
    _need_nonneg("inflight_window_us", inflight_window_us)
    _need_nonneg("retry_penalty_us", retry_penalty_us)
    _need_nonneg("slow_bg_iops", slow_bg_iops)
    if kind not in VALID_KINDS:
        raise ValueError(f"unknown failure kind {kind!r} "
                         f"(valid: {', '.join(VALID_KINDS)})")
    if not (isinstance(error_rate, (int, float)) and np.isfinite(error_rate)
            and 0.0 <= error_rate <= 1.0):
        raise ValueError(f"error_rate must be in [0, 1], got {error_rate!r}")
    if max_events_per_host < 0:
        raise ValueError("max_events_per_host must be >= 0")
    events = []
    for hi, name in enumerate(host_names):
        rng = np.random.default_rng(
            np.random.SeedSequence([seed, 0xFA11, hi]))
        t = 0.0
        for _ in range(max_events_per_host):
            t += float(rng.exponential(mtbf_us))
            if t >= duration_us:
                break
            down = max(1.0, float(rng.exponential(mttr_us)))
            end = min(t + down, duration_us)
            if end <= t:
                break
            events.append(FailureEvent(
                host=name, kind=kind, start_us=t, end_us=end,
                inflight_window_us=inflight_window_us,
                error_rate=error_rate, retry_penalty_us=retry_penalty_us,
                slow_bg_iops=slow_bg_iops))
            t = end
    return FailureSpec(events=tuple(events), seed=seed)


def overlapping(events: Sequence[FailureEvent], start_us: float,
                end_us: float) -> Tuple[FailureEvent, ...]:
    """Events whose window intersects ``[start_us, end_us)``."""
    return tuple(e for e in events
                 if e.start_us < end_us and e.end_us > start_us)
