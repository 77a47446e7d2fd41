"""Sampling span recorder; the clock is the caller's.

The recorder reads no clock and consumes no RNG: spans are stamped in
whatever microseconds the caller hands it. ``Telemetry.tracer`` is fed
**simulated microseconds** (`at_us` from the serve scheduler / device
clock), never wallclock, so the same seeded run produces a byte-identical
trace. ``Telemetry.wall`` (``ObsConfig.wall_spans``) is fed Unix µs from
``time.time_ns()``, the clock of ``torch.profiler``'s kineto records, so
the serving engine's host spans lie on the card's device trace.

Sampling is deterministic: each span *name* keeps its own occurrence
counter and every ``sample_every``-th occurrence is recorded (the first is
always kept). This keeps hot-path spans (one per served chunk, one per IO
wave) bounded without a random number draw, and the kept subset is
identical across serial / thread / process execution because each host
records into its own recorder which is absorbed in host order.

Export is Chrome trace-event JSON (the ``{"traceEvents": [...]}`` form)
loadable in Perfetto / ``chrome://tracing``: hosts map to numeric pids and
span categories to tids, named via ``process_name`` / ``thread_name``
metadata events. A copy of ``repro.obs.tracing``, plus :class:`WallSpans`.
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional

# Event tuples: (ts_us, dur_us, ph, name, cat, pid_label, args)
_PH_SPAN = "X"
_PH_INSTANT = "i"
_PH_COUNTER = "C"


class SpanRecorder:
    __slots__ = ("sample_every", "max_events", "events", "dropped", "_seen",
                 "host")

    def __init__(self, sample_every: int = 16, max_events: int = 65536,
                 host: str = ""):
        self.sample_every = max(int(sample_every), 1)
        self.max_events = int(max_events)
        self.events: List[tuple] = []
        self.dropped = 0
        self._seen: Dict[str, int] = {}
        self.host = host

    def _sampled(self, name: str) -> bool:
        k = self._seen.get(name, 0)
        self._seen[name] = k + 1
        return k % self.sample_every == 0

    def _push(self, ev: tuple) -> None:
        if len(self.events) >= self.max_events:
            self.dropped += 1
            return
        self.events.append(ev)

    # -- recording ----------------------------------------------------------

    def span(self, name: str, cat: str, at_us: float, dur_us: float,
             **args) -> None:
        """Sampled complete span (ph "X")."""
        if self._sampled(name):
            self._push((float(at_us), float(dur_us), _PH_SPAN, name, cat,
                        self.host, args))

    def want(self, name: str) -> bool:
        """Advance the sampler for ``name`` and say whether this occurrence
        is recorded. Hot paths gate argument construction (kwargs dicts,
        array sums) on this and then call :meth:`record` directly."""
        return self._sampled(name)

    def record(self, name: str, cat: str, at_us: float, dur_us: float,
               **args) -> None:
        """Unsampled span push — pair with a :meth:`want` check."""
        self._push((float(at_us), float(dur_us), _PH_SPAN, name, cat,
                    self.host, args))

    def instant(self, name: str, cat: str, at_us: float, **args) -> None:
        """Unsampled point event — for rare control-plane moments."""
        self._push((float(at_us), 0.0, _PH_INSTANT, name, cat, self.host,
                    args))

    def counter(self, name: str, at_us: float, value: float) -> None:
        """Sampled counter track (ph "C") — queue depth, inflight IOs."""
        if self._sampled(name):
            self._push((float(at_us), 0.0, _PH_COUNTER, name, "counter",
                        self.host, {"value": float(value)}))

    # -- merge / export ------------------------------------------------------

    def absorb(self, other: "SpanRecorder", host: Optional[str] = None) -> None:
        label = host if host is not None else other.host
        for ev in other.events:
            self._push(ev[:5] + (label or ev[5],) + ev[6:])
        self.dropped += other.dropped

    def reset(self) -> None:
        self.events.clear()
        self.dropped = 0
        self._seen.clear()

    def chrome_trace(self) -> dict:
        """Chrome trace-event JSON object (``json.dump`` ready)."""
        pids: Dict[str, int] = {}
        tids: Dict[str, int] = {}
        out: List[dict] = []
        for ev in sorted(self.events, key=lambda e: (e[0], e[5], e[3])):
            ts, dur, ph, name, cat, host, args = ev
            pid = pids.setdefault(host or "sim", len(pids) + 1)
            tid = tids.setdefault(cat, len(tids) + 1)
            rec = {"name": name, "cat": cat, "ph": ph, "ts": ts,
                   "pid": pid, "tid": tid}
            if ph == _PH_SPAN:
                rec["dur"] = dur
            if ph == _PH_INSTANT:
                rec["s"] = "t"
            if args:
                rec["args"] = dict(args)
            out.append(rec)
        meta: List[dict] = []
        for host, pid in pids.items():
            meta.append({"name": "process_name", "ph": "M", "pid": pid,
                         "tid": 0, "args": {"name": host}})
        for cat, tid in tids.items():
            for pid in pids.values():
                meta.append({"name": "thread_name", "ph": "M", "pid": pid,
                             "tid": tid, "args": {"name": cat}})
        return {"traceEvents": meta + out,
                "displayTimeUnit": "ms",
                "otherData": {"dropped_events": self.dropped}}


class WallSpans:
    """Nested wall-clock spans of one call, recorded into a ``wall``
    :class:`SpanRecorder` in Unix µs.

    Each boundary is one ``time.time_ns()`` read, shared by the span it
    closes and the one it starts, so adjacent spans meet exactly. Every
    span carries ``call`` and ``parent`` (the enclosing span's name, or
    ``None``); the category is ``engine``."""

    __slots__ = ("rec", "call", "t", "stack")

    def __init__(self, rec: SpanRecorder, call: int):
        self.rec, self.call = rec, call
        self.stack: List[tuple] = []
        self.t = time.time_ns()

    def open(self, name: str) -> None:
        """Open an enclosing span at the last boundary (no clock read)."""
        self.stack.append((name, self.t))

    def lap(self, name: str) -> None:
        """Record ``name`` from the last boundary to now."""
        t = time.time_ns()
        self._record(name, self.t, t)
        self.t = t

    def close(self) -> None:
        """Close the innermost open span now."""
        t = time.time_ns()
        name, t0 = self.stack.pop()
        self._record(name, t0, t)
        self.t = t

    def _record(self, name: str, t0: int, t1: int) -> None:
        self.rec.record(name, "engine", t0 / 1e3, (t1 - t0) / 1e3,
                        call=self.call,
                        parent=self.stack[-1][0] if self.stack else None)
