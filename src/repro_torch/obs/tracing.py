"""Sampling span recorder on the simulated clock.

Spans are stamped with **simulated microseconds** (`at_us` from the serve
scheduler / device clock), never wallclock — the recorder consumes no RNG
and no `time.*`, so the same seeded run produces a byte-identical trace.

Sampling is deterministic: each span *name* keeps its own occurrence
counter and every ``sample_every``-th occurrence is recorded (the first is
always kept). This keeps hot-path spans (one per served chunk, one per IO
wave) bounded without a random number draw, and the kept subset is
identical across serial / thread / process execution because each host
records into its own recorder which is absorbed in host order.

Export is Chrome trace-event JSON (the ``{"traceEvents": [...]}`` form)
loadable in Perfetto / ``chrome://tracing``: hosts map to numeric pids and
span categories to tids, named via ``process_name`` / ``thread_name``
metadata events. A copy of ``repro.obs.tracing``.
"""
from __future__ import annotations

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
