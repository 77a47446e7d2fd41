"""The card's idle time within the timed calls, named by what the host was doing.

The device records of a traced window (``sdmb_profile.trace_window``:
kineto's records, stamped in Unix ns) and the serving engine's wall spans
(``Telemetry.wall`` of ``ObsConfig(wall_spans=True)``: ``time.time_ns()``,
kept in Unix µs) lie on one clock, up to the wander of the device
records' conversion to it: tens of µs within seconds, and up to
milliseconds over a 30 s window on an H100. :func:`aligned` takes that out
call by call. Within each timed call ``[start, end]`` (Unix ns, stamped
around ``serve_columnar``), the card is idle wherever no device record
runs; each idle stretch is charged to the innermost engine span open on the
host over it, and time in a call under no engine span to ``OUTSIDE`` (the
harness loop and ``ColumnarQueries(...).whole()``).

``metrics`` gives the per-layer numbers these readings feed, by name; the
idle shares only where there are device records (a card run).
"""
from __future__ import annotations

import collections
import math
import warnings
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
from numpy.lib.stride_tricks import sliding_window_view

OUTSIDE = "outside engine"
ENGINE_HOST = ("engine.serve", "engine.densify", "engine.validate", "engine.h2d",
               "engine.d2h", "engine.account")
STEP = "engine.step"                 # with its children, ``step.*``
COPY_IN = "Memcpy HtoD (Pageable"                # the engine's two copies in a call
COPY_OUT = "Memcpy DtoH (Device -> Pageable"     # and its two copies out
ALIGN_CALLS = 8                      # calls each side whose bounds a call's offset takes
Call = Tuple[int, int]               # start ns, end ns
Span = Tuple[str, int, int, int]     # name, depth, start ns, end ns
Event = Tuple[str, int, int]         # a device record: name, start ns, duration ns


def group_of(name: str) -> str:
    """``outside_engine``, ``engine_host`` or ``step``: the three idle shares."""
    if name == OUTSIDE:
        return "outside_engine"
    if name == STEP or name.startswith("step."):
        return "step"
    if name in ENGINE_HOST:
        return "engine_host"
    raise ValueError(f"no idle group for span {name!r}")


def spans_ns(recorded: Sequence[tuple]) -> List[Span]:
    """A ``SpanRecorder``'s span events as ``(name, depth, start, end)`` in
    Unix ns; a span's depth counts its ``parent`` chain."""
    parent = {ev[3]: ev[6].get("parent") for ev in recorded}

    def depth(name):
        d = 0
        while parent.get(name) is not None:
            name, d = parent[name], d + 1
        return d

    depths = {name: depth(name) for name in parent}
    out = []
    for ts, dur, _, name, *_ in recorded:
        whole = math.floor(ts)            # ns from µs exactly: ts * 1e3 would round
        start = whole * 1000 + round((ts - whole) * 1e3)
        out.append((name, depths[name], start, start + round(dur * 1e3)))
    return out


def segments(spans: Sequence[Span], calls: Sequence[Call]
             ) -> Tuple[np.ndarray, np.ndarray, List[str]]:
    """The calls cut into stretches of one innermost open span: starts and
    ends (ns) and the span names, ``OUTSIDE`` where no span is open. Each
    depth holds one open span at a time: a span that opens at its depth
    replaces the one there (adjacent spans share a stamp, and the µs the
    recorder keeps may round the one's end past the other's start)."""
    points = [(s, 1, -1, i) for i, (s, _) in enumerate(calls)]
    points += [(e, 0, -1, i) for i, (_, e) in enumerate(calls)]
    points += [(s, 1, d, k) for k, (_, d, s, _) in enumerate(spans)]
    points += [(e, 0, d, k) for k, (_, d, _, e) in enumerate(spans)]
    # at one instant: closes before opens, and opens outermost first
    points.sort(key=lambda p: (p[0], p[1], p[2] if p[1] else -p[2]))
    open_at: Dict[int, int] = {}          # depth -> index of the span open there
    in_call = False
    starts, ends, names = [], [], []
    t_prev = None
    for t, is_open, d, k in points:
        if in_call and t_prev is not None and t > t_prev:
            deepest = max(open_at) if open_at else None
            starts.append(t_prev)
            ends.append(t)
            names.append(OUTSIDE if deepest is None else spans[open_at[deepest]][0])
        t_prev = t
        if d < 0:
            in_call = bool(is_open)
        elif is_open:
            open_at[d] = k
        elif open_at.get(d) == k:
            del open_at[d]
    return np.asarray(starts, np.int64), np.asarray(ends, np.int64), names


def busy_union(events: Sequence[Event]) -> Tuple[np.ndarray, np.ndarray]:
    """The device records ``(name, start ns, duration ns)`` merged into
    disjoint busy intervals, in order."""
    if not events:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    s = np.array([e[1] for e in events], np.int64)
    e = s + np.array([e[2] for e in events], np.int64)
    order = np.argsort(s, kind="stable")
    s, e = s[order], np.maximum.accumulate(e[order])
    new = np.r_[True, s[1:] > e[:-1]]
    last = np.r_[np.flatnonzero(new)[1:] - 1, len(s) - 1]
    return s[new], e[last]


def call_starts(events: Sequence[Event]) -> List[int]:
    """Where each call's records begin, in start order: at a copy in that
    opens the window or follows a copy out. A call's records run from its
    two copies in to its two copies out, so this holds where the profiler
    drops a record, unless it drops both of a call's copies in."""
    first, after_out = [], True
    for i, (name, _, _) in enumerate(events):
        if name.startswith(COPY_IN):
            if after_out:
                first.append(i)
            after_out = False
        elif name.startswith(COPY_OUT):
            after_out = True
    return first


def call_offsets(events: Sequence[Event], spans: Sequence[Span],
                 width: int = ALIGN_CALLS) -> Optional[np.ndarray]:
    """Each call's device-record clock less the host's (ns), in call order;
    None unless the records split into as many calls as the spans hold
    (:func:`call_starts`).

    A call's last copy out is synchronous: its record ends before the host
    returns from it, inside ``engine.d2h``, so the record's end less the
    span's is a lower bound of the offset, tight but for the host's return
    (a collector pass can delay it). Its first copy in starts after the
    host enters ``engine.h2d``: its start less the span's is an upper bound,
    loose by the copy's staging (100 µs or more). On an H100 the offset
    drifts by up to 30 µs a call for seconds and jumps by milliseconds now
    and then. So a call takes the largest of the lower bounds of the
    ``width`` calls each side that its upper bound admits (a jump does not
    leak over), each moved to the call by the drift, the median step from
    one of these bounds to the next."""
    starts = np.array(sorted(a for n, _, a, _ in spans if n == "engine.h2d"), np.int64)
    ends = np.array(sorted(e for n, _, _, e in spans if n == "engine.d2h"), np.int64)
    events = sorted(events, key=lambda e: e[1])
    first = call_starts(events)
    if not first or not len(first) == len(starts) == len(ends):
        return None
    at = np.array([s for _, s, _ in events], np.int64)
    end = at + np.array([d for _, _, d in events], np.int64)
    is_in = np.array([n.startswith(COPY_IN) for n, _, _ in events])
    is_out = np.array([n.startswith(COPY_OUT) for n, _, _ in events])
    last_out = np.maximum.reduceat(np.where(is_out, end, 0), first)   # 0: none recorded
    upper = (np.minimum.reduceat(np.where(is_in, at, end.max()), first) - starts).astype(float)
    lower = np.where(last_out > 0, last_out - ends, 0).astype(float)
    lower[last_out == 0] = -np.inf
    near = sliding_window_view(np.pad(lower, width, constant_values=np.nan), 2 * width + 1)
    near = np.where(near <= upper[:, None], near, np.nan)
    with warnings.catch_warnings():                   # a side may hold no bound
        warnings.simplefilter("ignore", RuntimeWarning)
        drift = np.nanmedian(np.diff(near, axis=1), axis=1)
        best = np.nanmax(near - np.nan_to_num(drift)[:, None]
                         * np.arange(-width, width + 1), axis=1)
    off = np.minimum(np.fmax(best, lower), upper)
    return np.where(np.isfinite(off), off, upper).astype(np.int64)


def aligned(events: Sequence[Event], spans: Sequence[Span]) -> Optional[List[Event]]:
    """The device records moved onto the host's clock by their call's
    offset (:func:`call_offsets`), in start order; None where the offsets
    are."""
    off = call_offsets(events, spans)
    if off is None:
        return None
    events = sorted(events, key=lambda e: e[1])
    call = np.searchsorted(call_starts(events), np.arange(len(events)), side="right") - 1
    return [(n, s - int(off[max(k, 0)]), d) for (n, s, d), k in zip(events, call)]


def idle_by_span(events: Sequence[Event], spans: Sequence[Span],
                 calls: Sequence[Call]) -> Dict[str, float]:
    """Idle seconds of the card within the calls, by innermost span."""
    a, b, names = segments(spans, calls)
    bs, be = busy_union(events)
    cum = np.r_[0, np.cumsum(be - bs)]
    prev_end = np.r_[0, be]

    def busy_before(t):
        i = np.searchsorted(bs, t, side="right")      # intervals begun by t
        return cum[i] - np.where(i > 0, np.maximum(prev_end[i] - t, 0), 0)

    idle = (b - a) - (busy_before(b) - busy_before(a))
    out: Dict[str, float] = collections.defaultdict(float)
    for name, ns in zip(names, idle.tolist()):
        out[name] += ns * 1e-9
    return dict(out)


def breakdown(idle: Dict[str, float], top: int = 10) -> List[list]:
    """``[span, seconds]`` of the most idle spans, most first."""
    return [[k, v] for k, v in sorted(idle.items(), key=lambda kv: -kv[1])[:top]]


def mean_ms(spans: Sequence[Span], name: str) -> Optional[float]:
    d = [e - s for n, _, s, e in spans if n == name]
    return float(np.mean(d)) * 1e-6 if d else None


def metrics(recorded: Sequence[tuple], calls: Sequence[Call],
            counters: Dict[str, int], spans_dropped: int,
            events: Optional[Sequence[Event]] = None) -> Dict[str, float]:
    """The per-layer metrics of a traced window, by name: mean span times a
    call (ms), the share of the padded block's slots that hold a key (%),
    and with device ``events``, the card's idle shares of the calls'
    seconds (%), from the records :func:`aligned` moves (as read where it
    cannot). Empty where a span was dropped."""
    if spans_dropped > 0 or not calls:
        return {}
    spans = spans_ns(recorded)
    out = {}
    for metric, name in (("densify_span_ms", "engine.densify"),
                         ("account_span_ms", "engine.account"),
                         ("step_host_ms", STEP)):
        v = mean_ms(spans, name)
        if v is not None:
            out[metric] = v
    if counters.get("engine.slots"):
        out["slot_use_share"] = (100.0 * counters["engine.valid_keys"]
                                 / counters["engine.slots"])
    if events:
        moved = aligned(events, spans)
        serving = sum(e - s for s, e in calls) * 1e-9
        by_group = collections.defaultdict(float)
        for name, sec in idle_by_span(events if moved is None else moved, spans,
                                      calls).items():
            by_group[group_of(name)] += sec
        for g in ("outside_engine", "engine_host", "step"):
            out[f"idle_{g}_share"] = 100.0 * by_group[g] / serving
    return out
