"""The device trace of the measured window.

The window marks are copied from ``chip_smoke.py`` (``device_profile``):
``torch.profiler`` drops a varying number of the first kernel records of a
profile, so ``PROFILE_MARKS`` short spin kernels run and are waited for
ahead of the window, only the records after the last mark recorded count,
and a trace that holds none of them raises. The records are read from the
profiler's raw kineto events (building its ``FunctionEvent`` list takes
seconds per hundred thousand records).
"""
from __future__ import annotations

import collections
from typing import Callable, Dict, List, Tuple

PROFILE_MARKS, PROFILE_MARK_CYCLES = 4096, 1_000
Event = Tuple[str, int, int]            # name, start ns, duration ns


def _ns(e, what: str) -> int:
    f = getattr(e, f"{what}_ns", None)
    return int(f()) if f is not None else int(getattr(e, f"{what}_us")() * 1000)


def trace_window(torch, run: Callable[[], None]) -> Tuple[List[Event], int]:
    """Device records of ``run()`` in start order, and the number of window
    marks the profiler dropped."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:   # device records only
        for _ in range(PROFILE_MARKS):
            torch.cuda._sleep(PROFILE_MARK_CYCLES)
        torch.cuda.synchronize()
        run()
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    events = sorted(((e.name(), _ns(e, "start"), _ns(e, "duration"))
                     for e in prof.profiler.kineto_results.events()
                     if e.device_type() == cuda), key=lambda e: e[1])
    marks = [i for i, e in enumerate(events) if "spin_kernel" in e[0]]
    if not marks:
        raise RuntimeError(f"the profiler dropped all {PROFILE_MARKS} spin kernels "
                           "ahead of the window: its first records may be missing too")
    return events[marks[-1] + 1:], PROFILE_MARKS - len(marks)


def summarize(events: List[Event], top: int = 10) -> Dict:
    """Busy seconds (one stream: the sum of its records), seconds and
    counts by name, the heaviest names, and the idle gaps between
    consecutive records grouped by the pair of operations around them (the
    host was between the two: finishing the one, launching the other)."""
    by_name: Dict[str, List[float]] = collections.defaultdict(lambda: [0, 0.0])
    gaps: Dict[str, float] = collections.defaultdict(float)
    prev = None
    for name, start, dur in events:
        by_name[name][0] += 1
        by_name[name][1] += dur * 1e-9
        if prev is not None:
            gap = start - (prev[1] + prev[2])
            if gap > 0:
                gaps[f"{_short(prev[0])} -> {_short(name)}"] += gap * 1e-9
        prev = (name, start, dur)
    heavy = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:top]
    return {"busy_s": sum(s for _, s in by_name.values()),
            "ops": sum(n for n, _ in by_name.values()),
            "by_name": {k: (n, s) for k, (n, s) in by_name.items()},
            "device_ops": [[_short(k), s] for k, (_, s) in heavy],
            "idle_gaps": [[k, s] for k, s in
                          sorted(gaps.items(), key=lambda kv: -kv[1])[:top]]}


def named(summary: Dict, key: str) -> Tuple[int, float]:
    """Records and seconds of the operations whose name holds ``key``."""
    n = s = 0
    for name, (c, sec) in summary["by_name"].items():
        if key in name:
            n += c
            s += sec
    return n, s


def _short(name: str) -> str:
    for junk in ("void ", "(anonymous namespace)::", "at::native::", "std::"):
        name = name.replace(junk, "")
    return name[:90]
