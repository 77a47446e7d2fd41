"""Exporters for the telemetry plane.

Three formats plus a human-readable run report:

* :func:`prometheus_text` — Prometheus text exposition (counters, gauges,
  and histograms as cumulative ``_bucket{le=...}`` series).
* :func:`telemetry_json` — a JSON object keyed like ``BENCH_serve.json``
  entries (``git_sha`` + ``generated_unix``). The obs plane itself never
  reads a clock; callers at the CLI layer pass the stamp in.
* :func:`write_chrome_trace` — Chrome trace-event JSON via
  :meth:`SpanRecorder.chrome_trace`, loadable in Perfetto.
* :func:`render_report` — the per-run text report: per-host table, tier
  engagement, hit rates, queue-depth timeline, and the tail breakdown by
  cause (queueing vs GC vs retry vs hedge), plus a flight-recorder dump
  when the run contained an anomaly.

A copy of ``repro.obs.export``.
"""
from __future__ import annotations

import json
import math
from typing import List, Optional, Sequence

from .metrics import LatencyHistogram, MetricsRegistry
from .telemetry import Telemetry


def _prom_name(name: str) -> str:
    return "sdm_" + name.replace(".", "_").replace("-", "_")


def prometheus_text(registry: MetricsRegistry) -> str:
    lines: List[str] = []
    for name, val in sorted(registry.counters.items()):
        p = _prom_name(name)
        lines += [f"# TYPE {p} counter", f"{p} {val}"]
    for name, val in sorted(registry.gauges.items()):
        p = _prom_name(name)
        lines += [f"# TYPE {p} gauge", f"{p} {val:.6g}"]
    for name, h in sorted(registry.hists.items()):
        p = _prom_name(name)
        lines.append(f"# TYPE {p} histogram")
        cum = 0
        for i in range(len(h.buckets)):
            c = int(h.buckets[i])
            le = h.bucket_hi(i)
            if c == 0 or math.isinf(le):
                continue
            cum += c
            lines.append(f'{p}_bucket{{le="{le:.0f}"}} {cum}')
        # the +Inf bucket is mandatory in the exposition format and always
        # carries the total count
        lines.append(f'{p}_bucket{{le="+Inf"}} {h.count}')
        lines += [f"{p}_sum {h.sum:.6g}", f"{p}_count {h.count}"]
    return "\n".join(lines) + "\n"


def telemetry_json(tel: Telemetry, git_sha: str = "unknown",
                   generated_unix: int = 0,
                   drop_prefixes: Sequence[str] = ()) -> dict:
    return {
        "git_sha": git_sha,
        "generated_unix": int(generated_unix),
        "host": tel.host,
        "metrics": tel.registry.as_dict(drop_prefixes=drop_prefixes),
        "flight_recorder": tel.recorder.dump(),
        "spans": {"recorded": len(tel.tracer.events),
                  "dropped": tel.tracer.dropped},
    }


def write_chrome_trace(tel: Telemetry, path: str) -> None:
    with open(path, "w") as f:
        json.dump(tel.tracer.chrome_trace(), f, indent=1)


# -- run report ----------------------------------------------------------------

def _fmt_hist_line(name: str, h: LatencyHistogram) -> str:
    b50 = h.percentile_bounds(50.0)
    b99 = h.percentile_bounds(99.0)
    return (f"  {name:<24} n={h.count:<9} mean={h.mean:9.1f}us  "
            f"p50~[{b50[0]:.0f},{_inf(b50[1])})  "
            f"p99~[{b99[0]:.0f},{_inf(b99[1])})")


def _inf(v: float) -> str:
    return "inf" if math.isinf(v) else f"{v:.0f}"


def _depth_timeline(tel: Telemetry, name: str, bins: int = 12) -> List[str]:
    pts = [(ev[0], ev[6]["value"]) for ev in tel.tracer.events
           if ev[2] == "C" and ev[3] == name]
    if not pts:
        return []
    t0 = min(p[0] for p in pts)
    t1 = max(p[0] for p in pts)
    span = max(t1 - t0, 1.0)
    agg = [[] for _ in range(bins)]
    for t, v in pts:
        agg[min(int((t - t0) / span * bins), bins - 1)].append(v)
    peak = max(max(a) for a in agg if a)
    out = [f"  {name} (t={t0:.0f}..{t1:.0f}us, peak={peak:.0f}):"]
    for i, a in enumerate(agg):
        if not a:
            out.append(f"    [{i:>2}] -")
            continue
        avg = sum(a) / len(a)
        bar = "#" * int(round(avg / peak * 40)) if peak else ""
        out.append(f"    [{i:>2}] avg={avg:7.1f} max={max(a):7.0f} {bar}")
    return out


def render_report(tel: Telemetry, hosts: Optional[Sequence] = None,
                  title: str = "run report") -> str:
    """Human-readable per-run report from a (merged) telemetry handle.

    ``hosts`` may be a sequence of ``HostReport``-like objects for the
    per-host table; everything else comes off the registry/tracer/ring.
    """
    reg = tel.registry
    c = reg.counters
    lines = [f"== {title} ==", ""]

    if hosts:
        lines.append("-- hosts --")
        lines.append(f"  {'name':<14}{'queries':>9}{'p50us':>9}{'p99us':>9}"
                     f"{'deferred':>9}{'sm_ios':>10}{'crashes':>8}")
        for h in hosts:
            lines.append(
                f"  {h.name:<14}{h.queries:>9}{h.p50_us:>9.1f}"
                f"{h.p99_us:>9.1f}{h.deferred:>9}{h.sm_ios:>10}"
                f"{getattr(h, 'crashes', 0):>8}")
        lines.append("")

    tiers = {k.split(".", 2)[2] if k.count(".") >= 2 else k: v
             for k, v in sorted(c.items()) if k.startswith("diag.tier.")}
    if tiers:
        total = sum(tiers.values()) or 1
        lines.append("-- tier engagement (chunks) --")
        for t, n in sorted(tiers.items(), key=lambda kv: -kv[1]):
            lines.append(f"  {t:<12} {n:>9}  {100.0 * n / total:5.1f}%")
        lines.append("")

    hit_pairs = [("row cache", "cache.row_hits", "cache.row_lookups"),
                 ("pooled cache", "cache.pooled_hits",
                  "cache.pooled_lookups")]
    hr_lines = []
    for label, hk, lk in hit_pairs:
        lk_v = c.get(lk, 0)
        if lk_v:
            hr_lines.append(f"  {label:<14} {100.0 * c.get(hk, 0) / lk_v:6.2f}%"
                            f"  ({c.get(hk, 0)}/{lk_v})")
    if "engine.hit_rate" in reg.gauges:
        hr_lines.append(f"  {'engine cache':<14} "
                        f"{100.0 * reg.gauges['engine.hit_rate']:6.2f}%")
    if hr_lines:
        lines += ["-- hit rates --"] + hr_lines + [""]

    if reg.hists:
        lines.append("-- latency histograms --")
        for name, h in sorted(reg.hists.items()):
            lines.append(_fmt_hist_line(name, h))
        lines.append("")

    for track in ("sched.inflight", "device.depth"):
        tl = _depth_timeline(tel, track)
        if tl:
            lines += ["-- queue-depth timeline --"] + tl + [""]
            break

    # Tail breakdown by cause: which mechanisms were in play while the
    # tail formed. Queueing pressure from device waits, GC interference
    # from the update stream, retry ladders, and hedges.
    qh = reg.hists.get("device.queue_wait_us")
    lines.append("-- tail breakdown by cause --")
    lines.append(f"  queueing : deferred={c.get('serve.deferred', 0)} "
                 f"wait_mean={qh.mean:.1f}us" if qh is not None else
                 f"  queueing : deferred={c.get('serve.deferred', 0)}")
    lines.append(f"  gc       : gc_events={c.get('device.gc_events', 0)} "
                 f"write_waves={c.get('device.write_waves', 0)}")
    lines.append(f"  retry    : io_error_retries="
                 f"{c.get('control.io_error_retries', 0)} "
                 f"ladder_steps={c.get('integrity.retry_steps', 0)}")
    lines.append(f"  hedge    : hedged_reads="
                 f"{c.get('integrity.hedged_reads', 0)} "
                 f"wins={c.get('integrity.hedge_wins', 0)}")
    lines.append("")

    if tel.recorder.anomalous:
        lines += ["-- flight recorder (anomaly post-mortem) --",
                  tel.recorder.dump_text(), ""]

    return "\n".join(lines)
