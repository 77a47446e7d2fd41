"""Port vs reference: the telemetry plane (``obs/``: metrics, recorder,
tracing, telemetry, export).

Each package's histograms, registries, flight recorders, span recorders and
telemetry handles are fed the same observations (seeded with numpy); their
``as_dict``, percentile bounds, dumps, Chrome traces and every exporter's
output (``prometheus_text``, ``telemetry_json`` with a fixed ``git_sha``,
``write_chrome_trace``, ``render_report``) must be equal, as must the
counter catalog (``HOST_COUNTERS``, ``LINT_FIELD_ALLOWLIST``).
"""
import dataclasses
import json
import pickle

import numpy as np
import pytest

import repro.obs as jobs
import repro_torch.obs as tobs
from repro_torch.runtime.cluster import HostReport

def both(fn):
    """``fn(obs)`` for the port and the reference, in that order."""
    return fn(tobs), fn(jobs)


def observations(seed):
    rng = np.random.default_rng(seed)
    return {"lognormal": rng.lognormal(6.0, 2.0, 700),
            "exponential": rng.exponential(900.0, 300),
            "scalars": rng.uniform(0.0, 5e4, 40).tolist(),
            "ints": rng.integers(0, 1 << 12, 25)}


# -- histograms and registries -----------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_histogram_matches_reference(seed):
    obs = observations(seed)

    def run(o):
        h, parts = o.LatencyHistogram(), o.LatencyHistogram()
        h.observe_many(obs["lognormal"])
        for v in obs["scalars"]:
            h.observe(v)
        h.observe_many(obs["ints"])              # not float64: copied as such
        other = o.LatencyHistogram()
        other.observe_many(obs["exponential"])
        parts.merge(other)
        parts.merge(h)
        bounds = [h.percentile_bounds(p) for p in (0, 50, 95, 99, 99.9, 100)]
        points = [h.percentile(p) for p in (50, 99)]
        return h.as_dict(), parts.as_dict(), bounds, points, h.mean, \
            o.LatencyHistogram().percentile_bounds(50.0)

    assert run(tobs) == run(jobs)


def test_histogram_observe_many_copies_input():
    def run(o):
        h = o.LatencyHistogram()
        v = np.array([1.0, 2.0, 3.0])
        h.observe_many(v)
        v[:] = 1e9
        return h.as_dict()
    t, j = both(run)
    assert t == j and t["max"] == 3.0


@pytest.mark.parametrize("seed", [0, 3])
def test_registry_matches_reference(seed):
    obs = observations(seed)

    def fill(o, host):
        r = o.MetricsRegistry()
        r.inc("serve.queries", 7 + host)
        r.inc("diag.tier.live")
        r.set("control.crashes", host)
        r.gauge("cache.row_hit_rate", 0.25 * (host + 1))
        r.observe_many("serve.latency_us", obs["lognormal"][host::3])
        r.observe("io.lat_us", obs["scalars"][host])
        return r

    def run(o):
        merged = o.MetricsRegistry()
        for h in range(3):
            merged.merge(fill(o, h))
        return (merged.as_dict(), merged.as_dict(drop_prefixes=("diag.",)),
                fill(o, 1).as_dict())

    assert run(tobs) == run(jobs)


def test_counter_catalog_matches_reference():
    assert tobs.HOST_COUNTERS == jobs.HOST_COUNTERS
    assert tobs.LINT_FIELD_ALLOWLIST == jobs.LINT_FIELD_ALLOWLIST
    fields = {f.name for f in dataclasses.fields(HostReport)}
    assert {f for f, _, _, _ in tobs.HOST_COUNTERS} <= fields
    assert fields == tobs.LINT_FIELD_ALLOWLIST["HostReport"]
    for f, _, metric, _ in tobs.HOST_COUNTERS:
        assert tobs.host_counter_metric(f) == jobs.host_counter_metric(f) == metric
    with pytest.raises(KeyError):
        tobs.host_counter_metric("not_a_counter")


# -- recorder and tracer ---------------------------------------------------------------


def record_events(o, seed, capacity=8, sample_every=3, max_events=24):
    rng = np.random.default_rng(seed)
    rec = o.FlightRecorder(capacity=capacity, host="h0")
    tr = o.SpanRecorder(sample_every=sample_every, max_events=max_events,
                        host="h0")
    t = 0.0
    for i in range(30):
        t += float(rng.exponential(100.0))
        kind = ["degrade_enter", "crash_restart", "io_error_retries",
                "degrade_exit"][i % 4]
        rec.record(t, kind, n=i)
        tr.span("serve.chunk", "serve", t, float(rng.uniform(1, 50)), n=i)
        tr.counter("sched.inflight", t, float(rng.integers(0, 64)))
        if tr.want("io.read_wave"):
            tr.record("io.read_wave", "io", t, 3.0, ios=i)
        if i % 7 == 0:
            tr.instant("control.crash", "control", t, host="h0")
    return rec, tr


@pytest.mark.parametrize("seed", [0, 5])
def test_recorder_and_tracer_match_reference(seed):
    def run(o):
        rec, tr = record_events(o, seed)
        rec2, tr2 = record_events(o, seed + 1, capacity=4)
        fleet_rec, fleet_tr = o.FlightRecorder(capacity=16), o.SpanRecorder(
            sample_every=1, max_events=50)
        fleet_rec.absorb(rec, host="a")
        fleet_rec.absorb(rec2)
        fleet_tr.absorb(tr, host="a")
        fleet_tr.absorb(tr2)
        return (rec.dump(), rec.dump_text(), rec.anomalous, tr.events,
                tr.dropped, tr.chrome_trace(), fleet_rec.dump(),
                fleet_tr.chrome_trace(), fleet_tr.dropped)

    t, j = run(tobs), run(jobs)
    assert t == j
    assert t[4] > 0 and t[8] > t[4]          # the caps dropped some events


def test_recorder_reset_rewinds_sequence():
    def run(o):
        rec, tr = record_events(o, 2)
        rec.reset()
        tr.reset()
        rec.record(1.0, "device_loss")
        return rec.dump(), rec.anomalous, tr.events, tr.dropped
    t, j = both(run)
    assert t == j and t[0][0]["seq"] == 0


# -- telemetry handles and exporters -----------------------------------------------------


def fleet_telemetry(o, seed):
    obs = observations(seed)
    hosts = []
    for h in range(2):
        tel = o.make_telemetry(o.ObsConfig(span_sample_every=2, max_spans=64,
                                           flight_capacity=16), host=f"h{h}")
        reg = tel.registry
        reg.set("serve.queries", 100 + h)
        reg.set("cache.row_hits", 60 + h)
        reg.set("cache.row_lookups", 90)
        reg.set("cache.pooled_hits", 5)
        reg.set("cache.pooled_lookups", 11)
        reg.inc("diag.tier.live", 3)
        reg.inc("diag.tier.resident", h)
        reg.gauge("engine.hit_rate", 0.5 + 0.1 * h)
        reg.observe_many("serve.latency_us", obs["lognormal"][h::2])
        reg.observe_many("device.queue_wait_us", obs["exponential"][h::2])
        rec, tr = record_events(o, seed + h)
        tel.recorder.absorb(rec)
        tel.tracer.absorb(tr)
        tel.tracer.counter("device.depth", 1.0, 2.0)
        hosts.append((f"h{h}", tel))
    hosts.append(("h2", None))
    return o.merge_telemetry(hosts)


def report_hosts():
    return [HostReport("h0", 101, 200.0, 250.0, 8333.3, 0, 4000, 1.0, 0.1,
                       3.0, 1.0, crashes=1),
            HostReport("h1", 100, 210.0, 260.0, 900.0, 2, 3000, 1.0, 0.1,
                       3.0, 1.0)]


@pytest.mark.parametrize("seed", [0, 4])
def test_exporters_match_reference(seed, tmp_path):
    def run(o):
        tel = fleet_telemetry(o, seed)
        path = tmp_path / f"{o.__name__}.json"
        o.write_chrome_trace(tel, str(path))
        return (o.prometheus_text(tel.registry),
                o.telemetry_json(tel, git_sha="abc123", generated_unix=17,
                                 drop_prefixes=("diag.",)),
                path.read_text(),
                o.render_report(tel, hosts=report_hosts(), title="fleet"),
                o.render_report(tel))

    t, j = run(tobs), run(jobs)
    assert t == j
    assert json.loads(t[2])["traceEvents"]
    assert "-- tier engagement (chunks) --" in t[3]
    assert "-- flight recorder (anomaly post-mortem) --" in t[3]


def test_make_and_merge_telemetry_match_reference():
    def run(o):
        cfg = o.ObsConfig(span_sample_every=4)
        forms = [o.make_telemetry(None), o.make_telemetry(False)]
        on = o.make_telemetry(True, host="a")
        proto = o.make_telemetry(o.Telemetry(cfg), host="b")
        fresh = o.make_telemetry(cfg, host="c")
        on.registry.inc("x")
        on.reset()
        return (forms, on.host, on.config, proto.config, proto.host,
                fresh.tracer.sample_every, on.registry.as_dict(),
                o.merge_telemetry([("a", None)]))
    t, j = run(tobs), run(jobs)
    assert t[0] == j[0] == [None, None]
    assert (t[1], t[4], t[5], t[6], t[7]) == (j[1], j[4], j[5], j[6], j[7])
    assert dataclasses.asdict(t[2]) == dataclasses.asdict(j[2])
    assert dataclasses.asdict(t[3]) == dataclasses.asdict(j[3])
    with pytest.raises(TypeError):
        tobs.make_telemetry("on")


def test_telemetry_pickles_with_pending_observations():
    tel = fleet_telemetry(tobs, 1)
    tel.registry.observe("late", 3.0)        # still pending at pickling
    back = pickle.loads(pickle.dumps(tel))
    assert back.registry.as_dict() == tel.registry.as_dict()
    assert back.recorder.dump() == tel.recorder.dump()
    assert back.tracer.chrome_trace() == tel.tracer.chrome_trace()
