"""Port vs reference: the fleet plane's host side (``runtime/cluster.py``
``ClusterSim`` and ``runtime/control.py``, over ``workloads/failures.py``
and ``obs/``).

Twin ``ClusterSim``s, one built from ``repro`` and one from ``repro_torch``,
run the same traces (each package building its own from the same spec):
every ``dataclasses.asdict(HostReport)`` and the fleet p50/p95/p99/p999 must
be equal, as ``tests/test_fleet_ops.py`` compares its runs. The cases cover
the three routings, self-consistent passes with warmup, the analytic and
sampled device planes, a crash / slow / IO-error schedule under each
degrade policy, device loss on an integrity host, ``run_stream``, the
thread and process pools, the failure generator, the failover rewrite, the
autoscaler and the capacity planner. With telemetry on, the merged registry,
the flight recorder's dump and the Chrome trace must equal the reference's;
the reports must equal the telemetry-free run's.
"""
import dataclasses
import functools

import numpy as np
import pytest

import repro.obs as jobs
import repro_torch.obs as tobs
from repro.core import power as jpower
from repro.devices import DeviceTuning as JTuning
from repro.devices import IntegritySpec as JIntegrity
from repro.devices import UpdateSpec as JUpdate
from repro.runtime import cluster as jcluster
from repro.runtime import control as jcontrol
from repro.runtime.redundancy import ReplicationSpec as JReplication
from repro import workloads as jwork
from repro.workloads.stream import TraceStream as JStream
from repro_torch.core import power as tpower
from repro_torch.devices import DeviceTuning as TTuning
from repro_torch.devices import IntegritySpec as TIntegrity
from repro_torch.devices import UpdateSpec as TUpdate
from repro_torch.runtime import cluster as tcluster
from repro_torch.runtime import control as tcontrol
from repro_torch.runtime.redundancy import ReplicationSpec as TReplication
from repro_torch import workloads as twork
from repro_torch.workloads.stream import TraceStream as TStream

PORT = dict(power=tpower, cluster=tcluster, control=tcontrol, work=twork,
            stream=TStream, obs=tobs, tuning=TTuning, update=TUpdate,
            integrity=TIntegrity, replication=TReplication)
REF = dict(power=jpower, cluster=jcluster, control=jcontrol, work=jwork,
           stream=JStream, obs=jobs, tuning=JTuning, update=JUpdate,
           integrity=JIntegrity, replication=JReplication)
ROUTINGS = ("tenant_sticky", "round_robin", "per_tenant")


def spec(p, name="multi_tenant", n=480, seed=0):
    return dataclasses.replace(p["work"].ARCHETYPES[name], num_queries=n,
                               seed=seed)


@functools.lru_cache(maxsize=None)
def _trace(pkg, name="multi_tenant", n=480, seed=0):
    """Cached per package: traces are read-only to the serving stack."""
    p = PORT if pkg == "port" else REF
    return p["work"].build_trace(spec(p, name, n, seed))


def trace(p, *a):
    return _trace("port" if p is PORT else "ref", *a)


def hosts(p, k=3, cache=8 << 20, **kw):
    return tuple(p["cluster"].HostSpec(name=f"h{i}", host=p["power"].HW_SS,
                                       device="nand_flash",
                                       fm_cache_bytes=cache, **kw)
                 for i in range(k))


def sampled(p):
    return dict(latency_mode="sampled",
                tuning=p["tuning"](max_outstanding=12, read_priority=True),
                update=p["update"](model_size_gb=1000.0))


def cluster(p, k=3, routing="round_robin", chunk=64, telemetry=None, **kw):
    c = p["cluster"]
    return c.ClusterSim(c.ClusterConfig(hosts=hosts(p, k, **kw),
                                        routing=routing, chunk=chunk,
                                        telemetry=telemetry))


def report_key(rep):
    return ([dataclasses.asdict(h) for h in rep.hosts],
            (rep.p50_us, rep.p95_us, rep.p99_us, rep.p999_us))


def assert_reports_equal(a, b):
    assert report_key(a) == report_key(b)


def control_kwargs(p, tr, degrade=None, error_rate=0.2):
    w = p["work"]
    d = tr.duration_us
    fs = w.FailureSpec(events=(
        w.FailureEvent(host="h1", kind="crash", start_us=0.4 * d,
                       end_us=0.7 * d, inflight_window_us=0.02 * d),
        w.FailureEvent(host="h0", kind="slow", start_us=0.1 * d,
                       end_us=0.25 * d, slow_bg_iops=50_000.0),
        w.FailureEvent(host="h2", kind="io_errors", start_us=0.5 * d,
                       end_us=0.8 * d, error_rate=error_rate,
                       retry_penalty_us=900.0)), seed=3)
    deg = None if degrade is None else p["control"].DegradePolicy(
        mode=degrade, inflight_hi=8, inflight_lo=2)
    return dict(failures=fs, degrade=deg)


def twin(fn):
    """``fn(package)`` for the port and the reference."""
    return fn(PORT), fn(REF)


# -- routing, passes, latency modes --------------------------------------------------


@pytest.mark.parametrize("kw", [{}, dict(passes=2, warmup=True)],
                         ids=["one_pass", "two_passes_warm"])
@pytest.mark.parametrize("routing", ROUTINGS)
def test_routings_match_reference(routing, kw):
    t, j = twin(lambda p: cluster(p, routing=routing).run(trace(p), **kw))
    assert_reports_equal(t, j)
    assert t.queries == len(trace(PORT))


@pytest.mark.parametrize("mode", ["analytic", "sampled"])
def test_latency_modes_match_reference(mode):
    def run(p):
        kw = sampled(p) if mode == "sampled" else {}
        return cluster(p, cache=1 << 20, **kw).run(
            trace(p, "zipf_steady", 320), passes=2, warmup=True)
    t, j = twin(run)
    assert_reports_equal(t, j)
    assert all(h.sm_ios > 0 for h in t.hosts)


def test_dram_only_and_mixed_fleet_match_reference():
    def run(p):
        c = p["cluster"]
        mixed = (c.HostSpec("dram", p["power"].HW_L, device=None),
                 c.HostSpec("optane", p["power"].HW_SS, device="optane_ssd",
                            count=2, pooled_cache_bytes=1 << 20),
                 c.HostSpec("nand", p["power"].HW_SS, demand_scale=4.0))
        sim = c.ClusterSim(c.ClusterConfig(hosts=mixed, routing="per_tenant"))
        rep = sim.run(trace(p))
        return rep, rep.fleet_power(240 * 1200), rep.fleet_power(1e5, tail=True)
    t, j = twin(run)
    assert_reports_equal(t[0], j[0])
    assert [dataclasses.asdict(e) for e in t[1:]] == \
        [dataclasses.asdict(e) for e in j[1:]]
    assert (t[0].fleet_feasible_qps, t[0].sim_power, t[0].deferred) == \
        (j[0].fleet_feasible_qps, j[0].sim_power, j[0].deferred)


# -- the control plane -------------------------------------------------------------------


@pytest.mark.parametrize("degrade", [None, "stale", "shed"])
def test_control_plane_matches_reference(degrade):
    def run(p):
        tr = trace(p)
        return cluster(p, k=4).run(tr, passes=2, warmup=True,
                                   **control_kwargs(p, tr, degrade))
    t, j = twin(run)
    assert_reports_equal(t, j)
    assert t.crashes == 1 and t.queries == len(trace(PORT))
    assert t.io_error_retries > 0 and t.failed_over > 0
    if degrade is not None:
        assert t.degraded_chunks > 0
        assert (t.stale_served if degrade == "stale" else t.shed_queries) > 0
    for name, rollup, _, _ in tobs.HOST_COUNTERS:
        assert getattr(t, rollup) == getattr(j, rollup)


def test_device_loss_on_integrity_hosts_matches_reference():
    def run(p):
        tr = trace(p, "zipf_steady", 480)
        w = p["work"]
        fs = w.FailureSpec(events=(w.FailureEvent(
            host="h0", kind="device_loss", start_us=0.3 * tr.duration_us,
            end_us=0.9 * tr.duration_us),))
        sim = cluster(p, k=2, integrity=p["integrity"](uber=2e-3),
                      redundancy=p["replication"](k=2, hedge_after_us=60.0),
                      telemetry=True)
        return sim.run(tr, failures=fs)
    t, j = twin(run)
    assert_reports_equal(t, j)
    assert t.rows_lost > 0 and t.corrupt_reads > 0
    assert t.telemetry.registry.as_dict() == j.telemetry.registry.as_dict()
    assert t.telemetry.recorder.dump() == j.telemetry.recorder.dump()
    assert "rebuild_start" in {e["kind"] for e in t.telemetry.recorder.dump()}


@pytest.mark.parametrize("routing,passes", [("tenant_sticky", 1),
                                            ("round_robin", 2),
                                            ("per_tenant", 1)])
def test_run_stream_matches_reference(routing, passes):
    def run(p):
        sim = cluster(p, routing=routing)
        st = p["stream"](spec(p, n=480), piece=120)
        kw = control_kwargs(p, trace(p, "multi_tenant", 480), "stale")
        return sim.run_stream(st, passes=passes, warmup=passes > 1, **kw)
    t, j = twin(run)
    assert_reports_equal(t, j)
    assert t.queries == 480


def test_thread_pool_matches_serial_and_reference():
    tr = trace(PORT)
    sim = cluster(PORT, k=4)
    kw = control_kwargs(PORT, tr, "stale")
    serial = sim.run(tr, passes=2, warmup=True, **kw)
    threaded = sim.run(tr, passes=2, warmup=True, parallel="thread", **kw)
    jtr = trace(REF)
    ref = cluster(REF, k=4).run(jtr, passes=2, warmup=True,
                                **control_kwargs(REF, jtr, "stale"))
    assert_reports_equal(serial, threaded)
    assert_reports_equal(serial, ref)


@pytest.mark.slow
def test_process_pool_matches_serial():
    tr = trace(PORT, "multi_tenant", 240)
    sim = cluster(PORT)
    kw = control_kwargs(PORT, tr, "stale")
    serial = sim.run(tr, passes=2, warmup=True, **kw)
    procs = sim.run(tr, passes=2, warmup=True, parallel="process",
                    max_workers=2, **kw)
    assert_reports_equal(serial, procs)


def test_empty_fleet_and_trace_match_reference():
    def run(p):
        c = p["cluster"]
        empty = c.ClusterSim(c.ClusterConfig(hosts=()))
        tr = trace(p)
        none = tr.subset(np.zeros(len(tr), bool))
        return (empty.run(tr), cluster(p).run(none),
                cluster(p).run_device_plane(none, {}))
    for a, b in zip(*twin(run)):
        assert_reports_equal(a, b)


# -- generators, rewrite, autoscaler, planner -----------------------------------------------


# ids of their own: a bare "slow" id would read as the slow marker
@pytest.mark.parametrize("kind", ["crash", "slow", "io_errors"],
                         ids=lambda k: f"{k}_events")
def test_seeded_failures_match_reference(kind):
    def run(p):
        return p["work"].seeded_failures(
            ["h0", "h1", "h2"], 4e5, seed=7, mtbf_us=2e5, mttr_us=2e4,
            kind=kind, slow_bg_iops=1e4)
    t, j = twin(run)
    assert [dataclasses.asdict(e) for e in t.events] == \
        [dataclasses.asdict(e) for e in j.events]
    assert t.seed == j.seed and len(t.events) > 0
    with pytest.raises(ValueError):
        twork.seeded_failures(["h0"], 1.0, mtbf_us=0.0)


def test_rewrite_assignment_matches_reference():
    def run(p):
        tr = trace(p)
        names = ["h0", "h1", "h2", "h3"]
        fs = p["work"].seeded_failures(names, tr.duration_us, seed=5,
                                       mtbf_us=tr.duration_us / 2,
                                       mttr_us=tr.duration_us / 10,
                                       inflight_window_us=2e3)
        assign = p["cluster"].sticky_route(tr.tenant, 4)
        plan = p["control"].rewrite_assignment(assign, tr.arrival_us, names,
                                               fs)
        ctls = p["control"].build_controls(names, fs, None, seed=1)
        return plan, ctls
    (tp, tc), (jp, jc) = twin(run)
    assert tp.assign.tolist() == jp.assign.tolist()
    assert tp.replay_at_us.tolist() == jp.replay_at_us.tolist()
    assert (tp.failed_over_in, tp.replayed_in, tp.stranded) == \
        (jp.failed_over_in, jp.replayed_in, jp.stranded)
    assert sum(tp.failed_over_in.values()) > 0
    assert [None if c is None else (c.host_index, c.pressure_windows,
                                    len(c.events)) for c in tc] == \
        [None if c is None else (c.host_index, c.pressure_windows,
                                 len(c.events)) for c in jc]


@pytest.mark.parametrize("routing", ROUTINGS)
def test_autoscale_run_matches_reference(routing):
    def run(p):
        ctl = p["control"]
        tr = trace(p, "diurnal", 480, 2)
        peak = len(tr) / tr.duration_us * 1e6
        policy = ctl.AutoscalePolicy(host_capacity_qps=peak / 2.0,
                                     window_us=tr.duration_us / 24.0,
                                     cooldown_us=tr.duration_us / 24.0,
                                     initial_hosts=2, max_hosts=4)
        res = ctl.autoscale_run(cluster(p, k=4, routing=routing), tr, policy)
        return res, ctl.autoscale_assign(tr, res.schedule, policy, routing)
    (t, ta), (j, ja) = twin(run)
    assert t.schedule.tolist() == j.schedule.tolist()
    assert ta.tolist() == ja.tolist()
    assert (t.host_seconds, t.static_host_seconds, t.host_seconds_saved) == \
        (j.host_seconds, j.static_host_seconds, j.host_seconds_saved)
    assert_reports_equal(t.report, j.report)


def test_plan_capacity_matches_reference():
    def run(p):
        c, hw = p["cluster"], p["power"]
        candidates = {
            "nand": c.HostSpec("nand", hw.HW_SS, device="nand_flash",
                               fm_cache_bytes=8 << 20),
            "optane": c.HostSpec("optane", dataclasses.replace(
                hw.HW_SS, ssd_kind="optane"), device="optane_ssd",
                fm_cache_bytes=8 << 20),
            "dram": c.HostSpec("dram", hw.HW_L, device=None)}
        tr = trace(p, "multi_tenant", 240)
        fails = functools.partial(p["work"].seeded_failures,
                                  duration_us=tr.duration_us, seed=1,
                                  mtbf_us=tr.duration_us, mttr_us=1e4)
        return [p["control"].plan_capacity(tr, candidates, 240 * 1200, slo,
                                           passes=1, warmup=False,
                                           failures=fails, percentile=pct)
                for slo, pct in ((10_000.0, 99.0), (5_000.0, 99.9),
                                 (100.0, 99.0))]
    for t, j in zip(*twin(run)):
        assert [dataclasses.asdict(o) for o in t.options] == \
            [dataclasses.asdict(o) for o in j.options]
        assert (t.best, t.best_mix, t.best_power) == \
            (j.best, j.best_mix, j.best_power)


# -- telemetry -----------------------------------------------------------------------------


def telemetry_run(p, telemetry, mode="analytic"):
    tr = trace(p)
    kw = sampled(p) if mode == "sampled" else {}
    return cluster(p, telemetry=telemetry, **kw).run(
        tr, passes=2, warmup=True, **control_kwargs(p, tr, "stale"))


@pytest.mark.parametrize("mode", ["analytic", "sampled"])
def test_telemetry_matches_reference(mode):
    cfg = {"port": tobs.ObsConfig(span_sample_every=4),
           "ref": jobs.ObsConfig(span_sample_every=4)}
    t, j = twin(lambda p: telemetry_run(
        p, cfg["port" if p is PORT else "ref"], mode))
    assert_reports_equal(t, j)
    tt, jt = t.telemetry, j.telemetry
    assert tt.registry.as_dict() == jt.registry.as_dict()
    assert tt.recorder.dump() == jt.recorder.dump()
    assert tt.tracer.chrome_trace() == jt.tracer.chrome_trace()
    assert tobs.prometheus_text(tt.registry) == jobs.prometheus_text(jt.registry)
    assert tobs.render_report(tt, t.hosts) == jobs.render_report(jt, j.hosts)
    assert tobs.telemetry_json(tt, git_sha="0" * 7) == \
        jobs.telemetry_json(jt, git_sha="0" * 7)
    c = tt.registry.counters
    assert c["control.crashes"] == t.crashes == 1
    assert any(k.startswith("diag.tier.") for k in c)
    if mode == "sampled":
        assert "device.queue_wait_us" in tt.registry.hists


@pytest.mark.parametrize("mode", ["analytic", "sampled"])
def test_telemetry_off_is_bit_invisible(mode):
    on = telemetry_run(PORT, True, mode)
    off = telemetry_run(PORT, None, mode)
    assert off.telemetry is None and on.telemetry is not None
    assert_reports_equal(on, off)
    assert_reports_equal(off, telemetry_run(REF, None, mode))


def test_spec_level_false_overrides_cluster_default():
    c = tcluster
    specs = (dataclasses.replace(hosts(PORT, 1)[0], name="off",
                                 telemetry=False),
             dataclasses.replace(hosts(PORT, 1)[0], name="on"))
    sim = c.ClusterSim(c.ClusterConfig(hosts=specs, routing="round_robin",
                                       telemetry=True))
    rep = sim.run(trace(PORT))
    assert rep.telemetry is not None
    assert [e["pid"] for e in rep.telemetry.tracer.chrome_trace()["traceEvents"]
            if e["name"] == "process_name"] == [1]
