"""Port vs reference: the host serving plane (``core/sdm.py``
``SDMEmbeddingStore`` and ``runtime/serve_sched.py`` ``ServeScheduler``).

Twin stores, one from ``repro`` and one from ``repro_torch``, are built over
the same table inventories (``sample_table_metas`` and the M1 trace of the
reference example, each package building its own) and served the same
queries through every entry point: ``serve_query``, ``serve_batch``,
``serve_batch_dict``, ``serve_columnar`` and the scheduler's. Analytic and
sampled latency modes, and a data-integrity/redundancy plane. Per-query
``QueryStats`` and latencies, the tier that served each chunk, the replay
and fallback counters and both caches' full state must be exactly equal;
pooled vectors (``materialize_dim``) within 1e-6.

Every store gets a telemetry handle of its own package: the reference
records ``last_tier`` only with one attached (the port records it always),
and both count each chunk's tier under ``diag.tier.<tier>``, which must be
equal too.
"""
import dataclasses

import numpy as np
import pytest

from repro.core import locality as jloc
from repro.core import sdm as jsdm
from repro.core.io_sim import DEVICES as JDEVICES
from repro.devices import DeviceTuning as JTuning
from repro.devices import IntegritySpec as JIntegrity
from repro.devices import UpdateSpec as JUpdate
from repro.obs import Telemetry as JTelemetry
from repro.runtime import serve_sched as jsched
from repro.runtime.redundancy import ReplicationSpec as JReplication
from repro.workloads import ARCHETYPES as JARCH
from repro.workloads import build_trace as jbuild
from repro_torch import serve_dlrm
from repro_torch.core import locality as tloc
from repro_torch.core import sdm as tsdm
from repro_torch.core.io_sim import DEVICES as TDEVICES
from repro_torch.devices import DeviceTuning as TTuning
from repro_torch.devices import IntegritySpec as TIntegrity
from repro_torch.devices import UpdateSpec as TUpdate
from repro_torch.obs import Telemetry as TTelemetry
from repro_torch.runtime import serve_sched as tsched
from repro_torch.runtime.redundancy import ReplicationSpec as TReplication
from repro_torch.workloads import build_trace as tbuild

POOL_TOL = 1e-6

PORT = dict(sdm=tsdm, loc=tloc, dev=TDEVICES, tuning=TTuning, update=TUpdate,
            integrity=TIntegrity, replication=TReplication, sched=tsched,
            build=tbuild, telemetry=TTelemetry)
REF = dict(sdm=jsdm, loc=jloc, dev=JDEVICES, tuning=JTuning, update=JUpdate,
           integrity=JIntegrity, replication=JReplication, sched=jsched,
           build=jbuild, telemetry=JTelemetry)

# latency-mode / device-plane variants of SDMConfig, built per package
MODES = {
    "analytic": lambda p: {},
    "sampled": lambda p: dict(latency_mode="sampled", sim_seed=4),
    "sampled_tuned": lambda p: dict(
        latency_mode="sampled", sim_seed=4,
        update=p["update"](model_size_gb=1000.0),
        tuning=p["tuning"](max_outstanding=12, read_priority=True)),
    "integrity": lambda p: dict(
        integrity=p["integrity"](uber=2e-3, wear_scale=0.5),
        redundancy=p["replication"](k=2, hedge_after_us=60.0)),
    "integrity_sampled": lambda p: dict(
        latency_mode="sampled", sim_seed=4,
        update=p["update"](model_size_gb=1000.0),
        integrity=p["integrity"](uber=2e-3, disturb_scale=2.0),
        redundancy=p["replication"](k=2, hedge_after_us=150.0)),
}


def sample_metas(p, num_user=10, pool=16):
    return p["loc"].sample_table_metas(
        np.random.default_rng(0), num_user=num_user, num_item=4,
        user_dim_bytes=(90, 172), item_dim_bytes=(90, 172), user_pool=pool,
        item_pool=8, total_bytes=2e9)


def make_store(p, metas, mode="analytic", *, fm=64 << 20, pooled=8 << 20,
               materialize_dim=0, seed=1, **kw):
    cfg = p["sdm"].SDMConfig(fm_cache_bytes=fm, pooled_cache_bytes=pooled,
                             pooled_len_threshold=4, **MODES[mode](p), **kw)
    store = p["sdm"].SDMEmbeddingStore(metas, p["dev"]["nand_flash"], cfg,
                                       seed=seed,
                                       materialize_dim=materialize_dim)
    store.telemetry = p["telemetry"]()
    return store


def twins(mode="analytic", metas=None, **kw):
    tm = sample_metas(PORT) if metas is None else metas[0]
    jm = sample_metas(REF) if metas is None else metas[1]
    return make_store(PORT, tm, mode, **kw), make_store(REF, jm, mode, **kw)


def tier_counts(store):
    """The store's ``diag.tier.*`` counters (the whole registry: a store's
    handle counts nothing else)."""
    counters = store.telemetry.registry.counters
    assert all(k.startswith("diag.tier.") for k in counters), counters
    return counters


def stats_tuple(q):
    return dataclasses.astuple(q)


def assert_stores_equal(t, j):
    assert stats_tuple(t.stats) == stats_tuple(j.stats)
    tc, jc = t.row_cache, j.row_cache
    np.testing.assert_array_equal(tc.tags, jc.tags)
    np.testing.assert_array_equal(tc.stamp, jc.stamp)
    assert (tc.clock, tc.hits, tc.misses, tc.filled, tc.evictions) == \
        (jc.clock, jc.hits, jc.misses, jc.filled, jc.evictions)
    assert (t.pooled_cache is None) == (j.pooled_cache is None)
    if t.pooled_cache is not None:
        tp, jp = t.pooled_cache, j.pooled_cache
        assert list(tp.store) == list(jp.store)
        assert (tp.used, tp.hits, tp.misses, tp.skipped, tp.hit_len_sum) == \
            (jp.used, jp.hits, jp.misses, jp.skipped, jp.hit_len_sum)
        if tp.store:
            np.testing.assert_allclose(
                np.concatenate([v for v, _ in tp.store.values()]),
                np.concatenate([v for v, _ in jp.store.values()]),
                rtol=0, atol=POOL_TOL)
    assert (t.batch_fallbacks, t.chunk_plan_hits, t.last_tier) == \
        (j.batch_fallbacks, j.chunk_plan_hits, j.last_tier)
    assert tier_counts(t) == tier_counts(j)
    assert (t.row_hit_rate, t.pooled_hit_rate) == (j.row_hit_rate, j.pooled_hit_rate)
    assert (t.io.total_ios, t.io.total_bus_bytes) == \
        (j.io.total_ios, j.io.total_bus_bytes)
    assert (t.io.sim is None) == (j.io.sim is None)
    if t.io.sim is not None:
        assert (t.io.sim.now_us, t.io.sim.read_ios, t.io.sim.read_waves,
                t.io.sim.write_busy_us) == (j.io.sim.now_us, j.io.sim.read_ios,
                                            j.io.sim.read_waves,
                                            j.io.sim.write_busy_us)
        np.testing.assert_array_equal(t.io.sim.slot_free_us, j.io.sim.slot_free_us)
    assert (t.io.integrity is None) == (j.io.integrity is None)
    if t.io.integrity is not None:
        assert dataclasses.astuple(t.io.integrity.stats) == \
            dataclasses.astuple(j.io.integrity.stats)


# -- per-query paths over sample_table_metas -------------------------------------


@pytest.mark.parametrize("mode", sorted(MODES))
def test_serve_query_equal(mode):
    t, j = twins(mode, materialize_dim=8, pooled=1 << 16)
    tqs = [t.synth_query() for _ in range(32)]
    jqs = [j.synth_query() for _ in range(32)]
    for tq, jq in zip(tqs, jqs):
        assert list(tq) == list(jq)
        for k in tq:
            np.testing.assert_array_equal(tq[k], jq[k])
    at = 0.0
    for tq, jq in zip(tqs + tqs[:16], jqs + jqs[:16]):   # repeats hit pooled
        at += 300.0
        assert stats_tuple(t.serve_query(tq, 5_000, at_us=at)) == \
            stats_tuple(j.serve_query(jq, 5_000, at_us=at))
    assert_stores_equal(t, j)
    for k in t.payloads:
        np.testing.assert_array_equal(t.payloads[k], j.payloads[k])
    assert t.stats.row_hits > 0 and t.stats.pooled_hits > 0
    if mode.startswith("integrity"):
        assert t.stats.corrupt_reads > 0 and t.stats.hedged_reads > 0


@pytest.mark.parametrize("checksums", [True, False])
def test_lookup_pool_vectors_equal(checksums):
    """``lookup_pool``'s pooled vectors, with the integrity plane attached;
    with checksums off the undetected count perturbs them on purpose
    (``core/sdm.py:188-197``)."""
    metas = (sample_metas(PORT), sample_metas(REF))
    kw = dict(materialize_dim=16, pooled=1 << 15)
    t = make_store(PORT, metas[0], integrity=TIntegrity(uber=0.3, checksums=checksums),
                   redundancy=TReplication(k=2), **kw)
    j = make_store(REF, metas[1], integrity=JIntegrity(uber=0.3, checksums=checksums),
                   redundancy=JReplication(k=2), **kw)
    clean = make_store(PORT, metas[0], **kw)
    perturbed = 0
    for _ in range(30):
        tq, jq, cq = t.synth_query(), j.synth_query(), clean.synth_query()
        for tid in tq:
            rt = t.lookup_pool(tid, tq[tid], 1e4)
            rj = j.lookup_pool(tid, jq[tid], 1e4)
            rc = clean.lookup_pool(tid, cq[tid], 1e4)
            assert (rt["latency_us"], rt["ios"], rt["pooled_hit"]) == \
                (rj["latency_us"], rj["ios"], rj["pooled_hit"])
            assert (rt["vector"] is None) == (rj["vector"] is None)
            if rt["vector"] is not None:
                np.testing.assert_allclose(rt["vector"], rj["vector"],
                                           rtol=0, atol=POOL_TOL)
                perturbed += not np.array_equal(rt["vector"], rc["vector"])
    assert_stores_equal(t, j)
    assert (perturbed > 0) == (not checksums)


@pytest.mark.parametrize("path", ["serve_batch", "serve_batch_dict"])
@pytest.mark.parametrize("fm,pooled", [(64 << 20, 8 << 20), (1 << 16, 1 << 12),
                                       (1 << 20, 0)])
@pytest.mark.parametrize("mode", ["analytic", "sampled", "integrity"])
def test_serve_batch_paths_equal(path, fm, pooled, mode):
    t, j = twins(mode, fm=fm, pooled=pooled, materialize_dim=8)
    seq = make_store(PORT, sample_metas(PORT), mode, fm=fm, pooled=pooled,
                     materialize_dim=8)
    for b in range(3):
        tqs = [t.synth_query() for _ in range(16)]
        jqs = [j.synth_query() for _ in range(16)]
        for _ in range(16):
            seq.synth_query()
        tqs += tqs[:4]                 # repeats: pooled pending hits, re-hits
        jqs += jqs[:4]
        at = 1e4 * b + 250.0 * np.arange(len(tqs))
        got = getattr(t, path)(tqs, 2e4, arrivals_us=at)
        want = getattr(j, path)(jqs, 2e4, arrivals_us=at)
        assert [stats_tuple(q) for q in got] == [stats_tuple(q) for q in want]
        assert_stores_equal(t, j)
        if mode == "analytic":         # the batch paths are the sequential one
            one = [seq.serve_query(q, 2e4) for q in tqs]
            assert [(q.sm_ios, q.sm_time_us) for q in one] == \
                [(q.sm_ios, q.sm_time_us) for q in got]
    if fm == 1 << 16:
        assert t.batch_fallbacks > 0


# -- the columnar plane over the M1 trace -----------------------------------------


def m1(p, name="zipf_steady", queries=128, table_bytes=3e6, rate=None):
    """The reference example's M1 traffic (``serve_dlrm.m1_spec``), cut to
    ``table_bytes``; ``rate`` sets the arrival rate as the example's sampled
    mode does."""
    if p is PORT:
        spec = serve_dlrm.m1_spec(name, queries=queries, table_bytes=table_bytes)
    else:
        spec = JARCH[name]
        spec = dataclasses.replace(
            spec, num_queries=queries,
            tenants=tuple(dataclasses.replace(
                t, model="dlrm-m1", num_user_tables=61, num_item_tables=30,
                table_bytes=table_bytes) for t in spec.tenants))
    if rate is not None:
        spec = dataclasses.replace(spec, arrival=dataclasses.replace(
            spec.arrival, rate_qps=rate))
    return p["build"](spec)


def serve_chunks(store, trace, chunk=32, bg=1e4, arrivals=True):
    out = []
    for ch in trace.chunks(chunk):
        sm, ios = store.serve_columnar(
            ch.columnar, bg, arrivals_us=ch.arrival_us if arrivals else None)
        out.append((sm.tolist(), ios.tolist(), store.last_tier))
    return out


@pytest.mark.parametrize("mode", ["analytic", "sampled_tuned", "integrity"])
@pytest.mark.parametrize("fm,pooled", [(8 << 20, 0), (8 << 20, 1 << 20),
                                       (1 << 17, 0)])
def test_serve_columnar_m1_trace_equal(mode, fm, pooled):
    """Two passes over the trace on one store (the resident tier once every
    key is in), then a fresh store over the same trace (the virgin replay
    tier), and an evicting cache (the exact fallback tier): per-chunk
    latencies, IOs and tiers equal."""
    queries = 32 if fm == 1 << 17 else 128     # the fallback tier is per query
    ttr, jtr = m1(PORT, queries=queries), m1(REF, queries=queries)
    metas = (ttr.all_metas(), jtr.all_metas())
    kw = dict(fm=fm, pooled=pooled)
    t, j = twins(mode, metas, **kw)
    tiers = []
    for _ in range(2):
        got, want = serve_chunks(t, ttr), serve_chunks(j, jtr)
        assert got == want
        tiers += [c[2] for c in got]
        assert_stores_equal(t, j)
    t2, j2 = twins(mode, metas, **kw)
    got, want = serve_chunks(t2, ttr), serve_chunks(j2, jtr)
    assert got == want
    tiers += [c[2] for c in got]
    assert_stores_equal(t2, j2)
    if pooled == 0 and fm == 8 << 20:
        assert {"resident", "virgin"} <= set(tiers)
    if fm == 1 << 17:
        assert "fallback" in tiers and t.batch_fallbacks > 0


def test_serve_columnar_m1_replay_tiers_are_exact():
    """The port's fused replay tiers leave what its live path leaves: the
    same trace on a store whose replay caches are dropped before every
    chunk."""
    trace = m1(PORT)
    fused, live = (make_store(PORT, trace.all_metas(), fm=8 << 20, pooled=0)
                   for _ in range(2))
    serve_chunks(make_store(PORT, trace.all_metas(), fm=8 << 20, pooled=0), trace)
    for _ in range(2):
        for ch in trace.chunks(32):
            live.drop_plan_caches()
            a = fused.serve_columnar(ch.columnar, 1e4)
            b = live.serve_columnar(ch.columnar, 1e4)
            assert [x.tolist() for x in a] == [x.tolist() for x in b]
    assert fused.chunk_plan_hits > 0
    assert dataclasses.astuple(fused.stats) == dataclasses.astuple(live.stats)
    np.testing.assert_array_equal(fused.row_cache.stamp, live.row_cache.stamp)


def test_serve_columnar_matches_serve_query_on_prefix():
    trace = m1(PORT, rate=240.0)
    a, b = (make_store(PORT, trace.all_metas(), "sampled_tuned", fm=8 << 20,
                       pooled=1 << 20) for _ in range(2))
    chunks = list(trace.chunks(32))[:2]
    for ch in chunks:
        a.serve_columnar(ch.columnar, 1e4, arrivals_us=ch.arrival_us)
        for req, at in zip(ch.requests, ch.arrival_us.tolist()):
            b.serve_query(req, 1e4, at_us=at)
    assert dataclasses.astuple(a.stats) == dataclasses.astuple(b.stats)


# -- the scheduler -----------------------------------------------------------------


def sched_twins(mode="analytic", metas=None, pooled=1 << 16, **cfg):
    t, j = twins(mode, metas, fm=4 << 20, pooled=pooled)
    return (tsched.ServeScheduler(t, tsched.ServeConfig(**cfg)),
            jsched.ServeScheduler(j, jsched.ServeConfig(**cfg)))


def assert_sched_equal(t, j):
    assert t.p_lat == j.p_lat
    assert (t.now_us, t.inflight, t.deferred) == (j.now_us, j.inflight, j.deferred)
    assert sorted(t._events) == sorted(j._events)
    for p in (50, 95, 99):
        assert t.percentile(p) == j.percentile(p)
    for target, pct in [(None, None), (500.0, None), (None, 99.0), (300.0, 95.0)]:
        assert t.qps_at_latency(target, pct) == j.qps_at_latency(target, pct)
    assert_stores_equal(t.store, j.store)


@pytest.mark.parametrize("cfg", [
    dict(),
    dict(inter_op_parallel=False),
    dict(arrival_gap_us=0.0, max_inflight_ios=400),
    dict(arrival_gap_us=50.0, max_inflight_ios=2_000, item_compute_us=100.0)])
def test_scheduler_dict_paths_equal(cfg):
    t, j = sched_twins(**cfg)
    assert t.percentile(99) == j.percentile(99) == 0.0
    assert t.qps_at_latency() == j.qps_at_latency() == 0.0
    for step in range(4):
        tqs = [t.store.synth_query() for _ in range(12)]
        jqs = [j.store.synth_query() for _ in range(12)]
        if step == 0:
            got = [t.serve(q, 1e4) for q in tqs]
            want = [j.serve(q, 1e4) for q in jqs]
        elif step == 1:
            got, want = t.serve_batch(tqs, 1e4), j.serve_batch(jqs, 1e4)
        elif step == 2:
            got = t.serve_batch_dict(tqs, 1e4)
            want = j.serve_batch_dict(jqs, 1e4)
        else:
            at = t.now_us + 40.0 * np.arange(12)
            got = t.serve_batch(tqs, 1e4, arrivals_us=at)
            want = j.serve_batch(jqs, 1e4, arrivals_us=at)
        assert [dataclasses.astuple(r) for r in got] == \
            [dataclasses.astuple(r) for r in want]
        assert_sched_equal(t, j)
    if cfg.get("max_inflight_ios") == 400:
        assert t.deferred > 0
    with pytest.raises(ValueError, match="arrivals_us"):
        t.serve_batch(tqs[:2], arrivals_us=[0.0])


@pytest.mark.parametrize("mode,rate,cfg", [
    ("analytic", 240.0, dict(inter_op_parallel=True, item_compute_us=200.0)),
    ("sampled_tuned", 240.0, dict(inter_op_parallel=True, item_compute_us=200.0)),
    ("analytic", None, dict(max_inflight_ios=100)),
    ("integrity_sampled", 240.0, dict(max_inflight_ios=20_000))])
def test_scheduler_serve_trace_equal(mode, rate, cfg):
    """``serve_trace`` and ``serve_columnar`` over the M1 trace, the way the
    reference example serves it; a tight ``max_inflight_ios`` at the
    archetype's own rate takes the saturated per-query ledger."""
    ttr, jtr = m1(PORT, rate=rate), m1(REF, rate=rate)
    t, j = sched_twins(mode, (ttr.all_metas(), jtr.all_metas()),
                       pooled=1 << 20, **cfg)
    assert t.serve_trace(ttr, 32, 1e4, collect=False) is None
    j.serve_trace(jtr, 32, 1e4, collect=False)
    assert_sched_equal(t, j)
    got = t.serve_trace(ttr, 32, 1e4, collect=True)
    want = j.serve_trace(jtr, 32, 1e4, collect=True)
    assert [dataclasses.astuple(r) for r in got] == \
        [dataclasses.astuple(r) for r in want]
    for tc, jc in zip(ttr.chunks(48), jtr.chunks(48)):
        got = t.serve_columnar(tc.columnar, 1e4, arrivals_us=tc.arrival_us)
        want = j.serve_columnar(jc.columnar, 1e4, arrivals_us=jc.arrival_us)
        assert [dataclasses.astuple(r) for r in got] == \
            [dataclasses.astuple(r) for r in want]
    assert_sched_equal(t, j)
    if cfg.get("max_inflight_ios") == 100:
        assert t.deferred > 0
    with pytest.raises(ValueError, match="arrivals_us"):
        t.serve_columnar(tc.columnar, arrivals_us=tc.arrival_us[:1])


# -- the slice's path: serve_dlrm --host-plane ----------------------------------------


@pytest.mark.parametrize("mode,updating,tuned", [("analytic", False, False),
                                                 ("sampled", True, True)])
def test_host_plane_path_matches_reference_example(mode, updating, tuned):
    """``serve_dlrm``'s host plane against the reference example's
    (``examples/serve_dlrm.py:83-115``, cut to a small inventory): the same
    store and scheduler settings served chunk by chunk at the trace's
    arrival times give the same latencies, ledger, caches and write plane,
    and the same Table 8 power statement; the device engine beside it
    pools within the reference tolerance of ``reference_pool``."""
    from repro.core.power import HW_L, HW_SS, Workload, run_scenario
    kw = dict(queries=96, table_bytes=3e6, latency_mode=mode)
    spec = serve_dlrm.host_plane_spec("zipf_steady", **kw)
    trace = tbuild(spec)
    store, sched = serve_dlrm.build_host_plane(
        trace, latency_mode=mode, updating=updating, tuned=tuned)
    store.telemetry = TTelemetry()
    engine = serve_dlrm.build_trace_engine(spec, 8, torch_device="cpu")
    res = serve_dlrm.serve_host_plane(sched, engine, trace, 32)
    jtr = m1(REF, queries=96, table_bytes=3e6,
             rate=240.0 if mode == "sampled" else None)
    jstore = jsdm.SDMEmbeddingStore(
        jtr.all_metas(), JDEVICES["nand_flash"],
        jsdm.SDMConfig(fm_cache_bytes=128 << 20, pooled_cache_bytes=16 << 20,
                       latency_mode=mode,
                       update=JUpdate(model_size_gb=1000.0) if updating else None,
                       tuning=(JTuning(max_outstanding=12, read_priority=True)
                               if tuned else None)),
        seed=3)
    jstore.telemetry = JTelemetry()
    jsch = jsched.ServeScheduler(jstore, jsched.ServeConfig(
        inter_op_parallel=True, item_compute_us=200.0))
    jtiers = []
    for ch in jtr.chunks(32):
        jsch.serve_columnar(ch.columnar, bg_iops=10_000,
                            arrivals_us=ch.arrival_us, collect=False)
        jtiers.append(jstore.last_tier)
    assert res.tiers == jtiers and res.chunks == 3 and res.queries == 96
    assert tier_counts(store) == tier_counts(jstore)
    assert sum(tier_counts(store).values()) == 3
    assert_sched_equal(sched, jsch)
    if updating:
        u, ju = store.io.sim.update, jstore.io.sim.update
        assert (u.waves, u.gc_events) == (ju.waves, ju.gc_events)
        assert u.waves > 0
    assert res.max_dev_gap <= 1.0 and res.max_dev_err < 1e-4
    assert len(res.host_ms) == len(res.device_ms) == 3
    w = Workload("m1", sm_tables=50, avg_pool=42, row_bytes=59,
                 cache_hit_rate=max(jstore.row_hit_rate, 0.9),
                 total_qps=240 * 1200)
    want = (run_scenario("HW-L", HW_L, w, use_sdm=False, qps_override=240),
            run_scenario("HW-SS+SDM", HW_SS, w, use_sdm=True))
    assert [dataclasses.astuple(r) for r in serve_dlrm.fleet_power(store)] == \
        [dataclasses.astuple(r) for r in want]


def test_serve_dlrm_host_plane_cli_on_cpu(capsys):
    serve_dlrm.main(["--device", "cpu", "--archetype", "zipf_steady",
                     "--host-plane", "--latency-mode", "sampled", "--updating",
                     "--tuned", "--queries", "64", "--table-bytes", "3e6",
                     "--dim", "16", "--item-batch", "8"])
    out = capsys.readouterr().out
    for line in ("SM latency plane:    sampled (updating=True, tuned=True)",
                 "update write plane:", "p50/p95/p99 latency:",
                 "row-cache hit rate:", "pooled hit rate:",
                 "inflight IOs (now):", "feasible QPS (p95):",
                 "device engine:       hit rate", "fleet power: HW-L=1200"):
        assert line in out, line
    assert "served 64 queries of trace 'zipf_steady'" in out


def test_serve_dlrm_host_plane_flags():
    with pytest.raises(SystemExit):
        serve_dlrm.main(["--device", "cpu", "--latency-mode", "sampled"])
    with pytest.raises(SystemExit):
        serve_dlrm.main(["--device", "cpu", "--host-plane"])
    import torch
    if not torch.cuda.is_available():   # the device engine defaults to cuda
        with pytest.raises(RuntimeError, match="CUDA"):
            serve_dlrm.main(["--archetype", "zipf_steady", "--host-plane",
                             "--queries", "8", "--table-bytes", "3e6"])
