"""Port vs reference: the workload plane (``repro_torch.workloads`` vs
``repro.workloads``), the locality and key helpers under it
(``core/locality.py``, ``core/cache_sim.py``, ``core/pooled_cache.py``) and
the DLRM configs (Table 6). Same specs, seeds and numpy inputs; every array
bit-equal."""
import dataclasses

import numpy as np
import pytest

from repro.configs.base import DLRM_REGISTRY as JDLRM
from repro.core import cache_sim as jcs
from repro.core import locality as jloc
from repro.core import pooled_cache as jpc
from repro.workloads import archetypes as jarch
from repro.workloads import stream as jstream
from repro.workloads import trace as jtrace
from repro_torch.configs.base import DLRM_REGISTRY as TDLRM
from repro_torch.configs import get_dlrm_config
from repro_torch.core import cache_sim as tcs
from repro_torch.core import locality as tloc
from repro_torch.core import pooled_cache as tpc
from repro_torch.workloads import archetypes as tarch
from repro_torch.workloads import stream as tstream
from repro_torch.workloads import trace as ttrace

ARCHETYPES = sorted(jarch.ARCHETYPES)


def small(spec, n=48):
    """The small-trace cut of ``tests/test_sharded_engine.py``: 48 queries,
    3 user tables and 1 item table per tenant, 3e5 bytes of inventory."""
    return dataclasses.replace(
        spec, num_queries=n,
        tenants=tuple(dataclasses.replace(
            t, table_bytes=3e5, num_user_tables=3, num_item_tables=1)
            for t in spec.tenants))


def as_tuples(metas):
    return [dataclasses.astuple(m) for m in metas]


def assert_trace_equal(t, j):
    assert (t.name, t.seed, t.tenant_names) == (j.name, j.seed, j.tenant_names)
    for name in ("arrival_us", "tenant"):
        a, b = getattr(t, name), getattr(j, name)
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    for name in ("values", "seg_offsets", "seg_table", "query_seg"):
        a, b = getattr(t.queries, name), getattr(j.queries, name)
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert list(t.metas) == list(j.metas)
    for k in j.metas:
        assert as_tuples(t.metas[k]) == as_tuples(j.metas[k])


# -- configs ------------------------------------------------------------------


def test_dlrm_registry_copy_agrees():
    assert sorted(TDLRM) == sorted(JDLRM) == ["dlrm-m1", "dlrm-m2", "dlrm-m3"]
    for name, j in JDLRM.items():
        t = get_dlrm_config(name)
        for f in dataclasses.fields(j):
            assert getattr(t, f.name) == getattr(j, f.name), (name, f.name)
        assert dataclasses.asdict(t.reduced()) == dataclasses.asdict(j.reduced())


# -- traces ---------------------------------------------------------------------


@pytest.mark.parametrize("name", ARCHETYPES)
def test_build_trace_bit_equal(name):
    t = tarch.build_trace(small(tarch.ARCHETYPES[name]))
    j = jarch.build_trace(small(jarch.ARCHETYPES[name]))
    assert_trace_equal(t, j)
    assert as_tuples(t.all_metas()) == as_tuples(j.all_metas())
    assert (t.duration_us, t.offered_qps) == (j.duration_us, j.offered_qps)


@pytest.mark.parametrize("name", ARCHETYPES)
def test_archetype_specs_agree(name):
    assert dataclasses.asdict(tarch.ARCHETYPES[name]) == \
        dataclasses.asdict(jarch.ARCHETYPES[name])
    assert tarch.TENANT_TID_BASE == jarch.TENANT_TID_BASE


def test_build_trace_at_m1_inventory():
    """The serving path's inventory (61 user and 30 item tables, as
    ``examples/serve_dlrm.py`` builds it), with few queries."""
    def m1(spec_mod):
        spec = spec_mod.ARCHETYPES["zipf_steady"]
        return dataclasses.replace(spec, num_queries=12, tenants=tuple(
            dataclasses.replace(t, num_user_tables=61, num_item_tables=30,
                                table_bytes=4e9) for t in spec.tenants))
    t, j = tarch.build_trace(m1(tarch)), jarch.build_trace(m1(jarch))
    assert_trace_equal(t, j)
    assert sum(m.num_rows for m in t.all_metas() if m.kind == "user") == 21_730_221


@pytest.mark.parametrize("name", ["zipf_steady", "zipf_drift", "diurnal",
                                  "bursty"])
def test_trace_chunks_subset_and_slices_agree(name):
    t = tarch.build_trace(small(tarch.ARCHETYPES[name], 40))
    j = jarch.build_trace(small(jarch.ARCHETYPES[name], 40))
    for tc, jc in zip(t.chunks(7), j.chunks(7)):
        assert tc.start == jc.start
        np.testing.assert_array_equal(tc.arrival_us, jc.arrival_us)
        for a, b in zip(tc.requests, jc.requests):
            assert list(a) == list(b)
            for k in a:
                np.testing.assert_array_equal(a[k], b[k])
    mask = np.random.default_rng(1).random(40) < 0.5
    assert_trace_equal(t.subset(mask), j.subset(mask))
    assert_trace_equal(ttrace.slice_trace(t, 5, 23), jtrace.slice_trace(j, 5, 23))
    parts_t = [ttrace.slice_trace(t, a, b) for a, b in ((0, 9), (9, 30), (30, 40))]
    parts_j = [jtrace.slice_trace(j, a, b) for a, b in ((0, 9), (9, 30), (30, 40))]
    assert_trace_equal(ttrace.concat_traces(parts_t), jtrace.concat_traces(parts_j))
    assert_trace_equal(ttrace.concat_traces(parts_t), t)


# -- streams --------------------------------------------------------------------


@pytest.mark.parametrize("name", ARCHETYPES)
def test_trace_stream_bit_equal(name):
    spec_t = small(tarch.ARCHETYPES[name], 100)
    spec_j = small(jarch.ARCHETYPES[name], 100)
    whole = jstream.TraceStream(spec_j, piece=100, block=32).materialize()
    for piece in (17, 40):
        ts = tstream.TraceStream(spec_t, piece=piece, block=32)
        js = jstream.TraceStream(spec_j, piece=piece, block=32)
        assert len(ts) == len(js) == 100
        assert as_tuples(ts.all_metas()) == as_tuples(js.all_metas())
        got = list(ts.pieces())
        want = list(js.pieces())
        assert [p.start for p in got] == [p.start for p in want]
        for a, b in zip(got, want):
            assert_trace_equal(a.trace, b.trace)
        assert_trace_equal(ts.materialize(), whole)


def test_trace_stream_rejects_per_tenant_arrivals():
    spec = dataclasses.replace(
        tarch.ARCHETYPES["zipf_steady"],
        tenants=(dataclasses.replace(tarch.ARCHETYPES["zipf_steady"].tenants[0],
                                     arrival=tarch.ArrivalSpec()),))
    with pytest.raises(ValueError):
        tstream.TraceStream(spec)
    with pytest.raises(ValueError):
        tstream.TraceStream(tarch.ARCHETYPES["zipf_steady"], piece=0)


def test_per_tenant_arrival_streams_bit_equal():
    def spec(mod):
        base = mod.ARCHETYPES["multi_tenant"]
        tenants = tuple(dataclasses.replace(t, arrival=mod.ArrivalSpec(p))
                        for t, p in zip(base.tenants, ("poisson", "mmpp", "diurnal")))
        return small(dataclasses.replace(base, tenants=tenants), 60)
    assert_trace_equal(tarch.build_trace(spec(tarch)), jarch.build_trace(spec(jarch)))


# -- index and arrival processes -------------------------------------------------


@pytest.mark.parametrize("alpha", [1.05, 1.3, 2.0])
@pytest.mark.parametrize("num_rows", [1, 64, 2_679, 6_533_638])
def test_zipf_indices_bit_equal(alpha, num_rows):
    seed = int(alpha * 100) + num_rows
    got = tloc.zipf_indices(np.random.default_rng(seed), num_rows, alpha, 5000)
    want = jloc.zipf_indices(np.random.default_rng(seed), num_rows, alpha, 5000)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    assert got.min() >= 0 and got.max() < num_rows


@pytest.mark.parametrize("epoch,blend", [(0, 0.0), (3, 0.0), (7, 0.3)])
def test_zipf_drift_bit_equal(epoch, blend):
    args = (50_000, 1.2, 4000, epoch, blend)
    np.testing.assert_array_equal(
        ttrace.zipf_indices_drift(np.random.default_rng(epoch), *args),
        jtrace.zipf_indices_drift(np.random.default_rng(epoch), *args))
    sizes = np.array([0, 5, 41, 1, 0, 63])
    epochs = np.array([0, 1, 1, 2, 5, 9])
    np.testing.assert_array_equal(
        ttrace.zipf_indices_drift_flat(np.random.default_rng(4), 999, 1.4, sizes,
                                       epochs, blend),
        jtrace.zipf_indices_drift_flat(np.random.default_rng(4), 999, 1.4, sizes,
                                       epochs, blend))


def test_arrival_processes_bit_equal():
    for fn, args in ((ttrace.poisson_arrivals, (500, 2000.0)),
                     (ttrace.mmpp_arrivals, (500, 2000.0)),
                     (ttrace.nonhomogeneous_arrivals,
                      (500, 3000.0, lambda t: 1500.0 + 1000.0 * np.sin(t / 1e5)))):
        jfn = getattr(jtrace, fn.__name__)
        np.testing.assert_array_equal(fn(np.random.default_rng(3), *args),
                                      jfn(np.random.default_rng(3), *args))
    parts = [np.sort(np.random.default_rng(i).random(20)) for i in range(3)]
    for a, b in zip(ttrace.interleave_arrivals(parts), jtrace.interleave_arrivals(parts)):
        np.testing.assert_array_equal(a, b)
    arr = np.sort(np.random.default_rng(5).random(300) * 1e6)
    np.testing.assert_array_equal(ttrace.windowed_qps(arr, 1e6),
                                  jtrace.windowed_qps(arr, 1e6))


def test_stream_arrival_blocks_bit_equal():
    for process in ("poisson", "diurnal", "mmpp"):
        a = tarch.ArrivalSpec(process)
        ja = jarch.ArrivalSpec(process)
        carry_t = carry_j = None
        for bi in range(3):
            got, carry_t = tstream._arrival_block(a, 200, carry_t,
                                                  np.random.default_rng(bi))
            want, carry_j = jstream._arrival_block(ja, 200, carry_j,
                                                   np.random.default_rng(bi))
            np.testing.assert_array_equal(got, want)
            assert carry_t == carry_j


# -- locality, keys and hash mixers ----------------------------------------------


def test_table_metas_bit_equal():
    kw = dict(num_user=61, num_item=30, user_dim_bytes=(90, 172),
              item_dim_bytes=(90, 172), user_pool=42, item_pool=9,
              total_bytes=4e9)
    assert as_tuples(tloc.sample_table_metas(np.random.default_rng(7), **kw)) == \
        as_tuples(jloc.sample_table_metas(np.random.default_rng(7), **kw))
    spec = small(jarch.ARCHETYPES["multi_tenant"])
    got = tarch.tenant_table_metas(small(tarch.ARCHETYPES["multi_tenant"]))
    want = jarch.tenant_table_metas(spec)
    assert {k: as_tuples(v) for k, v in got.items()} == \
        {k: as_tuples(v) for k, v in want.items()}


def test_locality_measures_bit_equal():
    rng = np.random.default_rng(11)
    tr = jloc.zipf_indices(rng, 20_000, 1.2, 30_000)
    np.testing.assert_array_equal(tloc.access_cdf(tr, 20_000), jloc.access_cdf(tr, 20_000))
    assert tloc.spatial_locality(tr, 136, window=7_000) == \
        jloc.spatial_locality(tr, 136, window=7_000)
    users = rng.integers(0, 1 << 40, 1000)
    np.testing.assert_array_equal(tloc.sticky_route(users, 7), jloc.sticky_route(users, 7))


def test_row_keys_and_sets_bit_equal():
    rng = np.random.default_rng(12)
    tids = rng.integers(0, 3 << 14, 4000)
    rows = rng.integers(0, 6_533_638, 4000)
    for table in (tids, 5, np.int64(49_151)):
        got, want = tcs.make_row_keys(table, rows), jcs.make_row_keys(table, rows)
        assert got.dtype == want.dtype == np.int64
        np.testing.assert_array_equal(got, want)
    keys = tcs.make_row_keys(tids, rows)
    for sets in (1, 7_281, 1 << 20):
        np.testing.assert_array_equal(tcs.row_key_sets(keys, sets),
                                      jcs.row_key_sets(keys, sets))


def test_hash_mixers_bit_equal():
    rng = np.random.default_rng(13)
    x = rng.integers(0, np.iinfo(np.int64).max, 5000).astype(np.uint64)
    x[:4] = [0, 1, np.iinfo(np.uint64).max, 1 << 63]        # wrap at the ends
    with np.errstate(over="ignore"):
        got, want = tpc._splitmix(x), jpc._splitmix(x)
    assert got.dtype == want.dtype == np.uint64
    np.testing.assert_array_equal(got, want)
    for tid in (0, 7, 3 << 14, rng.integers(0, 1 << 20, 100)):
        got, want = tpc.table_mix(tid), jpc.table_mix(tid)
        assert got.dtype == want.dtype == np.uint64
        np.testing.assert_array_equal(got, want)
