"""Port vs reference: the columnar (CSR) query plane
(``repro_torch.core.columnar`` vs ``repro.core.columnar``). Seeded request
lists and archetype traces go through both; every grouped array, chunk
span, key, hash, view and subset is bit-equal."""
import dataclasses

import numpy as np
import pytest

from repro.core import columnar as jcol
from repro.core.pooled_cache import order_invariant_hash
from repro.workloads import ARCHETYPES as JARCH
from repro.workloads import build_trace as jbuild
from repro_torch.core import columnar as tcol
from repro_torch.workloads import ARCHETYPES as TARCH
from repro_torch.workloads import build_trace as tbuild


def random_requests(seed, n=40):
    """Seeded request dicts: ragged lengths (empty segments included), table
    ids out of order, a few queries with no tables, repeated indices."""
    rng = np.random.default_rng(seed)
    reqs = []
    for _ in range(n):
        k = int(rng.integers(0, 6))
        tids = rng.choice([3, 11, 0, 7, 1 << 14, 9, 42], size=k, replace=False)
        reqs.append({int(t): rng.integers(0, 50, int(rng.integers(0, 9)))
                     for t in tids})
    return reqs


def pair(seed):
    reqs = random_requests(seed)
    copy = [{t: v.copy() for t, v in r.items()} for r in reqs]
    return (tcol.ColumnarQueries.from_requests(reqs),
            jcol.ColumnarQueries.from_requests(copy), reqs)


def assert_cq_equal(t, j):
    for name in ("values", "seg_offsets", "seg_table", "query_seg"):
        a, b = getattr(t, name), getattr(j, name)
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)


def assert_views_equal(tv, jv):
    assert len(tv) == len(jv)
    for a, b in zip(tv, jv):
        assert a.tid == b.tid
        for f in dataclasses.fields(b):
            x, y = getattr(a, f.name), getattr(b, f.name)
            if y is None:
                assert x is None, f.name
            elif isinstance(y, np.ndarray):
                assert x.dtype == y.dtype, f.name
                np.testing.assert_array_equal(x, y, err_msg=f.name)


@pytest.mark.parametrize("seed", range(4))
def test_from_requests_round_trip(seed):
    t, j, reqs = pair(seed)
    assert_cq_equal(t, j)
    assert (t.n_queries, len(t)) == (j.n_queries, len(j)) == (len(reqs), len(reqs))
    np.testing.assert_array_equal(t.nseg, j.nseg)
    fresh = tcol.ColumnarQueries(t.values, t.seg_offsets, t.seg_table, t.query_seg)
    for a, b in zip(fresh.requests(), reqs):   # rebuilt, not the originals
        assert list(a) == list(b)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
    assert fresh.build_requests(5, 9)[0].keys() == reqs[5].keys()


@pytest.mark.parametrize("seed", range(4))
def test_grouping_bit_equal(seed):
    t, j, _ = pair(seed)
    tg, jg = t.group(), j.group()
    for name in ("table_ids", "t_spans", "q_g", "tpos_g", "lens_g", "eoff_g",
                 "vals_g", "comb"):
        a, b = getattr(tg, name), getattr(jg, name)
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    for csize in (1, 3, 7, 40, 64):
        np.testing.assert_array_equal(tg.chunk_bounds(csize), jg.chunk_bounds(csize))
    np.testing.assert_array_equal(tg.keys_g(), jg.keys_g())
    assert tg.hash_g().dtype == np.uint64
    np.testing.assert_array_equal(tg.hash_g(), jg.hash_g())


def test_segment_hashes_are_the_order_invariant_hash():
    t, _, _ = pair(9)
    g = t.group()
    for s in range(len(g.lens_g)):
        tid = int(np.repeat(g.table_ids, np.diff(g.t_spans))[s])
        vals = g.vals_g[g.eoff_g[s]:g.eoff_g[s + 1]]
        assert int(g.hash_g()[s]) == order_invariant_hash(tid, vals)


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("csize", [4, 13, None])
def test_chunk_views_bit_equal(seed, csize):
    t, j, _ = pair(seed)
    n = t.n_queries
    step = csize or 9
    for qs in range(0, n, step):
        qe = min(qs + step, n)
        tc, jc = t.chunk(qs, qe, csize), j.chunk(qs, qe, csize)
        assert (tc.n_queries, tc.start, tc.csize, tc.max_segs) == \
            (jc.n_queries, jc.start, jc.csize, jc.max_segs)
        np.testing.assert_array_equal(tc.table_ids, jc.table_ids)
        for with_hashes in (False, True):
            assert_views_equal(tc.table_views(with_hashes), jc.table_views(with_hashes))
        for a, b in zip(tc.requests(), jc.requests()):
            assert list(a) == list(b)
    assert_views_equal(t.whole().table_views(True), j.whole().table_views(True))


@pytest.mark.parametrize("seed", range(3))
def test_subset_bit_equal(seed):
    t, j, _ = pair(seed)
    rng = np.random.default_rng(seed + 100)
    for idx in (rng.permutation(t.n_queries)[:17], np.arange(0),
                np.arange(t.n_queries), np.array([3, 3, 0])):
        assert_cq_equal(t.subset(idx), j.subset(idx))


def test_plan_factor_and_peek_bit_equal():
    t, j, _ = pair(5)
    for cq in (t, j):
        assert cq.chunk(0, 8, 8).plan_factor_peek(("a",)) is None
    for qs in range(0, 40, 8):
        for cq in (t, j):
            ch = cq.chunk(qs, qs + 8, 8)
            ch.plan_factor(("a",), lambda ch=ch: np.concatenate(
                [v.keys for v in ch.table_views()] or [np.zeros(0, np.int64)]))
    assert t.factor_builds == j.factor_builds == 5
    for qs in range(0, 40, 8):
        a = t.chunk(qs, qs + 8, 8).plan_factor_peek(("a",))
        b = j.chunk(qs, qs + 8, 8).plan_factor_peek(("a",))
        for k in ("uniq", "inv"):
            np.testing.assert_array_equal(a[k], b[k])
    # ad-hoc ranges and a whole-trace chunk are never factored
    for cq in (t, j):
        assert cq.chunk(3, 11, 8).plan_factor_peek(("a",)) is None
        assert cq.chunk(0, 40, 40).plan_factor(("a",), lambda: None) is None
        assert cq.chunk(0, 8, 8).plan_factor_peek(("b",)) is None
    t.chunk(0, 8, 8).plan_factor(("a",), lambda: 1 / 0)      # cached: not rebuilt
    assert t.factor_builds == 5


@pytest.mark.parametrize("name", ["zipf_steady", "diurnal", "multi_tenant"])
def test_trace_chunks_views_bit_equal(name):
    def small(spec):
        return dataclasses.replace(spec, num_queries=40, tenants=tuple(
            dataclasses.replace(t, table_bytes=3e5, num_user_tables=3,
                                num_item_tables=1) for t in spec.tenants))
    t = tbuild(small(TARCH[name]))
    j = jbuild(small(JARCH[name]))
    for tc, jc in zip(t.chunks(16), j.chunks(16)):
        assert_views_equal(tc.columnar.table_views(True), jc.columnar.table_views(True))


def test_empty_inputs():
    t = tcol.ColumnarQueries.from_requests([])
    j = jcol.ColumnarQueries.from_requests([])
    assert_cq_equal(t, j)
    assert t.n_queries == 0 and t.whole().table_views() == []
    t = tcol.ColumnarQueries.from_requests([{}, {4: np.zeros(0, np.int64)}, {}])
    j = jcol.ColumnarQueries.from_requests([{}, {4: np.zeros(0, np.int64)}, {}])
    assert_cq_equal(t, j)
    np.testing.assert_array_equal(t.group().hash_g(), j.group().hash_g())
    assert_views_equal(t.whole().table_views(True), j.whole().table_views(True))
