"""Port vs reference: the host serving plane's caches (``core/cache_sim.py``,
``core/pooled_cache.py``). The same seeded access streams go through the
reference's and the port's ``SimRowCache``, ``BatchedRowCache``,
``PerTableCaches``, ``SetAssocSimCache`` and ``PooledEmbeddingCache``; every
return value and the full state (tags, stamps, clock, counters, LRU order)
must be equal. Then the host mirror of the device cache
(``tests/test_cache.py:77``): per-access hit/miss of the port's
``TorchRowCache`` (CPU, single-key batches) equals the port's
``SetAssocSimCache`` driven at the device's set index."""
import numpy as np
import pytest
import torch

from repro.core import cache_sim as jcs
from repro.core import pooled_cache as jpc
from repro_torch.core import cache_sim as tcs
from repro_torch.core import pooled_cache as tpc
from repro_torch.core.cache import CacheGeometry, TorchRowCache, set_index


def zipf_rows(rng, n, hi, a=1.2):
    return (rng.zipf(a, n) % hi).astype(np.int64)


def assert_arrays(a, b, names):
    for n in names:
        x, y = getattr(a, n), getattr(b, n)
        assert x.dtype == y.dtype, n
        np.testing.assert_array_equal(x, y, err_msg=n)


def assert_scalars(a, b, names):
    assert [getattr(a, n) for n in names] == [getattr(b, n) for n in names]


# -- SimRowCache / PerTableCaches (exact LRU, byte budget) ---------------------


@pytest.mark.parametrize("meta", [None, 16])
@pytest.mark.parametrize("seed", [0, 1])
def test_sim_row_cache_equal(meta, seed):
    rng = np.random.default_rng(seed)
    t = tcs.SimRowCache(40_000, metadata_bytes=meta)
    j = jcs.SimRowCache(40_000, metadata_bytes=meta)
    for step in range(60):
        tid = int(rng.integers(0, 4))
        rb = int(rng.choice([64, 128, 300]))
        if step % 3:
            rows = zipf_rows(rng, 40, 500)
            assert t.access_batch(tid, rows, rb) == j.access_batch(tid, rows, rb)
        else:
            for r in zipf_rows(rng, 10, 500).tolist():
                assert t.access(tid, r, rb) == j.access(tid, r, rb)
        assert list(t.lru.items()) == list(j.lru.items())
        assert_scalars(t, j, ("used", "hits", "misses", "hit_rate"))
    t.reset_stats()
    j.reset_stats()
    assert_scalars(t, j, ("hits", "misses", "hit_rate"))


def test_per_table_caches_equal():
    rng = np.random.default_rng(4)
    weights = {0: 1.0, 1: 3.0, 2: 0.5}
    t = tcs.PerTableCaches(30_000, [0, 1, 2], weights)
    j = jcs.PerTableCaches(30_000, [0, 1, 2], weights)
    tu = tcs.PerTableCaches(30_000, [0, 1, 2])
    ju = jcs.PerTableCaches(30_000, [0, 1, 2])
    for _ in range(1500):
        tid, r = int(rng.integers(0, 3)), int(zipf_rows(rng, 1, 400)[0])
        assert t.access(tid, r, 100) == j.access(tid, r, 100)
        assert tu.access(tid, r, 100) == ju.access(tid, r, 100)
    for a, b in ((t, j), (tu, ju)):
        assert a.hit_rate == b.hit_rate
        for tid in (0, 1, 2):
            assert a.caches[tid].capacity == b.caches[tid].capacity
            assert list(a.caches[tid].lru.items()) == list(b.caches[tid].lru.items())


# -- BatchedRowCache (the serving plane's FM row cache) ------------------------

BATCHED_STATE = ("tags", "stamp")
BATCHED_SCALARS = ("clock", "hits", "misses", "filled", "evictions",
                   "num_sets", "ways", "capacity_rows", "hit_rate")


def assert_plans(a, b):
    assert (a is None) == (b is None)
    if a is None:
        return
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("capacity,meta", [(1 << 14, None), (1 << 16, None),
                                           (1 << 20, 40)])
@pytest.mark.parametrize("seed", [0, 1])
def test_batched_row_cache_equal(capacity, meta, seed):
    rng = np.random.default_rng(seed)
    t = tcs.BatchedRowCache(capacity, 96, ways=4, metadata_bytes=meta)
    j = jcs.BatchedRowCache(capacity, 96, ways=4, metadata_bytes=meta)
    plans = 0
    for step in range(40):
        tid = int(rng.integers(0, 5))
        rows = zipf_rows(rng, int(rng.integers(0, 60)), 3000)
        op = step % 4
        if op == 0:
            ht, nt = t.access_batch(tid, rows)
            hj, nj = j.access_batch(tid, rows)
            np.testing.assert_array_equal(ht, hj)
            assert nt == nj
        elif op == 1:
            np.testing.assert_array_equal(t.probe(tid, rows), j.probe(tid, rows))
            t.fill(tid, rows[::2])
            j.fill(tid, rows[::2])
        else:
            keys = np.concatenate([t.make_keys(tid, rows),
                                   t.make_keys(tid + 1, rows[:7])])
            np.testing.assert_array_equal(keys, np.concatenate(
                [j.make_keys(tid, rows), j.make_keys(tid + 1, rows[:7])]))
            pt, pj = t.batch_plan(keys), j.batch_plan(keys)
            assert_plans(pt, pj)
            if pt is not None:
                plans += 1
                used = np.arange(0, len(pt["uniq"]), 2, dtype=np.int64)
                ev = (None if op == 2 else
                      rng.permutation(len(used)).astype(np.int64))
                t.commit(pt, used, ev)
                j.commit(pj, used, ev)
        assert_arrays(t, j, BATCHED_STATE)
        assert_scalars(t, j, BATCHED_SCALARS)
    if capacity >= 1 << 20:
        assert plans > 0
    t.reset_stats()
    j.reset_stats()
    assert_scalars(t, j, BATCHED_SCALARS)


def test_batched_plan_from_unique_and_keys_equal():
    rng = np.random.default_rng(9)
    rows = zipf_rows(rng, 5000, 1 << 30)
    tids = rng.integers(0, 61, 5000)
    keys = tcs.make_row_keys(tids, rows)
    np.testing.assert_array_equal(keys, jcs.make_row_keys(tids, rows))
    for n in (1, 7, 7281, 1 << 20):
        np.testing.assert_array_equal(tcs.row_key_sets(keys, n),
                                      jcs.row_key_sets(keys, n))
    s = np.sort(tcs.row_key_sets(keys, 97))
    np.testing.assert_array_equal(tcs.rank_within_set(s), jcs.rank_within_set(s))
    t = tcs.BatchedRowCache(1 << 18, 64)
    j = jcs.BatchedRowCache(1 << 18, 64)
    uniq, inv = np.unique(keys[:800], return_inverse=True)
    assert_plans(t.plan_from_unique(uniq, inv), j.plan_from_unique(uniq, inv))


# -- SetAssocSimCache ----------------------------------------------------------


@pytest.mark.parametrize("sets,ways", [(4, 2), (16, 4), (64, 8)])
def test_set_assoc_sim_cache_equal(sets, ways):
    rng = np.random.default_rng(sets)
    t, j = tcs.SetAssocSimCache(sets, ways), jcs.SetAssocSimCache(sets, ways)
    for step in range(30):
        tid = int(rng.integers(0, 3))
        rows = zipf_rows(rng, int(rng.integers(0, 80)), 4 * sets * ways)
        if step % 2:
            np.testing.assert_array_equal(t.access_batch(tid, rows),
                                          j.access_batch(tid, rows))
        else:
            for r in rows[:10].tolist():
                assert t.access_scalar(tid, r) == j.access_scalar(tid, r)
        assert_arrays(t, j, ("tags", "stamp"))
        assert_scalars(t, j, ("clock", "hits", "misses", "hit_rate"))


def test_access_in_set_is_access_scalar_at_the_sim_hash():
    rng = np.random.default_rng(3)
    a, b = tcs.SetAssocSimCache(8, 2), tcs.SetAssocSimCache(8, 2)
    for tid, r in zip(rng.integers(0, 3, 400).tolist(),
                      zipf_rows(rng, 400, 60).tolist()):
        key = int(a._key(tid, np.array([r]))[0])
        s = int(a._sets(np.array([key]))[0])
        assert a.access_scalar(tid, r) == b.access_in_set(s, key)
    assert_arrays(a, b, ("tags", "stamp"))
    assert_scalars(a, b, ("clock", "hits", "misses"))


# -- pooled cache and its hashes -------------------------------------------------


def test_order_invariant_hashes_equal():
    rng = np.random.default_rng(11)
    lens = rng.integers(1, 40, 200)
    cat = zipf_rows(rng, int(lens.sum()), 1 << 40)
    offs = np.r_[0, np.cumsum(lens)[:-1]]
    for tid in (0, 5, 1 << 20):
        got = tpc.order_invariant_hash_batch(tid, cat, offs)
        want = jpc.order_invariant_hash_batch(tid, cat, offs)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
        for i in range(0, 200, 17):
            seg = cat[offs[i]:offs[i] + lens[i]]
            h = tpc.order_invariant_hash(tid, seg)
            assert h == jpc.order_invariant_hash(tid, seg) == int(got[i])
            assert h == tpc.order_invariant_hash(tid, seg[::-1])
    assert tpc.order_invariant_hash_batch(3, np.zeros(0, np.int64),
                                          np.zeros(0, np.int64)).shape == (0,)


@pytest.mark.parametrize("threshold", [1, 4])
def test_pooled_cache_equal(threshold):
    rng = np.random.default_rng(threshold)
    t = tpc.PooledEmbeddingCache(6_000, threshold)
    j = jpc.PooledEmbeddingCache(6_000, threshold)
    for step in range(400):
        tid = int(rng.integers(0, 3))
        idx = zipf_rows(rng, int(rng.integers(1, 9)), 30)
        vec = rng.standard_normal(int(rng.choice([4, 16]))).astype(np.float32)
        if step % 5 == 4:
            key = jpc.order_invariant_hash(tid, idx)
            rt, rj = t.lookup_hashed(key, len(idx)), j.lookup_hashed(key, len(idx))
            t.note_pending_hit(len(idx))
            j.note_pending_hit(len(idx))
            t.insert_hashed(key, vec)
            j.insert_hashed(key, vec)
        else:
            rt, rj = t.lookup(tid, idx), j.lookup(tid, idx)
            if rt is None:
                t.insert(tid, idx, vec)
                j.insert(tid, idx, vec)
        assert (rt is None) == (rj is None)
        if rt is not None:
            np.testing.assert_array_equal(rt, rj)
        assert list(t.store) == list(j.store)
        assert [c for _, c in t.store.values()] == [c for _, c in j.store.values()]
        assert_scalars(t, j, ("used", "hits", "misses", "skipped",
                              "hit_len_sum", "hit_rate", "avg_hit_len"))
    assert t.hits > 0 and t.skipped > 0


# -- the host mirror of the device cache -----------------------------------------


def mirror_run(geo: CacheGeometry, tables: np.ndarray, rows: np.ndarray,
               device="cpu"):
    """One access at a time through ``TorchRowCache`` on ``device`` (probe
    through ``lookup_device``, insert on a miss) and through
    ``SetAssocSimCache.access_in_set`` at the device's set index. Returns
    both hit sequences, the device cache's state and the host mirror."""
    dev = TorchRowCache(geo, device=device)
    state = dev.init()
    sim = tcs.SetAssocSimCache(geo.num_sets, geo.ways)
    sets = set_index(torch.from_numpy(tables), torch.from_numpy(rows),
                     geo.num_sets).tolist()
    keys = sim._key(tables, rows).tolist()
    got, want = [], []
    zero = torch.zeros((1, geo.dim), device=device)
    for t, r, s, k in zip(tables.tolist(), rows.tolist(), sets, keys):
        tt = torch.tensor([t], dtype=torch.int32, device=device)
        rr = torch.tensor([r], dtype=torch.int32, device=device)
        _, hit, _ = dev.lookup_device(state, tt, rr)
        if not bool(hit[0]):
            dev.insert(state, tt, rr, zero)
        got.append(bool(hit[0]))
        want.append(sim.access_in_set(s, k))
    return got, want, state, sim


@pytest.mark.parametrize("seed", range(8))
def test_torch_cache_matches_host_oracle(seed):
    """``tests/test_cache.py:77`` for the port: streams of (table, row)
    accesses with heavy set collisions (4 sets x 2 ways, rows < 200)."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 121))
    tables = rng.integers(0, 4, n).astype(np.int32)
    rows = rng.integers(0, 201, n).astype(np.int32)
    got, want, state, sim = mirror_run(CacheGeometry(4, 2, 2), tables, rows)
    assert got == want
    assert int(state["hits"]) == sim.hits and int(state["misses"]) == sim.misses
    np.testing.assert_array_equal(resident_keys(state), sim.tags)


def resident_keys(state) -> np.ndarray:
    """The device cache's tags as the host mirror's composite keys (-1 for
    an empty line): the same lines resident, way for way."""
    tt = state["tag_table"].cpu().numpy().astype(np.int64)
    tags = (tt << 40) | state["tag_row"].cpu().numpy().astype(np.int64)
    tags[tt < 0] = -1
    return tags
