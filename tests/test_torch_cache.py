"""Port vs reference: the HBM row cache (``repro_torch.core.cache.TorchRowCache``
vs ``repro.core.cache.JaxRowCache``). Same numpy inputs; set ids, hits,
values and the full state dict (tags, data, stamps, clock, counters) equal
after every operation."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import cache as jc
from repro_torch.core import cache as tc


def assert_state_equal(js: dict, ts: dict):
    assert set(js) == set(ts)
    for k in js:
        want = np.asarray(js[k])
        got = ts[k].numpy()
        assert got.dtype == want.dtype, k
        np.testing.assert_array_equal(got, want, err_msg=k)


class Pair:
    """The reference cache and the port's, driven in lockstep."""

    def __init__(self, num_sets, ways, dim):
        self.j = jc.JaxRowCache(jc.CacheGeometry(num_sets, ways, dim))
        self.t = tc.TorchRowCache(tc.CacheGeometry(num_sets, ways, dim),
                                  device="cpu")
        self.js, self.ts = self.j.init(), self.t.init()
        assert_state_equal(self.js, self.ts)

    def lookup(self, tables, rows):
        t, r = np.asarray(tables, np.int32), np.asarray(rows, np.int32)
        jv, jh, self.js = self.j.lookup(self.js, jnp.asarray(t), jnp.asarray(r))
        tv, th, ts = self.t.lookup(self.ts, torch.from_numpy(t), torch.from_numpy(r))
        assert ts is self.ts                          # updated in place
        np.testing.assert_array_equal(th.numpy(), np.asarray(jh))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
        assert_state_equal(self.js, self.ts)
        return th.numpy()

    def lookup_device(self, tables, rows, valid=None, use_kernel=False):
        t, r = np.asarray(tables, np.int32), np.asarray(rows, np.int32)
        jval = None if valid is None else jnp.asarray(valid)
        tval = None if valid is None else torch.from_numpy(np.asarray(valid, bool))
        jv, jh, self.js = self.j.lookup_device(
            self.js, jnp.asarray(t), jnp.asarray(r), use_kernel=use_kernel,
            valid=jval)
        tv, th, _ = self.t.lookup_device(
            self.ts, torch.from_numpy(t), torch.from_numpy(r),
            use_kernel=use_kernel, valid=tval)
        np.testing.assert_array_equal(th.numpy(), np.asarray(jh))
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=0, atol=1e-6)
        assert_state_equal(self.js, self.ts)
        return th.numpy()

    def insert(self, tables, rows, values, mask=None):
        t, r = np.asarray(tables, np.int32), np.asarray(rows, np.int32)
        v = np.asarray(values, np.float32)
        self.js = self.j.insert(self.js, jnp.asarray(t), jnp.asarray(r),
                                jnp.asarray(v),
                                mask=None if mask is None else jnp.asarray(mask))
        ts = self.t.insert(self.ts, torch.from_numpy(t), torch.from_numpy(r),
                           torch.from_numpy(v),
                           mask=None if mask is None else torch.from_numpy(
                               np.asarray(mask, bool)))
        assert ts is self.ts
        assert_state_equal(self.js, self.ts)


# ---------------------------------------------------------------------------
# set ids
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("num_sets", [1, 3, 8, 64, 13_107, 1 << 20, (1 << 31) - 1])
def test_set_index_equal(num_sets):
    rng = np.random.default_rng(num_sets)
    i32 = np.iinfo(np.int32)
    tables = np.concatenate([rng.integers(i32.min, i32.max, 500),
                             [0, 1, -1, -2, i32.max, i32.min, 7, 123_456]])
    rows = np.concatenate([rng.integers(i32.min, i32.max, 500),
                           [0, -2, -1, -2, i32.min, i32.max, 99_999, 1 << 30]])
    tables, rows = tables.astype(np.int32), rows.astype(np.int32)
    want = np.asarray(jc.set_index(jnp.asarray(tables), jnp.asarray(rows), num_sets))
    got = tc.set_index(torch.from_numpy(tables), torch.from_numpy(rows), num_sets)
    np.testing.assert_array_equal(got.numpy(), want)


def test_null_key_hashes_as_uint32():
    null = torch.tensor([tc.NULL_KEY], dtype=torch.int32)
    h = tc.set_index(null, null, 1 << 31)
    t = 0xFFFFFFFE
    x = ((t * 0x85EBCA6B) ^ (t * 0x9E3779B9)) & 0xFFFFFFFF
    assert int(h[0]) == (x ^ (x >> 16)) % (1 << 31)
    assert tc.NULL_KEY == int(jc.NULL_KEY) and tc.EMPTY == int(jc.EMPTY)


def test_dual_cache_geometry_equal():
    for budget in (1 << 12, 1 << 16, 8 << 20):
        for dim, rb in ((16, 24), (64, 72), (128, 600)):
            for ways in (2, 8):
                want = jc.dual_cache_geometry(budget, dim, rb, ways)
                got = tc.dual_cache_geometry(budget, dim, rb, ways)
                assert (got.num_sets, got.ways, got.dim, got.capacity_rows) == \
                    (want.num_sets, want.ways, want.dim, want.capacity_rows)


# ---------------------------------------------------------------------------
# the sequences of tests/test_cache.py
# ---------------------------------------------------------------------------


def test_miss_then_hit():
    p = Pair(8, 4, 8)
    assert not p.lookup([1, 1], [10, 11]).any()
    p.insert([1, 1], [10, 11], np.arange(16, dtype=np.float32).reshape(2, 8))
    assert p.lookup([1, 1], [10, 11]).all()


def test_miss_returns_zeros():
    p = Pair(8, 4, 8)
    assert not p.lookup([5], [99]).any()


def test_lru_eviction_within_set():
    p = Pair(1, 2, 4)
    for r in (1, 2, 3):
        p.insert([0], [r], np.full((1, 4), float(r)))
    assert not p.lookup([0], [1])[0]
    assert p.lookup([0], [3])[0]


def test_update_in_place_no_duplicate():
    p = Pair(4, 2, 2)
    p.insert([0], [7], np.ones((1, 2)))
    p.insert([0], [7], 2 * np.ones((1, 2)))
    assert (p.ts["tag_row"].numpy() == 7).sum() == 1
    p.lookup([0], [7])
    assert float(p.ts["data"][p.ts["tag_row"] == 7][0, 0]) == 2.0


# ---------------------------------------------------------------------------
# batched inserts: ranked ways, wrapped ranks, the last writer
# ---------------------------------------------------------------------------


def test_more_than_ways_new_keys_in_one_set_last_writer_wins():
    """Five new keys into a 1-set, 2-way cache in one batch: ranks wrap, so
    two writes land on each way; the last in order wins (rows 4 and 3)."""
    p = Pair(1, 2, 3)
    rows = np.arange(5)
    p.insert(np.zeros(5), rows, np.repeat(rows[:, None], 3, 1))
    assert sorted(p.ts["tag_row"][0].tolist()) == [3, 4]
    assert p.ts["stamp"][0].tolist() == [1, 1]
    assert p.ts["data"][0, :, 0].tolist() == p.ts["tag_row"][0].float().tolist()


def test_masked_insert_and_duplicate_keys():
    p = Pair(2, 2, 2)
    p.insert([0, 0, 0, 1, 1], [1, 1, 2, 5, 6], np.arange(10).reshape(5, 2),
             mask=[True, True, False, True, False])
    p.insert([0, 1, 2], [1, 5, 9], -np.ones((3, 2)), mask=[False, True, True])


@pytest.mark.parametrize("seed", range(6))
def test_random_stream_with_collisions(seed):
    """Random lookups/probes/inserts over a small key domain: set
    collisions, re-inserts of resident keys, duplicate keys in a batch,
    masks and valid masks, and more than W new keys per set per batch."""
    rng = np.random.default_rng(seed)
    p = Pair(4, 2, 3)
    n = 8
    for _ in range(25):
        t = rng.integers(0, 3, n)
        r = rng.integers(0, 10, n)
        op = rng.integers(0, 3)
        if op == 0:
            p.lookup(t, r)
        elif op == 1:
            p.lookup_device(t, r, valid=rng.random(n) < 0.7)
        else:
            p.insert(t, r, rng.standard_normal((n, 3)),
                     mask=rng.random(n) < 0.8)


def test_lookup_device_kernel_path_and_valid_mask():
    """The reference's Pallas probe (interpret mode) against the port's
    dispatch on CPU tensors; invalid keys never hit, stamp or count."""
    p = Pair(4, 2, 3)
    p.insert([0, 1, 2, 0], [1, 2, 3, 4], np.arange(12).reshape(4, 3))
    for use_kernel in (True, False):
        hit = p.lookup_device([0, 1, 2, 0, 0, 1], [1, 2, 3, 4, 9, 2],
                              valid=[True, True, False, True, True, False],
                              use_kernel=use_kernel)
        assert hit.tolist() == [True, True, False, True, False, False]
    p.lookup_device([0, 1, 2, 0, 0, 1], [1, 2, 3, 4, 9, 2], use_kernel=True)
