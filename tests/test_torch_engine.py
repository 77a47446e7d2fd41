"""Port vs reference: the device serving engine
(``repro_torch.runtime.engine`` vs ``repro.runtime.engine``) and the IO
accounting under it (``repro_torch.core.io_sim`` vs ``repro.core.io_sim``).
Same numpy tables and batches; per-query ``sm_ios`` and ``latency_us``
exactly equal, store totals, hit rate and the cache state equal, pooled bags
within 1e-5."""
import dataclasses

import numpy as np
import pytest
import torch

from repro.core import io_sim as jio
from repro.core.columnar import ColumnarQueries as JColumnar
from repro.core.locality import TableMeta
from repro.core.sdm import SDMConfig, SDMEmbeddingStore
from repro.runtime import engine as jeng
from repro.workloads import ARCHETYPES as JARCH
from repro.workloads import build_trace as jbuild
from repro_torch import serve_dlrm
from repro_torch.core import io_sim as tio
from repro_torch.core.columnar import ColumnarQueries as TColumnar
from repro_torch.core.quant import quantize_rows, row_bytes
from repro_torch.kernels import ops
from repro_torch.runtime import engine as teng
from repro_torch.workloads import ARCHETYPES as TARCH
from repro_torch.workloads import TraceStream, tenant_table_metas
from repro_torch.workloads import build_trace as tbuild

POOL_TOL = 1e-5


def _engines(tables, device="nand_flash", **cfg):
    j = jeng.DeviceServingEngine(tables, jio.DEVICES[device],
                                 jeng.EngineConfig(**cfg))
    t = teng.DeviceServingEngine(tables, tio.DEVICES[device],
                                 teng.EngineConfig(**cfg), torch_device="cpu")
    return j, t


def _assert_state_equal(js, ts):
    """Every state tensor equal; the port's cached rows are compared over the
    reference's ``dim`` columns, and the pad columns past it (the pitch)
    must be zero."""
    assert set(js) == set(ts)
    for k in js:
        want = np.asarray(js[k])
        got = ts[k].numpy()
        if k == "data":
            assert not got[..., want.shape[-1]:].any()
            got = got[..., :want.shape[-1]]
        assert got.dtype == want.dtype, k
        np.testing.assert_array_equal(got, want, err_msg=k)


def _serve_both(j, t, idx, bg_iops=1e4, valid=None):
    jp, js = j.serve_batch(idx, bg_iops, valid=valid)
    tp, ts = t.serve_batch(idx, bg_iops, valid=valid)
    assert [s.sm_ios for s in ts] == [s.sm_ios for s in js]
    assert [s.latency_us for s in ts] == [s.latency_us for s in js]
    assert [s.sm_time_us for s in ts] == [s.sm_time_us for s in js]
    assert tp.shape == jp.shape and tp.dtype == jp.dtype
    np.testing.assert_allclose(tp, jp, rtol=0, atol=POOL_TOL)
    np.testing.assert_allclose(tp, t.reference_pool(idx, valid), rtol=0,
                               atol=POOL_TOL)
    assert (t.stats.sm_ios, t.stats.latency_us) == (j.stats.sm_ios, j.stats.latency_us)
    assert t.hit_rate == j.hit_rate
    assert (t.io.total_ios, t.io.total_bus_bytes, t.io.total_wanted_bytes) == \
        (j.io.total_ios, j.io.total_bus_bytes, j.io.total_wanted_bytes)
    _assert_state_equal(j.state, t.state)
    return tp, ts


@pytest.mark.parametrize("use_kernels", [True, False])
def test_three_batches_match_reference(use_kernels):
    """Cold, evicting and partly warm batches through a small cache (12 sets
    x 8 ways), with duplicate keys inside each batch."""
    rng = np.random.default_rng(0)
    rows = (300, 200, 250)
    tables = {t: rng.standard_normal((r, 24)).astype(np.float32)
              for t, r in enumerate(rows)}
    j, t = _engines(tables, hbm_cache_bytes=1 << 12, use_kernels=use_kernels)
    assert t.cache.geo == t.cache.geo.__class__(12, 8, 24)
    ops.reset_launch_counts()
    hot = np.stack([rng.integers(0, 40, (8, 8)) for _ in rows], axis=1)
    for rep in range(3):
        idx = np.stack([rng.integers(0, r, (8, 8)) for r in rows], axis=1)
        idx = np.where(rng.random(idx.shape) < 0.5, hot, idx).astype(np.int32)
        _serve_both(j, t, idx, bg_iops=1e4 * (rep + 1))
    # CPU tensors take the plain versions: nothing launched
    assert ops.launch_counts() == {"gather_pool": 0, "cache_probe": 0,
                                   "flash_decode": 0, "densify": 0}
    assert 0.0 < t.hit_rate < 1.0


@pytest.mark.parametrize("dim,use_kernels", [(13, True), (13, False), (279, False)])
def test_odd_dim_matches_reference(dim, use_kernels):
    """A row width that is not a multiple of 4 (M2's 279: 287 B rows, above
    255 B, so the 40 B-metadata cache): the port stores and caches rows at
    a pitch of 16 or 280 and returns ``dim`` columns. Pooled bags within the
    tolerance, the cache's first ``dim`` columns, tags, stamps and counters,
    ``sm_ios`` and Eq. 3 latency exactly the reference's."""
    rng = np.random.default_rng(dim)
    rows = (300, 200, 250)
    tables = {t: rng.standard_normal((r, dim)).astype(np.float32)
              for t, r in enumerate(rows)}
    budget = 12 * 8 * (row_bytes(dim) + (40 if dim > 247 else 8))
    j, t = _engines(tables, hbm_cache_bytes=budget, use_kernels=use_kernels)
    assert (t.dim, t.pitch) == (dim, -(-dim // 4) * 4)
    assert t.payload.shape == (sum(rows) + 1, t.pitch) and not t.payload[:, dim:].any()
    assert t.cache.geo == t.cache.geo.__class__(12, 8, t.pitch)
    assert j.cache.geo.num_sets == 12
    hot = np.stack([rng.integers(0, 40, (6, 8)) for _ in rows], axis=1)
    for rep in range(3):
        idx = np.stack([rng.integers(0, r, (6, 8)) for r in rows], axis=1)
        idx = np.where(rng.random(idx.shape) < 0.5, hot, idx).astype(np.int32)
        valid = rng.random(idx.shape) < 0.9
        pooled, _ = _serve_both(j, t, idx, bg_iops=1e4 * (rep + 1), valid=valid)
        assert pooled.shape == (6, 3, dim)
    assert 0.0 < t.hit_rate < 1.0


@pytest.mark.parametrize("dim,pitch,gather_vec,probe_vec", [
    (164, 164, 4, 4),        # M1: the pitch is dim, the plans are unchanged
    (279, 280, 8, 4),        # M2: 1-byte and 1-float plans at dim
    (13, 16, 16, 4), (24, 24, 8, 4)])
def test_row_pitch_and_launch_plans(monkeypatch, dim, pitch, gather_vec, probe_vec):
    """The store and the cache hold rows at ``row_pitch(dim)``, and the
    kernels' launch plans follow it; at a multiple of 4 (M1's 164) the store
    is the tables' quantized rows stacked, as before the pitch."""
    from repro_torch.kernels import cache_probe as cp_module
    from repro_torch.kernels import gather_pool as gp_module
    rng = np.random.default_rng(dim)
    tables = {5: rng.standard_normal((40, dim)).astype(np.float32),
              2: rng.standard_normal((24, dim)).astype(np.float32)}
    eng = teng.DeviceServingEngine(tables, tio.DEVICES["nand_flash"],
                                   teng.EngineConfig(hbm_cache_bytes=1 << 16),
                                   torch_device="cpu")
    assert teng.row_pitch(dim) == eng.pitch == pitch
    assert eng.payload.shape[1] == eng.state["data"].shape[2] == eng.cache.geo.dim == pitch
    assert eng.row_bytes == dim + 8
    qs = [quantize_rows(torch.as_tensor(tables[t])) for t in (5, 2)]
    assert torch.equal(eng.payload[:-1, :dim], torch.cat([q["payload"] for q in qs]))
    assert torch.equal(eng.scale[:-1], torch.cat([q["scale"] for q in qs]))
    assert not eng.payload[-1].any() and eng.scale[-1] == 0 and eng.bias[-1] == 0
    # quantized block by block of rows: the same store as whole tables
    monkeypatch.setattr(teng, "QUANT_BLOCK_ROWS", 7)
    blocked = teng.DeviceServingEngine(tables, tio.DEVICES["nand_flash"],
                                       teng.EngineConfig(hbm_cache_bytes=1 << 16),
                                       torch_device="cpu")
    for a, b in ((blocked.payload, eng.payload), (blocked.scale, eng.scale),
                 (blocked.bias, eng.bias)):
        assert torch.equal(a, b)
    plan = gp_module.launch_plan(eng.payload.shape[1], 1, 0, 32 * 450, 64)
    assert plan.vec == gather_vec
    assert cp_module.launch_plan(8, eng.state["data"].shape[2], 1 << 20).vec == probe_vec
    if pitch != dim:        # what an unpadded store and cache would run
        assert gp_module.launch_plan(dim, 1, 0, 32 * 450, 64).vec == 1
        assert cp_module.launch_plan(8, dim, 1 << 20).vec == 1


def test_valid_mask_with_out_of_range_garbage():
    """Padded positions may hold anything: the reference clamps them, the
    port must neither raise nor differ."""
    rng = np.random.default_rng(9)
    tables = {3: rng.standard_normal((32, 8)).astype(np.float32),
              5: rng.standard_normal((48, 8)).astype(np.float32)}
    j, t = _engines(tables, use_kernels=True)
    for rep in range(3):
        idx = np.stack([rng.integers(0, 32, (4, 8)), rng.integers(0, 48, (4, 8))],
                       axis=1).astype(np.int32)
        valid = rng.random(idx.shape) < 0.6
        garbage = rng.choice([-7, -1, 48, 10**6, np.iinfo(np.int32).max],
                             idx.shape)
        idx = np.where(valid, idx, garbage).astype(np.int32)
        _serve_both(j, t, idx, valid=valid)
    assert int(t.state["hits"]) + int(t.state["misses"]) == \
        int(j.state["hits"]) + int(j.state["misses"])


def test_duplicate_misses_cost_one_io():
    rng = np.random.default_rng(5)
    tables = {0: rng.standard_normal((64, 8)).astype(np.float32)}
    j, t = _engines(tables, hbm_cache_bytes=1 << 20, use_kernels=False)
    idx = np.array([[[7, 7, 7, 7]], [[7, 3, 3, 5]]], np.int32)
    _, stats = _serve_both(j, t, idx)
    assert [s.sm_ios for s in stats] == [1, 2] and t.io.total_ios == 3
    _, warm = _serve_both(j, t, idx)
    assert sum(s.sm_ios for s in warm) == 0


def test_degenerate_batches():
    rng = np.random.default_rng(8)
    j, t = _engines({0: rng.standard_normal((16, 4)).astype(np.float32)},
                    use_kernels=False)
    assert t.hit_rate == 0.0
    pooled, stats = t.serve_batch(np.zeros((0, 1, 4), np.int32))
    assert pooled.shape == (0, 1, 4) and pooled.dtype == np.float32
    assert stats == [] and t.stats.sm_ios == 0
    j.serve_batch(np.zeros((0, 1, 4), np.int32))
    _serve_both(j, t, np.zeros((2, 1, 1), np.int32))              # P = 1
    _serve_both(j, t, np.array([[[3]], [[3]], [[15]]], np.int32))


def test_rejects_mismatched_dims_and_bad_indices():
    rng = np.random.default_rng(2)
    with pytest.raises(ValueError):
        teng.DeviceServingEngine({0: rng.standard_normal((8, 4)),
                                  1: rng.standard_normal((8, 6))},
                                 tio.DEVICES["nand_flash"], torch_device="cpu")
    with pytest.raises(ValueError):
        teng.DeviceServingEngine({}, tio.DEVICES["nand_flash"], torch_device="cpu")
    eng = teng.DeviceServingEngine(
        {0: rng.standard_normal((8, 4)).astype(np.float32)},
        tio.DEVICES["nand_flash"], torch_device="cpu")
    for bad in (np.full((1, 1, 2), 9), np.full((1, 1, 2), -1),   # rows of 8
                np.zeros((1, 2, 2)), np.zeros((1, 2))):          # T, ndim
        with pytest.raises(ValueError):
            eng.serve_batch(bad.astype(np.int32))
    # an invalid position is not range-checked
    eng.serve_batch(np.array([[[9, 1]]], np.int32),
                    valid=np.array([[[False, True]]]))


def test_default_config_not_shared_between_engines():
    rng = np.random.default_rng(3)
    tables = {0: rng.standard_normal((16, 4)).astype(np.float32)}
    a = teng.DeviceServingEngine(tables, tio.DEVICES["nand_flash"], torch_device="cpu")
    b = teng.DeviceServingEngine(tables, tio.DEVICES["nand_flash"], torch_device="cpu")
    assert a.cfg is not b.cfg
    a.cfg.item_time_us = 999.0
    assert b.cfg.item_time_us != 999.0


def test_default_torch_device_raises_without_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    tables = {0: np.zeros((4, 4), np.float32)}
    with pytest.raises(RuntimeError, match="CUDA"):
        teng.DeviceServingEngine(tables, tio.DEVICES["nand_flash"])


def test_engine_matches_host_store_accounting():
    """As ``tests/test_engine.py``: per-query ``sm_ios`` and ``latency_us``
    equal to the reference host store on an identical stream."""
    rng = np.random.default_rng(7)
    rows = [200, 150, 300]
    tables = {t: rng.standard_normal((r, 16)).astype(np.float32)
              for t, r in enumerate(rows)}
    eng = teng.DeviceServingEngine(
        tables, tio.DEVICES["nand_flash"],
        teng.EngineConfig(hbm_cache_bytes=8 << 20, num_devices=2),
        torch_device="cpu")
    metas = [TableMeta(table_id=t, num_rows=r, dim_bytes=eng.row_bytes,
                       pooling_factor=4, zipf_alpha=1.05, kind="user")
             for t, r in enumerate(rows)]
    store = SDMEmbeddingStore(metas, jio.DEVICES["nand_flash"],
                              SDMConfig(fm_cache_bytes=8 << 20, num_devices=2,
                                        item_time_us=eng.cfg.item_time_us))
    for rep in range(3):
        idx = np.stack([rng.integers(0, r, (8, 4)) for r in rows],
                       axis=1).astype(np.int32)
        _, stats = eng.serve_batch(idx, bg_iops=1e5)
        host = [store.serve_query({t: idx[b, t] for t in range(3)}, bg_iops=1e5)
                for b in range(8)]
        assert [s.sm_ios for s in stats] == [q.sm_ios for q in host], rep
        assert [s.latency_us for s in stats] == [q.latency_us for q in host], rep
    assert eng.stats.sm_ios == store.stats.sm_ios
    assert eng.stats.latency_us == store.stats.latency_us


# ---------------------------------------------------------------------------
# the fill over the call's unique misses alone
# ---------------------------------------------------------------------------


def all_slot_fill(cache, state, store, tables, rows, store_rows, io_mask, dim):
    """The fill as it ran over every slot of the block: each slot's row
    dequantized, then one insert masked to the unique misses. A slot outside
    the mask is never inserted; where its row lies past the store (a foreign
    key of the sharded table layout) it reads the store's last row, the
    zero sentinel."""
    last = store[0].shape[0] - 1
    deq = teng.fill_rows(store, store_rows.clamp(max=last), dim)
    cache.insert(state, tables, rows, deq, mask=io_mask)
    return int(io_mask.sum())


def spy_fill_rows(monkeypatch):
    """Record the rows each ``fill_rows`` call dequantizes."""
    seen, fill_rows = [], teng.fill_rows

    def spy(store, rows, dim):
        seen.append(rows.shape[0])
        return fill_rows(store, rows, dim)

    monkeypatch.setattr(teng, "fill_rows", spy)
    return seen


def _fill_calls(rng, rows):
    """(idx, valid) blocks of a call sequence into a 3-set, 4-way cache:
    a cold call of repeated keys from a small domain (more new keys in a
    set than ways), a partly warm one with a valid mask, one key twice, and
    the same again, which all hits."""
    B, P = 4, 8
    small = np.stack([rng.integers(0, 30, (B, P)) for _ in rows], axis=1)
    mixed = np.stack([rng.integers(0, r, (B, P)) for r in rows], axis=1)
    mixed = np.where(rng.random(mixed.shape) < 0.5, small, mixed)
    one = np.zeros((B, len(rows), P), np.int64)
    one_valid = np.zeros(one.shape, bool)
    one[:, 0, :2] = 7
    one_valid[:2, 0, :2] = True
    return [(small, np.ones(small.shape, bool)),
            (mixed, rng.random(mixed.shape) < 0.8),
            (one, one_valid), (one, one_valid)]


@pytest.mark.parametrize("dim", [24, 279])
def test_fill_over_unique_misses_equals_all_slot_fill(monkeypatch, dim):
    """The fill of the call's unique misses alone leaves the cache state of
    the fill over every slot bit for bit (tags, data, stamps, clock, hits,
    misses) after each call, and serves the same; ``fill_rows`` is handed K
    rows, the call's summed miss counts, not B*T*P. The all-hit call fills
    nothing and still advances the clock. At 279 the pad column of every
    cached row is zero. The reference engine, served the same calls, holds
    the same state after each."""
    rng = np.random.default_rng(dim)
    rows = (300, 200, 250)
    tables = {t: rng.standard_normal((r, dim)).astype(np.float32)
              for t, r in enumerate(rows)}
    calls = _fill_calls(rng, rows)
    budget = 3 * 4 * (row_bytes(dim) + (40 if row_bytes(dim) > 255 else 8))
    cfg = teng.EngineConfig(hbm_cache_bytes=budget, ways=4, use_kernels=False)

    def run():
        eng = teng.DeviceServingEngine(tables, tio.DEVICES["nand_flash"], cfg,
                                       torch_device="cpu")
        assert (eng.cache.geo.num_sets, eng.cache.geo.ways) == (3, 4)
        out = []
        for idx, valid in calls:
            pooled, stats = eng.serve_batch(idx.astype(np.int32), 1e4, valid)
            out.append((pooled, [(s.sm_ios, s.sm_time_us) for s in stats],
                        {k: v.clone() for k, v in eng.state.items()}))
        return out

    with monkeypatch.context() as m:
        m.setattr(teng, "fill_misses", all_slot_fill)
        old_seen = spy_fill_rows(m)
        want = run()
    seen = spy_fill_rows(monkeypatch)
    got = run()
    slots = calls[0][0].size
    assert old_seen == [slots] * len(calls)
    assert seen == [sum(i for i, _ in q) for _, q, _ in got]
    # more unique misses than the cache holds: some set took more new keys
    # than ways in one call, so ranks wrapped
    assert 3 * 4 < seen[0] < slots
    assert seen[1] > 0 and seen[2] == 1 and seen[3] == 0
    for (pg, qg, sg), (pw, qw, sw) in zip(got, want):
        np.testing.assert_array_equal(pg, pw)
        assert qg == qw
        for k in sw:
            assert sg[k].dtype == sw[k].dtype and torch.equal(sg[k], sw[k]), k
        assert not sg["data"][..., dim:].any()
    # the all-hit call: its probe and its empty fill each tick the clock
    assert int(got[3][2]["clock"]) == int(got[2][2]["clock"]) + 2
    assert int(got[3][2]["hits"]) == int(got[2][2]["hits"]) + 4
    # the reference engine served the same calls: the same state after each
    j = jeng.DeviceServingEngine(tables, jio.DEVICES["nand_flash"],
                                 jeng.EngineConfig(hbm_cache_bytes=budget, ways=4,
                                                   use_kernels=False))
    for (idx, valid), (pg, qg, sg) in zip(calls, got):
        jp, js = j.serve_batch(idx.astype(np.int32), 1e4, valid=valid)
        assert [(s.sm_ios, s.sm_time_us) for s in js] == qg
        np.testing.assert_allclose(pg, jp, rtol=0, atol=POOL_TOL)
        _assert_state_equal(j.state, sg)


# ---------------------------------------------------------------------------
# IOEngine (analytic mode): bit-equal to the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("device", sorted(tio.DEVICES))
@pytest.mark.parametrize("small_granularity", [True, False])
def test_io_engine_bit_equal(device, small_granularity):
    assert tio.DEVICES[device] == tio.DeviceModel(
        **{f: getattr(jio.DEVICES[device], f)
           for f in tio.DeviceModel.__dataclass_fields__})
    rng = np.random.default_rng(len(device))
    kw = dict(max_outstanding_per_table=200, small_granularity=small_granularity)
    j = jio.IOEngine(jio.DEVICES[device], 3, jio.IOQueueConfig(**kw))
    t = tio.IOEngine(tio.DEVICES[device], 3, tio.IOQueueConfig(**kw))
    for bg in (0.0, 1e4, 3e5, 5e7):
        n = rng.integers(0, 3000, 17)
        n[::4] = 0
        rb = rng.integers(10, 700, 17)
        for name, args in (("submit_batch", (n, 72, bg)),
                           ("submit_batch_multi", (n, rb, bg))):
            lj, bj = getattr(j, name)(*args)
            lt, bt = getattr(t, name)(*args)
            np.testing.assert_array_equal(lt, lj)
            np.testing.assert_array_equal(bt, bj)
        for k in (0, 1, 33, 2999):
            assert t.submit(k, 40, bg) == j.submit(k, 40, bg)
        assert t.submit_batch(np.zeros(3, np.int64), 72, bg)[0].tolist() == [0.0] * 3
    assert (t.total_ios, t.total_bus_bytes, t.total_wanted_bytes, t.bus_overhead) == \
        (j.total_ios, j.total_bus_bytes, j.total_wanted_bytes, j.bus_overhead)


# ---------------------------------------------------------------------------
# the columnar entry: dense_from_chunk and serve_columnar
# ---------------------------------------------------------------------------


def _small_spec(archetypes, name, queries):
    """The small-trace cut of ``tests/test_sharded_engine.py``: 3 user tables
    and 1 item table per tenant, 3e5 bytes of inventory."""
    spec = archetypes[name]
    return dataclasses.replace(
        spec, num_queries=queries,
        tenants=tuple(dataclasses.replace(
            t, table_bytes=3e5, num_user_tables=3, num_item_tables=1)
            for t in spec.tenants))


def _trace_pair(name, queries):
    """(port trace, reference trace, numpy tables of D 16 per user table)."""
    tt = tbuild(_small_spec(TARCH, name, queries))
    jt = jbuild(_small_spec(JARCH, name, queries))
    rng = np.random.default_rng(2)
    tables = {m.table_id: rng.standard_normal((m.num_rows, 16)).astype(np.float32)
              for m in jt.all_metas() if m.kind == "user"}
    return tt, jt, tables


@pytest.mark.parametrize("name", ["zipf_steady", "diurnal", "multi_tenant"])
def test_dense_from_chunk_matches_reference(name):
    tt, jt, tables = _trace_pair(name, 40)
    slots = {t: i for i, t in enumerate(tables)}
    Ps = set()
    for tc, jc in zip(tt.chunks(16), jt.chunks(16)):
        idx, valid = teng.dense_from_chunk(tc.columnar, slots, len(slots))
        jidx, jvalid = jeng.dense_from_chunk(jc.columnar, slots, len(slots))
        assert idx.shape == jidx.shape and idx.dtype == jidx.dtype == np.int32
        assert valid.dtype == jvalid.dtype == np.bool_
        np.testing.assert_array_equal(idx, jidx)
        np.testing.assert_array_equal(valid, jvalid)
        assert not idx[~valid].any()               # padded slots hold row 0
        Ps.add(idx.shape[2])
    # pooling 42 on average gives P 64; a lognormal pooling mix gives 128
    assert Ps == ({64} if name == "zipf_steady" else {128})


def _fixed_pool_requests(rng, queries, tids, pool, rows=50):
    """Every query touches every table of ``tids`` (in that order) with the
    table's own fixed pooling ``pool[i]``, rows below ``rows``."""
    return [{int(t): rng.integers(0, rows, int(pool[i]))
             for i, t in enumerate(tids)} for _ in range(queries)]


def _ragged_requests(rng, queries, tids, max_len):
    """Each query touches a random subset of ``tids`` in random order, with
    bags of 0 to ``max_len`` keys."""
    out = []
    for _ in range(queries):
        pick = rng.permutation(tids)[:int(rng.integers(1, len(tids) + 1))]
        out.append({int(t): rng.integers(0, 1000, int(rng.integers(0, max_len + 1)))
                    for t in pick})
    return out


def _densify_case(case):
    """(requests, [(qs, qe, csize)] chunks to densify, table_slot, the P
    every chunk must pad to, or None where it follows the drawn bags)."""
    rng = np.random.default_rng(31)
    if case == "m1_shape":
        # the paper's M1: 61 tables, a fixed pooling a table, 32 queries
        tids = np.arange(61) * 3 + 7
        pool = rng.integers(1, 65, 61)
        pool[5] = 64
        reqs = _fixed_pool_requests(rng, 32, tids, pool)
        return reqs, [(0, 32, 32)], {int(t): i for i, t in enumerate(tids)}, 64
    tids = np.array([2, 9, 4, 11, 30])
    slots = {int(t): i for i, t in enumerate(tids)}
    if case == "strided":
        reqs = _ragged_requests(rng, 100, tids, 20)
        return reqs, [(q, min(q + 16, 100), 16) for q in range(0, 100, 16)], slots, None
    if case == "adhoc":
        reqs = _ragged_requests(rng, 60, tids, 20)
        return reqs, [(7, 29, None), (0, 60, None), (59, 60, None)], slots, None
    if case == "ragged_empty":
        reqs = _ragged_requests(rng, 24, tids, 5)
        reqs[3] = {9: np.zeros(0, np.int64), 30: np.array([4, 4, 1])}
        reqs[4] = {11: np.zeros(0, np.int64)}
        return reqs, [(0, 8, 8), (8, 16, 8), (16, 24, 8)], slots, None
    if case in ("pow2", "pow2_plus_one"):
        top = 64 if case == "pow2" else 65
        reqs = _fixed_pool_requests(rng, 6, tids, [3, top, 17, 1, 40])
        return reqs, [(0, 6, None)], slots, 64 if case == "pow2" else 128
    if case == "all_empty":
        reqs = [{2: np.zeros(0, np.int64)}, {4: np.zeros(0, np.int64), 9: np.zeros(0, np.int64)}]
        return reqs, [(0, 2, None)], slots, 1
    if case == "slots_out_of_order":
        reqs = _ragged_requests(rng, 20, tids, 12)
        # slots not in table-id order, and tables no query touches
        ids = [30, 500, 4, 2, 77, 11, 9]
        return (reqs, [(0, 10, 10), (10, 20, 10)],
                {t: s for t, s in zip(ids, [6, 0, 3, 5, 1, 2, 4])}, None)
    raise ValueError(case)


DENSIFY_CASES = ["m1_shape", "strided", "adhoc", "ragged_empty", "pow2",
                 "pow2_plus_one", "all_empty", "slots_out_of_order"]


@pytest.mark.parametrize("case", DENSIFY_CASES)
def test_dense_from_chunk_cases_match_reference(case):
    """The vectorized pass equals the reference's per-table loop bit for
    bit: block shape and dtype, every index and the valid mask."""
    reqs, ranges, slots, want_p = _densify_case(case)
    tq, jq = TColumnar.from_requests(reqs), JColumnar.from_requests(reqs)
    T = max(slots.values()) + 1
    for qs, qe, csize in ranges:
        idx, valid = teng.dense_from_chunk(tq.chunk(qs, qe, csize), slots, T)
        jidx, jvalid = jeng.dense_from_chunk(jq.chunk(qs, qe, csize), slots, T)
        longest = max([len(v) for r in reqs[qs:qe] for v in r.values()] + [1])
        P = 1 << (longest - 1).bit_length()
        assert want_p in (None, P)
        assert idx.shape == jidx.shape == (qe - qs, T, P)
        assert idx.dtype == jidx.dtype == np.int32
        assert valid.dtype == jvalid.dtype == np.bool_
        np.testing.assert_array_equal(idx, jidx)
        np.testing.assert_array_equal(valid, jvalid)
        assert not idx[~valid].any()               # padded slots hold row 0
        keys = sum(len(v) for r in reqs[qs:qe] for v in r.values())
        assert int(valid.sum()) == keys


@pytest.mark.parametrize("missing", ["touched", "empty_bag", "other_chunk"])
def test_dense_from_chunk_missing_table(missing):
    """A table id of the chunk that ``table_slot`` lacks raises ``KeyError``
    in both packages, also where its bags are empty; one only another chunk
    of the trace touches does not."""
    reqs = [{1: np.array([3, 4]), 2: np.array([5])},
            {2: np.array([6, 7, 8])},
            {8: np.array([1])}]
    if missing == "empty_bag":
        reqs[1][5] = np.zeros(0, np.int64)
    slots = {1: 0, 2: 1}
    tq, jq = TColumnar.from_requests(reqs), JColumnar.from_requests(reqs)
    if missing == "other_chunk":
        idx, valid = teng.dense_from_chunk(tq.chunk(0, 2, 2), slots, 2)
        jidx, jvalid = jeng.dense_from_chunk(jq.chunk(0, 2, 2), slots, 2)
        np.testing.assert_array_equal(idx, jidx)
        np.testing.assert_array_equal(valid, jvalid)
        return
    want = 8 if missing == "touched" else 5
    for eng, q in ((teng, tq), (jeng, jq)):
        with pytest.raises(KeyError) as e:
            eng.dense_from_chunk(q.whole(), slots, 2)
        assert e.value.args == (want,)


def test_dense_from_chunk_slot_out_of_range():
    """A slot at or past ``num_tables`` raises ``IndexError`` in both
    packages, never a key written into another query's rows."""
    reqs = [{1: np.array([3]), 2: np.array([5, 6])}, {1: np.array([4])}]
    for eng, cq in ((teng, TColumnar), (jeng, JColumnar)):
        with pytest.raises(IndexError):
            eng.dense_from_chunk(cq.from_requests(reqs).whole(), {1: 0, 2: 2}, 2)


def _plain_block(chunk, slots, T):
    """The block the engine builds on its device, by the plain version of
    ``ops.csr_densify`` from ``block_inputs``: (idx, valid, bad) [B, T, P]."""
    seg = teng.chunk_segments(chunk, slots, T)
    values, meta = teng.block_inputs(seg, T)
    assert values.dtype == np.int64
    B, P = seg.n_queries, seg.P
    m = torch.from_numpy(meta)
    rows = torch.arange(T, dtype=torch.int64) * 7 + 1000     # any limits above the keys
    idx, valid, bad = ops.csr_densify(torch.from_numpy(values), m[:B * T], m[B * T:],
                                      rows, P, use_kernel=False)
    return idx.view(B, T, P).numpy(), valid.view(B, T, P).numpy(), int(bad)


@pytest.mark.parametrize("dtype", [np.int64, np.int32])
@pytest.mark.parametrize("case", DENSIFY_CASES)
def test_plain_densify_equals_dense_from_chunk(case, dtype):
    """The card's block, by the kernel's plain version from the CSR arrays
    the engine copies in, equals ``dense_from_chunk`` bit for bit: ragged
    bags, empty bags, tables a query lacks, slots out of table-id order, a
    trace's keys int64 or int32 (``block_inputs`` widens them to the
    kernel's one width)."""
    reqs, ranges, slots, _ = _densify_case(case)
    tq = TColumnar.from_requests(reqs)
    tq = TColumnar(tq.values.astype(dtype), tq.seg_offsets, tq.seg_table, tq.query_seg)
    T = max(slots.values()) + 1
    for qs, qe, csize in ranges:
        ch = tq.chunk(qs, qe, csize)
        idx, valid = teng.dense_from_chunk(ch, slots, T)
        pidx, pvalid, bad = _plain_block(ch, slots, T)
        assert pidx.dtype == np.int32 and pvalid.dtype == np.bool_ and bad == 0
        np.testing.assert_array_equal(pidx, idx)
        np.testing.assert_array_equal(pvalid, valid)


@pytest.mark.parametrize("P", [1, 2, 4, 8, 16, 32, 64])
def test_plain_densify_at_each_width(P):
    """Bags whose longest is P (and one shorter by one, where P > 1) over 5
    tables, some missing and some empty: the block is P wide and equal to
    ``dense_from_chunk``'s."""
    rng = np.random.default_rng(P)
    tids = [2, 9, 4, 11, 30]
    reqs = _ragged_requests(rng, 9, tids, P)
    reqs[0] = {9: rng.integers(0, 1000, P), 4: np.zeros(0, np.int64)}
    reqs[1] = {30: rng.integers(0, 1000, max(P - 1, 0))}
    slots = {t: i for i, t in enumerate(tids)}
    ch = TColumnar.from_requests(reqs).whole()
    idx, valid = teng.dense_from_chunk(ch, slots, 5)
    pidx, pvalid, bad = _plain_block(ch, slots, 5)
    assert idx.shape == (9, 5, P) and bad == 0
    np.testing.assert_array_equal(pidx, idx)
    np.testing.assert_array_equal(pvalid, valid)


def _twin_engines(tables, sharded, use_kernels=False):
    """Two CPU engines of one kind: the single engine, or a 2-shard row
    layout."""
    cfg = teng.EngineConfig(hbm_cache_bytes=1 << 12, ways=4, use_kernels=use_kernels)
    if sharded:
        from repro_torch.launch import make_embed_mesh
        from repro_torch.runtime.sharded_engine import ShardedServingEngine
        return [ShardedServingEngine(tables, tio.DEVICES["nand_flash"], cfg,
                                     mesh=make_embed_mesh(2, "cpu")) for _ in range(2)]
    return [teng.DeviceServingEngine(tables, tio.DEVICES["nand_flash"], cfg,
                                     torch_device="cpu") for _ in range(2)]


def _states_of(eng):
    return eng.state if isinstance(eng.state, list) else [eng.state]


def _clone_states(eng):
    return [{k: v.clone() for k, v in st.items()} for st in _states_of(eng)]


def _assert_states_same(a, b):
    for sa, sb in zip(a, b, strict=True):
        assert sa.keys() == sb.keys()
        for k in sa:
            assert torch.equal(sa[k], sb[k]), k


ENGINE_KINDS = pytest.mark.parametrize("sharded", [False, True], ids=["single", "sharded2"])


@ENGINE_KINDS
@pytest.mark.parametrize("use_kernels", [True, False])
def test_serve_columnar_equals_serve_batch_of_dense_block(sharded, use_kernels):
    """``serve_columnar`` (the block built from the CSR arrays on the
    engine's device) and ``serve_batch`` of ``dense_from_chunk``'s block on a
    twin engine serve the same: pooled output, ``sm_ios`` and
    ``sm_time_us`` equal, and every cache-state tensor after every chunk."""
    tt, _, tables = _trace_pair("zipf_steady", 48)
    a, b = _twin_engines(tables, sharded, use_kernels)
    for tc in tt.chunks(16):
        pa, ta, ia = a.serve_columnar(tc.columnar, bg_iops=5e4)
        idx, valid = teng.dense_from_chunk(tc.columnar, b.table_slot, len(tables))
        pb, stats = b.serve_batch(idx, 5e4, valid=valid)
        np.testing.assert_array_equal(pa, pb)
        assert ia.tolist() == [s.sm_ios for s in stats]
        assert ta.tolist() == [s.sm_time_us for s in stats]
        _assert_states_same(_states_of(a), _states_of(b))
    assert a.stats == b.stats and 0.0 < a.hit_rate < 1.0


@ENGINE_KINDS
@pytest.mark.parametrize("bad", ["negative", "at_rows", "past_rows", "past_2_31"])
def test_serve_columnar_bad_key_raises_before_any_state_change(sharded, bad):
    """A key outside its table raises ``ValueError`` from the count the
    block's build keeps, before the step: every cache-state tensor (the
    clock included) and the store totals are as they were. An int64 key
    past 2**31 is caught as an int64: narrowed, 2**32 + 3 would be row
    3, in range."""
    rng = np.random.default_rng(11)
    tables = {3: rng.standard_normal((32, 8)).astype(np.float32),
              5: rng.standard_normal((48, 8)).astype(np.float32)}
    eng, _ = _twin_engines(tables, sharded)
    good = [{3: np.array([1, 2, 3]), 5: np.array([4, 7])}, {5: np.array([9])}]
    eng.serve_columnar(TColumnar.from_requests(good).whole())
    key = {"negative": -1, "at_rows": 48, "past_rows": 1000,
           "past_2_31": 2 ** 32 + 3}[bad]
    reqs = [{3: np.array([1, 2]), 5: np.array([4, key], np.int64)}, {3: np.array([0])}]
    before, stats = _clone_states(eng), dataclasses.replace(eng.stats)
    with pytest.raises(ValueError, match="row index out of range"):
        eng.serve_columnar(TColumnar.from_requests(reqs).whole())
    _assert_states_same(before, _states_of(eng))
    assert eng.stats == stats
    eng.serve_columnar(TColumnar.from_requests(good).whole())   # still serves


@ENGINE_KINDS
def test_serve_columnar_missing_table_and_bad_slot(sharded):
    """Through ``serve_columnar`` on both engines: a table id the engine
    lacks raises ``KeyError`` with that id, a slot past its tables
    ``IndexError``; neither touches the cache."""
    rng = np.random.default_rng(12)
    tables = {1: rng.standard_normal((16, 8)).astype(np.float32),
              2: rng.standard_normal((16, 8)).astype(np.float32)}
    eng, _ = _twin_engines(tables, sharded)
    before = _clone_states(eng)
    reqs = [{1: np.array([3, 4]), 2: np.array([5])}, {8: np.array([1])}]
    with pytest.raises(KeyError) as e:
        eng.serve_columnar(TColumnar.from_requests(reqs).whole())
    assert e.value.args == (8,)
    eng.table_slot = {1: 0, 2: 2}
    with pytest.raises(IndexError):
        eng.serve_columnar(TColumnar.from_requests(reqs[:1]).whole())
    _assert_states_same(before, _states_of(eng))


def test_densify_reads_no_table_views(monkeypatch):
    """``dense_from_chunk`` and ``serve_columnar`` read the CSR arrays only:
    with ``ColumnarChunk.table_views`` made to raise, both return what they
    return without the patch."""
    from repro_torch.core.columnar import ColumnarChunk
    tt, _, tables = _trace_pair("zipf_steady", 24)
    chunks = [tc.columnar for tc in tt.chunks(8)]
    cfg = teng.EngineConfig(hbm_cache_bytes=1 << 14, use_kernels=False)

    def run():
        eng = teng.DeviceServingEngine(tables, tio.DEVICES["optane_ssd"], cfg,
                                       torch_device="cpu")
        blocks = [teng.dense_from_chunk(c, eng.table_slot, len(tables))
                  for c in chunks]
        served = [eng.serve_columnar(c, bg_iops=5e4) for c in chunks]
        return blocks, served

    want_blocks, want_served = run()

    def refuse(self, with_hashes=False):
        raise AssertionError("densify read the table views")

    monkeypatch.setattr(ColumnarChunk, "table_views", refuse)
    got_blocks, got_served = run()
    for (i, v), (wi, wv) in zip(got_blocks, want_blocks):
        np.testing.assert_array_equal(i, wi)
        np.testing.assert_array_equal(v, wv)
    for got, want in zip(got_served, want_served):
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)


def test_valid_mask_and_columnar_entry():
    """As ``tests/test_engine.py``: padded positions pool nothing, cost no IO
    and never perturb the cache; ``serve_columnar`` round-trips through
    ``dense_from_chunk`` with the same accounting as ``serve_batch``."""
    rng = np.random.default_rng(9)
    tables = {3: rng.standard_normal((32, 8)).astype(np.float32),
              5: rng.standard_normal((48, 8)).astype(np.float32)}
    j, eng = _engines(tables, use_kernels=False)
    reqs = [{3: np.array([1, 2, 3]), 5: np.array([4])},
            {5: np.array([4, 7, 7, 9, 11])}]       # ragged + a repeat
    chunk = TColumnar.from_requests(reqs).whole()
    idx, valid = teng.dense_from_chunk(chunk, eng.table_slot, 2)
    assert idx.shape[2] == 8                       # P=5 padded to pow2
    assert valid.sum() == 9
    pooled, tm, ios = eng.serve_columnar(chunk)
    np.testing.assert_allclose(pooled, eng.reference_pool(idx, valid), atol=1e-5)
    assert ios.tolist() == [4, 3]                  # 7 deduped; 4 re-hits
    assert int(eng.state["hits"]) + int(eng.state["misses"]) == 9
    jp, jtm, jios = j.serve_columnar(JColumnar.from_requests(reqs).whole())
    np.testing.assert_allclose(pooled, jp, rtol=0, atol=POOL_TOL)
    assert tm.tolist() == jtm.tolist() and ios.tolist() == jios.tolist()
    _assert_state_equal(j.state, eng.state)
    # empty chunk
    empty = TColumnar.from_requests([]).whole()
    pooled, tm, ios = eng.serve_columnar(empty)
    assert pooled.shape == (0, 2, 8) and len(tm) == 0 and len(ios) == 0
    assert (pooled.dtype, tm.dtype, ios.dtype) == (np.float32, np.float64, np.int64)


# Bags of 42-128 rows sum to tens, where float32 differs in summation order
# by more than 1e-5: the reference's own tolerance for serve_columnar on these
# traces (tests/test_sharded_engine.py:198).
COLUMNAR_POOL_TOL = dict(rtol=1e-5, atol=1e-5)

# The reference's Pallas kernels run in interpret mode on the CPU at about 3
# ms a grid step (one probe, or one pooled row), so the kernel cases serve a
# few queries in two chunks; the plain cases serve the sharded test's 48
# queries in chunks of 24.
COLUMNAR_CASES = [("zipf_steady", True, 8, 4), ("bursty", True, 8, 4),
                  ("multi_tenant", True, 4, 2),
                  ("zipf_steady", False, 48, 24), ("bursty", False, 48, 24),
                  ("multi_tenant", False, 48, 24),
                  ("diurnal", False, 48, 24), ("zipf_drift", False, 48, 24)]


@pytest.mark.parametrize("name,use_kernels,queries,chunk", COLUMNAR_CASES)
def test_serve_columnar_matches_reference(name, use_kernels, queries, chunk):
    tt, jt, tables = _trace_pair(name, queries)
    cfg = dict(hbm_cache_bytes=1 << 14, use_kernels=use_kernels)
    j = jeng.DeviceServingEngine(tables, jio.DEVICES["optane_ssd"],
                                 jeng.EngineConfig(**cfg))
    t = teng.DeviceServingEngine(tables, tio.DEVICES["optane_ssd"],
                                 teng.EngineConfig(**cfg), torch_device="cpu")
    for tc, jc in zip(tt.chunks(chunk), jt.chunks(chunk)):
        tp, ttm, tios = t.serve_columnar(tc.columnar, bg_iops=5e4)
        jp, jtm, jios = j.serve_columnar(jc.columnar, bg_iops=5e4)
        assert tios.dtype == jios.dtype and ttm.dtype == jtm.dtype
        np.testing.assert_array_equal(tios, jios)
        np.testing.assert_array_equal(ttm, jtm)
        assert tp.shape == jp.shape and tp.dtype == jp.dtype
        np.testing.assert_allclose(tp, jp, **COLUMNAR_POOL_TOL)
        idx, valid = teng.dense_from_chunk(tc.columnar, t.table_slot,
                                           len(t.table_ids))
        np.testing.assert_allclose(tp, t.reference_pool(idx, valid),
                                   **COLUMNAR_POOL_TOL)
        _assert_state_equal(j.state, t.state)
    assert (t.stats.sm_ios, t.stats.latency_us) == (j.stats.sm_ios, j.stats.latency_us)
    assert t.hit_rate == j.hit_rate and 0.0 < t.hit_rate < 1.0


def test_serve_trace_stream_equals_materialized():
    """``serve_trace`` over a stream, piece by piece, serves the same chunks
    as over the materialized trace: equal per-query results and cache
    state; Eq. 3 latency is ``max(item_time_us, sm_time_us)``."""
    spec = _small_spec(TARCH, "zipf_drift", 96)
    stream = TraceStream(spec, piece=32, block=40)
    whole = stream.materialize()
    res = {}
    for label, src in (("stream", stream), ("whole", whole)):
        eng = serve_dlrm.build_trace_engine(
            spec, 8, seed=3, torch_device="cpu",
            cfg=teng.EngineConfig(hbm_cache_bytes=1 << 14))
        res[label] = (serve_dlrm.serve_trace(eng, src, 16, 2e6, keep_pooled=True),
                      eng)
    (a, ea), (b, eb) = res["stream"], res["whole"]
    assert a.chunks == b.chunks == 6 and len(a.sm_ios) == 96
    for f in ("latency_us", "sm_time_us", "sm_ios"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    np.testing.assert_array_equal(a.latency_us,
                                  np.maximum(ea.cfg.item_time_us, a.sm_time_us))
    assert (a.latency_us > ea.cfg.item_time_us).any()   # the SM time surfaces
    for pa, pb in zip(a.pooled, b.pooled):
        np.testing.assert_array_equal(pa, pb)
    assert int(a.sm_ios.sum()) == ea.stats.sm_ios and ea.hit_rate == eb.hit_rate
    for k in ea.state:
        assert torch.equal(ea.state[k], eb.state[k]), k
    assert serve_dlrm.serve_trace(eb, whole, 16).pooled is None
    with pytest.raises(ValueError, match="multiple"):
        serve_dlrm.serve_trace(ea, TraceStream(spec, piece=20), 16)


def test_build_trace_engine_tables_follow_the_inventory():
    spec = _small_spec(TARCH, "multi_tenant", 8)
    eng = serve_dlrm.build_trace_engine(spec, 4, seed=0, torch_device="cpu")
    users = [m for ms in tenant_table_metas(spec).values() for m in ms
             if m.kind == "user"]
    assert eng.table_ids == [m.table_id for m in users]
    assert eng.rows_per_table.tolist() == [m.num_rows for m in users]
    assert eng.dim == 4 and eng.payload.shape == (sum(m.num_rows for m in users) + 1, 4)
    again = serve_dlrm.build_trace_engine(spec, 4, seed=0, torch_device="cpu")
    assert torch.equal(eng.payload, again.payload)        # seeded


def test_serve_dlrm_trace_cli_on_cpu(capsys):
    serve_dlrm.main(["--device", "cpu", "--archetype", "zipf_steady",
                     "--queries", "48", "--table-bytes", "3e5", "--dim", "16"])
    out = capsys.readouterr().out
    assert "served 48 zipf_steady queries (batch=32, 2 chunks) over 61 tables" in out
    assert "p50/p95/p99 latency" in out and "hit rate" in out
    serve_dlrm.main(["--device", "cpu", "--archetype", "bursty", "--queries",
                     "40", "--batch", "8", "--table-bytes", "3e5", "--dim", "8",
                     "--stream", "16"])
    assert "served 40 bursty queries (batch=8, 5 chunks)" in capsys.readouterr().out
