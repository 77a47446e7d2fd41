"""Port vs reference: the device serving engine
(``repro_torch.runtime.engine`` vs ``repro.runtime.engine``) and the IO
accounting under it (``repro_torch.core.io_sim`` vs ``repro.core.io_sim``).
Same numpy tables and batches; per-query ``sm_ios`` and ``latency_us``
exactly equal, store totals, hit rate and the cache state equal, pooled bags
within 1e-5."""
import numpy as np
import pytest
import torch

from repro.core import io_sim as jio
from repro.core.locality import TableMeta
from repro.core.sdm import SDMConfig, SDMEmbeddingStore
from repro.runtime import engine as jeng
from repro_torch.core import io_sim as tio
from repro_torch.kernels import ops
from repro_torch.runtime import engine as teng

POOL_TOL = 1e-5


def _engines(tables, device="nand_flash", **cfg):
    j = jeng.DeviceServingEngine(tables, jio.DEVICES[device],
                                 jeng.EngineConfig(**cfg))
    t = teng.DeviceServingEngine(tables, tio.DEVICES[device],
                                 teng.EngineConfig(**cfg), torch_device="cpu")
    return j, t


def _assert_state_equal(js, ts):
    assert set(js) == set(ts)
    for k in js:
        want = np.asarray(js[k])
        assert ts[k].numpy().dtype == want.dtype, k
        np.testing.assert_array_equal(ts[k].numpy(), want, err_msg=k)


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
    assert ops.launch_counts() == {"gather_pool": 0, "cache_probe": 0}
    assert 0.0 < t.hit_rate < 1.0


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
