"""Port vs reference: the fleet power model (``core/power.py``, Tables 8-11),
placement (``core/placement.py``, §4.6) and de-pruning (``core/depruning.py``,
§4.5). Same inputs through ``repro`` and ``repro_torch``; every number
exactly equal, and the Table 8/9/11 goldens of
``tests/test_power_goldens.py`` hold for the port."""
import dataclasses

import numpy as np
import pytest

from repro.core import depruning as jdp
from repro.core import io_sim as jio
from repro.core import locality as jloc
from repro.core import placement as jplc
from repro.core import power as jpw
from repro_torch.core import depruning as tdp
from repro_torch.core import io_sim as tio
from repro_torch.core import locality as tloc
from repro_torch.core import placement as tplc
from repro_torch.core import power as tpw

HOSTS = ("HW_L", "HW_S", "HW_SS", "HW_AN", "HW_AO")


def workloads(pw):
    return {
        "m1": pw.Workload("m1", sm_tables=50, avg_pool=42, row_bytes=59,
                          cache_hit_rate=0.96, total_qps=240 * 1200),
        "m2": pw.Workload("m2", sm_tables=450, avg_pool=25, row_bytes=72,
                          cache_hit_rate=0.90, latency_budget_us=300.0,
                          total_qps=450 * 1500),
        "m3": pw.Workload("m3", sm_tables=2000, avg_pool=30, row_bytes=128,
                          cache_hit_rate=0.80, compute_qps_scale=0.5,
                          latency_budget_us=1_000.0, total_qps=3150 * 100),
    }


def scenarios(pw):
    """The Table 8 and Table 9 rows, as ``test_power_goldens`` builds them."""
    w = workloads(pw)
    t8 = [pw.run_scenario("HW-L", pw.HW_L, w["m1"], use_sdm=False,
                          qps_override=240),
          pw.run_scenario("HW-SS + SDM", pw.HW_SS, w["m1"], use_sdm=True)]
    t9 = pw.normalize([
        pw.run_scenario("HW-AN + ScaleOut", pw.HW_AN, w["m2"], use_sdm=False,
                        qps_override=450, remote_hosts_per=0.2,
                        remote=pw.HW_S),
        pw.run_scenario("HW-AN + SDM", pw.HW_AN, w["m2"], use_sdm=True),
        pw.run_scenario("HW-AO + SDM", pw.HW_AO, w["m2"], use_sdm=True)],
        "HW-AN + ScaleOut")
    return t8, t9


def test_power_constants_and_hosts_equal():
    for name in ("P_SOCKET", "P_DRAM_PER_64GB", "P_SSD", "P_OPTANE_SSD",
                 "P_ACCEL"):
        assert getattr(tpw, name) == getattr(jpw, name)
    for h in HOSTS:
        a, b = getattr(tpw, h), getattr(jpw, h)
        assert dataclasses.astuple(a) == dataclasses.astuple(b)
        assert a.power == b.power
        assert (a.device is None) == (b.device is None)
        if a.device is not None:
            assert dataclasses.astuple(a.device) == dataclasses.astuple(b.device)


@pytest.mark.parametrize("host", HOSTS)
@pytest.mark.parametrize("wl", ["m1", "m2", "m3"])
@pytest.mark.parametrize("use_sdm", [False, True])
def test_qps_per_host_equal(host, wl, use_sdm):
    got = tpw.qps_per_host(getattr(tpw, host), workloads(tpw)[wl],
                           use_sdm=use_sdm)
    want = jpw.qps_per_host(getattr(jpw, host), workloads(jpw)[wl],
                            use_sdm=use_sdm)
    assert got == want


def test_table8_table9_rows_equal_and_golden():
    (t8, t9), (j8, j9) = scenarios(tpw), scenarios(jpw)
    assert [dataclasses.astuple(r) for r in t8 + t9] == \
        [dataclasses.astuple(r) for r in j8 + j9]
    assert [r.row() for r in t8 + t9] == [r.row() for r in j8 + j9]
    base, sdm = t8
    # tests/test_power_goldens.py: Table 8
    assert base.hosts == pytest.approx(1200, rel=0.01)
    assert base.total_power == pytest.approx(1200, rel=0.02)
    assert sdm.qps_per_host == pytest.approx(120, rel=0.05)
    assert sdm.hosts == pytest.approx(2400, rel=0.05)
    assert sdm.total_power == pytest.approx(960, rel=0.05)
    assert 1 - sdm.total_power / base.total_power == pytest.approx(0.20, abs=0.02)
    # Table 9
    assert t9[1].qps_per_host == pytest.approx(230, rel=0.15)
    assert t9[2].qps_per_host == pytest.approx(450, rel=0.01)
    assert t9[0].host_power == pytest.approx(1.0, abs=1e-9)
    assert 1.0 < t9[2].host_power < 1.02
    assert 1 - t9[2].total_power / t9[0].total_power == pytest.approx(0.05, abs=0.02)


@pytest.mark.parametrize("kw", [
    {}, dict(base_util=0.63, sdm_util=0.90, extra_host_power_frac=0.01),
    dict(base_util=0.5, sdm_util=0.8, extra_host_power_frac=0.03)])
def test_multitenancy_power_equal(kw):
    got, want = tpw.multitenancy_power(**kw), jpw.multitenancy_power(**kw)
    assert got == want
    if kw.get("sdm_util") == 0.90:       # Table 11 golden
        assert got["HW-FAO + SDM"]["fleet_power"] == pytest.approx(0.71, abs=0.01)
        assert got["saving"] == pytest.approx(0.29, abs=0.01)


@pytest.mark.parametrize("kw", [
    {}, dict(qps=1000, tables=500, pool=20, hit_rate=0.9, device="nand_flash"),
    dict(device="zssd", hit_rate=0.5)])
def test_m3_ssd_provisioning_equal(kw):
    assert tpw.m3_ssd_provisioning(**kw) == jpw.m3_ssd_provisioning(**kw)


def test_io_helpers_equal():
    for args in [(240.0, 50, 42, 0.04), (3150.0, 2000, 30.0, 0.2),
                 (1.0, 1, 1.0)]:
        assert tio.required_iops(*args) == jio.required_iops(*args)
    assert tio.bw_per_query_bytes(32, 61, 42.0, 136.0) == \
        jio.bw_per_query_bytes(32, 61, 42.0, 136.0)
    for name in jio.DEVICES:
        a, b = tio.DEVICES[name], jio.DEVICES[name]
        for size in (100.0, 1000.0, 4000.0):
            assert a.update_interval_days(size) == b.update_interval_days(size)
            assert a.update_interval_days(size, 800.0) == \
                b.update_interval_days(size, 800.0)


def _metas(loc, seed):
    return loc.sample_table_metas(
        np.random.default_rng(seed), num_user=14, num_item=5,
        user_dim_bytes=(64, 200), item_dim_bytes=(64, 200), user_pool=20,
        item_pool=8, total_bytes=5e8)


@pytest.mark.parametrize("policy", ["sm_only_with_cache", "fixed_fm_sm_cache",
                                    "per_table_cache", "fm_only"])
@pytest.mark.parametrize("items_on_fm", [True, False])
def test_placement_assign_equal(policy, items_on_fm):
    tm, jm = _metas(tloc, 3), _metas(jloc, 3)
    assert [dataclasses.astuple(m) for m in tm] == \
        [dataclasses.astuple(m) for m in jm]
    force = (jm[2].table_id, jm[5].table_id)
    kw = dict(policy=policy, fm_budget_bytes=int(6e7), cache_bypass_alpha=1.05,
              force_fm=force, item_tables_on_fm=items_on_fm)
    got = tplc.assign(tm, tplc.PlacementConfig(**kw))
    want = jplc.assign(jm, jplc.PlacementConfig(**kw))
    assert list(got.items()) == list(want.items())
    assert tplc.fm_bytes_used(tm, got) == jplc.fm_bytes_used(jm, want)
    assert tplc.sm_bytes_used(tm, got) == jplc.sm_bytes_used(jm, want)
    assert (tplc.FM_DIRECT, tplc.SM_CACHED, tplc.SM_UNCACHED) == \
        (jplc.FM_DIRECT, jplc.SM_CACHED, jplc.SM_UNCACHED)
    with pytest.raises(ValueError, match="unknown policy"):
        tplc.assign(tm, tplc.PlacementConfig(policy="nope"))


@pytest.mark.parametrize("keep_frac", [0.3, 0.9])
@pytest.mark.parametrize("idx_bytes", [4, 8])
def test_depruning_equal(keep_frac, idx_bytes):
    table = np.random.default_rng(5).integers(0, 256, (400, 12)).astype(np.uint8)
    tp = tdp.prune_table(np.random.default_rng(6), table, keep_frac, idx_bytes)
    jp = jdp.prune_table(np.random.default_rng(6), table, keep_frac, idx_bytes)
    np.testing.assert_array_equal(tp.values, jp.values)
    np.testing.assert_array_equal(tp.mapper, jp.mapper)
    assert (tp.mapper_bytes, tp.pruned_rows) == (jp.mapper_bytes, jp.pruned_rows)
    np.testing.assert_array_equal(tdp.deprune(tp), jdp.deprune(jp))
    trace = np.random.default_rng(7).integers(0, 400, 900)
    np.testing.assert_array_equal(tdp.lookup_pruned(tp, trace),
                                  jdp.lookup_pruned(jp, trace))
    assert tdp.depruning_accounting(tp, trace) == \
        jdp.depruning_accounting(jp, trace)
    # Algorithm 2: the dense table serves what the two-step lookup served
    np.testing.assert_array_equal(tdp.deprune(tp)[trace],
                                  tdp.lookup_pruned(tp, trace))
