"""Port vs reference: the sampled device plane and the data-integrity plane
(``devices/``, ``runtime/redundancy.py``, the sampled and integrity paths of
``core/io_sim.IOEngine``). The same seeds and the same submission sequences
go through ``repro`` and ``repro_torch``; every latency, every RNG-driven
counter and the queue state must be exactly equal, over the whole sequence
(the simulators are stateful in time)."""
import dataclasses
import math

import numpy as np
import pytest

from repro.core import io_sim as jio
from repro.devices import integrity as jint
from repro.devices import sim as jsim
from repro.devices import tuning as jtun
from repro.devices import writes as jwr
from repro.runtime import redundancy as jred
from repro_torch.core import io_sim as tio
from repro_torch.devices import integrity as tint
from repro_torch.devices import sim as tsim
from repro_torch.devices import tuning as ttun
from repro_torch.devices import writes as twr
from repro_torch.runtime import redundancy as tred

DEVICE_NAMES = sorted(jio.DEVICES)
SIM_SCALARS = ("now_us", "_rr", "_depth", "_tokens", "_tok_t", "read_waves",
               "read_ios", "read_busy_us", "write_busy_us", "repair_busy_us",
               "smoothing_delay_us", "depth_collapses")
TUNINGS = {
    "untuned": {},
    "tuned": dict(max_outstanding=12, read_priority=True),
    "smoothed": dict(max_outstanding=8, smoothing_window_us=500.0,
                     smoothing_iops=2e5),
}


def arrivals(rng, n, gap_us=150.0):
    return np.cumsum(rng.exponential(gap_us, n))


def assert_sims_equal(t, j):
    assert [getattr(t, k) for k in SIM_SCALARS] == \
        [getattr(j, k) for k in SIM_SCALARS]
    np.testing.assert_array_equal(t.slot_free_us, j.slot_free_us)
    assert sorted(t._depth_events) == sorted(j._depth_events)
    assert t.utilization() == j.utilization()
    assert (t.update is None) == (j.update is None)
    if t.update is not None:
        assert (t.update.waves, t.update.gc_events, t.update.next_us) == \
            (j.update.waves, j.update.gc_events, j.update.next_us)


def make_sims(name, tuning, update, seed=5, num_devices=2):
    out = []
    for io, tun, wr, sim in ((tio, ttun, twr, tsim), (jio, jtun, jwr, jsim)):
        out.append(sim.DeviceSim(
            io.DEVICES[name], num_devices, io.IOQueueConfig(),
            tun.DeviceTuning(**TUNINGS[tuning]),
            wr.UpdateSpec(model_size_gb=1000.0) if update else None,
            seed=seed))
    return out


@pytest.mark.parametrize("name", DEVICE_NAMES)
@pytest.mark.parametrize("tuning", sorted(TUNINGS))
@pytest.mark.parametrize("update", [False, True])
def test_device_sim_equal(name, tuning, update):
    t, j = make_sims(name, tuning, update)
    rng = np.random.default_rng(1)
    at = arrivals(rng, 300, 300.0)
    n = rng.integers(0, 400, 300)
    # scalar submissions, then batches out of arrival order, then a rewind
    for a, k, bg in zip(at[:60].tolist(), n[:60].tolist(),
                        rng.uniform(0, 2e5, 60).tolist()):
        assert t.submit(a, k, bg) == j.submit(a, k, bg)
    for s in range(60, 300, 48):
        perm = rng.permutation(np.arange(s, min(s + 48, 300)))
        np.testing.assert_array_equal(t.submit_batch(at[perm], n[perm], 1e4),
                                      j.submit_batch(at[perm], n[perm], 1e4))
        assert_sims_equal(t, j)
    t.reset_clock()
    j.reset_clock()
    assert_sims_equal(t, j)
    np.testing.assert_array_equal(t.submit_batch(at[:50], n[:50]),
                                  j.submit_batch(at[:50], n[:50]))
    assert_sims_equal(t, j)
    if update and jio.DEVICES[name].gc_prob > 0:
        assert t.update.waves > 0


def test_device_tuning_equal():
    for kw in TUNINGS.values():
        t, j = ttun.DeviceTuning(**kw), jtun.DeviceTuning(**kw)
        for per_dev, cap in [(1, 32), (40, 32), (300, 16), (5, 1)]:
            assert t.effective_outstanding(per_dev, cap) == \
                j.effective_outstanding(per_dev, cap)
        assert dataclasses.astuple(t.degraded(2)) == \
            dataclasses.astuple(j.degraded(2))
    assert dataclasses.astuple(ttun.DEFAULT_TUNING) == \
        dataclasses.astuple(jtun.DEFAULT_TUNING)
    with pytest.raises(ValueError):
        ttun.DEFAULT_TUNING.degraded(0)


@pytest.mark.parametrize("name", DEVICE_NAMES)
@pytest.mark.parametrize("spec", [dict(model_size_gb=1000.0),
                                  dict(model_size_gb=100.0, interval_days=1.0,
                                       chunk_bytes=1 << 18)])
def test_update_stream_equal(name, spec):
    ts, js = twr.UpdateSpec(**spec), jwr.UpdateSpec(**spec)
    dt, dj = tio.DEVICES[name], jio.DEVICES[name]
    assert ts.interval_for(dt) == js.interval_for(dj)
    assert ts.write_bytes_per_us(dt) == js.write_bytes_per_us(dj)
    t = twr.UpdateStream(ts, dt, 2, np.random.default_rng(3))
    j = jwr.UpdateStream(js, dj, 2, np.random.default_rng(3))
    assert (t.mean_gap_us, t.service_us, t.next_us) == \
        (j.mean_gap_us, j.service_us, j.next_us)
    for horizon in (1e3, 1e5, 1e6, 5e6):
        assert list(t.pop_until(horizon)) == list(j.pop_until(horizon))
        assert (t.waves, t.gc_events, t.next_us) == (j.waves, j.gc_events, j.next_us)


# -- IOEngine: sampled mode and the integrity hook ------------------------------


def make_engines(name, *, sampled, tuning="untuned", update=False,
                 integrity=None, replication=None, total_rows=50_000):
    """Port and reference ``IOEngine`` over the same device, optionally with
    a seeded ``DeviceSim`` and a ``RedundancyPlane`` (``integrity`` and
    ``replication`` are keyword dicts of the specs)."""
    sims = make_sims(name, tuning, update) if sampled else (None, None)
    out = []
    for io, intm, red, sim in ((tio, tint, tred, sims[0]),
                               (jio, jint, jred, sims[1])):
        eng = io.IOEngine(io.DEVICES[name], 2, io.IOQueueConfig(), sim=sim)
        if integrity is not None or replication is not None:
            eng.integrity = red.RedundancyPlane(
                None if integrity is None else intm.IntegritySpec(**integrity),
                None if replication is None else red.ReplicationSpec(**replication),
                io.DEVICES[name], 2, total_rows, seed=11, sim=sim)
        out.append(eng)
    return out


def drive(t, j, rng, steps=12, loss_at=None):
    """The same mix of ``submit``, ``submit_batch`` and
    ``submit_batch_multi`` calls, with arrival times, on both engines."""
    now = 0.0
    for step in range(steps):
        at = now + arrivals(rng, 24, 60.0)
        now = float(at[-1])
        n = rng.integers(0, 120, 24) * (rng.random(24) < 0.8)
        rb = rng.choice([90, 128, 172], 24)
        if loss_at == step:
            assert t.integrity.device_loss(now) == j.integrity.device_loss(now)
        if step % 3 == 0:
            for a, k in zip(at[:6].tolist(), n[:6].tolist()):
                assert t.submit(k, 128, 1e4, at_us=a) == j.submit(k, 128, 1e4, at_us=a)
        elif step % 3 == 1:
            for x, y in zip(t.submit_batch(n, 96, 2e4, at_us=at),
                            j.submit_batch(n, 96, 2e4, at_us=at)):
                np.testing.assert_array_equal(x, y)
        else:
            for x, y in zip(t.submit_batch_multi(n, rb, 5e3, at_us=at),
                            j.submit_batch_multi(n, rb, 5e3, at_us=at)):
                np.testing.assert_array_equal(x, y)
    assert (t.total_ios, t.total_bus_bytes, t.total_wanted_bytes,
            t.bus_overhead) == (j.total_ios, j.total_bus_bytes,
                                j.total_wanted_bytes, j.bus_overhead)
    if t.sim is not None:
        assert_sims_equal(t.sim, j.sim)
    if t.integrity is not None:
        assert dataclasses.asdict(t.integrity.stats) == \
            dataclasses.asdict(j.integrity.stats)


@pytest.mark.parametrize("name", ["nand_flash", "optane_ssd", "zssd"])
@pytest.mark.parametrize("tuning,update", [("untuned", False), ("tuned", True)])
def test_io_engine_sampled_equal(name, tuning, update):
    t, j = make_engines(name, sampled=True, tuning=tuning, update=update)
    drive(t, j, np.random.default_rng(2))
    # submissions without an arrival time queue at the simulator's clock
    assert t.submit(40, 128, 0.0) == j.submit(40, 128, 0.0)
    n = np.array([0, 3, 70])
    for x, y in zip(t.submit_batch(n, 128, 0.0), j.submit_batch(n, 128, 0.0)):
        np.testing.assert_array_equal(x, y)


def test_io_engine_analytic_ignores_arrivals():
    t, j = make_engines("nand_flash", sampled=False)
    rng = np.random.default_rng(4)
    n = rng.integers(0, 200, 50)
    at = arrivals(rng, 50)
    base = tio.IOEngine(tio.DEVICES["nand_flash"], 2)
    want = base.submit_batch(n, 128, 3e4)[0]
    np.testing.assert_array_equal(t.submit_batch(n, 128, 3e4, at_us=at)[0], want)
    np.testing.assert_array_equal(j.submit_batch(n, 128, 3e4, at_us=at)[0], want)
    drive(t, j, rng)


INTEGRITY = {
    "corrupt": (dict(uber=5e-3, wear_scale=0.5, disturb_scale=2.0), dict(k=2)),
    "no_replica": (dict(uber=2e-2, retry_ladder=(1.0, 2.0),
                        retry_success=0.3), dict(k=1)),
    "hedged": (None, dict(k=2, hedge_after_us=120.0)),
    "silent": (dict(uber=1e-2, checksums=False), dict(k=2)),
    "inert": (dict(uber=0.0), dict(k=2)),
}


@pytest.mark.parametrize("case", sorted(INTEGRITY))
@pytest.mark.parametrize("sampled", [False, True])
def test_io_engine_integrity_equal(case, sampled):
    integ, rep = INTEGRITY[case]
    t, j = make_engines("nand_flash", sampled=sampled, update=sampled,
                        integrity=integ, replication=rep)
    drive(t, j, np.random.default_rng(6), steps=15)
    s = t.integrity.stats
    if case == "corrupt":
        assert s.corrupt_reads > 0 and s.retry_steps > 0
    if case == "hedged":
        assert s.hedged_reads > 0
    if case == "silent":
        assert s.undetected > 0 and s.corrupt_reads == 0
        assert t.integrity.take_undetected() == j.integrity.take_undetected()
    if case == "inert":
        assert t.integrity.inert and s == tint.IntegrityStats()


@pytest.mark.parametrize("sampled", [False, True])
def test_redundancy_plane_loss_and_rebuild_equal(sampled):
    """A device loss mid-run: replica reads while the rebuild stream runs
    (background IOPS in analytic mode, channel waves in sampled mode)."""
    rep = dict(k=2, hedge_after_us=400.0, rebuild_rows_per_wave=2048,
               rebuild_gap_us=50.0)
    t, j = make_engines("nand_flash", sampled=sampled,
                        integrity=dict(uber=1e-3), replication=rep)
    drive(t, j, np.random.default_rng(8), steps=15, loss_at=3)
    pt, pj = t.integrity, j.integrity
    assert pt.stats.rows_lost > 0 and pt.stats.replica_reads > 0
    for plane in (pt, pj):
        plane.advance(1e9)
    assert dataclasses.asdict(pt.stats) == dataclasses.asdict(pj.stats)
    assert pt.stats.rows_rebuilt == pt.stats.rows_lost
    assert (pt.rebuild.rows_done, pt.rebuild.waves, pt._lost_remaining) == \
        (pj.rebuild.rows_done, pj.rebuild.waves, pj._lost_remaining)
    for plane in (pt, pj):
        plane.reset_stats()
        plane.begin_replay()
    drive(t, j, np.random.default_rng(9), steps=6, loss_at=1)


def test_rebuild_stream_equal():
    rep_t = tred.ReplicationSpec(rebuild_rows_per_wave=100, rebuild_gap_us=10.0)
    rep_j = jred.ReplicationSpec(rebuild_rows_per_wave=100, rebuild_gap_us=10.0)
    t = tred.RebuildStream(rep_t, tio.DEVICES["nand_flash"])
    j = jred.RebuildStream(rep_j, jio.DEVICES["nand_flash"])
    for s in (t, j):
        s.start(at_us=5.0, rows=250)
    assert list(t.pop_until(20.0)) == list(j.pop_until(20.0))
    t.reset_clock()
    j.reset_clock()
    assert list(t.pop_until(1000.0)) == list(j.pop_until(1000.0))
    assert (t.rows_done, t.waves, t.active) == (j.rows_done, j.waves, j.active)
    assert math.isinf(t.next_us)


@pytest.mark.parametrize("kw", [
    dict(uber=-0.1), dict(uber=float("nan")), dict(disturb_groups=0),
    dict(retry_ladder=()), dict(retry_success=0.0), dict(refetch_penalty=-1.0)])
def test_integrity_spec_validation_equal(kw):
    for mod in (tint, jint):
        with pytest.raises(ValueError):
            mod.IntegritySpec(**kw)


@pytest.mark.parametrize("kw", [
    dict(k=0), dict(hedge_after_us=0.0), dict(hedge_after_us=float("nan")),
    dict(rebuild_rows_per_wave=0), dict(rebuild_gap_us=0.0),
    dict(rebuild_iops=-1.0)])
def test_replication_spec_validation_equal(kw):
    for mod in (tred, jred):
        with pytest.raises(ValueError):
            mod.ReplicationSpec(**kw)


# -- the media model and checksums ------------------------------------------------


@pytest.mark.parametrize("name", ["nand_flash", "optane_dimm"])
def test_media_error_model_equal(name):
    kw = dict(uber=1e-3, wear_scale=0.5, disturb_scale=2.0, disturb_groups=4,
              disturb_refresh=1000.0)
    t = tint.MediaErrorModel(tint.IntegritySpec(**kw), tio.DEVICES[name], seed=3)
    j = jint.MediaErrorModel(jint.IntegritySpec(**kw), jio.DEVICES[name], seed=3)
    for step in range(40):
        g = t.note_reads(100 * step)
        assert g == j.note_reads(100 * step)
        if step % 7 == 0:
            t.observe_update(step, 1 << 20)
            j.observe_update(step, 1 << 20)
        assert t.p_corrupt(g) == j.p_corrupt(g)
        n = np.arange(step % 5 + 1) * 300
        np.testing.assert_array_equal(t.draw_corrupt(n, 0.01),
                                      j.draw_corrupt(n, 0.01))
        st, sj = tint.IntegrityStats(), jint.IntegrityStats()
        for replica_p in (-1.0, 0.3):
            assert t.recover_rows(3, st, replica_p) == \
                j.recover_rows(3, sj, replica_p)
        assert dataclasses.asdict(st) == dataclasses.asdict(sj)
        np.testing.assert_array_equal(t.sample_read_us(4), j.sample_read_us(4))
    np.testing.assert_array_equal(t._disturb, j._disturb)
    assert (t._wear_gib, t._rr) == (j._wear_gib, j._rr)


def test_row_checksums_equal_and_bit_sensitive():
    rng = np.random.default_rng(12)
    rows = rng.standard_normal((64, 24)).astype(np.float32)
    ct, cj = tint.row_checksums(rows), jint.row_checksums(rows)
    assert ct.dtype == cj.dtype == np.uint64
    np.testing.assert_array_equal(ct, cj)
    assert tint.verify_rows(rows, ct).all()
    bad = rows.copy()
    bits = bad.view(np.uint32)
    bits[5, 7] ^= np.uint32(1 << 13)
    np.testing.assert_array_equal(tint.verify_rows(bad, ct),
                                  jint.verify_rows(bad, cj))
    assert tint.verify_rows(bad, ct).tolist() == [i != 5 for i in range(64)]
