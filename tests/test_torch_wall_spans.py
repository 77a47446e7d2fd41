"""The serving engine's wall-clock spans and counters
(``ObsConfig(wall_spans=True)``, ``Telemetry.wall``): one of each span a
call, nested as documented, on the clock of ``torch.profiler``'s records,
and invisible to what the engine serves. CPU only; the card's side is
``sdm_bench/test_sdmb_spans.py``."""
import numpy as np
import pytest
import torch

import repro_torch.obs.tracing as tracing
from repro_torch.core.columnar import ColumnarQueries
from repro_torch.core.io_sim import DEVICES
from repro_torch.launch import make_embed_mesh
from repro_torch.obs import ObsConfig, make_telemetry, merge_telemetry
from repro_torch.runtime.engine import (DeviceServingEngine, EngineConfig,
                                        dense_from_chunk)
from repro_torch.runtime.sharded_engine import ShardedServingEngine

PARENT = {"engine.serve": None, "engine.densify": "engine.serve",
          "engine.validate": "engine.serve", "engine.h2d": "engine.serve",
          "engine.step": "engine.serve", "step.probe": "engine.step",
          "step.hit_pool": "engine.step", "step.miss_pool": "engine.step",
          "step.dedupe": "engine.step", "step.fill": "engine.step",
          "engine.d2h": "engine.serve", "engine.account": "engine.serve"}
ULP_US = 0.5                 # Unix µs in float64 keep 0.25 µs


def _tables(seed=0, dim=8):
    rng = np.random.default_rng(seed)
    return {10 + t: rng.standard_normal((200 + 150 * t, dim)).astype(np.float32)
            for t in range(4)}


def _engine(tables, telemetry=None, shards=None):
    """The single engine, or with ``shards`` a row-layout
    ``ShardedServingEngine`` of that many CPU shards."""
    cfg = EngineConfig(hbm_cache_bytes=1 << 11, ways=4)
    if shards is None:
        eng = DeviceServingEngine(tables, DEVICES["nand_flash"], cfg,
                                  torch_device="cpu")
    else:
        eng = ShardedServingEngine(tables, DEVICES["nand_flash"], cfg,
                                   mesh=make_embed_mesh(shards, "cpu"))
    eng.telemetry = telemetry
    return eng


def _states(eng):
    """The engine's cache states: one a shard, or the single engine's."""
    return eng.state if isinstance(eng.state, list) else [eng.state]


def _chunks(tables, n=4, queries=6, seed=1):
    """Chunks of Zipf-ish keys (repeats, so hits and deduped misses), each
    query over a random subset of the tables with its own pooling."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        reqs = []
        for _ in range(queries):
            tids = [t for t in tables if rng.random() < 0.8] or [next(iter(tables))]
            reqs.append({t: np.minimum(rng.zipf(1.3, rng.integers(1, 9)) - 1,
                                       len(tables[t]) - 1) for t in tids})
        out.append(ColumnarQueries.from_requests(reqs).whole())
    return out


def _wall_engine(tables, shards=None):
    return _engine(tables, make_telemetry(ObsConfig(wall_spans=True)), shards)


def _by_call(events):
    calls = {}
    for ts, dur, ph, name, cat, host, args in events:
        assert ph == "X" and cat == "engine"
        calls.setdefault(args["call"], []).append((name, ts, ts + dur, args))
    return calls


def test_one_of_each_span_a_call_nested_in_its_parent():
    tables = _tables()
    eng = _wall_engine(tables)
    chunks = _chunks(tables)
    for ch in chunks:
        eng.serve_columnar(ch, 1e4)
    calls = _by_call(eng.telemetry.wall.events)
    assert sorted(calls) == list(range(1, len(chunks) + 1))
    assert eng.telemetry.wall.dropped == 0
    for spans in calls.values():
        assert sorted(n for n, *_ in spans) == sorted(PARENT)
        at = {n: (s, e) for n, s, e, _ in spans}
        for name, s, e, args in spans:
            assert args["parent"] == PARENT[name]
            assert e >= s
            if args["parent"] is not None:
                ps, pe = at[args["parent"]]
                assert ps - ULP_US <= s and e <= pe + ULP_US
        # siblings meet end to start: one clock read per boundary. The
        # columnar entry copies the CSR arrays in before the card builds and
        # checks the block: densify, h2d, validate, step
        for a, b in [("engine.densify", "engine.h2d"), ("engine.h2d", "engine.validate"),
                     ("engine.validate", "engine.step"), ("engine.step", "engine.d2h"),
                     ("engine.d2h", "engine.account"), ("step.probe", "step.hit_pool"),
                     ("step.hit_pool", "step.miss_pool"), ("step.miss_pool", "step.dedupe"),
                     ("step.dedupe", "step.fill")]:
            assert at[a][1] == pytest.approx(at[b][0], abs=ULP_US)
        assert at["engine.serve"][0] == at["engine.densify"][0]
        assert at["engine.step"][0] == at["step.probe"][0]
    # calls follow each other on the clock
    starts = [min(s for _, s, _, _ in calls[c]) for c in sorted(calls)]
    assert starts == sorted(starts)


def test_serve_batch_alone_has_no_serve_or_densify_span():
    tables = _tables()
    eng = _wall_engine(tables)
    idx, valid = dense_from_chunk(_chunks(tables, n=1)[0], eng.table_slot, len(tables))
    eng.serve_batch(idx, 1e4, valid=valid)
    (spans,) = _by_call(eng.telemetry.wall.events).values()
    names = {n for n, *_ in spans}
    assert names == set(PARENT) - {"engine.serve", "engine.densify"}
    assert all(a["parent"] is None for n, _, _, a in spans if not n.startswith("step."))


@pytest.mark.parametrize("shards", [None, 2], ids=["single", "sharded2"])
def test_serve_batch_spans_keep_their_order(shards):
    """The dense entry validates on the host before its copies in:
    validate, h2d, step, d2h, account, each meeting the next."""
    tables = _tables()
    eng = _wall_engine(tables, shards)
    for ch in _chunks(tables, n=2, seed=3):
        idx, valid = dense_from_chunk(ch, eng.table_slot, len(tables))
        eng.serve_batch(idx, 1e4, valid=valid)
    calls = _by_call(eng.telemetry.wall.events)
    assert len(calls) == 2
    order = ["engine.validate", "engine.h2d", "engine.step", "engine.d2h", "engine.account"]
    for spans in calls.values():
        at = {n: (s, e) for n, s, e, _ in spans}
        for a, b in zip(order, order[1:]):
            assert at[a][1] == pytest.approx(at[b][0], abs=ULP_US)
        assert [n for n, *_ in sorted((x for x in spans if x[0] in order),
                                      key=lambda x: x[1])] == order


@pytest.mark.parametrize("shards", [None, 2], ids=["single", "sharded2"])
def test_h2d_bytes_counts_each_calls_copies_in(shards):
    """``engine.h2d_bytes``: the bytes a call copies in. The columnar entry
    copies the chunk's keys as int64 and one int32 word a block row and a
    segment, plus one; the dense entry 5 bytes a slot (int32 key,
    bool mask). Two CPU shards share one device: one copy."""
    from repro_torch.runtime.engine import block_inputs, chunk_segments
    tables = _tables()
    eng = _wall_engine(tables, shards)
    reg = eng.telemetry.registry
    total = 0
    for ch in _chunks(tables, n=3, seed=2):
        values, meta = block_inputs(chunk_segments(ch, eng.table_slot, len(tables)),
                                    len(tables))
        B, S = ch.n_queries, len(ch.parent.seg_table)
        assert values.dtype == np.int64 and meta.nbytes == 4 * (B * len(tables) + S + 1)
        eng.serve_columnar(ch, 1e4)
        total += values.nbytes + meta.nbytes
        assert reg.as_dict()["counters"]["engine.h2d_bytes"] == total
    idx, valid = dense_from_chunk(_chunks(tables, n=1, seed=2)[0], eng.table_slot,
                                  len(tables))
    eng.serve_batch(idx, 1e4, valid=valid)
    assert reg.as_dict()["counters"]["engine.h2d_bytes"] == total + 5 * idx.size
    # less than the dense block the columnar entry no longer copies
    assert values.nbytes + meta.nbytes < 5 * idx.size


SHARDS = pytest.mark.parametrize("shards", [None, 2], ids=["single", "sharded2"])


@SHARDS
def test_wall_spans_change_nothing_served(shards):
    """Pooled output, SM reads and time, the cache's state and its counters
    are bit-identical with the wall spans on and with no telemetry."""
    tables = _tables(3)
    off, on = _engine(tables, shards=shards), _wall_engine(tables, shards)
    for ch in _chunks(tables, n=5, seed=7):
        a, b = off.serve_columnar(ch, 1e4), on.serve_columnar(ch, 1e4)
        for x, y in zip(a, b):
            assert x.dtype == y.dtype and np.array_equal(x, y)
    idx, valid = dense_from_chunk(_chunks(tables, n=1, seed=8)[0], off.table_slot,
                                  len(tables))
    (pa, sa), (pb, sb) = off.serve_batch(idx, 0.0, valid), on.serve_batch(idx, 0.0, valid)
    assert np.array_equal(pa, pb) and sa == sb
    for so, sn in zip(_states(off), _states(on), strict=True):
        assert so.keys() == sn.keys()
        for k in so:
            assert torch.equal(so[k], sn[k]), k
    assert off.stats == on.stats


@SHARDS
@pytest.mark.parametrize("flag", [None, True])
def test_no_wall_recorder_reads_no_clock(monkeypatch, flag, shards):
    """With no telemetry, or the default handle (no ``wall``), the engine
    reads no clock and records no engine span."""
    class NoClock:
        @staticmethod
        def time_ns():
            raise AssertionError("a clock was read")

    monkeypatch.setattr(tracing, "time", NoClock)
    tables = _tables()
    tel = make_telemetry(flag)
    eng = _engine(tables, tel, shards)
    for ch in _chunks(tables, n=2):
        eng.serve_columnar(ch, 1e4)
    if tel is not None:
        assert tel.wall is None
        assert not [e for e in tel.tracer.events if e[3].startswith(("engine.", "step."))]
        counters = tel.registry.as_dict()["counters"]
        assert counters["engine.batches"] == 2
        assert not {"engine.slots", "engine.valid_keys", "engine.filled_rows",
                    "engine.h2d_bytes"} & set(counters)
        assert not {"engine.dim", "engine.row_pitch"} & set(tel.registry.gauges)


@SHARDS
def test_slot_counters_are_the_blocks(shards):
    """The counters count each call's block; the sharded engine records the
    host spans and ``engine.step``, with no ``step.*`` children."""
    tables = _tables()
    eng = _wall_engine(tables, shards)
    slots = keys = 0
    for ch in _chunks(tables, n=3, seed=5):
        idx, valid = dense_from_chunk(ch, eng.table_slot, len(tables))
        slots += idx.size
        keys += int(valid.sum())
        eng.serve_columnar(ch, 1e4)
    counters = eng.telemetry.registry.as_dict()["counters"]
    assert counters["engine.slots"] == slots
    assert counters["engine.valid_keys"] == keys < slots
    names = {e[3] for e in eng.telemetry.wall.events}
    assert names == {n for n in PARENT if shards is None or not n.startswith("step.")}


def test_filled_rows_counter_is_the_calls_sm_ios():
    """``engine.filled_rows`` counts the rows the fill dequantized and
    offered to the cache: the call's unique misses, its queries' summed
    ``sm_ios``, fewer than the block's slots."""
    tables = _tables(4)
    eng = _wall_engine(tables)
    reg = eng.telemetry.registry
    total = 0
    for ch in _chunks(tables, n=4, seed=9):
        _, _, ios = eng.serve_columnar(ch, 1e4)
        total += int(ios.sum())
        assert reg.as_dict()["counters"]["engine.filled_rows"] == total
    idx, valid = dense_from_chunk(_chunks(tables, n=1, seed=9)[0], eng.table_slot,
                                  len(tables))
    _, stats = eng.serve_batch(idx, 1e4, valid)          # warm: few or no misses
    total += sum(s.sm_ios for s in stats)
    counters = reg.as_dict()["counters"]
    assert counters["engine.filled_rows"] == total == eng.stats.sm_ios
    assert 0 < total < counters["engine.valid_keys"] < counters["engine.slots"]


@pytest.mark.parametrize("dim,pitch", [(8, 8), (13, 16), (279, 280)])
def test_width_gauges_name_the_pitch(dim, pitch):
    """With the wall spans on, the registry's gauges ``engine.dim`` and
    ``engine.row_pitch`` say at which width the kernels ran: set once a
    registry, and again on the fresh one a reset brings."""
    tables = _tables(dim=dim)
    eng = _wall_engine(tables)
    chunks = _chunks(tables, n=3, seed=6)
    for ch in chunks[:2]:
        eng.serve_columnar(ch, 1e4)
    gauges = eng.telemetry.registry.as_dict()["gauges"]
    assert (gauges["engine.dim"], gauges["engine.row_pitch"]) == (dim, pitch)
    eng.telemetry.reset()
    eng.serve_columnar(chunks[2], 1e4)
    gauges = eng.telemetry.registry.as_dict()["gauges"]
    assert (gauges["engine.dim"], gauges["engine.row_pitch"]) == (dim, pitch)


def test_reset_and_merge_carry_the_wall_recorder():
    tables = _tables()
    a, b = _wall_engine(tables), _wall_engine(tables)
    ch = _chunks(tables, n=1)[0]
    a.serve_columnar(ch)
    b.serve_columnar(ch)
    b.serve_columnar(ch)
    merged = merge_telemetry([("h0", a.telemetry), ("h1", None), ("h2", b.telemetry)])
    assert len(merged.wall.events) == 3 * len(PARENT)
    assert {e[5] for e in merged.wall.events} == {"h0", "h2"}
    assert merged.tracer.events == []
    a.telemetry.reset()
    assert a.telemetry.wall.events == [] and a.telemetry.wall.dropped == 0


def test_profiler_records_of_the_step_fall_inside_engine_step():
    """The step's aten records under ``torch.profiler`` (kineto, Unix ns)
    lie inside the call's ``engine.step`` span within 5 µs, and its copies
    in, inside ``engine.h2d``: one clock, no correlation needed."""
    from torch.profiler import ProfilerActivity, profile
    tables = _tables(2)
    eng = _wall_engine(tables)
    chunks = _chunks(tables, n=3, seed=4)
    eng.serve_columnar(chunks[0], 1e4)             # warm: lazy set-up off the record
    eng.telemetry.reset()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for ch in chunks[1:]:
            eng.serve_columnar(ch, 1e4)
    spans = {(c, n): (s * 1e3, e * 1e3)
             for c, ss in _by_call(eng.telemetry.wall.events).items()
             for n, s, e, _ in ss}
    steps = sorted(v for (c, n), v in spans.items() if n == "engine.step")
    fills = sorted(v for (c, n), v in spans.items() if n == "step.fill")
    assert len(steps) == len(chunks) - 1
    step_ops = ("aten::argsort", "aten::cummax", "aten::nonzero")
    found = {k: 0 for k in step_ops}
    tol = 5_000                                   # ns
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        if name not in step_ops:
            continue
        s, end = e.start_ns(), e.start_ns() + e.duration_ns()
        assert any(a - tol <= s and end <= b + tol for a, b in steps), (name, s)
        if name == "aten::cummax":                # the fill's insert alone
            assert any(a - tol <= s and end <= b + tol for a, b in fills), (name, s)
        found[name] += 1
    assert all(found.values()), found
