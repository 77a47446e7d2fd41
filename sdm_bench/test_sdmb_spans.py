"""The idle attribution of ``sdmb_spans``: hand-built device records and
spans on the CPU, the span and counter metrics of a tiny served window, and
on the card (``cuda``-marked, skipped without one) the engine's wall spans
laid on a real device trace."""
from __future__ import annotations

import time

import numpy as np
import pytest
import torch

import sdmb_testing as tt  # noqa: F401  (puts src/ and sdm_bench/ on sys.path)
import sdmb_harness as harness
import sdmb_inputs as inputs
import sdmb_spans as spans_mod
from repro_torch.core.columnar import ColumnarQueries
from repro_torch.core.io_sim import DEVICES
from repro_torch.obs import ObsConfig, make_telemetry
from repro_torch.runtime.engine import DeviceServingEngine, EngineConfig

BASE_US = 1_792_287_000_000_000            # a Unix µs of 2026: float64 keeps it whole
PARENT = {"engine.serve": None, "engine.densify": "engine.serve",
          "engine.validate": "engine.serve", "engine.h2d": "engine.serve",
          "engine.step": "engine.serve", "step.probe": "engine.step",
          "step.hit_pool": "engine.step", "step.miss_pool": "engine.step",
          "step.dedupe": "engine.step", "step.fill": "engine.step",
          "engine.d2h": "engine.serve", "engine.account": "engine.serve"}


def _span(name, a_us, b_us, call=1):
    return (float(BASE_US + a_us), float(b_us - a_us), "X", name, "engine", "",
            {"call": call, "parent": PARENT[name]})


def _ns(us):
    return (BASE_US + us) * 1000


def _rec(name, a_us, b_us):
    return (name, _ns(a_us), (b_us - a_us) * 1000)


# one call of the engine's layout, µs after BASE_US; then a call of one span
CALL1 = [("engine.serve", 1100, 1900), ("engine.densify", 1100, 1300),
         ("engine.validate", 1300, 1350), ("engine.h2d", 1350, 1400),
         ("engine.step", 1400, 1700), ("step.probe", 1400, 1500),
         ("step.hit_pool", 1500, 1520), ("step.miss_pool", 1520, 1560),
         ("step.dedupe", 1560, 1600), ("step.fill", 1600, 1680),
         ("engine.d2h", 1700, 1750), ("engine.account", 1750, 1850)]
CALL2 = [("engine.serve", 3000, 3900), ("engine.densify", 3000, 3900)]
DEVICE = [("Memcpy HtoD", 1360, 1390), ("k1", 1410, 1450), ("k2", 1470, 1530),
          ("k3", 1540, 1545), ("k4", 1542, 1548),          # overlapping records
          ("k5", 1690, 1720),                              # across step -> d2h
          ("Memcpy DtoH", 1725, 1740), ("k6", 2500, 2600),  # between calls
          ("k7", 2950, 3050)]                               # across a call's start
EXPECTED_US = {spans_mod.OUTSIDE: 100 + 100 + 100, "engine.densify": 200 + 850,
               "engine.validate": 50, "engine.h2d": 20, "step.probe": 30,
               "step.hit_pool": 0, "step.miss_pool": 22, "step.dedupe": 40,
               "step.fill": 80, "engine.step": 10, "engine.d2h": 15,
               "engine.account": 100, "engine.serve": 50}


def _hand_built():
    recorded = ([_span(n, a, b) for n, a, b in CALL1]
                + [_span(n, a, b, call=2) for n, a, b in CALL2])
    calls = [(_ns(1000), _ns(2000)), (_ns(3000), _ns(4000))]
    return recorded, calls, [_rec(*d) for d in DEVICE]


def test_idle_goes_to_the_innermost_open_span():
    recorded, calls, events = _hand_built()
    idle = spans_mod.idle_by_span(events, spans_mod.spans_ns(recorded), calls)
    assert idle.keys() == EXPECTED_US.keys()
    for name, us in EXPECTED_US.items():
        assert idle[name] == pytest.approx(us * 1e-6, abs=1e-12), name
    # the groups sum to the idle time within the calls: their seconds less
    # the busy union inside them
    busy_in_calls = (30 + 40 + 60 + 8 + 30 + 15) + 50
    assert sum(idle.values()) == pytest.approx((2000 - busy_in_calls) * 1e-6, abs=1e-12)
    assert spans_mod.breakdown(idle, top=2) == [["engine.densify", idle["engine.densify"]],
                                                [spans_mod.OUTSIDE, idle[spans_mod.OUTSIDE]]]


IN, OUT = "Memcpy HtoD (Pageable -> Device)", "Memcpy DtoH (Device -> Pageable)"


def _engine_calls(n, lag_us=0, late_us=None):
    """``n`` calls of CALL1's layout 1000 µs apart, with the engine's two
    copies in and out, the second copy out ending ``late_us[k]`` before
    ``engine.d2h`` does (the host late to return); the device records
    ``lag_us(k)`` late on the host's clock."""
    recorded, events, calls = [], [], []
    for k in range(n):
        t = 1000 * k
        recorded += [_span(name, a + t, b + t, call=k + 1) for name, a, b in CALL1]
        calls.append((_ns(1000 + t), _ns(2000 + t)))
        lag = lag_us(k) if callable(lag_us) else lag_us
        late = late_us[k] if late_us else 0
        dev = [(IN, 1360, 1380), (IN, 1380, 1390), ("k1", 1410, 1450), ("k2", 1470, 1530),
               ("k5", 1690, 1720), (OUT, 1725, 1735), (OUT, 1740 - late, 1750 - late)]
        events += [_rec(name, a + t + lag, b + t + lag) for name, a, b in dev]
    return recorded, calls, events


def test_metrics_of_engine_calls():
    recorded, calls, events = _engine_calls(3)
    counters = {"engine.slots": 400, "engine.valid_keys": 100}
    m = spans_mod.metrics(recorded, calls, counters, 0, events)
    assert m["densify_span_ms"] == pytest.approx(0.2)
    assert m["account_span_ms"] == pytest.approx(0.1)
    assert m["step_host_ms"] == pytest.approx(0.3)
    assert m["slot_use_share"] == 25.0
    # a call: outside 200; probe 100 - 70, miss_pool 40 - 10, the rest of
    # the step idle, step self 20 - 10; densify 200, validate 50, h2d 50 -
    # 30, d2h 50 - 40, account 100, serve self 50
    groups = {"outside_engine": 200, "step": 30 + 0 + 30 + 40 + 80 + 10,
              "engine_host": 200 + 50 + 20 + 10 + 100 + 50}
    for g, us in groups.items():
        assert m[f"idle_{g}_share"] == pytest.approx(100 * us / 1000, abs=1e-9), g
    assert spans_mod.metrics(recorded, calls, counters, 1, events) == {}
    no_device = spans_mod.metrics(recorded, calls, counters, 0)
    assert set(no_device) == {"densify_span_ms", "account_span_ms", "step_host_ms",
                              "slot_use_share"}
    # nor does the device clock's offset from the host's
    for lag in (300, -40):
        r2, c2, e2 = _engine_calls(3, lag)
        assert spans_mod.metrics(r2, c2, counters, 0, e2) == pytest.approx(m)


def test_call_offsets_take_the_tightest_admissible_bound_around_a_call():
    """A call's lower bound is its last copy out's end less its
    ``engine.d2h`` end, its upper bound its first copy in's start less its
    ``engine.h2d`` start (10 µs here). A host late to return from one copy
    (call 4) loosens that call's bound only; a step of the offset (calls 8
    on) does not reach back over it."""
    lag = [100] * 8 + [130] * 3
    late = [0, 0, 0, 0, 60, 0, 0, 0, 0, 0, 0]
    recorded, calls, events = _engine_calls(len(lag), lambda k: lag[k], late)
    spans = spans_mod.spans_ns(recorded)
    off = spans_mod.call_offsets(events, spans, width=1)
    assert (off / 1000).tolist() == lag
    off = spans_mod.call_offsets(events, spans)          # 8 calls each side
    assert (off / 1000).tolist() == lag
    moved = spans_mod.aligned(events, spans)
    assert [s for n, s, _ in moved if n == IN][0::2] == [_ns(1360 + 1000 * k)
                                                         for k in range(len(lag))]
    # a record the profiler dropped: a copy out loosens one bound, both
    # copies in of a call merge it with the one before
    assert (spans_mod.call_offsets(events[:-1], spans) / 1000).tolist() == lag
    assert spans_mod.call_offsets([e for e in events if e[0] != IN or e[1] < _ns(5000)],
                                  spans) is None


def test_call_offsets_follow_a_drift():
    """The offset moving 25 µs a call (seen for seconds on an H100), one
    host late to return: each call's own offset, not a neighbour's."""
    lag = [100 + 25 * k for k in range(30)]
    late = [0] * 30
    late[12] = 10
    recorded, calls, events = _engine_calls(len(lag), lambda k: lag[k], late)
    off = spans_mod.call_offsets(events, spans_mod.spans_ns(recorded))
    assert (off / 1000).tolist() == lag


def test_rounded_stamps_of_adjacent_spans_are_not_lost():
    """Two adjacent spans whose kept µs round the one's end 0.25 µs past the
    other's start: the overlap goes to the later span, nothing to the
    parent, and the sibling's close does not close the later one."""
    recorded = [(float(BASE_US), 10.0, "X", "engine.serve", "engine", "",
                 {"call": 1, "parent": None}),
                (float(BASE_US), 4.25, "X", "engine.densify", "engine", "",
                 {"call": 1, "parent": "engine.serve"}),
                (float(BASE_US) + 4.0, 6.0, "X", "engine.validate", "engine", "",
                 {"call": 1, "parent": "engine.serve"})]
    calls = [(BASE_US * 1000, (BASE_US + 10) * 1000)]
    idle = spans_mod.idle_by_span([], spans_mod.spans_ns(recorded), calls)
    assert idle == pytest.approx({"engine.densify": 4e-6, "engine.validate": 6e-6})


def _tiny(dev, seed=4242424242, traffic=None, **over):
    cfg = tt.tiny_config(**over)
    inv = inputs.Inventory.from_config(cfg)
    tables = inputs.make_tables(torch, inv, seed, dev)
    engine = DeviceServingEngine(
        tables, DEVICES[cfg["sm"]["device"]],
        EngineConfig(hbm_cache_bytes=cfg["cache"]["hbm_bytes"], ways=cfg["cache"]["ways"],
                     num_devices=cfg["sm"]["num_devices"]), torch_device=dev)
    src = inputs.ChunkSource(inputs.TrafficGen(torch, inv, traffic or tt.tiny_traffic("zipf"),
                                               seed, dev))
    return cfg, engine, src


def _serve(engine, src, first, n, bg, calls):
    """Serve chunks ``first ..`` as the harness's window does, each call
    stamped in Unix ns."""
    for i in range(first, first + n):
        while not src.ready(i):
            src.make_next_block()
        raw = src.raw(i)
        t0 = time.time_ns()
        engine.serve_columnar(ColumnarQueries(*raw).whole(), bg)
        calls.append((t0, time.time_ns()))


def test_span_and_counter_metrics_of_a_tiny_cpu_window():
    """On the CPU: the span times and the slot share, no idle share."""
    cfg, engine, src = _tiny("cpu")
    bg = float(cfg["sm"]["bg_iops"])
    _serve(engine, src, 0, 4, bg, [])
    engine.telemetry = make_telemetry(ObsConfig(wall_spans=True))
    calls = []
    _serve(engine, src, 4, 12, bg, calls)
    wall = engine.telemetry.wall
    counters = engine.telemetry.registry.as_dict()["counters"]
    m = spans_mod.metrics(wall.events, calls, counters, wall.dropped)
    assert set(m) == {"densify_span_ms", "account_span_ms", "step_host_ms",
                      "slot_use_share"}
    walls_ms = [(e - s) * 1e-6 for s, e in calls]
    assert 0 < m["densify_span_ms"] + m["account_span_ms"] + m["step_host_ms"] < max(walls_ms)
    assert 0 < m["slot_use_share"] < 100
    # every span lies within its call
    for _, _, s, e in spans_mod.spans_ns(wall.events):
        assert any(a <= s + 500 and e <= b + 500 for a, b in calls)


@pytest.mark.parametrize("trace", [False, True])
def test_the_harness_serves_with_no_telemetry(tmp_path, monkeypatch, trace):
    """An untraced run serves every call with no telemetry; a traced run
    attaches the wall spans for its window only: warm-up serves with none."""
    seen = []
    serve = DeviceServingEngine.serve_columnar

    def spy(self, *args, **kw):
        seen.append(self.telemetry)
        return serve(self, *args, **kw)

    monkeypatch.setattr(DeviceServingEngine, "serve_columnar", spy)
    root = tt.make_root(tmp_path, cells=("tiny-zipf",))
    out = harness.run(root, "tiny-zipf", 7, 0.2, trace, device="cpu")
    assert out["correct"] and seen
    warm = next((k for k, t in enumerate(seen) if t is not None), len(seen))
    assert all(t is None for t in seen[:warm])
    if trace:
        assert 0 < warm < len(seen) and seen[warm].wall is not None
        assert all(t is seen[warm] for t in seen[warm:])
    else:
        assert warm == len(seen)


# -- the card ------------------------------------------------------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


@pytest.mark.cuda
def test_card_copies_lie_in_their_spans_and_idle_adds_up(card):
    """A short profiled window on the card, M1's block ([32, 61, 64]: 61
    tables, pooling 42) over small tables. Once :func:`sdmb_spans.aligned`
    has moved the device records onto the host's clock, each pageable copy
    in starts within its call's ``engine.h2d`` and the first ends in it,
    each pageable copy out lies within its ``engine.d2h``, each within 5
    µs, but in calls (under 1%) inside which the device clock jumped; and
    the three idle shares sum to the trace's idle share within 1 point.
    The second copy in may end after ``engine.h2d``: ``cudaMemcpy`` returns
    from a pageable copy in once its last piece is staged, while that
    piece's transfer still runs."""
    from sdmb_profile import summarize, trace_window
    cfg, engine, src = _tiny(card, traffic=tt.tiny_traffic("zipf", chunk=32,
                                                          block_queries=2048),
                             tables=[[20_000, 42, 1.1, 24]] * 61)
    bg = float(cfg["sm"]["bg_iops"])
    n = 300
    with torch.no_grad():
        _serve(engine, src, 0, 16, bg, [])
        engine.telemetry = make_telemetry(ObsConfig(wall_spans=True))
        while not src.ready(16 + n):
            src.make_next_block()
        torch.cuda.synchronize()
        calls = []
        events, _ = trace_window(torch, lambda: _serve(engine, src, 16, n, bg, calls))
    tel, engine.telemetry = engine.telemetry, None
    assert tel.wall.dropped == 0
    spans = spans_mod.spans_ns(tel.wall.events)
    off = spans_mod.call_offsets(events, spans)
    assert off is not None
    print(f"device clock less the host's, µs: {np.percentile(off, [0, 50, 100]) / 1e3}")
    moved = spans_mod.aligned(events, spans)
    tol, bad = 5_000, set()
    for kind, span in ((spans_mod.COPY_IN, "engine.h2d"), (spans_mod.COPY_OUT, "engine.d2h")):
        inside = np.repeat([(s, e) for n, _, s, e in spans if n == span], 2, axis=0)
        copies = np.array([(st, st + d) for n, st, d in moved if n.startswith(kind)])
        assert copies.shape == inside.shape, (kind, len(copies), len(calls))
        early, late = inside[:, 0] - copies[:, 0], copies[:, 1] - inside[:, 1]
        if span == "engine.h2d":
            late[1::2] = 0                      # the second copy in may run on
        print(f"{span}: a copy starts before it by at most {early.max()} ns, ends "
              f"after it by at most {late.max()} ns")
        bad |= set((np.flatnonzero((early > tol) | (late > tol)) // 2).tolist())
    print(f"calls with a copy outside its span: {sorted(bad)}")
    assert len(bad) <= n // 100
    busy = summarize(events)["busy_s"]
    serving = sum(e - s for s, e in calls) * 1e-9
    device_idle = 100.0 * (1.0 - busy / serving)
    counters = tel.registry.as_dict()["counters"]
    m = spans_mod.metrics(tel.wall.events, calls, counters, tel.wall.dropped, events)
    total = sum(m[f"idle_{g}_share"] for g in ("outside_engine", "engine_host", "step"))
    print(f"device idle {device_idle:.3f}%, by span {total:.3f}%: {m}")
    assert abs(total - device_idle) <= 1.0
    assert m["slot_use_share"] == pytest.approx(100 * 42 / 64)
