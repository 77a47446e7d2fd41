"""One run of one cell of the SDM serving benchmark.

The cell, its configuration, its traffic and its metrics are found by name:
``BENCHMARK.json`` at the checkout's root names them, and the files are
``sdm_bench/configs/<config>.json``, ``sdm_bench/traffic/<traffic>.json``,
``sdm_bench/end_to_end/<metric>.py`` and ``sdm_bench/metrics/<metric>.py``
(each reader a ``read(ctx)`` that returns a number, or None where it finds
nothing to read).

A run: the seeded f32 tables are made on the device and handed to the
program's ``DeviceServingEngine`` (which quantizes them into its store);
the traffic is made in seeded blocks; warm-up serves chunks until the row
cache has taken fills of ``warmup_fills`` times its rows, and at least
``warmup_min_chunks`` chunks; then the window
serves chunk after chunk, closed loop, for ``seconds`` of serving. Each
timed call starts from the chunk's raw CSR arrays: ``ColumnarQueries(...)``,
``.whole()``, ``serve_columnar``; it returns host arrays, so it ends
synchronized. With ``trace`` the window runs under the device profiler and
the per-layer metrics are read; without, the end-to-end ones. Once the
window has closed, the program's state is freed and the plain reference
(``sdmb_reference``) decides ``correct``.

``memory_peak_bytes`` is the window's own peak: the device's peak counter
is reset once set-up has ended (set-up's peak, the program's f32 tables
while it quantizes them, is logged apart).
"""
from __future__ import annotations

import gc
import importlib.util
import json
import math
import os
import pathlib
import resource
import subprocess
import sys
import time
import types
from typing import Dict, List, Optional, Sequence

import numpy as np

import sdmb_inputs as inputs
import sdmb_reference as reference
from sdmb_yardstick import ChunkCounts

BENCH = "sdm_bench"
FORBIDDEN = ("jax", "jaxlib", "flax", "repro", "benchmarks")
SAMPLE_EVERY = 8                 # window chunks whose pooled output is compared: 1 in 8
WARMUP_MAX_CHUNKS = 4096
TRACE_TRAFFIC_MARGIN = 1.5       # traced window: traffic made ahead for 1.5x the warm-up rate


def log(*parts) -> None:
    print(*parts, file=sys.stderr, flush=True)


# -- the cell, found by name -----------------------------------------------------------


def load_cell(root: pathlib.Path, workload: str) -> types.SimpleNamespace:
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    cfg_entry = next(c for c in bench["configs"] if c["name"] == cell["config"])
    e2e = [m for m in bench["end_to_end"] if workload in m.get("workloads", [workload])]
    e2e_names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if (workload in m["workloads"] if "workloads" in m
                     else m["moves"] in e2e_names)]
    return types.SimpleNamespace(
        chips=int(cell["chips"]),
        config=json.loads((root / cfg_entry["file"]).read_text()),
        traffic=json.loads((root / BENCH / "traffic" / f"{cell['traffic']}.json").read_text()),
        end_to_end=e2e, per_layer=per_layer)


def reader(root: pathlib.Path, kind: str, name: str):
    path = root / BENCH / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"sdmb_{kind}_{name.replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules(names: Optional[Sequence[str]] = None) -> List[str]:
    """The forbidden top-level names among ``names`` (the loaded modules by
    default), each compared whole: ``repro_torch`` is not ``repro``."""
    names = list(sys.modules) if names is None else names
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def card_power_limit() -> Optional[str]:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout else None


def cpu_mhz() -> Optional[float]:
    """The mean clock of the host's cores, where the host shows it."""
    try:
        with open("/proc/cpuinfo") as f:
            mhz = [float(line.split(":")[1]) for line in f if line.startswith("cpu MHz")]
    except (OSError, ValueError, IndexError):
        return None
    return sum(mhz) / len(mhz) if mhz else None


def host_state() -> Dict:
    """What the host path competes with: the host's load and clock, this
    process's involuntary context switches and CPU seconds."""
    ru = resource.getrusage(resource.RUSAGE_SELF)
    return {"load1": os.getloadavg()[0], "nivcsw": ru.ru_nivcsw,
            "cpu_s": ru.ru_utime + ru.ru_stime, "mhz": cpu_mhz()}


class GcClock:
    """Seconds and passes of Python's garbage collector while it is on."""

    def __init__(self):
        self.seconds, self.passes, self._t = 0.0, 0, None

    def __call__(self, phase, info):
        if phase == "start":
            self._t = time.perf_counter()
        elif self._t is not None:
            self.seconds += time.perf_counter() - self._t
            self.passes += 1
            self._t = None

    def __enter__(self):
        gc.callbacks.append(self)
        return self

    def __exit__(self, *exc):
        gc.callbacks.remove(self)


def verdict(checks: Dict) -> bool:
    return all(c["value"] <= c["limit"] for c in checks.values())


def sampled(seed: int, k: int) -> bool:
    """Whether window chunk ``k``'s pooled output is compared (1 in
    ``SAMPLE_EVERY``, drawn from the seed)."""
    return inputs.sub_seed(seed, 103, k) % SAMPLE_EVERY == 0


# -- the run ------------------------------------------------------------------------------


def run(root, workload: str, seed: int, seconds: float, trace: bool, *,
        device: str = "cuda", t_start: Optional[float] = None,
        controls: Sequence[str] = ()) -> Dict:
    """One run; returns the result line's object."""
    t0 = time.perf_counter() if t_start is None else t_start
    root = pathlib.Path(root)
    cell = load_cell(root, workload)
    cfg, traffic = cell.config, cell.traffic
    import torch
    from repro_torch.core.columnar import ColumnarQueries
    from repro_torch.core.io_sim import DEVICES
    from repro_torch.kernels import ops
    from repro_torch.runtime.engine import (DeviceServingEngine, EngineConfig,
                                            dense_from_chunk)
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    inv = inputs.Inventory.from_config(cfg)
    T, D = inv.num_tables, inv.dim
    sm, cache = cfg["sm"], cfg["cache"]
    sets, ways = reference.cache_geometry(cache["hbm_bytes"], D, cache["ways"])
    if (sets, ways) != (cache["sets"], cache["ways"]):
        raise ValueError(f"the configuration's cache is {cache['sets']} x {cache['ways']}, "
                         f"its budget gives {sets} x {ways}")
    power = card_power_limit() if cuda else None
    times = {}

    # -- set-up: tables, the program's store, traffic, warm-up -----------------
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    tables = inputs.make_tables(torch, inv, seed, dev)
    engine = DeviceServingEngine(
        tables, DEVICES[sm["device"]],
        EngineConfig(hbm_cache_bytes=cache["hbm_bytes"], ways=cache["ways"],
                     num_devices=sm["num_devices"], item_time_us=cfg["item_time_us"]),
        torch_device=dev)
    del tables
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    if (engine.cache.geo.num_sets, engine.cache.geo.ways) != (sets, ways):
        raise ValueError(f"the program built a {engine.cache.geo.num_sets} x "
                         f"{engine.cache.geo.ways} cache, the configuration states "
                         f"{sets} x {ways}")
    sync()
    times["store_s"] = time.perf_counter() - t
    t = time.perf_counter()
    src = inputs.ChunkSource(inputs.TrafficGen(torch, inv, traffic, seed, dev))
    src.make_next_block()
    sync()
    times["traffic_s"] = time.perf_counter() - t
    bg = float(sm["bg_iops"])
    want_fills = traffic["warmup_fills"] * sets * ways
    min_chunks = int(traffic.get("warmup_min_chunks", 0))
    t = time.perf_counter()
    fills, n_warm, warm_walls = 0, 0, []
    with torch.no_grad():
        while fills < want_fills or n_warm < min_chunks:
            if n_warm >= WARMUP_MAX_CHUNKS:
                raise RuntimeError(f"warm-up: {fills} fills after {n_warm} chunks, "
                                   f"want {want_fills}")
            raw = src.raw(n_warm)
            tw = time.perf_counter()
            _, _, ios = engine.serve_columnar(ColumnarQueries(*raw).whole(), bg)
            warm_walls.append(time.perf_counter() - tw)
            fills += int(ios.sum())
            n_warm += 1
    times["warmup_s"] = time.perf_counter() - t
    if trace:
        # the traced window takes no traffic made inside it: make ahead what
        # 1.5 times the warm-up's rate would serve
        rate = 1.0 / float(np.median(warm_walls[len(warm_walls) // 2:]))
        need = n_warm + int(seconds * rate * TRACE_TRAFFIC_MARGIN) + 1
        while not src.ready(need):
            src.make_next_block()
        sync()
    setup_s = time.perf_counter() - t0
    setup_peak = int(torch.cuda.max_memory_allocated(dev)) if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    host0 = host_state()

    # -- the window ------------------------------------------------------------
    state = engine.state
    hits0, misses0 = int(state["hits"]), int(state["misses"])
    ops.reset_launch_counts()
    win = types.SimpleNamespace(walls=[], ios=[], smt=[], kept={}, serving=0.0,
                                ran_out=False)

    def serve_window():
        k = 0
        while win.serving < seconds:
            i = n_warm + k
            if not src.ready(i):
                if trace:
                    win.ran_out = True
                    break
                src.make_next_block()          # between calls: not timed
                sync()
            raw = src.raw(i)
            tc = time.perf_counter()
            pooled, smt, ios = engine.serve_columnar(ColumnarQueries(*raw).whole(), bg)
            w = time.perf_counter() - tc
            win.serving += w
            win.walls.append(w)
            win.ios.append(ios)
            win.smt.append(smt)
            if sampled(seed, k):
                win.kept[k] = pooled
            win.last = (k, pooled)
            k += 1

    events, marks_lost = None, None
    with torch.no_grad(), GcClock() as gc_clock:
        if trace and cuda:
            from sdmb_profile import trace_window
            events, marks_lost = trace_window(torch, serve_window)
        else:
            serve_window()
    host1 = host_state()
    n_win = len(win.walls)
    if n_win:
        win.kept[win.last[0]] = win.last[1]
    memory_peak = int(torch.cuda.max_memory_allocated(dev)) if cuda else 0
    hits = int(state["hits"]) - hits0
    misses = int(state["misses"]) - misses0
    launches = ops.launch_counts()
    dense_ms = []
    if trace:
        for k in range(n_win):
            ch = ColumnarQueries(*src.raw(n_warm + k)).whole()
            tc = time.perf_counter()
            dense_from_chunk(ch, engine.table_slot, T)
            dense_ms.append((time.perf_counter() - tc) * 1e3)
    tags = (state["tag_table"].clone(), state["tag_row"].clone())
    del engine, state
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    log(f"sdm_bench: {workload} seed {seed}: set-up {setup_s:.3f} s "
        f"({', '.join(f'{k} {v:.3f}' for k, v in times.items())}); warm-up "
        f"{n_warm} chunks, {fills} fills; window {n_win} chunks, {win.serving:.3f} s "
        f"serving; launches {launches}; memory peak: set-up {setup_peak}, window "
        f"{memory_peak}; card {power}")
    log(f"sdm_bench: host over the window: load {host0['load1']:.2f} -> {host1['load1']:.2f}, "
        f"{host1['nivcsw'] - host0['nivcsw']} involuntary switches, "
        f"{host1['cpu_s'] - host0['cpu_s']:.3f} CPU s over {win.serving:.3f} s serving, "
        f"cores at {host0['mhz']} -> {host1['mhz']} MHz, garbage collection "
        f"{gc_clock.seconds:.4f} s in {gc_clock.passes} passes")

    # -- the reference ---------------------------------------------------------
    t = time.perf_counter()
    judged = judge(torch, dev, cfg, inv, src, seed, n_warm, win, hits, misses,
                   tags, sets, ways, bg, want_counts=trace, controls=controls)
    log(f"sdm_bench: reference {time.perf_counter() - t:.3f} s over "
        f"{n_warm + n_win} chunks, {len(win.kept)} pooled outputs compared")

    # -- metrics ---------------------------------------------------------------
    queries = int(sum(len(x) for x in win.ios))
    ctx = types.SimpleNamespace(
        seconds=seconds, serving_s=win.serving, walls=win.walls, queries=queries,
        sm_ios=int(sum(int(x.sum()) for x in win.ios)), setup_s=setup_s,
        counts=judged["counts"], ways=ways, hits=hits, misses=misses,
        events=events, dense_ms=dense_ms, launches=launches, power=power,
        summary=None)
    if events is not None:
        from sdmb_profile import named, summarize
        ctx.summary = summarize(events)
        log("sdm_bench: trace: " + ", ".join(
            f"{k} {named(ctx.summary, k)[0]} records of {launches[k]} launches"
            for k in ("gather_pool", "cache_probe")) + f"; {marks_lost} marks lost; "
            f"{ctx.summary['ops']} device records, busy {ctx.summary['busy_s']:.6f} s")
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        v = reader(root, "metrics" if trace else "end_to_end", m["name"])(ctx)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    checks = judged["checks"]
    correct = verdict(checks)
    device_info = {"platform": "gpu" if cuda else dev.type,
                   "kind": torch.cuda.get_device_name(dev) if cuda else "cpu",
                   "count": 1, "memory_peak_bytes": memory_peak,
                   "setup_peak_bytes": setup_peak, "power_limit": power}
    out = {"correct": correct, "attempted": queries, "failed": 0, "metrics": metrics,
           "device": device_info}
    if trace and ctx.summary is not None:
        device_info["busy_s"] = ctx.summary["busy_s"]
        device_info["window_s"] = win.serving
        device_info["marks_lost"] = marks_lost
        out["breakdown"] = {"device_ops": ctx.summary["device_ops"],
                            "idle_gaps": ctx.summary["idle_gaps"]}
    seg = np.floor(np.cumsum(win.walls) - 1e-12).astype(int)
    log("sdm_bench: calls per serving second " + " ".join(
        str(int(c)) for c in np.bincount(seg)) + "; median call ms "
        f"{float(np.median(win.walls)) * 1e3:.3f}")
    if trace and win.ran_out:
        log(f"sdm_bench: the traced window used up its traffic after "
            f"{win.serving:.3f} s of serving")
    if controls:
        # each control in the program's place: its pooled bags, the rest of the
        # checks as the program's, the same verdict
        out["controls"] = {}
        for kind, gap in judged["controls"].items():
            c = dict(checks, pooled_gap=dict(checks["pooled_gap"], value=gap))
            out["controls"][kind] = {"correct": verdict(c), "checks": c}
    out["checks"] = checks
    return out


def judge(torch, dev, cfg, inv, src, seed, n_warm, win, hits, misses, tags,
          sets, ways, bg, *, want_counts: bool, controls: Sequence[str]) -> Dict:
    """The reference's verdict on the window: every query's SM reads and SM
    time, the window's hits and misses, the cache's tags at its close, and
    the pooled output of the sampled chunks."""
    T = inv.num_tables
    values = torch.as_tensor(inv.values, device=dev)
    store = reference.RefStore(torch, inv, seed, dev)
    store4 = (reference.RefStore(torch, inv, seed, dev, bits=4)
              if "int4_store" in controls else None)
    replay = reference.CacheReplay(torch, sets, ways, inv.offsets, dev)
    offsets = torch.as_tensor(inv.offsets, device=dev)
    null_set = int(reference.set_index(torch, torch.tensor([reference.NULL_KEY]),
                                       torch.tensor([reference.NULL_KEY]), sets)[0])
    ios_diff = smt_diff = 0
    ref_hits = ref_misses = 0
    pooled_gap = 0.0
    control_gap = {k: 0.0 for k in controls}
    counts: List[ChunkCounts] = []
    for i in range(n_warm + len(win.walls)):
        raw = src.raw(i)
        q, t, r, P = inputs.chunk_positions(raw, T)
        tt = torch.as_tensor(t, device=dev)
        rr = torch.as_tensor(r, device=dev)
        hit, io, st = replay.step(tt, rr)
        k = i - n_warm
        if k < 0:
            continue
        B = len(raw[3]) - 1
        qq = torch.as_tensor(q, device=dev)
        bag = qq * T + tt
        io_bt = torch.zeros(B * T, dtype=torch.int64, device=dev)
        io_bt.index_add_(0, bag, io.to(torch.int64))
        io_bt = io_bt.view(B, T).cpu().numpy()
        ref_ios = io_bt.sum(axis=1)
        ref_smt = reference.sm_latency_us(io_bt, cfg["sm"], bg)
        got_ios, got_smt = np.asarray(win.ios[k]), np.asarray(win.smt[k])
        ios_diff += (int(np.sum(got_ios != ref_ios)) if got_ios.shape == ref_ios.shape
                     else B)
        smt_diff += (int(np.sum(got_smt != ref_smt)) if got_smt.shape == ref_smt.shape
                     else B)
        nh = int(hit.sum())
        ref_hits += nh
        ref_misses += len(r) - nh
        if want_counts:
            grow = offsets[tt] + rr
            su = torch.unique(st)
            vals = values[tt]
            hit_rows, first = torch.unique(grow[hit], return_inverse=True)
            row_vals = torch.zeros(hit_rows.numel(), dtype=vals.dtype, device=dev)
            row_vals[first] = vals[hit]
            counts.append(ChunkCounts(
                queries=B, tables=T, width=P, dim=inv.dim, valid=len(r), hits=nh,
                hit_rows=int(hit_rows.numel()),
                unique_misses=int(io.sum()),
                sets_probed=int(su.numel()) + int(B * T * P > len(r)
                                                  and not bool((su == null_set).any())),
                sets_valid=int(su.numel()),
                bag_values=B * int(inv.values.sum()),
                hit_values=int(vals[hit].sum()), miss_values=int(vals[~hit].sum()),
                hit_row_values=int(row_vals.sum()),
                miss_row_values=int(vals[io].sum())))
        if k in win.kept:
            grow = offsets[tt] + rr
            rows = store.rows(grow, torch.float64)
            ref = reference.pool(torch, rows, bag, B * T).view(B, T, -1)
            l1 = reference.pool(torch, store.magnitudes(grow), bag, B * T).view(B, T, -1)
            pooled_gap = max(pooled_gap, reference.pooled_gap(torch, win.kept[k], ref, l1))
            for kind in controls:
                c = reference.control_pool(torch, store4 if kind == "int4_store" else store,
                                           kind, grow, bag, B * T).view(B, T, -1)
                control_gap[kind] = max(control_gap[kind],
                                        reference.pooled_gap(torch, c, ref, l1))
    tag_t, tag_r = tags
    tags_diff = int(((tag_t.to(dev) != replay.tag_t) | (tag_r.to(dev) != replay.tag_r))
                    .sum())
    limits = cfg["limits"]
    checks = {
        "pooled_gap": {"value": pooled_gap, "limit": limits["pooled_gap"]},
        "sm_ios_diff": {"value": ios_diff, "limit": 0},
        "sm_time_diff": {"value": smt_diff, "limit": 0},
        "hits_diff": {"value": abs(hits - ref_hits) + abs(misses - ref_misses), "limit": 0},
        "tags_diff": {"value": tags_diff, "limit": 0},
    }
    for c in checks.values():              # a number JSON can hold
        if isinstance(c["value"], float) and not math.isfinite(c["value"]):
            c["value"] = 1e300
    return {"checks": checks, "counts": counts if want_counts else None,
            "controls": control_gap}
