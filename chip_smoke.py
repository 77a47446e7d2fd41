#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

Phases, one JSON line each:

1. device  -- the card as ``nvidia-smi`` and torch name it; TF32 off.
2. build   -- ``nvcc`` builds every kernel in ``src/repro_torch/csrc`` (one
              process per source, all started together); the registers and
              spills ``-Xptxas -v`` reports for each entry function, and no
              spill allowed.
3. kernels -- each kernel against its plain PyTorch version on the card, at
              the serving path's shapes plus edge cases, and the DLRM
              kernels at ``m1_batch``: 128 queries of the paper's M1 (7,808
              bags of 42 rows of 128 bytes from 16,777,216 rows; 327,936
              probes into a 1,048,576 x 8 x 128 f32 cache), made on the card.
4. main    -- the serving path (``repro_torch.serve_dlrm``: device serving
              engine + DLRM scoring) at the full ``DLRMArch()`` width: four
              batches of 32 queries, then the first batch again. The launch
              counters are zeroed just before and read just after; the same
              run on the CPU must give equal ``sm_ios``, ``latency_us``,
              hit rate and cache state, pooled bags and scores within 1e-5.
5. timing  -- kernel, plain and library times (CUDA events, median of 50
              single calls, 20 at ``m1_batch``, L2 flushed before each) at
              the path's shape and at ``m1_batch``, each kernel's bound from
              those inputs, the timer's floor (a one-element ``zero_()``
              timed the same way), ``gather_pool`` at ``m1_batch`` from an
              L2-resident slice of the store and a plain 4-byte random
              gather of its indices, the median ``serve_batch`` wall time with
              the kernels and with the plain versions, and the profiler's
              device µs per call of each kernel inside the step.
trace_path -- the trace-driven serving path (``serve_dlrm.build_trace_engine``,
              ``DeviceServingEngine.serve_columnar``, ``serve_dlrm.
              serve_trace``) at the paper's M1 inventory: the ``zipf_steady``
              archetype over 61 user tables of 21,730,221 rows in all, cut to
              one row width (D = 128 int8, 136 B with the header), batches of
              32 queries densified to P = 64. (a) 512 queries through a kernel
              engine and a plain engine (``use_kernels=False``) on the card,
              batch by batch in turns, each kernel call held to its plain
              version on that call's inputs: per-query ``sm_ios`` and
              ``sm_time_us`` and the cache state equal, pooled within the
              reference's columnar tolerance of each other and of
              ``reference_pool``, each kernel launched once a batch (the
              counters zeroed just before and read just after); (b) the
              median ``serve_columnar`` wall per batch for both engines in
              turns, ``dense_from_chunk``'s host ms, a profile of 8
              batches (each kernel once a batch), and each kernel's kernel,
              plain and library times and bound on one batch's inputs; (c) the same archetype cut
              to ``table_bytes=4e8`` (2,172,995 rows, tables made with numpy)
              on the card and on the CPU: ``sm_ios``, ``sm_time_us``, hit rate
              and cache state equal, pooled within the tolerance; (d) a
              ``TraceStream`` of 8,192 queries served in pieces of 2,048 on
              the kernel engine: hit rate and latency percentiles.
sharded_path -- the sharded serving engine (``ShardedServingEngine`` through
              ``serve_dlrm.build_trace_engine(shards=n, layout=...)``) over
              trace_path's M1 trace, every shard on the one card through an
              explicit device list (so its times measure per-shard overhead,
              not scale-out). (a) Each layout at 8 shards, a kernel and a
              plain engine batch by batch in turns over the 512 queries,
              every kernel call shadowed by its plain version: per-query
              ``sm_ios`` and ``sm_time_us`` and each shard's cache state
              equal after every batch, pooled within the columnar tolerance
              of ``reference_pool``, each kernel launched 8 times a batch;
              (b) both layouts at 1, 2, 4 and 8 shards beside the
              single-device engine: 1 shard equal to it in everything, every
              count's cold first batch equal to it in per-query ``sm_ios``;
              hit rate, ``sm_ios``, the store's bytes, the median
              ``serve_columnar`` wall and a profile of 8 more batches; (c)
              the 4e8 cut at 4 shards on the card and on the CPU, 8 batches:
              ``sm_ios``, ``sm_time_us``, hit rate and each shard's cache
              state equal, pooled within the tolerance.
6. flash_decode -- the decode-attention kernel against its plain version:
              f32, bf16 and the serving path's f32 query over a bf16
              cache, at the shapes of ``tests/test_kernels.py``, the
              smollm-135m, granite-3-2b (G 4) and granite-34b (G 48, hd
              128) shapes, ragged S, and kv_len 0, 1, S and > S; the
              arrival counters are all 0 afterwards.
7. lm_main -- the LM serving path (``repro_torch.serve_lm``) at the full
              ``smollm-135m`` width: 8 sequences decoded for 256 positions
              of a 1,024-position cache. (a) f32 cache on the card against
              the same run on the CPU, logits within 1e-4; (b) the serving
              bf16 cache: the kernel within 2e-2 of its plain version at
              each of the path's 7,680 calls, on that call's inputs, and
              the logits' gap to a ``use_kernels=False`` run and their
              top-1 agreement reported. Each card run with the kernel
              launches ``flash_decode`` 30 x 256 times; the counters are
              zeroed just before (b)'s first run and read just after.
8. lm_timing -- ``flash_decode`` kernel, plain and SDPA times with their
              bounds (bytes, f32 operations) at the path's shape, one
              ``decode_32k`` layer (also by split count) and one granite-34b
              layer (B 8, S = kv_len 8,192, H 48 over K 1, hd 128), and the
              median ``decode_step`` wall per token with the kernel and with
              the plain version, with the profiler's device time; the
              profile must show one ``flash_decode`` kernel per layer and no
              combine kernel.

Then the ``kernels`` summary line, and last
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Any failed check raises, so the script exits non-zero; without CUDA it exits
non-zero before printing any result.

Run from the repository root: python3 chip_smoke.py. With ``--kernels`` it
runs phases 1-3 and the kernel times of phase 5 only, and prints no ``ok``
line (a quick check of the DLRM kernels, or of another checkout's).
"""
from __future__ import annotations

import json
import os
import re
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

HBM_BYTES_PER_S = 3.35e12        # H100 SXM device memory rate
FP32_OPS_PER_S = 67e12           # H100 SXM float32 outside the tensor cores
GATHER_POOL_TOL = dict(rtol=1e-5, atol=1e-4)   # as tests/test_kernels.py
CACHE_PROBE_TOL = dict(rtol=0.0, atol=1e-6)
SERVE_TOL = 1e-5
BF16_OPS_PER_S = 989e12          # H100 SXM dense bf16 on the tensor cores
FLASH_DECODE_TOL = {"f32": 1e-5, "bf16": 2e-2, "path": 2e-2}  # tests/test_kernels.py:124
LM_CARD_VS_CPU_TOL = 1e-4
LM_BATCH, LM_TOKENS, LM_MAX_LEN = 8, 256, 1024
SPIN_CYCLES = 1_000_000          # about 0.5 ms at the H100's clock
# m1_batch: 128 queries of the paper's M1 (src/repro/configs/dlrm_models.py:4-19):
# 61 user tables pooling 42 rows each, 128-byte rows (136 with scale and bias)
M1_GATHER_POOL = dict(R=1 << 24, D=128, N=128 * 61, P=42)
M1_CACHE_PROBE = dict(S=1 << 20, W=8, D=128, N=128 * 61 * 42)
# trace_path: the zipf_steady archetype over the M1 inventory of the reference's
# examples/serve_dlrm.py:75-81 (61 user tables, table_bytes 4e9), one row width
TRACE_ARCHETYPE, TRACE_QUERIES, TRACE_BATCH, TRACE_DIM, TRACE_P = "zipf_steady", 512, 32, 128, 64
TRACE_TABLE_BYTES, TRACE_ROWS = 4e9, 21_730_221
TRACE_CUT_BYTES, TRACE_CUT_ROWS = 4e8, 2_172_995   # (c): card vs CPU
TRACE_TIMED = 16                 # timed batches of phase trace_path (b)
TRACE_STREAM_QUERIES, TRACE_STREAM_PIECE = 8192, 2048
TRACE_BG_IOPS = 10_000.0
# bags of 42-64 rows sum to tens, where float32 summation order moves the last
# bits by more than 1e-5: the reference's tolerance for serve_columnar
# (tests/test_sharded_engine.py:198)
TRACE_POOL_TOL = dict(rtol=1e-5, atol=1e-5)
# sharded_path: trace_path's M1 trace through the sharded engine, the shards
# sharing the one card through an explicit device list
SHARD_LAYOUTS, SHARD_COUNTS = ("row", "table"), (1, 2, 4, 8)
SHARD_CHECKED = 8                # shards of (a), kernel vs plain engine
SHARD_CUT, SHARD_CUT_BATCHES = 4, 8   # (c): shards and batches, card vs CPU
SHARD_PROFILED = 8               # profiled batches of (b)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def ptxas_summary(log: str, nvcc: str) -> list:
    """[kernel, registers, spill store bytes, spill load bytes] for each entry
    function in an ``nvcc -Xptxas -v`` log, names demangled by ``cu++filt``
    when the toolkit has it."""
    rows, fn, spill = [], None, (0, 0)
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            fn, spill = m.group(1), (0, 0)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
        if m:
            spill = (int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers", ln)
        if m and fn:
            rows.append([fn, int(m.group(1)), *spill])
            fn = None
    cufilt = os.path.join(os.path.dirname(nvcc), "cu++filt")
    if rows and os.path.exists(cufilt):
        names = subprocess.run([cufilt], input="\n".join(r[0] for r in rows),
                               capture_output=True, text=True, timeout=60).stdout.split("\n")
        for r, name in zip(rows, names):
            name = re.sub(r"\(anonymous namespace\)::|<unnamed>::|\(int\)", "",
                          name.strip())
            if name.endswith(")"):
                r[0] = name[:name.rfind("(")].removeprefix("void ")
    return rows


def bound_ms(nbytes: float, nops: float, ops_per_s: float = FP32_OPS_PER_S):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = nops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


class Timer:
    """Device time of one call (CUDA events), L2 flushed before each sample
    by reading a 128 MB buffer: a read leaves no dirty lines whose write-back
    would overlap the timed call. The device then spins for about half a
    millisecond, so the host has queued the call before the first event is
    reached and its launch overhead is not timed. Median and spread of
    ``reps`` samples."""

    def __init__(self, torch, reps: int = 50, warmup: int = 5):
        self.torch, self.reps, self.warmup = torch, reps, warmup
        self.flush = torch.ones(32 << 20, dtype=torch.float32, device="cuda")
        torch.cuda.synchronize()

    def ms(self, fn, reps: int = 0) -> dict:
        torch = self.torch
        for _ in range(self.warmup):
            fn()
        samples = []
        for _ in range(reps or self.reps):
            self.flush.sum()
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(SPIN_CYCLES)
            a.record()
            fn()
            b.record()
            b.synchronize()
            samples.append(a.elapsed_time(b))
        return {"median": statistics.median(samples), "min": min(samples),
                "max": max(samples)}


def gather_pool_cases(torch, np, rng):
    """(label, payload, scale, bias, idx) on the card; the first is the
    serving path's shape: the 8 user tables' 800,000 rows + sentinel, D=64,
    B*T = 256 bags of P = 8."""
    def case(label, R, D, N, P, dtype, idx=None):
        lo, hi = (0, 256) if dtype == np.uint8 else (-127, 128)
        payload = rng.integers(lo, hi, (R, D)).astype(dtype)
        scale = (rng.random(R) * 0.1).astype(np.float32)
        bias = rng.standard_normal(R).astype(np.float32)
        if idx is None:
            idx = rng.integers(0, R, (N, P)).astype(np.int32)
        return (label,) + tuple(torch.from_numpy(a).cuda()
                                for a in (payload, scale, bias, idx))
    return [
        case("main_u8", 800_001, 64, 256, 8, np.uint8),
        case("main_i8", 800_001, 64, 256, 8, np.int8),
        case("d96_u8", 100_001, 96, 256, 8, np.uint8),
        case("d24_i8", 4_096, 24, 33, 5, np.int8),
        case("dup_u8", 64, 16, 4, 8, np.uint8,
             idx=np.array([[3] * 8, [5, 5, 6, 6, 7, 7, 3, 3], [63] * 8,
                           [0] * 8], np.int32)),
    ]


def cache_probe_cases(torch, np, rng):
    """(label, tag_table, tag_row, data, q_table, q_row, sets) on the card;
    the first is the serving path's geometry (8 MB cache of 72-byte rows:
    13,107 sets x 8 ways, D = 64) and probe count (B*T*P = 2048), with a
    full cache and half the probes hitting."""
    def case(label, S, W, D, N):
        tt = rng.integers(0, 8, (S, W)).astype(np.int32)
        tr = rng.integers(0, 100_000, (S, W)).astype(np.int32)
        tt[rng.random((S, W)) < 0.1] = -1                  # some empty ways
        data = rng.standard_normal((S, W, D)).astype(np.float32)
        sets = rng.integers(0, S, N).astype(np.int32)
        way = rng.integers(0, W, N)
        qt = rng.integers(0, 8, N).astype(np.int32)
        qr = rng.integers(100_000, 200_000, N).astype(np.int32)  # absent rows
        hit = rng.random(N) < 0.5
        qt[hit], qr[hit] = tt[sets[hit], way[hit]], tr[sets[hit], way[hit]]
        return (label,) + tuple(torch.from_numpy(a).cuda()
                                for a in (tt, tr, data, qt, qr, sets))
    main = case("main", 13_107, 8, 64, 2048)
    # a set holding one key in two ways: the probe sums both rows
    two = list(case("two_ways", 4, 4, 24, 3))
    for plane in (1, 2):
        two[plane][2, :] = -1
        two[plane][2, 1] = two[plane][2, 3] = 7
    two[4][:] = 7
    two[5][:] = 7
    two[1][0, :] = -1                          # set 0 empty: query 2 misses
    two[6][:] = torch.tensor([2, 2, 0], dtype=torch.int32)
    return [main, case("w32", 64, 32, 96, 500), tuple(two)]


def m1_gather_pool_case(torch, R, D, N, P):
    """``m1_batch`` for ``gather_pool``, made on the card from a seeded
    generator: N bags of P uniform rows of a uint8 store of R rows of D."""
    g = torch.Generator(device="cuda").manual_seed(14)
    payload = torch.randint(0, 256, (R, D), generator=g, device="cuda", dtype=torch.uint8)
    scale = torch.rand(R, generator=g, device="cuda") * 0.1
    bias = torch.randn(R, generator=g, device="cuda")
    idx = torch.randint(0, R, (N, P), generator=g, device="cuda", dtype=torch.int32)
    return "m1_batch", payload, scale, bias, idx


def m1_cache_probe_case(torch, S, W, D, N):
    """``m1_batch`` for ``cache_probe``, made on the card as
    ``cache_probe_cases`` makes its cases: a full S x W x D cache with some
    empty ways and half of the N probes aimed at a resident key."""
    g = torch.Generator(device="cuda").manual_seed(15)

    def ints(lo, hi, shape):
        return torch.randint(lo, hi, shape, generator=g, device="cuda", dtype=torch.int32)
    tt, tr = ints(0, 8, (S, W)), ints(0, 100_000, (S, W))
    tt[torch.rand((S, W), generator=g, device="cuda") < 0.1] = -1
    data = torch.randn((S, W, D), generator=g, device="cuda")
    sets, way = ints(0, S, (N,)), ints(0, W, (N,)).long()
    qt, qr = ints(0, 8, (N,)), ints(100_000, 200_000, (N,))
    hit = torch.rand(N, generator=g, device="cuda") < 0.5
    slot = (sets.long()[hit], way[hit])
    qt[hit], qr[hit] = tt[slot], tr[slot]
    return "m1_batch", tt, tr, data, qt, qr, sets


def embedding_bag_call(torch, payload, scale, bias, idx):
    """The library yardstick for ``gather_pool``: PyTorch's row-wise
    quantized embedding bag, on the fused [R, D + 8] rows it takes (the
    uint8 payload, then the f32 scale and bias), built here outside the timed
    call. Timed only; the port never calls it. (callable, None) or (None,
    reason)."""
    if payload.dtype != torch.uint8:
        return None, "takes uint8 rows only"
    fused = torch.cat([payload, scale[:, None].view(torch.uint8),
                       bias[:, None].view(torch.uint8)], dim=1)
    flat = idx.reshape(-1)
    offsets = torch.arange(0, flat.numel(), idx.shape[1], dtype=torch.int32,
                           device=idx.device)
    op = torch.ops.quantized.embedding_bag_byte_rowwise_offsets

    def call():
        return op(fused, flat, offsets)
    try:
        call()
        torch.cuda.synchronize()
    except Exception as e:                     # a yardstick only: report why not
        return None, f"{type(e).__name__}: {str(e).strip().splitlines()[0][:300]}"
    return call, None


def device_profile(torch, run, nb: int, named=()):
    """Per step of ``run`` (which runs ``nb`` steps) under ``torch.profiler``:
    the device's busy time (one stream, so the sum of its kernels, copies and
    fills), the number of device operations, the heaviest ones by name, and
    the number and device µs of those whose name holds each string of
    ``named``."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:   # device events only
        run()
        torch.cuda.synchronize()
    by_name = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            n, us = by_name.get(e.name, (0, 0.0))
            by_name[e.name] = (n + 1, us + e.time_range.elapsed_us())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:8]
    return {"device_busy_us": sum(us for _, us in by_name.values()) / nb,
            "device_ops": sum(n for n, _ in by_name.values()) / nb,
            "top_us": [[name[:70], n / nb, us / nb] for name, (n, us) in top],
            "ops_named": {key: sum(n for name, (n, _) in by_name.items() if key in name) / nb
                          for key in named},
            "us_named": {key: sum(us for name, (_, us) in by_name.items() if key in name) / nb
                         for key in named}}


def gather_pool_bytes_ops(payload, idx):
    N, P = idx.shape
    D = payload.shape[1]
    rows = int(idx.unique().numel())           # each distinct row read once
    nbytes = N * P * 4 + rows * (D * payload.element_size() + 8) + N * D * 4
    return nbytes, 3 * N * P * D


def cache_probe_bytes_ops(tt, data, qt, hit_slots, sets):
    N = qt.shape[0]
    W, D = data.shape[1], data.shape[2]
    n_sets = int(sets.unique().numel())        # each distinct tag line once
    nbytes = N * 12 + n_sets * 2 * W * 4 + hit_slots * D * 4 + N * (D * 4 + 4)
    return nbytes, N * W * 2


def gather_pool_times(torch, timer, case, reps: int = 0) -> dict:
    """Kernel, plain and library times of ``gather_pool`` on one case, with
    its bound from the case's inputs."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.gather_pool import gather_pool
    label, payload, scale, bias, idx = case
    got = gather_pool(payload, scale, bias, idx)
    lib, reason = embedding_bag_call(torch, payload, scale, bias, idx)
    lib_diff = None
    if lib is not None:
        torch.testing.assert_close(lib(), got, **GATHER_POOL_TOL,
                                   msg=f"embedding_bag_byte_rowwise_offsets at {label}")
        lib_diff = float((lib() - got).abs().max())
    R, D = payload.shape
    N, P = idx.shape
    out = {"shape": {"R": R, "D": D, "N": N, "P": P, "dtype": str(payload.dtype)},
           "ms": timer.ms(lambda: gather_pool(payload, scale, bias, idx), reps),
           "plain_ms": timer.ms(lambda: ref.gather_pool_ref(payload, scale, bias, idx), reps),
           "library_ms": timer.ms(lib, reps) if lib is not None else None,
           "library": ("torch.ops.quantized.embedding_bag_byte_rowwise_offsets"
                       if lib is not None else reason),
           "library_max_abs_diff": lib_diff}
    out["bound_ms"], out["bound_by"] = bound_ms(*gather_pool_bytes_ops(payload, idx))
    return out


def gather_pool_access_times(torch, timer, case, reps: int = 20) -> dict:
    """What holds ``gather_pool`` at ``m1_batch``: the same call with every
    index folded into the store's first 65,536 rows (8.9 MB, which L2 holds
    after the first touch), and one PyTorch gather of the same indices from
    ``scale`` alone (4-byte random reads: the card's rate of random
    accesses; the kernel makes three a row, payload, scale and bias)."""
    from repro_torch.kernels.gather_pool import gather_pool
    _, payload, scale, bias, idx = case
    near = (idx % (1 << 16)).contiguous()
    flat = idx.reshape(-1)
    return {"l2_rows_ms": timer.ms(lambda: gather_pool(payload, scale, bias, near), reps),
            "scale_gather_ms": timer.ms(lambda: scale.index_select(0, flat), reps),
            "random_accesses": 3 * idx.numel()}


def cache_probe_times(torch, timer, case, reps: int = 0) -> dict:
    """Kernel and plain times of ``cache_probe`` on one case, with its bound
    from the case's inputs (no PyTorch call probes a set-associative cache)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.cache_probe import cache_probe
    _, tt, tr, data, qt, qr, sets = case
    hits = int(cache_probe(tt, tr, data, qt, qr, sets)[1].sum())
    S, W, D = data.shape
    out = {"shape": {"S": S, "W": W, "D": D, "N": qt.shape[0]}, "hits": hits,
           "ms": timer.ms(lambda: cache_probe(tt, tr, data, qt, qr, sets), reps),
           "plain_ms": timer.ms(lambda: ref.cache_probe_ref(tt, tr, data, qt, qr, sets), reps),
           "library_ms": None}
    out["bound_ms"], out["bound_by"] = bound_ms(*cache_probe_bytes_ops(tt, data, qt, hits, sets))
    return out


def dlrm_kernel_times(torch, timer, gp_cases, cp_cases) -> dict:
    """Phase 5's kernel times: each DLRM kernel at the path's shape (the
    first case) and at ``m1_batch`` (the last), what holds ``gather_pool``
    there, and the timer's floor, a one-element ``zero_()`` timed the same
    way."""
    tiny = torch.zeros(1, device="cuda")
    return {"timer_floor_ms": timer.ms(lambda: tiny.zero_()),
            "gather_pool": {"path": gather_pool_times(torch, timer, gp_cases[0]),
                            "m1_batch": gather_pool_times(torch, timer, gp_cases[-1], 20),
                            "m1_batch_access": gather_pool_access_times(torch, timer,
                                                                         gp_cases[-1])},
            "cache_probe": {"path": cache_probe_times(torch, timer, cp_cases[0]),
                            "m1_batch": cache_probe_times(torch, timer, cp_cases[-1], 20)}}


def kernel_entry(times, name, trace_times) -> dict:
    """A DLRM kernel's timing keys of the ``kernels`` line: medians at the
    path's shape, then at ``m1_batch`` and on the trace path's inputs,
    beside the timer's floor."""
    def medians(t):
        return {"ms": t["ms"]["median"], "plain_ms": t["plain_ms"]["median"],
                "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
                "library_ms": (t["library_ms"] or {}).get("median")}
    return {**medians(times[name]["path"]), "m1_batch": medians(times[name]["m1_batch"]),
            "trace_path": medians(trace_times[name]),
            "timer_floor_ms": times["timer_floor_ms"]["median"]}


def flash_decode_cases(torch, np, rng):
    """(label, dtype label, q, k, v, kv_len) on the card. Rows 0-3 of a case
    with four or more rows take kv_len 0, 1, S and S + 5."""
    shapes = [("mha", 1, 4, 4, 32, 512), ("gqa4", 2, 8, 2, 64, 1024),
              ("mqa", 2, 16, 1, 128, 512), ("smollm", 8, 9, 3, 64, 1024),
              ("ragged", 4, 9, 3, 64, 1000), ("ragged_hd16", 5, 6, 2, 16, 77),
              ("granite_3_2b", 5, 32, 8, 64, 300), ("granite_34b", 4, 48, 1, 128, 1000)]
    dtypes = [("f32", torch.float32, torch.float32),
              ("bf16", torch.bfloat16, torch.bfloat16),
              ("path", torch.float32, torch.bfloat16)]   # f32 q over a bf16 cache
    cases = []
    for label, B, H, K, hd, S in shapes:
        kv_len = rng.integers(1, S + 1, B)
        if B >= 4:
            kv_len[:4] = [0, 1, S, S + 5]
        for dlabel, qdt, kvdt in dtypes:
            q, k, v = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
                       .to("cuda", dt) for shape, dt in (((B, H, hd), qdt),
                                                         ((B, S, K, hd), kvdt),
                                                         ((B, S, K, hd), kvdt)))
            cases.append((f"{label}_{dlabel}", dlabel, q, k, v,
                          torch.from_numpy(kv_len.astype(np.int32)).cuda()))
    return cases


def flash_decode_bytes_ops(q, k, kv_len):
    """Bytes and operations this call needs: each row's keys and values up
    to min(kv_len, S) read once (all S when kv_len <= 0, as the function
    averages v then), q read once, the f32 output written once; two
    multiply-adds per (query head, position, element)."""
    B, H, hd = q.shape
    S, K = k.shape[1], k.shape[2]
    lens = kv_len.clamp(max=S)
    rows = int(lens.masked_fill(lens <= 0, S).sum())
    nbytes = 2 * rows * K * hd * k.element_size() + q.numel() * q.element_size() \
        + B * H * hd * 4
    return nbytes, 4 * rows * H * hd


def sdpa_call(torch, q, k, v, L):
    """The library yardstick: one SDPA call for one query token over the
    first L positions with the GQA head mapping. Timed only; the port never
    calls it. (callable, None) or (None, reason)."""
    from torch.nn import functional as F
    qs, ks, vs = q[:, :, None], k[:, :L].transpose(1, 2), v[:, :L].transpose(1, 2)

    def call():
        return F.scaled_dot_product_attention(qs, ks, vs, enable_gqa=True)
    try:
        call()
    except TypeError as e:                     # a torch without enable_gqa
        return None, f"torch {torch.__version__} SDPA: {e}"
    return call, None


def shadowed_dlrm_kernels(torch, ops, ref):
    """Wrap the DLRM kernels' entries in ``ops`` so that each kernel call also
    runs the plain version on the same inputs (no launch, so the counters
    do not move). Returns (restore, check, last): ``check()`` raises if any
    call disagreed and returns the largest difference of each kernel;
    ``last`` holds each kernel's inputs of its last call, the probe's cache
    state cloned (the fill updates it in place; nothing writes the store)."""
    gp_call, cp_call = ops.embedding_gather_pool, ops.row_cache_probe
    last = {}
    worst = {"gather_pool": torch.zeros((), device="cuda"),
             "cache_probe": torch.zeros((), device="cuda")}
    bad = torch.zeros((), dtype=torch.bool, device="cuda")

    def gather_pool(payload, scale, bias, indices, *, use_kernel=True):
        out = gp_call(payload, scale, bias, indices, use_kernel=use_kernel)
        if use_kernel:
            last["gather_pool"] = (payload, scale, bias, indices)
            want = ref.gather_pool_ref(payload, scale, bias, indices)
            torch.maximum(worst["gather_pool"], (out - want).abs().max(),
                          out=worst["gather_pool"])
            bad.logical_or_(~torch.isclose(out, want, **GATHER_POOL_TOL).all())
        return out

    def cache_probe(*args, use_kernel=True):
        vals, hit = cp_call(*args, use_kernel=use_kernel)
        if use_kernel:
            last["cache_probe"] = tuple(a.clone() for a in args)
            vals_ref, hit_ref = ref.cache_probe_ref(*args)
            torch.maximum(worst["cache_probe"], (vals - vals_ref).abs().max(),
                          out=worst["cache_probe"])
            bad.logical_or_((hit != hit_ref).any())
            bad.logical_or_(~torch.isclose(vals, vals_ref, **CACHE_PROBE_TOL).all())
        return vals, hit

    def restore():
        ops.embedding_gather_pool, ops.row_cache_probe = gp_call, cp_call

    def check():
        if bool(bad):
            raise AssertionError(f"a DLRM kernel call disagreed with its plain "
                                 f"version: {worst}")
        return {k: float(v) for k, v in worst.items()}
    ops.embedding_gather_pool, ops.row_cache_probe = gather_pool, cache_probe
    return restore, check, last


def trace_kernel_times(torch, timer, got) -> dict:
    """Kernel, plain and library times of both DLRM kernels on the inputs
    one batch of the trace path gave them (``got``), with their bounds, and two probes
    of what holds ``gather_pool`` there: the same call with every sentinel
    slot (a hit or a padded position) sent to a random one of the store's
    first 65,536 rows instead (8.9 MB, which L2 holds after the first
    touch), and with every slot the sentinel."""
    from repro_torch.kernels.gather_pool import gather_pool
    payload, scale, bias, idx = got["gather_pool"]
    sentinel = payload.shape[0] - 1
    g = torch.Generator(device="cuda").manual_seed(16)
    spread = torch.where(idx == sentinel,
                         torch.randint(0, min(1 << 16, sentinel), idx.shape, generator=g,
                                       device="cuda", dtype=torch.int32), idx)
    same = torch.full_like(idx, sentinel)
    return {"gather_pool": gather_pool_times(torch, timer, ("trace_path", *got["gather_pool"]),
                                             20),
            "gather_pool_access": {
                "sentinel_slots": int((idx == sentinel).sum()),
                "distinct_rows": int(idx.unique().numel()),
                "spread_l2_ms": timer.ms(lambda: gather_pool(payload, scale, bias, spread),
                                         20),
                "all_sentinel_ms": timer.ms(lambda: gather_pool(payload, scale, bias, same),
                                            20)},
            "cache_probe": cache_probe_times(torch, timer, ("trace_path", *got["cache_probe"]),
                                             20)}


def pool_gap(np, a, b) -> float:
    """The largest ``|a - b| / (atol + rtol |b|)`` under ``TRACE_POOL_TOL``:
    at most 1 is within the tolerance."""
    tol = TRACE_POOL_TOL
    return float((np.abs(a - b) / (tol["atol"] + tol["rtol"] * np.abs(b))).max())


def trace_path(torch, np, timer, smi) -> dict:
    """Phase ``trace_path``; returns the launches of its main run (a), each
    kernel's largest difference from its plain version there, its device µs
    per call and its times at the path's shapes."""
    from repro_torch import serve_dlrm
    from repro_torch.core.io_sim import DEVICES
    from repro_torch.kernels import ops, ref
    from repro_torch.runtime.engine import (DeviceServingEngine, EngineConfig,
                                            dense_from_chunk)
    from repro_torch.workloads import TraceStream, build_trace

    B, D, name = TRACE_BATCH, TRACE_DIM, TRACE_ARCHETYPE
    kernel_names = ("gather_pool", "cache_probe")
    t_phase = time.perf_counter()
    spec = serve_dlrm.m1_spec(name, queries=TRACE_QUERIES, table_bytes=TRACE_TABLE_BYTES)
    t0 = time.perf_counter()
    trace = build_trace(spec)
    build_trace_s = time.perf_counter() - t0
    users = [m for m in trace.all_metas() if m.kind == "user"]
    rows = sum(m.num_rows for m in users)
    if (len(users), rows) != (61, TRACE_ROWS):
        raise AssertionError(f"M1 inventory: {len(users)} tables, {rows} rows")
    keys = trace.queries.group().keys_g()

    # (a) kernel engine vs plain engine on the card, batch by batch in turns
    t0 = time.perf_counter()
    kern = serve_dlrm.build_trace_engine(spec, D, seed=0, torch_device="cuda",
                                         cfg=EngineConfig())
    plain = serve_dlrm.build_trace_engine(spec, D, seed=0, torch_device="cuda",
                                          cfg=EngineConfig(use_kernels=False))
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    setup_s = time.perf_counter() - t0
    for attr in ("payload", "scale", "bias"):
        if not torch.equal(getattr(kern, attr), getattr(plain, attr)):
            raise AssertionError(f"seeded stores differ in {attr}")
    T = len(kern.table_ids)
    chunks = list(trace.chunks(B))
    restore, check, last = shadowed_dlrm_kernels(torch, ops, ref)
    gap = {"kernel_vs_plain": 0.0, "kernel_vs_reference_pool": 0.0,
           "plain_vs_reference_pool": 0.0}
    max_abs = 0.0
    shapes = set()
    ops.reset_launch_counts()
    try:
        for i, ch in enumerate(chunks):
            pk, tk, ik = kern.serve_columnar(ch.columnar, TRACE_BG_IOPS)
            pp, tp, ip = plain.serve_columnar(ch.columnar, TRACE_BG_IOPS)
            if ik.tolist() != ip.tolist() or tk.tolist() != tp.tolist():
                raise AssertionError(f"batch {i}: sm_ios or sm_time_us differ "
                                     "between the kernel and plain engines")
            idx, valid = dense_from_chunk(ch.columnar, kern.table_slot, T)
            shapes.add(idx.shape)
            want = kern.reference_pool(idx, valid)
            if pk.shape != (B, T, D) or not np.isfinite(pk).all():
                raise AssertionError(f"batch {i}: pooled {pk.shape} not finite")
            for key, (a, b) in {"kernel_vs_plain": (pk, pp),
                                "kernel_vs_reference_pool": (pk, want),
                                "plain_vs_reference_pool": (pp, want)}.items():
                gap[key] = max(gap[key], pool_gap(np, a, b))
            max_abs = max(max_abs, float(np.abs(pk - pp).max()),
                          float(np.abs(pk - want).max()))
        torch.cuda.synchronize()
    finally:
        restore()
    launches = ops.launch_counts()
    kernel_err = check()
    if any(launches[k] != len(chunks) for k in kernel_names):
        raise AssertionError(f"trace path: {launches} launches over {len(chunks)} "
                             "batches, want each DLRM kernel once a batch")
    if max(gap.values()) > 1.0:
        raise AssertionError(f"trace path pooled outside {TRACE_POOL_TOL}: {gap}")
    if shapes != {(B, T, TRACE_P)}:
        raise AssertionError(f"trace path blocks {shapes}, want ({B}, {T}, {TRACE_P})")
    for k, v in kern.state.items():
        if not torch.equal(v, plain.state[k]):
            raise AssertionError(f"cache state {k} differs between the kernel "
                                 "and plain engines")
    hit_rate_a = kern.hit_rate
    emit({"phase": "trace_path", "part": "a_kernel_vs_plain", "archetype": name,
          "queries": len(trace), "batch": B, "batches": len(chunks),
          "tables": T, "rows": rows, "dim": D, "block": [B, T, TRACE_P],
          "keys": int(len(keys)), "distinct_keys": int(len(np.unique(keys))),
          "valid_positions": int(trace.queries.seg_offsets[-1]),
          "block_positions": len(chunks) * B * T * TRACE_P,
          "reduced": ["one row width for every table: D = 128 int8 (136 B with "
                      "the header) instead of 90-172 B a table"],
          "cache_sets": kern.cache.geo.num_sets, "cache_ways": kern.cache.geo.ways,
          "launches": launches, "hit_rate": hit_rate_a,
          "sm_ios": int(kern.stats.sm_ios), "kernel_vs_plain_per_call": kernel_err,
          "pooled_max_abs": max_abs, "pooled_gap_over_tolerance": gap,
          "tolerance": TRACE_POOL_TOL, "build_trace_s": build_trace_s,
          "setup_s": setup_s})

    # (b) timing: a longer trace of the same inventory (other draws: the RNG
    # stream shifts with the query count), both engines in turns, then a
    # profile of 8 batches of each
    timing = list(build_trace(serve_dlrm.m1_spec(
        name, queries=B * (TRACE_TIMED + 8), table_bytes=TRACE_TABLE_BYTES)).chunks(B))
    walls = {"kernels": [], "plain": []}
    dense_ms = []
    for i, ch in enumerate(timing[:TRACE_TIMED]):
        t0 = time.perf_counter()
        dense_from_chunk(ch.columnar, kern.table_slot, T)
        dense_ms.append((time.perf_counter() - t0) * 1e3)
        for label, eng in (("kernels", kern), ("plain", plain)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            eng.serve_columnar(ch.columnar, TRACE_BG_IOPS)
            if i >= 2:                         # first batches warm up
                walls[label].append((time.perf_counter() - t0) * 1e3)
    wall_ms = {k: statistics.median(v) for k, v in walls.items()}
    prof = {label: device_profile(
                torch, lambda eng=eng: [eng.serve_columnar(ch.columnar, TRACE_BG_IOPS)
                                        for ch in timing[TRACE_TIMED:]], 8,
                named=kernel_names)
            for label, eng in (("kernels", kern), ("plain", plain))}
    for label, p in prof.items():             # no device events: not measured
        p["idle_share"] = (1.0 - p["device_busy_us"] / (wall_ms[label] * 1e3)
                           if p["device_ops"] else None)
    named = prof["kernels"]["ops_named"]
    if any(named[k] != 1 for k in kernel_names):
        raise AssertionError(f"serve_columnar profile: {named} kernels per batch, "
                             "want one each")
    device_us = {k: prof["kernels"]["us_named"][k] / named[k] for k in kernel_names}
    times = trace_kernel_times(torch, timer, last)    # run (a)'s last batch
    del last
    emit({"phase": "trace_path", "part": "b_timing", "card": smi,
          "serve_columnar_ms_median": wall_ms,
          "serve_columnar_ms_min": {k: min(v) for k, v in walls.items()},
          "serve_columnar_batches": len(walls["kernels"]),
          "dense_from_chunk_ms_median": statistics.median(dense_ms),
          "device_us_per_call": device_us, "kernel_times": times,
          "kernel_shapes": {
              "gather_pool": {"N": B * T, "P": TRACE_P, "D": D,
                              "R": int(kern.payload.shape[0])},
              "cache_probe": {"N": B * T * TRACE_P, "S": kern.cache.geo.num_sets,
                              "W": kern.cache.geo.ways, "D": D}},
          "profile": prof})

    # (c) the 4e8 cut on the card and on the CPU, tables made with numpy
    del plain
    torch.cuda.empty_cache()
    cut = serve_dlrm.m1_spec(name, queries=TRACE_QUERIES, table_bytes=TRACE_CUT_BYTES)
    cut_trace = build_trace(cut)
    rng = np.random.default_rng(7)
    tables = {m.table_id: rng.standard_normal((m.num_rows, D), dtype=np.float32)
              for m in cut_trace.all_metas() if m.kind == "user"}
    cut_rows = sum(t.shape[0] for t in tables.values())
    if cut_rows != TRACE_CUT_ROWS:
        raise AssertionError(f"the 4e8 cut has {cut_rows} rows")
    res, engines, run_s = {}, {}, {}
    for dev in ("cuda", "cpu"):
        t0 = time.perf_counter()
        engines[dev] = DeviceServingEngine(tables, DEVICES["nand_flash"],
                                           EngineConfig(), torch_device=dev)
        res[dev] = serve_dlrm.serve_trace(engines[dev], cut_trace, B, TRACE_BG_IOPS,
                                          keep_pooled=True)
        run_s[dev] = time.perf_counter() - t0
    del tables
    card, host = engines["cuda"], engines["cpu"]
    for f in ("sm_ios", "sm_time_us", "latency_us"):
        if getattr(res["cuda"], f).tolist() != getattr(res["cpu"], f).tolist():
            raise AssertionError(f"4e8 cut: {f} differs between card and CPU")
    if card.hit_rate != host.hit_rate:
        raise AssertionError("4e8 cut: hit rate differs between card and CPU")
    for k, v in card.state.items():
        if not torch.equal(v.cpu(), host.state[k]):
            raise AssertionError(f"4e8 cut: cache state {k} differs between card and CPU")
    cut_gap = max(pool_gap(np, a, b) for a, b in zip(res["cuda"].pooled, res["cpu"].pooled))
    cut_abs = max(float(np.abs(a - b).max())
                  for a, b in zip(res["cuda"].pooled, res["cpu"].pooled))
    if cut_gap > 1.0:
        raise AssertionError(f"4e8 cut: pooled card vs CPU {cut_abs} outside {TRACE_POOL_TOL}")
    emit({"phase": "trace_path", "part": "c_card_vs_cpu", "table_bytes": TRACE_CUT_BYTES,
          "rows": cut_rows, "batches": res["cuda"].chunks,
          "hit_rate": card.hit_rate, "sm_ios": int(res["cuda"].sm_ios.sum()),
          "pooled_max_abs": cut_abs, "pooled_gap_over_tolerance": cut_gap,
          "card_s": run_s["cuda"], "cpu_s": run_s["cpu"]})
    del card, host, engines, res
    torch.cuda.empty_cache()

    # (d) a long stream on the kernel engine, in bounded memory
    before = (int(kern.state["hits"]), int(kern.state["misses"]))
    stream = TraceStream(serve_dlrm.m1_spec(name, queries=TRACE_STREAM_QUERIES,
                                            table_bytes=TRACE_TABLE_BYTES),
                         piece=TRACE_STREAM_PIECE)
    t0 = time.perf_counter()
    out = serve_dlrm.serve_trace(kern, stream, B, TRACE_BG_IOPS)
    stream_s = time.perf_counter() - t0
    hits = int(kern.state["hits"]) - before[0]
    misses = int(kern.state["misses"]) - before[1]
    if len(out.sm_ios) != TRACE_STREAM_QUERIES or not np.isfinite(out.latency_us).all():
        raise AssertionError(f"stream served {len(out.sm_ios)} queries")
    p50, p95, p99 = np.percentile(out.latency_us, [50, 95, 99])
    sm50, sm95, sm99 = np.percentile(out.sm_time_us, [50, 95, 99])
    emit({"phase": "trace_path", "part": "d_stream", "queries": len(out.sm_ios),
          "piece": TRACE_STREAM_PIECE, "batches": out.chunks,
          "hit_rate": hits / (hits + misses), "sm_ios": int(out.sm_ios.sum()),
          "latency_us_p50_p95_p99": [float(p50), float(p95), float(p99)],
          "sm_time_us_p50_p95_p99": [float(sm50), float(sm95), float(sm99)],
          "item_time_us": kern.cfg.item_time_us, "stream_s": stream_s,
          "phase_s": time.perf_counter() - t_phase})
    del kern
    torch.cuda.empty_cache()
    return {"launches": launches, "device_us": device_us, "err": kernel_err,
            "times": times}


def shard_state_diff(torch, a, b) -> list:
    """The (shard, key) pairs of cache state where sharded engines ``a`` and
    ``b`` differ (``b``'s state compared on ``a``'s device)."""
    return [(k, key) for k, (sa, sb) in enumerate(zip(a.state, b.state))
            for key, v in sa.items() if not torch.equal(v, sb[key].to(v.device))]


def sharded_path(torch, np, smi) -> dict:
    """Phase ``sharded_path``; returns the launches of its run (a), each
    kernel's largest difference from its plain version there, and each
    kernel's device µs per call in the step at 8 shards."""
    from repro_torch import serve_dlrm
    from repro_torch.core.io_sim import DEVICES
    from repro_torch.kernels import ops, ref
    from repro_torch.launch import make_embed_mesh
    from repro_torch.runtime.engine import EngineConfig, dense_from_chunk
    from repro_torch.runtime.sharded_engine import ShardedServingEngine
    from repro_torch.workloads import build_trace

    B, D, name = TRACE_BATCH, TRACE_DIM, TRACE_ARCHETYPE
    kernel_names = ("gather_pool", "cache_probe")
    t_phase = time.perf_counter()
    spec = serve_dlrm.m1_spec(name, queries=TRACE_QUERIES, table_bytes=TRACE_TABLE_BYTES)
    chunks = list(build_trace(spec).chunks(B))
    shared = "cuda:0"

    def engine(n, layout, use_kernels=True):
        return serve_dlrm.build_trace_engine(
            spec, D, seed=0, torch_device="cuda",
            cfg=EngineConfig(use_kernels=use_kernels), shards=n, layout=layout,
            devices=[shared] * n)

    def store(eng):
        return {"L": eng.sentinel,
                "store_bytes": sum(p.numel() + s.numel() * 4 + b.numel() * 4
                                   for p, s, b in zip(eng.payload, eng.scale, eng.bias))}

    emit({"phase": "sharded_path", "part": "mesh", "card": smi,
          "count": torch.cuda.device_count(), "shards_on": shared,
          "note": "every shard on one card through an explicit device list: "
                  "the times measure per-shard overhead, not scale-out",
          "reduced": ["one row width for every table: D = 128 int8 (136 B with "
                      "the header) instead of 90-172 B a table"]})

    # (a) kernel engine vs plain engine at 8 shards, batch by batch in turns
    n = SHARD_CHECKED
    launches = {k: 0 for k in kernel_names}
    gap = {"kernel_vs_plain": 0.0, "kernel_vs_reference_pool": 0.0,
           "plain_vs_reference_pool": 0.0}
    max_abs, per_layout = 0.0, {}
    restore, check, _ = shadowed_dlrm_kernels(torch, ops, ref)
    try:
        for layout in SHARD_LAYOUTS:
            t0 = time.perf_counter()
            kern, plain = engine(n, layout), engine(n, layout, use_kernels=False)
            torch.cuda.synchronize()
            setup_s = time.perf_counter() - t0
            for attr in ("payload", "scale", "bias"):
                if not all(map(torch.equal, getattr(kern, attr), getattr(plain, attr))):
                    raise AssertionError(f"{layout}: seeded stores differ in {attr}")
            T = len(kern.table_ids)
            ops.reset_launch_counts()
            for i, ch in enumerate(chunks):
                pk, tk, ik = kern.serve_columnar(ch.columnar, TRACE_BG_IOPS)
                pp, tp, ip = plain.serve_columnar(ch.columnar, TRACE_BG_IOPS)
                if ik.tolist() != ip.tolist() or tk.tolist() != tp.tolist():
                    raise AssertionError(f"{layout} batch {i}: sm_ios or sm_time_us "
                                         "differ between the kernel and plain engines")
                differ = shard_state_diff(torch, kern, plain)
                if differ:
                    raise AssertionError(f"{layout} batch {i}: cache state differs "
                                         f"between the kernel and plain engines: {differ}")
                idx, valid = dense_from_chunk(ch.columnar, kern.table_slot, T)
                if idx.shape != (B, T, TRACE_P):
                    raise AssertionError(f"{layout} batch {i}: block {idx.shape}")
                want = kern.reference_pool(idx, valid)
                if pk.shape != (B, T, D) or not np.isfinite(pk).all():
                    raise AssertionError(f"{layout} batch {i}: pooled {pk.shape} not finite")
                for key, (x, y) in {"kernel_vs_plain": (pk, pp),
                                    "kernel_vs_reference_pool": (pk, want),
                                    "plain_vs_reference_pool": (pp, want)}.items():
                    gap[key] = max(gap[key], pool_gap(np, x, y))
                max_abs = max(max_abs, float(np.abs(pk - pp).max()),
                              float(np.abs(pk - want).max()))
            torch.cuda.synchronize()
            counts = ops.launch_counts()
            if any(counts[k] != n * len(chunks) for k in kernel_names):
                raise AssertionError(f"sharded path ({layout}): {counts} launches over "
                                     f"{len(chunks)} batches, want {n} of each a batch")
            for k in kernel_names:
                launches[k] += counts[k]
            per_layout[layout] = {"launches": {k: counts[k] for k in kernel_names},
                                  "hit_rate": kern.hit_rate, "sm_ios": int(kern.stats.sm_ios),
                                  **store(kern), "setup_s": setup_s}
            del kern, plain
            torch.cuda.empty_cache()
    finally:
        restore()
    kernel_err = check()
    if max(gap.values()) > 1.0:
        raise AssertionError(f"sharded path pooled outside {TRACE_POOL_TOL}: {gap}")
    emit({"phase": "sharded_path", "part": "a_kernel_vs_plain", "archetype": name,
          "shards": n, "batches": len(chunks), "block": [B, T, TRACE_P],
          "layouts": per_layout, "launches": launches,
          "kernel_vs_plain_per_call": kernel_err, "pooled_max_abs": max_abs,
          "pooled_gap_over_tolerance": gap, "tolerance": TRACE_POOL_TOL,
          "part_s": time.perf_counter() - t_phase})

    # (b) both layouts x 1, 2, 4, 8 shards beside the single-device engine:
    # walls from cold over the trace, then a profile of 8 more batches
    t_part = time.perf_counter()
    profiled = list(build_trace(serve_dlrm.m1_spec(
        name, queries=B * SHARD_PROFILED, table_bytes=TRACE_TABLE_BYTES)).chunks(B))

    def sweep(eng, n):
        walls, out = [], []
        for ch in chunks:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out.append(eng.serve_columnar(ch.columnar, TRACE_BG_IOPS))
            walls.append((time.perf_counter() - t0) * 1e3)
        hit_rate = eng.hit_rate
        prof = device_profile(torch, lambda: [eng.serve_columnar(ch.columnar, TRACE_BG_IOPS)
                                              for ch in profiled],
                              SHARD_PROFILED, named=kernel_names)
        named = prof["ops_named"]
        if any(named[k] != n for k in kernel_names):
            raise AssertionError(f"{n} shards: profile shows {named} kernels a batch, "
                                 f"want {n} of each")
        wall = statistics.median(walls[2:])           # the first batches warm up
        row = {"shards": n, "hit_rate": hit_rate,
               "sm_ios": int(sum(int(o[2].sum()) for o in out)),
               "serve_columnar_ms_median": wall, "serve_columnar_ms_min": min(walls[2:]),
               "device_busy_us": prof["device_busy_us"], "device_ops": prof["device_ops"],
               "idle_share": (1.0 - prof["device_busy_us"] / (wall * 1e3)
                              if prof["device_ops"] else None),
               "device_us_per_call": {k: prof["us_named"][k] / named[k] for k in kernel_names},
               "top_us": prof["top_us"][:4]}
        return out, row

    single = serve_dlrm.build_trace_engine(spec, D, seed=0, torch_device="cuda",
                                           cfg=EngineConfig())
    base, base_row = sweep(single, 1)
    base_row["L"] = single.sentinel
    base_state = {k: v.clone() for k, v in single.state.items()}
    base_stats = (single.stats.sm_ios, single.stats.latency_us, single.hit_rate)
    base_row["shards"] = 0
    del single
    torch.cuda.empty_cache()
    rows, device_us = {"single": base_row}, {}
    for layout in SHARD_LAYOUTS:
        for n in SHARD_COUNTS:
            eng = engine(n, layout)
            got, row = sweep(eng, n)
            if got[0][2].tolist() != base[0][2].tolist():
                raise AssertionError(f"{layout} x {n}: the cold first batch's sm_ios "
                                     "differ from the single-device engine's")
            if n == 1:
                for i, (a, b) in enumerate(zip(got, base)):
                    if not all(np.array_equal(x, y) for x, y in zip(a, b)):
                        raise AssertionError(f"{layout} x 1: batch {i} differs from "
                                             "the single-device engine")
                differ = [k for k, v in eng.state[0].items()
                          if not torch.equal(v, base_state[k])]
                if differ or (eng.stats.sm_ios, eng.stats.latency_us,
                              eng.hit_rate) != base_stats:
                    raise AssertionError(f"{layout} x 1: state {differ} or totals differ "
                                         "from the single-device engine")
            rows[f"{layout}_{n}"] = {**row, **store(eng)}
            if n == SHARD_CHECKED:
                device_us[layout] = row["device_us_per_call"]
            del eng, got
            torch.cuda.empty_cache()
    emit({"phase": "sharded_path", "part": "b_sweep", "card": smi,
          "batches": len(chunks), "profiled_batches": SHARD_PROFILED, "runs": rows,
          "part_s": time.perf_counter() - t_part})

    # (c) the 4e8 cut at 4 shards on the card and on the CPU, tables made
    # with numpy
    t_part = time.perf_counter()
    cut_trace = build_trace(serve_dlrm.m1_spec(name, queries=B * SHARD_CUT_BATCHES,
                                               table_bytes=TRACE_CUT_BYTES))
    rng = np.random.default_rng(7)
    tables = {m.table_id: rng.standard_normal((m.num_rows, D), dtype=np.float32)
              for m in cut_trace.all_metas() if m.kind == "user"}
    if sum(t.shape[0] for t in tables.values()) != TRACE_CUT_ROWS:
        raise AssertionError("the 4e8 cut's rows")
    cut_out = {}
    for layout in SHARD_LAYOUTS:
        res, engines, run_s = {}, {}, {}
        for dev, mesh in (("cuda", make_embed_mesh(devices=[shared] * SHARD_CUT)),
                          ("cpu", make_embed_mesh(SHARD_CUT, "cpu"))):
            t0 = time.perf_counter()
            engines[dev] = ShardedServingEngine(tables, DEVICES["nand_flash"], EngineConfig(),
                                                mesh=mesh, layout=layout)
            res[dev] = serve_dlrm.serve_trace(engines[dev], cut_trace, B, TRACE_BG_IOPS,
                                              keep_pooled=True)
            run_s[dev] = time.perf_counter() - t0
        card, host = engines["cuda"], engines["cpu"]
        for f in ("sm_ios", "sm_time_us", "latency_us"):
            if getattr(res["cuda"], f).tolist() != getattr(res["cpu"], f).tolist():
                raise AssertionError(f"4e8 cut ({layout}): {f} differs between card and CPU")
        if card.hit_rate != host.hit_rate:
            raise AssertionError(f"4e8 cut ({layout}): hit rate differs between card and CPU")
        differ = shard_state_diff(torch, card, host)
        if differ:
            raise AssertionError(f"4e8 cut ({layout}): cache state differs between card "
                                 f"and CPU: {differ}")
        pairs = list(zip(res["cuda"].pooled, res["cpu"].pooled))
        cut_gap = max(pool_gap(np, a, b) for a, b in pairs)
        if cut_gap > 1.0:
            raise AssertionError(f"4e8 cut ({layout}): pooled card vs CPU outside "
                                 f"{TRACE_POOL_TOL}")
        cut_out[layout] = {"hit_rate": card.hit_rate, "sm_ios": int(res["cuda"].sm_ios.sum()),
                           "pooled_max_abs": max(float(np.abs(a - b).max()) for a, b in pairs),
                           "pooled_gap_over_tolerance": cut_gap,
                           "card_s": run_s["cuda"], "cpu_s": run_s["cpu"]}
        del card, host, engines, res, pairs
        torch.cuda.empty_cache()
    emit({"phase": "sharded_path", "part": "c_card_vs_cpu", "table_bytes": TRACE_CUT_BYTES,
          "rows": TRACE_CUT_ROWS, "shards": SHARD_CUT, "batches": SHARD_CUT_BATCHES,
          "layouts": cut_out, "part_s": time.perf_counter() - t_part,
          "phase_s": time.perf_counter() - t_phase})
    return {"launches": launches, "err": kernel_err, "device_us": device_us}


def lm_phases(torch, np, timer, smi) -> dict:
    """Phases 6-8; returns the ``flash_decode`` entry of the kernels line."""
    from repro_torch import serve_lm
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import flash_decode as fd_module
    from repro_torch.kernels.flash_decode import flash_decode
    from repro_torch.models.transformer import decode_step, init_cache

    # 6. flash_decode against its plain version on the card
    rng = np.random.default_rng(6)
    err = {k: 0.0 for k in FLASH_DECODE_TOL}
    cases = flash_decode_cases(torch, np, rng)
    for label, dlabel, q, k, v, kv_len in cases:
        got = flash_decode(q, k, v, kv_len)
        want = ref.flash_decode_ref(q, k, v, kv_len)
        torch.cuda.synchronize()
        tol = FLASH_DECODE_TOL[dlabel]
        torch.testing.assert_close(got, want, rtol=tol, atol=tol, msg=label)
        err[dlabel] = max(err[dlabel], float((got - want).abs().max()))
    if any(bool(buf.any()) for buf in fd_module._COUNTERS.values()):
        raise AssertionError("flash_decode left an arrival counter nonzero")
    emit({"phase": "flash_decode_vs_plain", "cases": [c[0] for c in cases],
          "kv_len_edges": [0, 1, "S", "S+5"], "max_abs_err": err,
          "tolerance": FLASH_DECODE_TOL})

    # 7. the LM serving path at full smollm-135m width
    cfg = get_config("smollm-135m")
    B, T, S = LM_BATCH, LM_TOKENS, LM_MAX_LEN
    want_launches = cfg.num_layers * T
    tokens = torch.from_numpy(serve_lm.make_tokens(cfg, batch=B, tokens=T, seed=1))
    tok_gpu = tokens.cuda()
    t0 = time.perf_counter()
    model = serve_lm.build(cfg, seed=0, torch_device="cuda")
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0

    def finite(name, logits):
        if tuple(logits.shape) != (B, T, cfg.vocab_size) or not bool(torch.isfinite(logits).all()):
            raise AssertionError(f"{name}: logits {tuple(logits.shape)} not finite")

    # (a) f32 cache: the card against the same run on the CPU
    ops.reset_launch_counts()
    card_f32 = serve_lm.decode(model, init_cache(cfg, B, S, torch.float32, "cuda"), tok_gpu)
    torch.cuda.synchronize()
    launches_f32 = ops.launch_counts()["flash_decode"]
    if launches_f32 != want_launches:
        raise AssertionError(f"f32 run launched flash_decode {launches_f32} times, "
                             f"not {want_launches}")
    t0 = time.perf_counter()
    host = serve_lm.build(cfg, seed=0, torch_device="cpu")
    cpu_f32 = serve_lm.decode(host, init_cache(cfg, B, S, torch.float32, "cpu"), tokens)
    cpu_s = time.perf_counter() - t0
    del host
    finite("card f32", card_f32)
    finite("cpu f32", cpu_f32)
    card_vs_cpu = float((card_f32.cpu() - cpu_f32).abs().max())
    if card_vs_cpu > LM_CARD_VS_CPU_TOL:
        raise AssertionError(f"f32-cache logits card vs CPU {card_vs_cpu} > "
                             f"{LM_CARD_VS_CPU_TOL}")
    del card_f32, cpu_f32

    # (b) the serving bf16 cache: the main path, then the plain version
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    kern = serve_lm.decode(model, init_cache(cfg, B, S, device="cuda"), tok_gpu)
    torch.cuda.synchronize()
    path_s = time.perf_counter() - t0
    launches = ops.launch_counts()
    if launches["flash_decode"] != want_launches:
        raise AssertionError(f"the LM path launched flash_decode "
                             f"{launches['flash_decode']} times, not {want_launches}")
    model.use_kernels = False
    plain = serve_lm.decode(model, init_cache(cfg, B, S, device="cuda"), tok_gpu)
    model.use_kernels = True
    torch.cuda.synchronize()
    if ops.launch_counts() != launches:
        raise AssertionError("use_kernels=False launched a kernel")
    finite("card bf16 kernel", kern)
    finite("card bf16 plain", plain)
    # The two runs' logits are reported, not held to a limit: a ~1e-7
    # difference in an attention output sometimes flips the bf16 rounding of
    # a key or value written to the cache, which moves later outputs by a
    # bf16 step (most at early positions, where the newest value dominates
    # the attention). The f32-cache run above is the end-to-end limit; the
    # kernel itself is held to its plain version at every call of the path,
    # on that call's own inputs, below.
    drift_by_pos = (kern - plain).abs().amax(dim=(0, 2))
    top1 = float((kern.argmax(-1) == plain.argmax(-1)).float().mean())
    del kern, plain
    worst = torch.zeros((), device="cuda")
    kernel_call = ops.decode_attention

    def shadowed(q, k, v, kv_len, *, use_kernel=True):
        out = kernel_call(q, k, v, kv_len, use_kernel=use_kernel)
        torch.maximum(worst, (out - ref.flash_decode_ref(q, k, v, kv_len)).abs().max(),
                      out=worst)
        return out
    ops.decode_attention = shadowed
    try:
        serve_lm.decode(model, init_cache(cfg, B, S, device="cuda"), tok_gpu)
    finally:
        ops.decode_attention = kernel_call
    per_call = float(worst)
    if per_call > FLASH_DECODE_TOL["path"]:
        raise AssertionError(f"flash_decode on the LM path: {per_call} from its plain "
                             f"version > {FLASH_DECODE_TOL['path']}")
    emit({"phase": "lm_main_path", "arch": cfg.name, "layers": cfg.num_layers,
          "batch": B, "positions": T, "cache_len": S, "weights": "f32, seed 0",
          "launches": launches, "launches_f32_run": launches_f32,
          "f32_cache_max_abs_card_vs_cpu": card_vs_cpu,
          "bf16_cache_kernel_vs_plain_per_call_max_abs": per_call,
          "bf16_cache_logits_max_abs_kernel_vs_plain": float(drift_by_pos.max()),
          "bf16_cache_logits_max_abs_at_position": {
              str(p): float(drift_by_pos[p]) for p in (0, 1, 15, 63, 127, T - 1)
              if p < T},
          "bf16_cache_top1_agreement": top1,
          "setup_s": setup_s, "path_s": path_s, "cpu_run_s": cpu_s})

    # 8. timing: the kernel at the path's shape, one decode_32k layer and one
    # granite-34b layer (G = 48, hd 128)
    def decode_inputs(B, S, L, H, K, hd):
        g = torch.Generator(device="cuda").manual_seed(S)
        q = torch.randn((B, H, hd), generator=g, device="cuda", dtype=torch.bfloat16)
        k = torch.randn((B, S, K, hd), generator=g, device="cuda", dtype=torch.bfloat16)
        v = torch.randn((B, S, K, hd), generator=g, device="cuda", dtype=torch.bfloat16)
        return q, k, v, torch.full((B,), L, dtype=torch.int32, device="cuda")

    def shape_times(B, S, L, H, K, hd, t, reps):
        q, k, v, kv_len = decode_inputs(B, S, L, H, K, hd)
        got = flash_decode(q, k, v, kv_len)
        err = float((got - ref.flash_decode_ref(q, k, v, kv_len)).abs().max())
        if err > FLASH_DECODE_TOL["bf16"]:
            raise AssertionError(f"flash_decode at B {B}, S {S}, H {H}: error {err}")
        lib, reason = sdpa_call(torch, q, k, v, L)
        if lib is not None:
            lib_err = float((lib()[:, :, 0].float() - got).abs().max())
            if lib_err > FLASH_DECODE_TOL["bf16"]:
                raise AssertionError(f"SDPA disagrees with the kernel by {lib_err}")
        nbytes, nops = flash_decode_bytes_ops(q, k, kv_len)
        tiles = fd_module.head_tiles(H // K)[0]
        n_split = fd_module.split_count(B, K, S, torch.cuda.get_device_properties(0)
                                        .multi_processor_count, tiles)
        out = {"shape": {"B": B, "S": S, "kv_len": L, "H": H, "K": K, "hd": hd,
                         "dtype": "bf16"},
               "splits": n_split, "busy_splits": fd_module.busy_splits(L, S, n_split, hd),
               "head_tiles": tiles, "max_abs_err": err,
               "ms": t.ms(lambda: flash_decode(q, k, v, kv_len), reps),
               "plain_ms": t.ms(lambda: ref.flash_decode_ref(q, k, v, kv_len), reps),
               "library_ms": t.ms(lib, reps) if lib is not None else None,
               "library": "F.scaled_dot_product_attention(enable_gqa=True)"
                          if lib is not None else reason,
               "bound_bytes_ms": nbytes / HBM_BYTES_PER_S * 1e3,
               "bound_f32_ops_ms": nops / FP32_OPS_PER_S * 1e3}
        out["bound_ms"], out["bound_by"] = bound_ms(nbytes, nops, BF16_OPS_PER_S)
        return out

    path_shape = shape_times(B, S, T, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim,
                             timer, 0)
    d32 = SHAPES["decode_32k"]
    long_shape = shape_times(d32.global_batch, d32.seq_len, d32.seq_len, cfg.num_heads,
                             cfg.num_kv_heads, cfg.head_dim, timer, 10)
    q, k, v, kv_len = decode_inputs(d32.global_batch, d32.seq_len, d32.seq_len,
                                    cfg.num_heads, cfg.num_kv_heads, cfg.head_dim)
    split_count = fd_module.split_count
    long_shape["ms_by_splits"] = {}
    try:                                       # the same call at forced split counts
        for n in (1, 2, 4, 8, 16):
            fd_module.split_count = lambda *args, n=n: n
            long_shape["ms_by_splits"][n] = timer.ms(
                lambda: flash_decode(q, k, v, kv_len), 10)["median"]
    finally:
        fd_module.split_count = split_count
    del q, k, v, kv_len
    g34 = get_config("granite-34b")
    mqa_shape = shape_times(LM_BATCH, 8192, 8192, g34.num_heads, g34.num_kv_heads,
                            g34.head_dim, timer, 10)
    torch.cuda.empty_cache()

    caches = {"kernels": init_cache(cfg, B, S, device="cuda"),
              "plain": init_cache(cfg, B, S, device="cuda")}
    walls = {"kernels": [], "plain": []}
    for t in range(T):                         # in turns, same tokens
        for name, cache in caches.items():
            model.use_kernels = name == "kernels"
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            decode_step(model, cache, tok_gpu[:, t:t + 1], t)
            torch.cuda.synchronize()
            if t >= 8:                         # first steps warm up
                walls[name].append((time.perf_counter() - t0) * 1e3)
    wall_ms = {k: statistics.median(v) for k, v in walls.items()}
    prof = {}
    for name, cache in caches.items():         # positions T .. T + 7
        model.use_kernels = name == "kernels"
        prof[name] = device_profile(
            torch, lambda cache=cache: [decode_step(model, cache, tok_gpu[:, p - T:p - T + 1], p)
                                        for p in range(T, T + 8)], 8,
            named=("flash_decode", "combine"))
        prof[name]["idle_share"] = (1.0 - prof[name]["device_busy_us"] / (wall_ms[name] * 1e3)
                                    if prof[name]["device_ops"] else None)
    model.use_kernels = True
    named = prof["kernels"]["ops_named"]
    if named["flash_decode"] != cfg.num_layers or named["combine"]:
        raise AssertionError(f"decode step profile: {named} device kernels per step, "
                             f"want {cfg.num_layers} flash_decode and no combine")
    emit({"phase": "lm_timing", "card": smi,
          "flash_decode_path_shape": path_shape,
          "flash_decode_decode_32k": long_shape,
          "flash_decode_granite_34b": mqa_shape,
          "decode_step_ms_median": wall_ms,
          "decode_step_ms_min": {k: min(v) for k, v in walls.items()},
          "decode_steps": len(walls["kernels"]),
          "decode_step_profile": prof})
    return {"launches": launches["flash_decode"],
            "max_abs_err": max(max(err.values()), per_call, path_shape["max_abs_err"],
                               long_shape["max_abs_err"], mqa_shape["max_abs_err"]),
            "ms": path_shape["ms"]["median"],
            "plain_ms": path_shape["plain_ms"]["median"],
            "bound_ms": path_shape["bound_ms"], "bound_by": path_shape["bound_by"],
            "library_ms": (path_shape["library_ms"] or {}).get("median")}


def main() -> int:
    if sys.argv[1:] not in ([], ["--kernels"]):
        print("usage: python3 chip_smoke.py [--kernels]", file=sys.stderr)
        return 2
    t_script = time.perf_counter()
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import numpy as np
    from repro_torch import serve_dlrm
    from repro_torch.kernels import build, ops, ref
    from repro_torch.kernels.cache_probe import cache_probe
    from repro_torch.kernels.gather_pool import gather_pool
    from repro_torch.models.dlrm import DLRMArch
    from repro_torch.core.io_sim import DEVICES
    from repro_torch.runtime.engine import DeviceServingEngine, EngineConfig

    # 1. device
    smi = nvidia_smi()
    kind = torch.cuda.get_device_name(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(smi, flush=True)
    emit({"phase": "device", "nvidia_smi": smi, "torch_name": kind,
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "numpy": np.__version__})

    # 2. build
    t0 = time.perf_counter()
    reports = build.build_all()
    ptxas = {name: ptxas_summary(log, build.nvcc_path()) for name, log in reports.items()}
    emit({"phase": "build", "seconds": round(time.perf_counter() - t0, 3),
          "ptxas": ptxas})
    spilled = [(name, f) for name, fns in ptxas.items() for f in fns if any(f[2:])]
    if spilled:
        raise AssertionError(f"ptxas spilled registers: {spilled}")

    # 3. each kernel against its plain version on the card
    rng = np.random.default_rng(0)
    err = {"gather_pool": 0.0, "cache_probe": 0.0}
    gp_cases = gather_pool_cases(torch, np, rng) + [
        m1_gather_pool_case(torch, **M1_GATHER_POOL)]
    for label, payload, scale, bias, idx in gp_cases:
        got = gather_pool(payload, scale, bias, idx)
        want = ref.gather_pool_ref(payload, scale, bias, idx)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, **GATHER_POOL_TOL, msg=label)
        err["gather_pool"] = max(err["gather_pool"],
                                 float((got - want).abs().max()))
    cp_cases = cache_probe_cases(torch, np, rng) + [
        m1_cache_probe_case(torch, **M1_CACHE_PROBE)]
    probed = {}
    for label, *args in cp_cases:
        vals, hit = cache_probe(*args)
        vals_ref, hit_ref = ref.cache_probe_ref(*args)
        torch.cuda.synchronize()
        if not torch.equal(hit, hit_ref):
            raise AssertionError(f"cache_probe {label}: hit differs")
        torch.testing.assert_close(vals, vals_ref, **CACHE_PROBE_TOL, msg=label)
        err["cache_probe"] = max(err["cache_probe"],
                                 float((vals - vals_ref).abs().max()))
        probed[label] = vals, hit
    vals, hit = probed["two_ways"]
    data = cp_cases[2][3]
    if hit.tolist() != [1, 1, 0] or not torch.equal(vals[0], data[2, 1] + data[2, 3]):
        raise AssertionError("cache_probe two_ways: matching ways not summed")
    emit({"phase": "kernels_vs_plain",
          "gather_pool_cases": [c[0] for c in gp_cases],
          "cache_probe_cases": [c[0] for c in cp_cases],
          "max_abs_err": err})
    timer = Timer(torch)
    if sys.argv[1:] == ["--kernels"]:          # phases 1-3 and the kernel times only
        emit({"phase": "timing", "card": smi, **dlrm_kernel_times(torch, timer, gp_cases,
                                                                  cp_cases)})
        return 0

    # 4. the serving path at full DLRMArch() width, on the card and the CPU
    arch = DLRMArch()
    cfg = EngineConfig()
    traffic = serve_dlrm.make_traffic(arch, queries=128, batch=32,
                                      item_batch=50, seed=1)
    traffic.append(traffic[0])                 # replay: the cache now hits
    t0 = time.perf_counter()
    model, engine = serve_dlrm.build(arch, seed=0, torch_device="cuda", cfg=cfg)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    gpu = serve_dlrm.serve(model, engine, traffic)
    torch.cuda.synchronize()
    path_s = time.perf_counter() - t0
    launches = ops.launch_counts()
    if min(launches["gather_pool"], launches["cache_probe"]) == 0:
        raise AssertionError(f"a kernel never ran on the DLRM path: {launches}")
    model_cpu, engine_cpu = serve_dlrm.build(arch, seed=0, torch_device="cpu",
                                             cfg=cfg)
    cpu = serve_dlrm.serve(model_cpu, engine_cpu, traffic)
    for name in ("payload", "scale", "bias"):
        if not torch.equal(getattr(engine, name).cpu(), getattr(engine_cpu, name)):
            raise AssertionError(f"quantized {name} differs between card and CPU")
    max_pool_err = max_score_diff = max_pool_diff = 0.0
    for b, (g, c) in enumerate(zip(gpu, cpu)):
        if [s.sm_ios for s in g.stats] != [s.sm_ios for s in c.stats]:
            raise AssertionError(f"batch {b}: sm_ios differ")
        if [s.latency_us for s in g.stats] != [s.latency_us for s in c.stats]:
            raise AssertionError(f"batch {b}: latency_us differ")
        if g.pooled.shape != (32, 8, 64) or not np.isfinite(g.pooled).all():
            raise AssertionError(f"batch {b}: pooled {g.pooled.shape} not finite")
        if g.scores.shape != (50,) or not np.isfinite(g.scores).all():
            raise AssertionError(f"batch {b}: scores {g.scores.shape} not finite")
        max_pool_err = max(max_pool_err, g.max_err, c.max_err)
        max_pool_diff = max(max_pool_diff, float(np.abs(g.pooled - c.pooled).max()))
        max_score_diff = max(max_score_diff, float(np.abs(g.scores - c.scores).max()))
    if max(max_pool_err, max_pool_diff, max_score_diff) > SERVE_TOL:
        raise AssertionError(
            f"pooled err {max_pool_err}, pooled card-CPU {max_pool_diff}, "
            f"scores card-CPU {max_score_diff} exceed {SERVE_TOL}")
    if engine.hit_rate != engine_cpu.hit_rate:
        raise AssertionError("hit rate differs between card and CPU")
    for k, v in engine.state.items():
        if not torch.equal(v.cpu(), engine_cpu.state[k]):
            raise AssertionError(f"cache state {k} differs between card and CPU")
    replay_ios = sum(s.sm_ios for s in gpu[-1].stats)
    if replay_ios != 0:
        raise AssertionError(f"replayed batch still missed {replay_ios} rows")
    emit({"phase": "main_path", "arch": "DLRMArch()", "batches": len(traffic),
          "queries": sum(len(r.stats) for r in gpu),
          "cache_sets": engine.cache.geo.num_sets,
          "cache_ways": engine.cache.geo.ways,
          "launches": launches, "hit_rate": engine.hit_rate,
          "sm_ios": [sum(s.sm_ios for s in r.stats) for r in gpu],
          "max_pool_err": max_pool_err, "max_pool_card_vs_cpu": max_pool_diff,
          "max_score_card_vs_cpu": max_score_diff,
          "setup_s": setup_s, "path_s": path_s})

    # 5. timing
    times = dlrm_kernel_times(torch, timer, gp_cases, cp_cases)
    engine_plain = DeviceServingEngine(
        {i: model.tables[i] for i in range(len(arch.user_tables))},
        DEVICES["nand_flash"], EngineConfig(use_kernels=False),
        torch_device="cuda")
    timing = serve_dlrm.make_traffic(arch, queries=32 * 24, batch=32,
                                     item_batch=50, seed=2)
    walls = {"kernels": [], "plain": []}
    for i, tb in enumerate(timing):            # in turns, same batches
        for name, eng in (("kernels", engine), ("plain", engine_plain)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            eng.serve_batch(tb["user"], bg_iops=10_000.0)
            if i >= 4:                         # first batches warm up
                walls[name].append((time.perf_counter() - t0) * 1e3)
    wall_ms = {k: statistics.median(v) for k, v in walls.items()}
    kernel_names = ("gather_pool", "cache_probe")
    prof = {name: device_profile(
                torch, lambda eng=eng: [eng.serve_batch(tb["user"], bg_iops=10_000.0)
                                        for tb in timing[:8]], 8, named=kernel_names)
            for name, eng in (("kernels", engine), ("plain", engine_plain))}
    for name, p in prof.items():             # no device events: not measured
        p["idle_share"] = (1.0 - p["device_busy_us"] / (wall_ms[name] * 1e3)
                           if p["device_ops"] else None)
    named = prof["kernels"]["ops_named"]
    if any(named[k] != 1 for k in kernel_names):
        raise AssertionError(f"serve_batch profile: {named} kernels per batch, want one each")
    device_us = {k: prof["kernels"]["us_named"][k] / named[k] for k in kernel_names}
    emit({"phase": "timing", "card": smi, **times,
          "device_us_per_call_in_step": device_us,
          "serve_batch_ms_median": wall_ms,
          "serve_batch_batches": len(walls["kernels"]),
          "serve_batch_profile": prof,
          "launches_per_batch": {k: launches[k] / len(traffic)
                                 for k in ("gather_pool", "cache_probe")}})

    del gp_cases, cp_cases, probed             # m1_batch holds about 6.5 GB
    del model, engine, model_cpu, engine_cpu, engine_plain
    torch.cuda.empty_cache()

    # trace_path: trace-driven serving at the M1 inventory
    tr = trace_path(torch, np, timer, smi)

    # sharded_path: the sharded engine at the M1 inventory
    sh = sharded_path(torch, np, smi)

    # 6-8. the LM decode path and its flash_decode kernel
    fd = lm_phases(torch, np, timer, smi)

    emit({"phase": "done", "script_s": time.perf_counter() - t_script})
    emit({"kernels": [
        {"name": "gather_pool", "route": "cuda",
         "source": "src/repro_torch/csrc/gather_pool.cu",
         "replaces": "src/repro/kernels/gather_pool.py:57",
         "launches": launches["gather_pool"] + tr["launches"]["gather_pool"] + sh["launches"]["gather_pool"],
         "launches_by_path": {"dlrm_uniform": launches["gather_pool"],
                              "trace_path": tr["launches"]["gather_pool"],
                              "sharded_path": sh["launches"]["gather_pool"]},
         "max_abs_err": max(err["gather_pool"], tr["err"]["gather_pool"], sh["err"]["gather_pool"]),
         **kernel_entry(times, "gather_pool", tr["times"]),
         "device_us_per_call_in_step": device_us["gather_pool"],
         "device_us_per_call_trace_path": tr["device_us"]["gather_pool"],
         "device_us_per_call_sharded_path": {lay: us["gather_pool"]
                                             for lay, us in sh["device_us"].items()}},
        {"name": "cache_probe", "route": "cuda",
         "source": "src/repro_torch/csrc/cache_probe.cu",
         "replaces": "src/repro/kernels/cache_probe.py:58",
         "launches": launches["cache_probe"] + tr["launches"]["cache_probe"] + sh["launches"]["cache_probe"],
         "launches_by_path": {"dlrm_uniform": launches["cache_probe"],
                              "trace_path": tr["launches"]["cache_probe"],
                              "sharded_path": sh["launches"]["cache_probe"]},
         "max_abs_err": max(err["cache_probe"], tr["err"]["cache_probe"], sh["err"]["cache_probe"]),
         **kernel_entry(times, "cache_probe", tr["times"]),
         "device_us_per_call_in_step": device_us["cache_probe"],
         "device_us_per_call_trace_path": tr["device_us"]["cache_probe"],
         "device_us_per_call_sharded_path": {lay: us["cache_probe"]
                                             for lay, us in sh["device_us"].items()}},
        {"name": "flash_decode", "route": "cuda",
         "source": "src/repro_torch/csrc/flash_decode.cu",
         "replaces": "src/repro/kernels/flash_decode.py:88", **fd},
    ]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
