#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

Phases, one JSON line each:

1. device  -- the card as ``nvidia-smi`` and torch name it; TF32 off.
2. build   -- ``nvcc`` builds every kernel in ``src/repro_torch/csrc`` (one
              process per source, all started together).
3. kernels -- each kernel against its plain PyTorch version on the card, at
              the serving path's shapes plus edge cases.
4. main    -- the serving path (``repro_torch.serve_dlrm``: device serving
              engine + DLRM scoring) at the full ``DLRMArch()`` width: four
              batches of 32 queries, then the first batch again. The launch
              counters are zeroed just before and read just after; the same
              run on the CPU must give equal ``sm_ios``, ``latency_us``,
              hit rate and cache state, pooled bags and scores within 1e-5.
5. timing  -- kernel and plain times (CUDA events, median of 50 single
              calls, L2 flushed before each), each kernel's bound from
              this run's inputs, and the median ``serve_batch`` wall time
              with the kernels and with the plain versions.
6. flash_decode -- the decode-attention kernel against its plain version:
              f32, bf16 and the serving path's f32 query over a bf16
              cache, at the shapes of ``tests/test_kernels.py``, the
              smollm-135m shape, a ragged S, and kv_len 0, 1, S and > S.
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
              byte bounds at the path's shape and one ``decode_32k`` layer,
              and the median ``decode_step`` wall per token with the kernel
              and with the plain version, with the profiler's device time.

Then the ``kernels`` summary line, and last
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Any failed check raises, so the script exits non-zero; without CUDA it exits
non-zero before printing any result.

Run from the repository root: python3 chip_smoke.py
"""
from __future__ import annotations

import json
import os
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


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def bound_ms(nbytes: float, nops: float, ops_per_s: float = FP32_OPS_PER_S):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = nops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


class Timer:
    """Device time of one call (CUDA events), L2 flushed before each sample
    by reading a 128 MB buffer: a read leaves no dirty lines whose write-back
    would overlap the timed call. Median and spread of ``reps`` samples."""

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


def device_profile(torch, run, nb: int):
    """Per step of ``run`` (which runs ``nb`` steps) under ``torch.profiler``:
    the device's busy time (one stream, so the sum of its kernels, copies and
    fills), the number of device operations and the heaviest ones by name."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
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
            "top_us": [[name[:70], n / nb, us / nb] for name, (n, us) in top]}


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


def flash_decode_cases(torch, np, rng):
    """(label, dtype label, q, k, v, kv_len) on the card. Rows 0-3 of a case
    with four or more rows take kv_len 0, 1, S and S + 5."""
    shapes = [("mha", 1, 4, 4, 32, 512), ("gqa4", 2, 8, 2, 64, 1024),
              ("mqa", 2, 16, 1, 128, 512), ("smollm", 8, 9, 3, 64, 1024),
              ("ragged", 4, 9, 3, 64, 1000), ("ragged_hd16", 5, 6, 2, 16, 77)]
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


def lm_phases(torch, np, timer, smi) -> dict:
    """Phases 6-8; returns the ``flash_decode`` entry of the kernels line."""
    from repro_torch import serve_lm
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.kernels import ops, ref
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

    # 8. timing: the kernel at the path's shape and one decode_32k layer
    def shape_times(B, S, L, t, reps):
        H, K, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
        g = torch.Generator(device="cuda").manual_seed(S)
        q = torch.randn((B, H, hd), generator=g, device="cuda", dtype=torch.bfloat16)
        k = torch.randn((B, S, K, hd), generator=g, device="cuda", dtype=torch.bfloat16)
        v = torch.randn((B, S, K, hd), generator=g, device="cuda", dtype=torch.bfloat16)
        kv_len = torch.full((B,), L, dtype=torch.int32, device="cuda")
        got = flash_decode(q, k, v, kv_len)
        err = float((got - ref.flash_decode_ref(q, k, v, kv_len)).abs().max())
        if err > FLASH_DECODE_TOL["bf16"]:
            raise AssertionError(f"flash_decode at B {B}, S {S}: error {err}")
        lib, reason = sdpa_call(torch, q, k, v, L)
        if lib is not None:
            lib_err = float((lib()[:, :, 0].float() - got).abs().max())
            if lib_err > FLASH_DECODE_TOL["bf16"]:
                raise AssertionError(f"SDPA disagrees with the kernel by {lib_err}")
        out = {"shape": {"B": B, "S": S, "kv_len": L, "H": H, "K": K, "hd": hd,
                         "dtype": "bf16"},
               "max_abs_err": err,
               "ms": t.ms(lambda: flash_decode(q, k, v, kv_len), reps),
               "plain_ms": t.ms(lambda: ref.flash_decode_ref(q, k, v, kv_len), reps),
               "library_ms": t.ms(lib, reps) if lib is not None else None,
               "library": "F.scaled_dot_product_attention(enable_gqa=True)"
                          if lib is not None else reason}
        out["bound_ms"], out["bound_by"] = bound_ms(
            *flash_decode_bytes_ops(q, k, kv_len), BF16_OPS_PER_S)
        return out

    path_shape = shape_times(B, S, T, timer, 0)
    d32 = SHAPES["decode_32k"]
    long_shape = shape_times(d32.global_batch, d32.seq_len, d32.seq_len, timer, 10)
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
                                        for p in range(T, T + 8)], 8)
        prof[name]["idle_share"] = (1.0 - prof[name]["device_busy_us"] / (wall_ms[name] * 1e3)
                                    if prof[name]["device_ops"] else None)
    model.use_kernels = True
    emit({"phase": "lm_timing", "card": smi,
          "flash_decode_path_shape": path_shape,
          "flash_decode_decode_32k": long_shape,
          "decode_step_ms_median": wall_ms,
          "decode_step_ms_min": {k: min(v) for k, v in walls.items()},
          "decode_steps": len(walls["kernels"]),
          "decode_step_profile": prof})
    return {"launches": launches["flash_decode"],
            "max_abs_err": max(max(err.values()), per_call, path_shape["max_abs_err"],
                               long_shape["max_abs_err"]),
            "ms": path_shape["ms"]["median"],
            "plain_ms": path_shape["plain_ms"]["median"],
            "bound_ms": path_shape["bound_ms"], "bound_by": path_shape["bound_by"],
            "library_ms": (path_shape["library_ms"] or {}).get("median")}


def main() -> int:
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
          "cuda": torch.version.cuda})

    # 2. build
    t0 = time.perf_counter()
    reports = build.build_all()
    ptxas = {name: [ln.strip() for ln in log.splitlines()
                    if "registers" in ln or "spill" in ln]
             for name, log in reports.items()}
    emit({"phase": "build", "seconds": round(time.perf_counter() - t0, 3),
          "ptxas": ptxas})

    # 3. each kernel against its plain version on the card
    rng = np.random.default_rng(0)
    err = {"gather_pool": 0.0, "cache_probe": 0.0}
    gp_cases = gather_pool_cases(torch, np, rng)
    for label, payload, scale, bias, idx in gp_cases:
        got = gather_pool(payload, scale, bias, idx)
        want = ref.gather_pool_ref(payload, scale, bias, idx)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, **GATHER_POOL_TOL, msg=label)
        err["gather_pool"] = max(err["gather_pool"],
                                 float((got - want).abs().max()))
    cp_cases = cache_probe_cases(torch, np, rng)
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
    timer = Timer(torch)
    _, payload, scale, bias, idx = gp_cases[0]
    gp_t = timer.ms(lambda: gather_pool(payload, scale, bias, idx))
    gp_plain_t = timer.ms(lambda: ref.gather_pool_ref(payload, scale, bias, idx))
    gp_ms, gp_plain = gp_t["median"], gp_plain_t["median"]
    gp_bound, gp_by = bound_ms(*gather_pool_bytes_ops(payload, idx))
    _, tt, tr, data, qt, qr, sets = cp_cases[0]
    cp_t = timer.ms(lambda: cache_probe(tt, tr, data, qt, qr, sets))
    cp_plain_t = timer.ms(lambda: ref.cache_probe_ref(tt, tr, data, qt, qr, sets))
    cp_ms, cp_plain = cp_t["median"], cp_plain_t["median"]
    hits = int(cache_probe(tt, tr, data, qt, qr, sets)[1].sum())
    cp_bound, cp_by = bound_ms(*cache_probe_bytes_ops(tt, data, qt, hits, sets))

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
    prof = {name: device_profile(
                torch, lambda eng=eng: [eng.serve_batch(tb["user"], bg_iops=10_000.0)
                                        for tb in timing[:8]], 8)
            for name, eng in (("kernels", engine), ("plain", engine_plain))}
    for name, p in prof.items():             # no device events: not measured
        p["idle_share"] = (1.0 - p["device_busy_us"] / (wall_ms[name] * 1e3)
                           if p["device_ops"] else None)
    emit({"phase": "timing", "card": smi,
          "gather_pool": {"ms": gp_t, "plain_ms": gp_plain_t, "bound_ms": gp_bound,
                          "shape": list(idx.shape), "rows": payload.shape[0]},
          "cache_probe": {"ms": cp_t, "plain_ms": cp_plain_t, "bound_ms": cp_bound,
                          "probes": qt.shape[0], "hits": hits},
          "serve_batch_ms_median": wall_ms,
          "serve_batch_batches": len(walls["kernels"]),
          "serve_batch_profile": prof,
          "launches_per_batch": {k: launches[k] / len(traffic)
                                 for k in ("gather_pool", "cache_probe")}})

    # 6-8. the LM decode path and its flash_decode kernel
    fd = lm_phases(torch, np, timer, smi)

    emit({"kernels": [
        {"name": "gather_pool", "route": "cuda",
         "source": "src/repro_torch/csrc/gather_pool.cu",
         "replaces": "src/repro/kernels/gather_pool.py:57",
         "launches": launches["gather_pool"],
         "max_abs_err": err["gather_pool"], "ms": gp_ms, "plain_ms": gp_plain,
         "bound_ms": gp_bound, "bound_by": gp_by, "library_ms": None},
        {"name": "cache_probe", "route": "cuda",
         "source": "src/repro_torch/csrc/cache_probe.cu",
         "replaces": "src/repro/kernels/cache_probe.py:58",
         "launches": launches["cache_probe"],
         "max_abs_err": err["cache_probe"], "ms": cp_ms, "plain_ms": cp_plain,
         "bound_ms": cp_bound, "bound_by": cp_by, "library_ms": None},
        {"name": "flash_decode", "route": "cuda",
         "source": "src/repro_torch/csrc/flash_decode.cu",
         "replaces": "src/repro/kernels/flash_decode.py:88", **fd},
    ]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
