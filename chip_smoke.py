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
              probes into a 1,048,576 x 8 x 128 f32 cache), made on the card;
              ``densify`` bit for bit at M1's and M2's chunk shapes (32
              queries over 61 and 450 tables, P 64), with keys out of range
              counted, and at P 1, 2 and 4.
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
              ``reference_pool``, each kernel (``densify`` included, whose
              block, mask and count must equal the plain version's exactly)
              launched once a batch (the counters zeroed just before and
              read just after); (b) the
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
              of ``reference_pool``, the step's kernels launched 8 times a
              batch and ``densify`` once (one block a distinct device);
              (b) both layouts at 1, 2, 4 and 8 shards beside the
              single-device engine: 1 shard equal to it in everything, every
              count's cold first batch equal to it in per-query ``sm_ios``;
              hit rate, ``sm_ios``, the store's bytes, the median
              ``serve_columnar`` wall and a profile of 8 more batches; (c)
              the 4e8 cut at 4 shards on the card and on the CPU, 8 batches:
              ``sm_ios``, ``sm_time_us``, hit rate and each shard's cache
              state equal, pooled within the tolerance.
host_plane -- the reference example's path (``examples/serve_dlrm.py``) at
              M1 (``repro_torch.serve_dlrm --host-plane``): the SDM host
              plane (``SDMEmbeddingStore`` + ``ServeScheduler``, numpy on the
              host) serves 512 ``zipf_steady`` queries of the 61 user and 30
              item tables chunk by chunk, beside the device engine over the
              same user tables at D 128 on the card and a small DLRM
              scoring 50 items a chunk. (a) Analytic, then sampled at 240
              QPS with the update write stream and the §4.1 knobs, every
              kernel call shadowed by its plain version (``densify``
              included), each kernel once a chunk (counters zeroed just
              before, read just after); the
              engine's pooled bags within the columnar tolerance of
              ``reference_pool``; write waves and GC pauses; a second
              sampled run of the same seed equal in every latency and
              stat; ``serve_columnar`` equal to per-query ``serve_query`` on
              the first 2 chunks; hit rates, tiers, replay and fallback
              counts, percentiles, feasible QPS and the Table 8 power
              model's statement. (b) The median wall per 32-query chunk of
              the host plane's ``serve_columnar`` (analytic and sampled)
              beside the device engine's on the same chunks. (c) The host
              mirror: the trace's keys that fall in 24 of the cache's 7,281
              sets, one access at a time, through ``TorchRowCache`` (the
              ``cache_probe`` kernel) and ``SetAssocSimCache`` at the
              device's set index: identical hit/miss at every access.
fleet_plane -- the fleet's device plane (``ClusterSim.run_device_plane``
              of ``serve_dlrm.build_fleet``'s hosts) over trace_path's M1 trace
              and tables (made on the card): simulated HW-SS hosts (Nand x 2,
              an 8 MiB cache budget, so each engine has trace_path's 7,281 x 8
              cache), each serving its routed share on its own engine. (a)
              One host: ``sm_ios`` and hit rate equal trace_path's engine.
              (b) Three hosts round robin, the last a 2-shard row-layout mesh
              slice with both shards on the card: kernel engines with
              telemetry (every kernel call shadowed by its plain version,
              the counters zeroed just before and read just after, the
              step's kernels once a chunk a shard and ``densify`` once a
              chunk, the shards sharing the card), kernel engines without it, and
              ``use_kernels=False`` engines, every ``HostReport`` field and
              the fleet percentiles equal; each host's engine build time,
              store bytes and ``serve_columnar`` walls, and the merged
              registry. (c) The 4e8 cut of (b) on the card and on the CPU:
              reports and merged registries equal. (d) ``repro_torch.
              fleet_control`` (outage, degraded mode, autoscale, capacity
              plan; numpy on the host) at its default 2,000 queries, with
              its wall.
train_path -- the training slice (``repro_torch.train_dlrm``,
              ``repro_torch.lm_train``). (a) ``train_dlrm``'s arch at full
              width (6 x 200,000 user + 3 x 100,000 item tables, D 64,
              pooling 8, 96,342,849 parameters), batch 256, AdamW with
              ``cosine_schedule(2e-3, warmup=50, total=40)`` and weight decay
              1e-5, checkpoints every 20 steps under ``build/`` (removed at
              the end): run A 40 steps uninterrupted; run B killed by its
              failure hook at step 27; run B', a fresh ``Trainer`` on B's
              directory, resumes from step 20 and must end equal to A bit for
              bit in every leaf of params, ``m``, ``v`` and ``step``. The
              first 5 steps again on the card (equal to A's losses) and on
              the CPU: step 0's loss and global norm within 1e-5, every loss
              within 1e-4, the largest param gap after step 5 printed. A
              same-batch overfit of 5 steps (AdamW 2e-3) must descend. The
              median step wall over steps 5-39 of A, a profile of 5 more
              steps, ``CheckpointManager.save`` and ``restore`` seconds and
              bytes. (b) ``microbatches=4`` against the plain step from A's
              final state (AdamW 1e-4; indices fed batch-major, since both
              split every batch leaf on its leading dim): the accumulated
              grads (before clipping) within 1e-6 of the plain step's in
              every element, loss within 1e-5, params within 1e-3. (c) Train to serve: A's trained user
              tables go out through ``incremental_embedding_update``, are
              read back with numpy into a ``DeviceServingEngine``
              (``EngineConfig()``) on the card, and the trained model scores
              4 batches of ``make_traffic(queries=128, batch=32,
              item_batch=50)`` through ``serve_dlrm.serve``, every kernel
              call shadowed by its plain version, each kernel once a batch
              (counters zeroed just before, read just after). (d)
              ``smollm-135m`` at full width through ``lm_train``'s path:
              batch 8, seq 64, AdamW 1e-3, 10 steps on the card; step 0's
              loss within 1e-4 of one CPU step; a 5-step same-batch overfit
              descends; the median step wall and a profile. Then 3 steps at
              ``train_4k``'s sequence (batch 8 x 4,096 tokens), finite
              losses, their median wall and a profile of one more.
6. flash_decode -- the decode-attention kernel against its plain version:
              f32, bf16 and the serving path's f32 query over a bf16
              cache, at the shapes of ``tests/test_kernels.py``, the
              smollm-135m, granite-3-2b (G 4), granite-34b (G 48, hd
              128) and llama-3.2-vision-90b (G 8, hd 128: self layers over
              512 positions, cross layers over 1,601 image keys) shapes,
              ragged S, and kv_len 0, 1, S and > S; the arrival counters
              are all 0 afterwards.
7. lm_main -- the LM serving path (``repro_torch.serve_lm``) at the full
              ``smollm-135m`` width: 8 sequences decoded for 256 positions
              of a 1,024-position cache. (a) f32 cache on the card against
              the same run on the CPU over the first 32 positions, logits
              within 1e-4 (``flash_decode`` 30 x 32 times); (b) the serving
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
              median ``decode_step`` wall per token with the kernel (through
              its ``torch.library`` operator, and called straight from
              Python as before the registration) and with the plain
              version, in turns, with the profiler's device time; the
              profile must show one ``flash_decode`` kernel per layer and no
              combine kernel.

lm_families -- the MoE, SSM and hybrid LM families (``repro_torch.serve_lm``,
              ``repro_torch.lm_train``) at full width, f32 weights from seed
              0, one arch at a time, depth cut: ``deepseek-moe-16b`` 4 of 28
              layers, ``mixtral-8x22b`` 1 of 56, ``mamba2-1.3b`` all 48,
              ``zamba2-1.2b`` all 38. (a) f32 caches, 8 sequences x 16
              positions on the card and on the CPU: every layer call of
              steps 0, 1, 7 and 15 replayed on the card from the CPU's input
              and cache, output and cache within 1e-4; for the MoE archs
              the experts each token chose at each layer call equal (a
              difference whose gates are within 1e-6 is reported as a tie;
              any other fails); the logits within the end-to-end limit, the
              larger of 1e-4 and twice the CPU's own decode-vs-prefill gap
              on the same weights (the f32 rounding of 48 SSD layers at
              full width reaches 1e-4 by itself). ``mamba2-1.3b`` runs (a)
              and (c) at 32 positions against a float64 CPU copy of the
              same weights instead: the recorded layer calls, the decode
              and the prefill again in float64; the card's f32 decode and
              prefill each within 3e-4 of it, the CPU's f32 errors beside
              (the card's own f32 error told apart from the CPU's). (b) The bf16 serving
              cache through ``serve_lm.decode``, 8 x 128 positions into a
              cache of 512: ``flash_decode`` launched exactly 4 x 128
              (deepseek) and 6 x 128 (zamba2's shared-block calls) times,
              none on mixtral's sliding window or mamba2 (counters zeroed
              just before, read just after); on the two kernel paths none
              with ``use_kernels=False``, and each call within 2e-2 of its
              plain version on that call's inputs. (c) Decode against
              prefill on the card over the 16 positions, f32, drops off:
              within the end-to-end limit. (d) The median ``decode_step``
              wall with and without the kernel, a profile (device busy µs,
              operations, idle share, the MoE layers' share of device
              time), and the kernel's, plain and SDPA times and bound at
              the deepseek and zamba2 shapes. (e)
              ``lm_train.build`` on each reduced config, step 0's loss card
              vs CPU within 1e-4; one full-width ``mamba2-1.3b`` step at 4
              layers, batch 2 x 512 tokens (two 256-token chunks), every
              grad finite.
lm_vlm_encoder -- the VLM and encoder families at full width, f32 weights
              from seed 0. ``llama-3.2-vision-90b`` cut to one section (its
              cross layer and 5 of 100 self layers: the whole model is
              104.8B parameters by ``param_count()``), every cross gate set
              to 0.5 on both copies (the reference's init leaves it at 0,
              where ``tanh(0)`` hides the cross layers from every logit),
              the host's free memory checked first, 8 sequences with
              ``make_images(seed=2)``: (a) 16 f32 positions card vs CPU, the
              image K/V fill, the logits and every layer call of steps 0,
              1, 7 and 15 replayed on the card within 1e-4; (b) 128
              positions into a bf16 cache of 512, ``flash_decode`` launched
              exactly 6 x 128 times (5 self calls and 1 cross call a step;
              counters zeroed just before, read just after), none with
              ``use_kernels=False``, each call within 2e-2 of its plain
              version; (c) decode vs prefill on the card, f32, within 1e-4;
              (d) the step wall with and without the kernel, a profile,
              and the kernel's, plain and SDPA times and bounds at the
              self shape and the cross shape (bf16 and f32).
              ``hubert-xlarge`` uncut (48 layers): prefill of 8 x 1,000
              frames timed and profiled, no kernel launched; card vs CPU
              at 2 x 500 within 1e-4; one full-width train step at 8 x
              1,000, every grad finite; the reduced configs' step-0 loss
              card vs CPU (the encoder's within 1e-6).

launch -- the launch tooling (``repro_torch.launch``). (a) The dry-run
              sweep, ``python -m repro_torch.launch.dryrun --mesh both`` in a
              subprocess with a timeout, on fake CUDA tensors over a fake
              process group: every (arch, shape) cell of the 16x16 and
              2x16x16 meshes ``ok`` or ``skipped`` with the reference's
              reason, each cell's fit, bottleneck and trace seconds, and
              the sweep's seconds (a cell that does not fit 80 GB is
              reported, not failed). (b) The tool against the card, while
              the sweep runs: ``smollm-135m`` train at 8 x 4,096 and its
              decode step (8 sequences into a 1,024-position cache, 1,023
              written) on ``make_host_mesh()`` (one rank, NCCL), each built
              by ``steps.build_step`` once on fake tensors (the sweep's
              method: two cut depths extrapolated) and once for real (seeded
              weights, bf16): FLOPs equal, the predicted peak within 10% of
              the measured one (``torch.cuda.max_memory_allocated`` above
              what was allocated just before the step, plus the step's
              arguments), the roofline time beside the measured wall; the
              decode step launches ``flash_decode`` 30 times (counters
              zeroed just before, read just after), its logits bit-equal to
              the plain-tensor decode step on the same weights and cache,
              and the kernel's ``lse`` within 1e-5 of the plain version's
              at the path's shape.

Then the ``kernels`` summary line, and last
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Any failed check raises, so the script exits non-zero; without CUDA it exits
non-zero before printing any result.

Run from the repository root: python3 chip_smoke.py. With ``--kernels`` it
runs phases 1-3 and the kernel times of phase 5 only, and prints no ``ok``
line (a quick check of the DLRM kernels, or of another checkout's).
"""
from __future__ import annotations

import dataclasses
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
LM_F32_TOKENS = 32               # phase 7 (a): card vs CPU, f32 caches
SPIN_CYCLES = 1_000_000          # about 0.5 ms at the H100's clock
PROFILE_MARKS, PROFILE_MARK_CYCLES = 4096, 1_000  # device_profile's window marks
# m1_batch: 128 queries of the paper's M1 (src/repro/configs/dlrm_models.py:4-19):
# 61 user tables pooling 42 rows each, 128-byte rows (136 with scale and bias)
M1_GATHER_POOL = dict(R=1 << 24, D=128, N=128 * 61, P=42)
M1_CACHE_PROBE = dict(S=1 << 20, W=8, D=128, N=128 * 61 * 42)
# densify at the benchmark's chunk shapes: 32 queries over M1's 61 tables
# (pooling 42: 85,856 keys, P 64) and M2's 450 (pooling 25: 359,200 keys,
# P 64), int64 keys as the trace carries them
DENSIFY_CHUNKS = {"m1_chunk": dict(B=32, T=61, lo=20, hi=64),
                  "m2_chunk": dict(B=32, T=450, lo=1, hi=49)}
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
# host_plane: the reference example's path (examples/serve_dlrm.py:83-161) at
# M1, the SDM host plane beside the device engine on trace_path's inventory
HOST_QUERIES = 512               # (a) and (b): 16 chunks of TRACE_BATCH
HOST_PREFIX_CHUNKS = 2           # (a): serve_columnar vs serve_query prefix
HOST_MIRROR_SETS = 24            # (c): sets the mirrored keys are drawn from
# fleet_plane: trace_path's M1 trace routed over simulated HW-SS hosts, each
# serving its share on its own device engine; the last host a mesh slice whose
# shards share the one card
FLEET_HOSTS, FLEET_MESH_SHARDS = 3, 2
# train_path: repro_torch.train_dlrm's arch and optimizer (examples/train_dlrm.py:27-37)
# and lm_train's smollm-135m path (examples/lm_train.py)
TRAIN_BATCH, TRAIN_STEPS, TRAIN_CKPT_EVERY, TRAIN_FAIL_AT = 256, 40, 20, 27
TRAIN_CPU_STEPS, TRAIN_OVERFIT, TRAIN_PROFILED, TRAIN_MICROBATCHES = 5, 5, 5, 4
TRAIN_TOL, TRAIN_CPU_TOL = 1e-5, 1e-4
# loss and params: tests/test_arch_smoke.py:114-119; grads: every element, set
# from the 1.9e-8 a CPU run at batch 256 shows (a wrong accumulation is off by
# about the grads' own size, up to 6e-2 there)
MICROBATCH_TOL = dict(loss=1e-5, params=1e-3, grads=1e-6)
LM_TRAIN_ARCH, LM_TRAIN_BATCH, LM_TRAIN_SEQ, LM_TRAIN_STEPS = "smollm-135m", 8, 64, 10
LM_LONG_SEQ, LM_LONG_STEPS = 4_096, 3            # train_4k's sequence
# lm_families: the MoE, SSM and hybrid archs at full width (f32 weights), each
# arch's depth cut to fit the card and the phase's time (PERF.md section 4),
# with the flash_decode calls a decode step makes: every layer of deepseek
# (MHA, hd 128), every shared-block call of zamba2 (MHA, hd 64); none on
# mixtral's sliding window (its ring goes through attention_core) or mamba2
FAMILIES = {"deepseek-moe-16b": (4, 4), "mixtral-8x22b": (1, 0), "mamba2-1.3b": (48, 0),
            "zamba2-1.2b": (38, 6)}
FAMILY_BATCH, FAMILY_F32_TOKENS = 8, 16          # (a) card vs CPU and (c), f32 caches
# mamba2: (a) and (c) at 32 positions, held against a float64 CPU copy of the
# same weights (every f32 cast of its path follows the input dtype): the card's
# f32 decode and prefill each within FAMILY_F64_TOL of the float64 run's
FAMILY_F64_ARCH, FAMILY_F64_TOKENS, FAMILY_F64_TOL = "mamba2-1.3b", 32, 3e-4
FAMILY_TOKENS, FAMILY_MAX_LEN = 128, 512         # (b) the bf16 serving cache
FAMILY_TIMED, FAMILY_WARM, FAMILY_PROFILED = 24, 4, 4   # (d) steps in turns, profiled
FAMILY_TIE_GAP = 1e-6                            # (a) a routing tie: gates this close
FAMILY_TRAIN = ("mamba2-1.3b", 4, 2, 512)        # (e) arch, layers, batch, seq: 2 chunks
# lm_vlm_encoder: the VLM at full width cut to one section (its cross layer and
# 5 of 100 self layers; the whole model is 104.8B parameters by param_count()),
# every cross gate opened to VLM_GATE (the reference's init leaves it at 0,
# where tanh(0) hides the cross layers from every logit); the encoder uncut
VLM_ARCH, VLM_SECTIONS, VLM_GATE, VLM_IMAGE_SEED = "llama-3.2-vision-90b", 1, 0.5, 2
VLM_BATCH, VLM_F32_TOKENS = 8, 16                # (a) card vs CPU and (c), f32 caches
VLM_TOKENS, VLM_MAX_LEN = 128, 512               # (b) the bf16 serving cache
ENC_ARCH, ENC_BATCH, ENC_FRAMES = "hubert-xlarge", 8, 1_000   # 20 s of audio at 50 Hz
ENC_CPU_BATCH, ENC_CPU_FRAMES = 2, 500           # card vs CPU prefill
ENC_STEP0_TOL = 1e-6                             # the reduced config's step-0 loss
# launch: the fake-mesh dry-run of every (arch, shape, mesh) cell in a
# subprocess, and the tool against the card on two one-card smollm-135m cells
LAUNCH_ARCH, LAUNCH_BATCH, LAUNCH_CACHE = "smollm-135m", 8, 1024   # (b) train 8 x 4,096
LAUNCH_MEM_TOL, LAUNCH_LSE_TOL = 0.10, 1e-5      # predicted vs measured peak; lse
LAUNCH_SWEEP_TIMEOUT, LAUNCH_TIMED = 300, 3      # (a) seconds; (b) timed steps


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


def densify_case(torch, np, rng, label, B, T, lo, hi, bad=False):
    """(label, values, row_seg, seg_offsets, rows_per_table, P) on the card:
    a chunk of B queries over T tables, each touching 90% of them with bags
    of lo to hi keys (one of hi), int64 keys below each table's rows; with
    ``bad`` a negative key, one at its table's rows and one past 2**31."""
    rows = rng.integers(1, 2_000_000, T).astype(np.int64)
    row_seg = np.full(B * T, -1, np.int32)
    seg_rows = np.flatnonzero(rng.random(B * T) < 0.9)
    row_seg[seg_rows] = np.arange(len(seg_rows), dtype=np.int32)
    lens = rng.integers(lo, hi + 1, len(seg_rows))
    lens[0] = hi
    offsets = np.r_[0, np.cumsum(lens)].astype(np.int32)
    limit = np.repeat(rows[seg_rows % T], lens)
    values = (rng.random(len(limit)) * limit).astype(np.int64)
    if bad:
        values[[0, len(values) // 2]] = [-1, limit[len(values) // 2]]
        values[-1] = 2 ** 31 + 5
    return (label,) + tuple(torch.from_numpy(a).cuda() for a in (
        values, row_seg, offsets, rows)) + (1 << (hi - 1).bit_length(),)


def densify_cases(torch, np, rng):
    """``densify`` at M1's and M2's chunk shapes (once with keys out of
    range), and at P 1, 2 and 4, where a thread's slots span rows."""
    cases = [densify_case(torch, np, rng, k, **v) for k, v in DENSIFY_CHUNKS.items()]
    cases.append(densify_case(torch, np, rng, "m2_chunk_bad", **DENSIFY_CHUNKS["m2_chunk"],
                              bad=True))
    for hi in (1, 2, 3):
        cases.append(densify_case(torch, np, rng, f"p{hi}", 5, 7, 0, hi, bad=True))
    return cases


def densify_bytes_ops(values, row_seg, offsets, rows, P):
    """Each input byte read once, each slot written once (4 + 1 bytes); no
    arithmetic."""
    N = row_seg.shape[0]
    nbytes = (values.numel() * values.element_size() + 4 * N + 4 * offsets.numel()
              + 8 * rows.numel() + 5 * N * P + 4)
    return nbytes, 0


def densify_times(torch, timer, case, reps: int = 20) -> dict:
    """Kernel and plain times of ``densify`` on one case, with its bound (no
    PyTorch call builds a padded block from CSR arrays)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.densify import densify
    _, values, row_seg, offsets, rows, P = case
    out = {"shape": {"N": row_seg.shape[0], "P": P, "keys": values.numel(),
                     "dtype": str(values.dtype)},
           "ms": timer.ms(lambda: densify(values, row_seg, offsets, rows, P), reps),
           "plain_ms": timer.ms(lambda: ref.densify_ref(values, row_seg, offsets, rows, P),
                                reps),
           "library_ms": None}
    out["bound_ms"], out["bound_by"] = bound_ms(*densify_bytes_ops(values, row_seg, offsets,
                                                                   rows, P))
    return out


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
    ``named``.

    The trace drops a varying number of the first kernel records of a
    profile (0 to 60 of 64 back-to-back spin kernels in one full run, all of
    256 by phase ``sharded_path`` of another, and two spin kernels 1 s apart
    in a third; the first ``flash_decode`` of a VLM step once), however long
    the host waits. So ``PROFILE_MARKS`` short spin kernels are launched and
    waited for before ``run``, only the events after the last one recorded
    count, and a trace that holds none of them raises; ``marks_lost`` says
    how many were dropped."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:   # device events only
        for _ in range(PROFILE_MARKS):
            torch.cuda._sleep(PROFILE_MARK_CYCLES)
        torch.cuda.synchronize()
        run()
        torch.cuda.synchronize()
    events = sorted((e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA),
                    key=lambda e: e.time_range.start)
    marks = [i for i, e in enumerate(events) if "spin_kernel" in e.name]
    if not marks:
        raise AssertionError(f"the profiler dropped all {PROFILE_MARKS} spin kernels ahead "
                             f"of the window: its first events may be missing too")
    by_name = {}
    for e in events[marks[-1] + 1:]:
        n, us = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, us + e.time_range.elapsed_us())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:8]
    return {"marks_lost": PROFILE_MARKS - len(marks),
            "device_busy_us": sum(us for _, us in by_name.values()) / nb,
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


def dlrm_kernel_times(torch, timer, gp_cases, cp_cases, dn_cases) -> dict:
    """Phase 5's kernel times: each DLRM kernel at the path's shape (the
    first case) and at ``m1_batch`` (the last), what holds ``gather_pool``
    there, ``densify`` at M1's and M2's chunks, and the timer's floor, a
    one-element ``zero_()`` timed the same way."""
    tiny = torch.zeros(1, device="cuda")
    return {"timer_floor_ms": timer.ms(lambda: tiny.zero_()),
            "densify": {c[0]: densify_times(torch, timer, c) for c in dn_cases
                        if c[0] in DENSIFY_CHUNKS},
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
              ("granite_3_2b", 5, 32, 8, 64, 300), ("granite_34b", 4, 48, 1, 128, 1000),
              ("vlm_self", 8, 64, 8, 128, 512), ("vlm_cross", 8, 64, 8, 128, 1601)]
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
    call disagreed and returns the largest difference of each kernel (for
    ``densify``, the most slots and counts of one call that differ: its
    block, mask and count are compared exactly); ``last`` holds each
    kernel's inputs of its last call, the probe's cache state cloned (the
    fill updates it in place; nothing writes the store)."""
    gp_call, cp_call = ops.embedding_gather_pool, ops.row_cache_probe
    dn_call = ops.csr_densify
    last = {}
    worst = {"gather_pool": torch.zeros((), device="cuda"),
             "cache_probe": torch.zeros((), device="cuda"),
             "densify": torch.zeros((), device="cuda")}
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

    def csr_densify(values, row_seg, seg_offsets, rows_per_table, P, *, use_kernel=True):
        out = dn_call(values, row_seg, seg_offsets, rows_per_table, P, use_kernel=use_kernel)
        if use_kernel:
            last["densify"] = (values, row_seg, seg_offsets, rows_per_table, P)
            want = ref.densify_ref(values, row_seg, seg_offsets, rows_per_table, P)
            if any(g.dtype != w.dtype or g.shape != w.shape for g, w in zip(out, want)):
                raise AssertionError("densify: the kernel's outputs are not the plain "
                                     "version's dtypes and shapes")
            differ = sum((g != w).sum() for g, w in zip(out, want))
            torch.maximum(worst["densify"], differ.float(), out=worst["densify"])
            bad.logical_or_(differ > 0)
        return out

    def restore():
        ops.embedding_gather_pool, ops.row_cache_probe = gp_call, cp_call
        ops.csr_densify = dn_call

    def check():
        if bool(bad):
            raise AssertionError(f"a DLRM kernel call disagreed with its plain "
                                 f"version: {worst}")
        return {k: float(v) for k, v in worst.items()}
    ops.embedding_gather_pool, ops.row_cache_probe = gather_pool, cache_probe
    ops.csr_densify = csr_densify
    return restore, check, last


def trace_kernel_times(torch, timer, got) -> dict:
    """Kernel, plain and library times of the DLRM kernels on the inputs
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
                                             20),
            "densify": densify_times(torch, timer, ("trace_path", *got["densify"]))}


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
    kernel_names = ("gather_pool", "cache_probe", "densify")
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
    hit_rate_a, kern_a_ios = kern.hit_rate, kern.stats.sm_ios
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
          "sm_ios": int(kern_a_ios), "kernel_vs_plain_per_call": kernel_err,
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
                              "W": kern.cache.geo.ways, "D": D},
              "densify": {"N": B * T, "P": TRACE_P}},
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
            "times": times, "sm_ios": int(kern_a_ios), "hit_rate": hit_rate_a}


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
    kernel_names = ("gather_pool", "cache_probe", "densify")
    t_phase = time.perf_counter()
    spec = serve_dlrm.m1_spec(name, queries=TRACE_QUERIES, table_bytes=TRACE_TABLE_BYTES)
    chunks = list(build_trace(spec).chunks(B))
    shared = "cuda:0"

    def per_call(eng, n):
        """Launches a batch: the step's kernels once a shard, ``densify``
        once a distinct device (here the one card)."""
        return {"gather_pool": n, "cache_probe": n, "densify": len(set(eng.devices))}

    def engine(n, layout, use_kernels=True):
        return serve_dlrm.build_trace_engine(
            spec, D, seed=0, torch_device="cuda",
            cfg=EngineConfig(use_kernels=use_kernels), shards=n, layout=layout,
            devices=[shared] * n)

    def store(eng):
        return {"L": eng.sentinel, "store_bytes": engine_store_bytes(eng)}

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
            want = per_call(kern, n)
            if any(counts[k] != want[k] * len(chunks) for k in kernel_names):
                raise AssertionError(f"sharded path ({layout}): {counts} launches over "
                                     f"{len(chunks)} batches, want {want} a batch")
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
        named, want = prof["ops_named"], per_call(eng, n)
        if any(named[k] != want[k] for k in kernel_names):
            raise AssertionError(f"{n} shards: profile shows {named} kernels a batch, "
                                 f"want {want}")
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


def host_plane(torch, np, smi) -> dict:
    """Phase ``host_plane``; returns the launches of its main run (a) and
    each kernel's largest difference from its plain version there."""
    from repro_torch import serve_dlrm
    from repro_torch.core.cache import TorchRowCache, set_index
    from repro_torch.core.cache_sim import SetAssocSimCache
    from repro_torch.kernels import ops, ref
    from repro_torch.models.dlrm import DLRM
    from repro_torch.runtime.engine import EngineConfig
    from repro_torch.workloads import build_trace

    B, D, name = TRACE_BATCH, TRACE_DIM, TRACE_ARCHETYPE
    kernel_names = ("gather_pool", "cache_probe", "densify")
    t_phase = time.perf_counter()
    specs = {mode: serve_dlrm.host_plane_spec(name, queries=HOST_QUERIES,
                                              table_bytes=TRACE_TABLE_BYTES,
                                              latency_mode=mode)
             for mode in ("analytic", "sampled")}
    traces = {mode: build_trace(spec) for mode, spec in specs.items()}
    metas = traces["analytic"].all_metas()
    users = [m for m in metas if m.kind == "user"]
    if (len(users), len(metas) - len(users), sum(m.num_rows for m in users)) != \
            (61, 30, TRACE_ROWS):
        raise AssertionError(f"M1 inventory: {len(users)} user tables of "
                             f"{sum(m.num_rows for m in users)} rows, {len(metas)} in all")
    t0 = time.perf_counter()
    kern = serve_dlrm.build_trace_engine(specs["analytic"], D, seed=0,
                                         torch_device="cuda", cfg=EngineConfig())
    model = DLRM(serve_dlrm.SCORING_ARCH, device="cuda",
                 generator=torch.Generator().manual_seed(1))
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    setup_s = time.perf_counter() - t0

    def plane(mode):
        return serve_dlrm.build_host_plane(
            traces[mode], latency_mode=mode, updating=mode == "sampled",
            tuned=mode == "sampled")

    def summary(store, sched, res):
        tiers = {t: res.tiers.count(t) for t in sorted(set(res.tiers))}
        p50, p95, p99 = (sched.percentile(p) for p in (50, 95, 99))
        out = {"queries": res.queries, "chunks": res.chunks,
               "row_hit_rate": store.row_hit_rate,
               "pooled_hit_rate": store.pooled_hit_rate, "last_tier_counts": tiers,
               "chunk_plan_hits": store.chunk_plan_hits,
               "batch_fallbacks": store.batch_fallbacks,
               "latency_us_p50_p95_p99": [p50, p95, p99],
               "feasible_qps": sched.qps_at_latency(),
               "inflight": sched.inflight, "deferred": sched.deferred,
               "sm_ios": int(store.stats.sm_ios),
               "engine_hit_rate": kern.hit_rate, "engine_sm_ios": res.engine_sm_ios,
               "engine_pooled_max_abs": res.max_dev_err,
               "engine_pooled_gap_over_tolerance": res.max_dev_gap,
               "mean_ctr_score": res.mean_score}
        sim = store.io.sim
        if sim is not None and sim.update is not None:
            out["update_waves"], out["gc_pauses"] = sim.update.waves, sim.update.gc_events
        return out

    # (a) the reference example's path: analytic, then sampled with the update
    # stream and the tuning knobs, the device engine beside each on the card
    # with every kernel call shadowed by its plain version
    runs, planes = {}, {}
    restore, check, _ = shadowed_dlrm_kernels(torch, ops, ref)
    try:
        ops.reset_launch_counts()
        for mode in ("analytic", "sampled"):
            store, sched = planes[mode] = plane(mode)
            res = serve_dlrm.serve_host_plane(sched, kern, traces[mode], B, model=model,
                                              bg_iops=TRACE_BG_IOPS)
            runs[mode] = summary(store, sched, res)
            if res.max_dev_gap > 1.0 or not np.isfinite(res.mean_score):
                raise AssertionError(f"host plane ({mode}): device engine pooled "
                                     f"{res.max_dev_err} outside {TRACE_POOL_TOL}, "
                                     f"score {res.mean_score}")
        torch.cuda.synchronize()
        launches = ops.launch_counts()
    finally:
        restore()
    kernel_err = check()
    n_chunks = runs["analytic"]["chunks"] + runs["sampled"]["chunks"]
    if any(launches[k] != n_chunks for k in kernel_names):
        raise AssertionError(f"host plane: {launches} launches over {n_chunks} chunks, "
                             "want each DLRM kernel once a chunk")
    sampled = runs["sampled"]
    if not (sampled.get("update_waves", 0) > 0 and sampled.get("gc_pauses", 0) > 0):
        raise AssertionError(f"--updating: {sampled.get('update_waves')} write waves, "
                             f"{sampled.get('gc_pauses')} GC pauses")
    # the same trace again through a fresh sampled plane of the same seed
    store, sched = planes["sampled"]
    again_store, again = plane("sampled")
    for ch in traces["sampled"].chunks(B):
        again.serve_columnar(ch.columnar, bg_iops=TRACE_BG_IOPS,
                             arrivals_us=ch.arrival_us, collect=False)
    if again.p_lat != sched.p_lat or \
            dataclasses.astuple(again_store.stats) != dataclasses.astuple(store.stats):
        raise AssertionError("sampled plane: a second run of the same seed differs")
    # serve_columnar against per-query serve_query on a prefix, fresh planes
    prefix = {}
    for mode in ("analytic", "sampled"):
        (a, _), (b, _) = plane(mode), plane(mode)
        for ch in list(traces[mode].chunks(B))[:HOST_PREFIX_CHUNKS]:
            a.serve_columnar(ch.columnar, TRACE_BG_IOPS, arrivals_us=ch.arrival_us)
            for req, at in zip(ch.requests, ch.arrival_us.tolist()):
                b.serve_query(req, TRACE_BG_IOPS, at_us=at)
        if dataclasses.astuple(a.stats) != dataclasses.astuple(b.stats):
            raise AssertionError(f"{mode}: serve_columnar and serve_query differ on "
                                 f"the first {HOST_PREFIX_CHUNKS} chunks")
        prefix[mode] = dataclasses.asdict(a.stats)
    base, sdm = serve_dlrm.fleet_power(planes["analytic"][0])
    emit({"phase": "host_plane", "part": "a_reference_path", "archetype": name,
          "inventory": {"user_tables": 61, "item_tables": 30, "user_rows": TRACE_ROWS,
                        "table_bytes": TRACE_TABLE_BYTES},
          "offered_qps": {m: t.offered_qps for m, t in traces.items()},
          "host_plane": "SDMEmbeddingStore(fm_cache_bytes=128 MiB, pooled_cache_bytes"
                        "=16 MiB, nand_flash) + ServeScheduler(item_compute_us=200)",
          "runs": runs, "launches": launches, "kernel_vs_plain_per_call": kernel_err,
          "sampled_rerun_equal": True, "prefix_chunks": HOST_PREFIX_CHUNKS,
          "prefix_stats": prefix,
          "fleet_power_model": {
              "what": "Table 8 power model output (core/power.py) at the analytic "
                      "run's row hit rate, not a measurement",
              "HW-L": base.total_power, "HW-SS+SDM": sdm.total_power,
              "saving": 1 - sdm.total_power / base.total_power},
          "setup_s": setup_s, "part_s": time.perf_counter() - t_phase})

    # (b) walls per chunk on this host: fresh host planes, the device engine
    # (warm from (a), kernels unshadowed) on the same chunks
    t_part = time.perf_counter()
    walls = {}
    for mode in ("analytic", "sampled"):
        store, sched = plane(mode)
        res = serve_dlrm.serve_host_plane(sched, kern, traces[mode], B,
                                          bg_iops=TRACE_BG_IOPS)
        walls[mode] = {"host_serve_columnar_ms_median": statistics.median(res.host_ms[2:]),
                       "host_serve_columnar_ms_min": min(res.host_ms[2:]),
                       "device_engine_serve_columnar_ms_median":
                           statistics.median(res.device_ms[2:]),
                       "device_engine_serve_columnar_ms_min": min(res.device_ms[2:]),
                       "chunks_timed": len(res.host_ms) - 2}
    emit({"phase": "host_plane", "part": "b_walls", "card": smi, "chunk": B,
          "walls": walls, "part_s": time.perf_counter() - t_part})

    # (c) the host mirror against the device cache at the trace path's geometry:
    # single-key accesses of the trace's own (table slot, row) keys that fall in
    # HOST_MIRROR_SETS sets, in arrival order, through TorchRowCache's cache_probe
    # on the card and through SetAssocSimCache at the device's set index
    t_part = time.perf_counter()
    geo = kern.cache.geo
    q = traces["analytic"].queries
    tabs = np.repeat(q.seg_table, np.diff(q.seg_offsets))      # arrival order
    rows = q.values.astype(np.int64)
    ids = np.array(kern.table_ids)
    by_id = np.argsort(ids)
    pos = np.minimum(np.searchsorted(ids[by_id], tabs), len(ids) - 1)
    slots = by_id[pos]
    keep = ids[slots] == tabs
    sets = set_index(torch.from_numpy(slots[keep]), torch.from_numpy(rows[keep]),
                     geo.num_sets).numpy()
    chosen = np.unique(sets)[:HOST_MIRROR_SETS]
    pick = np.isin(sets, chosen)
    mt = slots[keep][pick].astype(np.int32)
    mr = rows[keep][pick].astype(np.int32)
    dev = TorchRowCache(geo, device="cuda")
    state = dev.init()
    sim = SetAssocSimCache(geo.num_sets, geo.ways)
    zero = torch.zeros((1, geo.dim), device="cuda")
    got, want = [], []
    ops.reset_launch_counts()
    for t, r, s_, k in zip(mt.tolist(), mr.tolist(), sets[pick].tolist(),
                           sim._key(mt, mr).tolist()):
        tt = torch.tensor([t], dtype=torch.int32, device="cuda")
        rr = torch.tensor([r], dtype=torch.int32, device="cuda")
        _, hit, _ = dev.lookup_device(state, tt, rr)
        h = bool(hit[0])
        if not h:
            dev.insert(state, tt, rr, zero)
        got.append(h)
        want.append(sim.access_in_set(s_, k))
    probes = ops.launch_counts()["cache_probe"]
    if probes != len(got):
        raise AssertionError(f"mirror: {probes} cache_probe launches for {len(got)} accesses")
    first = next((i for i, (a, b) in enumerate(zip(got, want)) if a != b), None)
    if first is not None:
        raise AssertionError(f"mirror: access {first} hit {got[first]} on the card, "
                             f"{want[first]} on the host mirror")
    if (int(state["hits"]), int(state["misses"])) != (sim.hits, sim.misses):
        raise AssertionError("mirror: hit and miss counts differ")
    tt = state["tag_table"].cpu().numpy().astype(np.int64)
    resident = (tt << 40) | state["tag_row"].cpu().numpy().astype(np.int64)
    resident[tt < 0] = -1
    if not np.array_equal(resident, sim.tags):
        raise AssertionError("mirror: resident lines differ")
    distinct = int(len(np.unique(sim._key(mt, mr))))
    if sim.misses <= distinct:
        raise AssertionError(f"mirror: {sim.misses} misses of {distinct} keys, no "
                             "eviction exercised")
    per_set = np.bincount(np.searchsorted(chosen, sets[pick]))
    emit({"phase": "host_plane", "part": "c_mirror", "sets": int(geo.num_sets),
          "ways": int(geo.ways), "accesses": len(got), "sets_used": len(chosen),
          "distinct_keys": distinct,
          "accesses_per_set_min_max": [int(per_set.min()), int(per_set.max())],
          "hits": sim.hits, "misses": sim.misses,
          "misses_after_eviction": sim.misses - distinct, "identical": True,
          "part_s": time.perf_counter() - t_part,
          "phase_s": time.perf_counter() - t_phase})
    del kern, model, state
    torch.cuda.empty_cache()
    return {"launches": launches, "err": kernel_err}


def engine_store_bytes(eng) -> int:
    """Bytes of an engine's quantized store (every shard's), sentinel rows
    included."""
    parts = (zip(eng.payload, eng.scale, eng.bias) if isinstance(eng.payload, list)
             else [(eng.payload, eng.scale, eng.bias)])
    return sum(p.numel() * p.element_size() + s.numel() * 4 + b.numel() * 4
               for p, s, b in parts)


def fleet_plane(torch, np, smi, single) -> dict:
    """Phase ``fleet_plane``; ``single`` is trace_path's run (a) (its
    engine's ``sm_ios`` and hit rate). Returns the launches of its main run
    (b) and each kernel's largest difference from its plain version there."""
    import contextlib
    import gc
    import io

    from repro_torch import fleet_control, serve_dlrm
    from repro_torch.kernels import ops, ref
    from repro_torch.runtime import cluster
    from repro_torch.workloads import build_trace

    B, D, name = TRACE_BATCH, TRACE_DIM, TRACE_ARCHETYPE
    kernel_names = ("gather_pool", "cache_probe", "densify")
    t_phase = time.perf_counter()
    spec = serve_dlrm.m1_spec(name, queries=TRACE_QUERIES, table_bytes=TRACE_TABLE_BYTES)
    trace = build_trace(spec)
    t0 = time.perf_counter()
    tables = serve_dlrm.trace_tables(spec, D, seed=0, torch_device="cuda")
    torch.cuda.synchronize()
    tables_s = time.perf_counter() - t0
    table_bytes = sum(t.numel() * t.element_size() for t in tables.values())
    shared = [torch.device("cuda", 0)] * FLEET_MESH_SHARDS

    # each host's engine: its build time, store bytes and serve_columnar walls
    hosts = {}
    attach = cluster.HostSim.attach_engine

    def timed_attach(self, *args, **kw):
        t0 = time.perf_counter()
        eng = attach(self, *args, **kw)
        torch.cuda.synchronize()
        rec = hosts[self.spec.name] = {"build_s": time.perf_counter() - t0,
                                       "store_bytes": engine_store_bytes(eng),
                                       "serve_columnar_ms": []}
        serve = eng.serve_columnar

        def timed_serve(chunk, bg_iops):
            t0 = time.perf_counter()
            out = serve(chunk, bg_iops)          # host arrays: the device is done
            rec["serve_columnar_ms"].append((time.perf_counter() - t0) * 1e3)
            return out
        eng.serve_columnar = timed_serve
        return eng

    def run(sim, tr, tabs, **kw):
        """One ``run_device_plane``; returns its report and each host's
        engine record, the engines freed (the timing wrapper is a cycle)."""
        hosts.clear()
        t0 = time.perf_counter()
        with torch.no_grad():
            rep = sim.run_device_plane(tr, tabs, bg_iops=TRACE_BG_IOPS,
                                       **{"torch_device": "cuda", **kw})
        wall = time.perf_counter() - t0
        recs = {h: dict(r, serve_columnar_ms_median=statistics.median(r["serve_columnar_ms"]))
                for h, r in hosts.items()}
        gc.collect()
        torch.cuda.empty_cache()
        return rep, recs, wall

    def key(rep):
        return ([dataclasses.asdict(h) for h in rep.hosts],
                [rep.p50_us, rep.p95_us, rep.p99_us, rep.p999_us])

    def fleet(telemetry=None):
        return serve_dlrm.build_fleet(FLEET_HOSTS, mesh_host_shards=FLEET_MESH_SHARDS,
                                      layout="row", routing="round_robin", chunk=B,
                                      telemetry=telemetry)

    cluster.HostSim.attach_engine = timed_attach
    try:
        # (a) one host: the trace path's engine, through the fleet's router
        one, one_hosts, one_s = run(serve_dlrm.build_fleet(1, chunk=B), trace, tables)
        (h,) = one.hosts
        if (h.queries, h.sm_ios, h.engine_hit_rate, h.mesh_devices) != \
                (len(trace), single["sm_ios"], single["hit_rate"], 1):
            raise AssertionError(f"1-host fleet: {h.queries} queries, sm_ios {h.sm_ios}, "
                                 f"hit rate {h.engine_hit_rate}; trace_path's engine "
                                 f"{single['sm_ios']}, {single['hit_rate']}")
        emit({"phase": "fleet_plane", "part": "a_one_host", "archetype": name,
              "queries": len(trace), "tables": len(tables), "dim": D,
              "table_bytes_on_card": table_bytes, "tables_s": tables_s,
              "host": dataclasses.asdict(h), "engine": one_hosts, "run_s": one_s,
              "trace_path_engine": single})

        # (b) three hosts round robin, the last a 2-shard mesh slice on the one card:
        # kernel engines with telemetry (every kernel call shadowed by its plain
        # version, the counters zeroed just before and read just after), kernel
        # engines without telemetry (the timed run), plain engines
        restore, check, _ = shadowed_dlrm_kernels(torch, ops, ref)
        try:
            ops.reset_launch_counts()
            kern_tel, _, tel_s = run(fleet(True), trace, tables, devices=shared)
            torch.cuda.synchronize()
            launches = ops.launch_counts()
        finally:
            restore()
        kernel_err = check()
        kern, kern_hosts, kern_s = run(fleet(), trace, tables, devices=shared)
        plain, plain_hosts, plain_s = run(
            fleet(), trace, tables, devices=shared,
            engine_cfg=serve_dlrm.fleet_engine_config(use_kernels=False))
        for label, other in (("telemetry off", kern), ("plain engines", plain)):
            if key(other) != key(kern_tel):
                raise AssertionError(f"fleet: the kernel engines with telemetry and "
                                     f"the {label} differ: {key(kern_tel)} {key(other)}")
        # the step's kernels once a chunk a shard, densify once a chunk a
        # distinct device: every host's shards share the one card
        calls = sum(-(-h.queries // B) for h in kern.hosts)
        chunks = sum(-(-h.queries // B) * h.mesh_devices for h in kern.hosts)
        want = {"gather_pool": chunks, "cache_probe": chunks, "densify": calls}
        if any(launches[k] != want[k] for k in kernel_names):
            raise AssertionError(f"fleet: {launches} launches, want {want}")
        by = {h.name: h for h in kern.hosts}
        mesh = by[f"h{FLEET_HOSTS - 1}"]
        reg = kern_tel.telemetry.registry
        c = reg.counters
        if (c["serve.queries"], c["serve.sm_ios"],
                c["engine.shard0.sm_ios"] + c["engine.shard1.sm_ios"]) != \
                (len(trace), sum(h.sm_ios for h in kern.hosts), mesh.sm_ios) or \
                mesh.mesh_devices != FLEET_MESH_SHARDS:
            raise AssertionError(f"fleet telemetry {c} against the reports")
        emit({"phase": "fleet_plane", "part": "b_kernel_vs_plain", "card": smi,
              "hosts": FLEET_HOSTS, "mesh_host_shards": FLEET_MESH_SHARDS,
              "shards_on": [str(d) for d in shared], "routing": "round_robin",
              "host_spec": "HW_SS, nand_flash x 2, fm_cache_bytes 8 MiB "
                           "(the engines' 7,281 x 8 cache)",
              "reports": [dataclasses.asdict(h) for h in kern.hosts],
              "fleet_p50_p95_p99_p999_us": key(kern)[1],
              "launches": launches, "chunks_x_shards": chunks, "chunks": calls,
              "kernel_vs_plain_per_call": kernel_err,
              "engines_kernels": kern_hosts, "engines_plain": plain_hosts,
              "run_s": {"kernels_telemetry_shadowed": tel_s, "kernels": kern_s,
                        "plain": plain_s},
              "registry": reg.as_dict()})
        del tables
        gc.collect()
        torch.cuda.empty_cache()

        # (c) the 4e8 cut of (b) on the card and on the CPU, tables made with numpy
        cut_trace = build_trace(serve_dlrm.m1_spec(name, queries=TRACE_QUERIES,
                                                   table_bytes=TRACE_CUT_BYTES))
        rng = np.random.default_rng(7)
        cut = {m.table_id: rng.standard_normal((m.num_rows, D), dtype=np.float32)
               for m in cut_trace.all_metas() if m.kind == "user"}
        if sum(t.shape[0] for t in cut.values()) != TRACE_CUT_ROWS:
            raise AssertionError("the 4e8 cut's inventory changed")
        card, _, card_s = run(fleet(True), cut_trace, cut, devices=shared)
        host, _, cpu_s = run(fleet(True), cut_trace, cut, torch_device="cpu")
        del cut
        if key(card) != key(host):
            raise AssertionError(f"4e8 cut: card {key(card)} and CPU {key(host)} differ")
        if card.telemetry.registry.as_dict() != host.telemetry.registry.as_dict():
            raise AssertionError("4e8 cut: the merged registries differ")
        emit({"phase": "fleet_plane", "part": "c_card_vs_cpu",
              "table_bytes": TRACE_CUT_BYTES, "rows": TRACE_CUT_ROWS,
              "reports": [dataclasses.asdict(h) for h in card.hosts],
              "card_s": card_s, "cpu_s": cpu_s})
    finally:
        cluster.HostSim.attach_engine = attach

    # (d) the fleet control plane's four legs (numpy on the host) at their
    # default 2,000 queries
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        fleet_control.main([])
    control_s = time.perf_counter() - t0
    lines = out.getvalue().splitlines()
    if "queries served 2000/2000  (lost: 0)" not in lines:
        raise AssertionError(f"fleet_control: {lines[:3]}")
    emit({"phase": "fleet_plane", "part": "d_fleet_control", "queries": 2000,
          "lines": lines, "wall_s": control_s,
          "phase_s": time.perf_counter() - t_phase})
    return {"launches": launches, "err": kernel_err}


def train_path(torch, np, smi) -> dict:
    """Phase ``train_path``; returns the launches of its serving run (c) and
    each kernel's largest difference from its plain version there."""
    import shutil

    from repro_torch import lm_train, serve_dlrm, train_dlrm
    from repro_torch.checkpoint import (CheckpointManager,
                                        incremental_embedding_update, latest_step)
    from repro_torch.configs import get_config
    from repro_torch.core.io_sim import DEVICES
    from repro_torch.data import make_dlrm_batch
    from repro_torch.kernels import ops, ref
    from repro_torch.models import dlrm
    from repro_torch.optim import AdamW, TrainState, global_norm, make_train_step
    from repro_torch.runtime.engine import DeviceServingEngine, EngineConfig
    from repro_torch.tree import leaves

    t_phase = time.perf_counter()
    arch = train_dlrm.ARCH
    root = os.path.join(ROOT, "build", "train_path")
    shutil.rmtree(root, ignore_errors=True)

    def trainer(name, device="cuda", **kw):
        return train_dlrm.build(arch, steps=TRAIN_STEPS, batch=TRAIN_BATCH,
                                ckpt_dir=os.path.join(root, name), device=device,
                                ckpt_every=TRAIN_CKPT_EVERY, **kw)

    def batch(step, device):
        raw = make_dlrm_batch(arch, TRAIN_BATCH, seed=0, step=step)
        return {k: torch.from_numpy(v).to(device) for k, v in raw.items()}

    def steps(step_fn, state, nb, device, first=0, same=False):
        """``nb`` steps from ``state``; returns it and each step's loss and
        global norm (as floats, so each step is waited for)."""
        out = []
        for i in range(nb):
            state, m = step_fn(state, batch(first if same else first + i, device))
            out.append((float(m["loss"]), float(m["grad_norm"])))
        return state, out

    try:
        # (a) runs A, B (killed at TRAIN_FAIL_AT) and B' (resumed), on the card
        t0 = time.perf_counter()
        a = trainer("a")
        run_a = a.run()
        torch.cuda.synchronize()
        run_a_s = time.perf_counter() - t0

        class Killed(RuntimeError):
            pass

        def kill(step):
            if step == TRAIN_FAIL_AT:
                raise Killed(f"step {step}")
        try:
            trainer("b", failure_hook=kill).run()
            raise AssertionError("run B was not killed")
        except Killed:
            pass
        if latest_step(os.path.join(root, "b")) != TRAIN_CKPT_EVERY:
            raise AssertionError("run B left no checkpoint at step "
                                 f"{TRAIN_CKPT_EVERY}")
        b2 = trainer("b")
        run_b2 = b2.run()
        if (run_b2["metrics"][0]["step"], run_b2["final_step"]) != (TRAIN_CKPT_EVERY,
                                                                     TRAIN_STEPS):
            raise AssertionError(f"run B' ran steps {run_b2['metrics'][0]['step']}-"
                                 f"{run_b2['final_step']}")
        diff = [k for k, (x, y) in enumerate(zip(leaves(b2.state), leaves(a.state)))
                if x.dtype != y.dtype or not torch.equal(x, y)]
        if diff or len(leaves(a.state)) != 3 * len(leaves(a.state["params"])) + 1:
            raise AssertionError(f"run B' differs from run A in leaves {diff}")
        shutil.rmtree(os.path.join(root, "b"))
        losses_a = [m["loss"] for m in run_a["metrics"]]
        walls = [t * 1e3 for t in a.step_times[5:]]

        # the first steps again on the card and on the CPU
        fresh = trainer("fresh")
        card5, card_m = steps(fresh.step_fn, fresh.state, TRAIN_CPU_STEPS, "cuda")
        if [m[0] for m in card_m] != losses_a[:TRAIN_CPU_STEPS]:
            raise AssertionError(f"card rerun {card_m} against run A {losses_a[:5]}")
        t0 = time.perf_counter()
        cpu = trainer("cpu", device="cpu")
        cpu5, cpu_m = steps(cpu.step_fn, cpu.state, TRAIN_CPU_STEPS, "cpu")
        cpu_s = time.perf_counter() - t0
        gaps = {"step0_loss": abs(card_m[0][0] - cpu_m[0][0]),
                "step0_global_norm": abs(card_m[0][1] - cpu_m[0][1]),
                "loss": max(abs(x[0] - y[0]) for x, y in zip(card_m, cpu_m)),
                "param_after_5": max(float((x.cpu() - y).abs().max())
                                     for x, y in zip(leaves(card5["params"]),
                                                     leaves(cpu5["params"])))}
        if max(gaps["step0_loss"], gaps["step0_global_norm"]) > TRAIN_TOL or \
                gaps["loss"] > TRAIN_CPU_TOL:
            raise AssertionError(f"card vs CPU: {gaps}")
        del cpu, cpu5, fresh, card5

        # a same-batch overfit at the schedule's peak rate
        opt = AdamW(lr=2e-3, weight_decay=1e-5)
        init = dlrm.init_params(arch, device="cuda", generator=torch.Generator().manual_seed(0))
        _, over = steps(make_train_step(lambda p, b: dlrm.loss_fn(p, b, arch), opt),
                        TrainState(init, opt), TRAIN_OVERFIT, "cuda", same=True)
        if not over[-1][0] < over[0][0]:
            raise AssertionError(f"same-batch overfit did not descend: {over}")
        del init

        # a profile of TRAIN_PROFILED more steps from A's final state
        prof_batches = [batch(TRAIN_STEPS + i, "cuda") for i in range(TRAIN_PROFILED)]

        def profiled():
            st = a.state
            for b in prof_batches:
                st, _ = a.step_fn(st, b)
        prof = device_profile(torch, profiled, TRAIN_PROFILED)
        wall_ms = statistics.median(walls)
        prof["idle_share"] = (1.0 - prof["device_busy_us"] / (wall_ms * 1e3)
                              if prof["device_ops"] else None)

        # CheckpointManager.save and restore of A's state
        mgr = CheckpointManager(os.path.join(root, "timing"), keep=1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        path = mgr.save(a.state, TRAIN_STEPS)
        save_s = time.perf_counter() - t0
        ckpt_bytes = sum(os.path.getsize(os.path.join(path, f)) for f in os.listdir(path))
        t0 = time.perf_counter()
        restored, _ = mgr.restore(a.state)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        if not all(torch.equal(x, y) for x, y in zip(leaves(restored), leaves(a.state))):
            raise AssertionError("restored checkpoint differs from the saved state")
        del restored
        shutil.rmtree(os.path.join(root, "timing"))
        n_params = sum(x.numel() for x in leaves(a.state["params"]))
        if n_params != arch.param_count():
            raise AssertionError(f"{n_params} parameters, arch says {arch.param_count()}")
        emit({"phase": "train_path", "part": "a_dlrm", "card": smi,
              "params": n_params, "batch": TRAIN_BATCH, "steps": TRAIN_STEPS,
              "fail_at": TRAIN_FAIL_AT, "resumed_from": TRAIN_CKPT_EVERY,
              "resumed_equals_uninterrupted": True, "leaves": len(leaves(a.state)),
              "loss_first_last": [losses_a[0], losses_a[-1]],
              "card_vs_cpu": gaps, "cpu_5_steps_s": cpu_s,
              "overfit_losses": [m[0] for m in over],
              "step_wall_ms_median_5_39": wall_ms, "step_wall_ms_min_max":
              [min(walls), max(walls)], "run_a_s": run_a_s, "stragglers":
              len(run_a["stragglers"]), "profile": prof,
              "checkpoint": {"save_s": save_s, "restore_s": restore_s,
                             "bytes": ckpt_bytes}})

        # (b) microbatches=4 against the plain step from A's final state
        def batch_major(loss_fn):
            return lambda p, b: loss_fn(p, {**b, "indices": b["indices"].transpose(0, 1)})
        loss = batch_major(lambda p, b: dlrm.loss_fn(p, b, arch))
        opt = AdamW(lr=1e-4, weight_decay=1e-5)
        mb_batch = batch(TRAIN_STEPS, "cuda")
        mb_batch["indices"] = mb_batch["indices"].transpose(0, 1).contiguous()
        grads = {"plain": [], "micro": []}

        def keep(name):
            def transform(g):          # the step's grads, before clipping
                grads[name].append(g)
                return g
            return transform
        plain_state, pm = make_train_step(loss, opt, grad_transform=keep("plain"))(
            a.state, mb_batch)
        micro_state, mm = make_train_step(loss, opt, microbatches=TRAIN_MICROBATCHES,
                                          grad_transform=keep("micro"))(a.state, mb_batch)
        mb_gap = {"loss": abs(float(pm["loss"]) - float(mm["loss"])),
                  "params": max(float((x - y).abs().max()) for x, y in
                                zip(leaves(plain_state["params"]),
                                    leaves(micro_state["params"]))),
                  "grads": max(float((x - y).abs().max()) for x, y in
                               zip(leaves(grads["plain"][0]), leaves(grads["micro"][0])))}
        grad_max = max(float(x.abs().max()) for x in leaves(grads["plain"][0]))
        if any(mb_gap[k] >= MICROBATCH_TOL[k] for k in mb_gap):
            raise AssertionError(f"microbatches={TRAIN_MICROBATCHES}: {mb_gap}")
        del plain_state, micro_state, grads
        emit({"phase": "train_path", "part": "b_microbatches", "card": smi,
              "microbatches": TRAIN_MICROBATCHES, "gap": mb_gap, "bounds": MICROBATCH_TOL,
              "grad_max_abs": grad_max})

        # (c) train to serve: A's user tables through an incremental update,
        # read back with numpy, served by the device engine, scored by the
        # trained model
        n_user = len(arch.user_tables)
        user = {f"table_{i}": a.state["params"]["tables"][i] for i in range(n_user)}
        upd = incremental_embedding_update(os.path.join(root, "a"), TRAIN_STEPS, user,
                                           update_id=1)
        read = {i: np.load(os.path.join(upd, f"table_{i}.npy")) for i in range(n_user)}
        for i, arr in read.items():
            if not torch.equal(torch.from_numpy(arr), user[f"table_{i}"].cpu()):
                raise AssertionError(f"table_{i} read back differs")
        model = dlrm.params_from_jax(dlrm.DLRM(arch, device="cuda"), a.state["params"])
        engine = DeviceServingEngine({i: torch.from_numpy(arr).to("cuda")
                                      for i, arr in read.items()},
                                     DEVICES["nand_flash"], EngineConfig(),
                                     torch_device="cuda")
        traffic = serve_dlrm.make_traffic(arch, queries=128, batch=32, item_batch=50, seed=1)
        restore, check, _ = shadowed_dlrm_kernels(torch, ops, ref)
        try:
            ops.reset_launch_counts()
            served = serve_dlrm.serve(model, engine, traffic)
            torch.cuda.synchronize()
            launches = ops.launch_counts()
        finally:
            restore()
        kernel_err = check()
        if any(launches[k] != len(traffic) for k in ("gather_pool", "cache_probe")):
            raise AssertionError(f"train to serve: {launches}, want each kernel once a "
                                 f"batch ({len(traffic)})")
        for r in served:
            if r.pooled.shape != (32, n_user, arch.embed_dim) or \
                    not np.isfinite(r.pooled).all() or r.scores.shape != (50,) or \
                    not np.isfinite(r.scores).all():
                raise AssertionError("train to serve: pooled or scores malformed")
        max_err = max(r.max_err for r in served)
        if max_err > SERVE_TOL:
            raise AssertionError(f"train to serve: pooled {max_err} from reference_pool")
        emit({"phase": "train_path", "part": "c_train_to_serve", "card": smi,
              "update": upd[len(ROOT) + 1:],
              "tables": n_user, "batches": len(traffic), "launches": launches,
              "kernel_vs_plain_per_call": kernel_err, "max_pool_err": max_err,
              "hit_rate": engine.hit_rate,
              "sm_ios": [sum(s.sm_ios for s in r.stats) for r in served],
              "score_mean": float(np.mean([r.scores.mean() for r in served]))})
        del model, engine, a, b2
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(root, ignore_errors=True)

    # (d) smollm-135m at full width through lm_train's path
    cfg = get_config(LM_TRAIN_ARCH)

    def lm_batch(i, device):
        return lm_train.lm_batch(cfg, LM_TRAIN_BATCH, LM_TRAIN_SEQ, i, device)
    t0 = time.perf_counter()
    state, step = lm_train.build(cfg, device="cuda")
    torch.cuda.synchronize()
    lm_setup_s = time.perf_counter() - t0
    init = state
    lm_losses, lm_walls = [], []
    for i in range(LM_TRAIN_STEPS):
        t0 = time.perf_counter()
        state, m = step(state, lm_batch(i, "cuda"))
        lm_losses.append(float(m["loss"]))
        lm_walls.append((time.perf_counter() - t0) * 1e3)
    t0 = time.perf_counter()
    cpu_state, cpu_step = lm_train.build(cfg, device="cpu")
    _, cm = cpu_step(cpu_state, lm_batch(0, "cpu"))
    lm_cpu_s = time.perf_counter() - t0
    lm_gap = abs(float(cm["loss"]) - lm_losses[0])
    if lm_gap > TRAIN_CPU_TOL or not all(np.isfinite(lm_losses)):
        raise AssertionError(f"{LM_TRAIN_ARCH} step 0: card {lm_losses[0]}, CPU "
                             f"{float(cm['loss'])}")
    del cpu_state
    st, over = init, []
    for _ in range(TRAIN_OVERFIT):
        st, m = step(st, lm_batch(0, "cuda"))
        over.append(float(m["loss"]))
    if not over[-1] < over[0]:
        raise AssertionError(f"{LM_TRAIN_ARCH} same-batch overfit: {over}")
    prof_batches = [lm_batch(LM_TRAIN_STEPS + i, "cuda") for i in range(TRAIN_PROFILED)]

    def profiled():
        st = state
        for b in prof_batches:
            st, _ = step(st, b)
    prof = device_profile(torch, profiled, TRAIN_PROFILED)
    lm_wall = statistics.median(lm_walls[2:])
    prof["idle_share"] = (1.0 - prof["device_busy_us"] / (lm_wall * 1e3)
                          if prof["device_ops"] else None)
    del st, prof_batches

    # the same step at train_4k's sequence, on the card only
    long_losses, long_walls = [], []
    st = init
    torch.cuda.reset_peak_memory_stats()
    for i in range(LM_LONG_STEPS):
        b = lm_train.lm_batch(cfg, LM_TRAIN_BATCH, LM_LONG_SEQ, i, "cuda")
        t0 = time.perf_counter()
        st, m = step(st, b)
        long_losses.append(float(m["loss"]))
        long_walls.append((time.perf_counter() - t0) * 1e3)
    if not all(np.isfinite(long_losses)):
        raise AssertionError(f"{LM_TRAIN_ARCH} at seq {LM_LONG_SEQ}: {long_losses}")
    long_batch = lm_train.lm_batch(cfg, LM_TRAIN_BATCH, LM_LONG_SEQ, LM_LONG_STEPS, "cuda")
    long_prof = device_profile(torch, lambda: step(st, long_batch), 1)
    long_wall = statistics.median(long_walls[1:])
    long_prof["idle_share"] = (1.0 - long_prof["device_busy_us"] / (long_wall * 1e3)
                               if long_prof["device_ops"] else None)
    emit({"phase": "train_path", "part": "d_lm_train", "card": smi, "arch": LM_TRAIN_ARCH,
          "params": sum(x.numel() for x in leaves(state["params"])),
          "batch": LM_TRAIN_BATCH, "seq": LM_TRAIN_SEQ, "losses": lm_losses,
          "step0_card_vs_cpu": lm_gap, "overfit_losses": over,
          "step_wall_ms_median_2_9": lm_wall, "setup_s": lm_setup_s,
          "cpu_step_s": lm_cpu_s, "profile": prof,
          "long": {"seq": LM_LONG_SEQ, "losses": long_losses, "step_walls_ms": long_walls,
                   "step_wall_ms_median_1_2": long_wall, "profile": long_prof,
                   "peak_gib": torch.cuda.max_memory_allocated() / 2**30},
          "phase_s": time.perf_counter() - t_phase})
    del state, init, st, long_batch
    torch.cuda.empty_cache()
    return {"launches": launches, "err": kernel_err}


def decode_inputs(torch, B, S, L, H, K, hd, dtype=None):
    """q [B, H, hd], k/v [B, S, K, hd] (bf16 unless ``dtype``) from a
    generator seeded with S, and kv_len L for every row, on the card."""
    dt = dtype or torch.bfloat16
    g = torch.Generator(device="cuda").manual_seed(S)
    q = torch.randn((B, H, hd), generator=g, device="cuda", dtype=dt)
    k = torch.randn((B, S, K, hd), generator=g, device="cuda", dtype=dt)
    v = torch.randn((B, S, K, hd), generator=g, device="cuda", dtype=dt)
    return q, k, v, torch.full((B,), L, dtype=torch.int32, device="cuda")


def shape_times(torch, B, S, L, H, K, hd, t, reps, dtype=None) -> dict:
    """``flash_decode`` at one shape (bf16 unless ``dtype``, kv_len L of a
    cache of S): its error against the plain version, kernel, plain and
    SDPA times, its split plan and its bounds."""
    from repro_torch.kernels import flash_decode as fd_module
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_decode import flash_decode
    q, k, v, kv_len = decode_inputs(torch, B, S, L, H, K, hd, dtype)
    f32 = q.dtype == torch.float32
    tol = FLASH_DECODE_TOL["f32" if f32 else "bf16"]
    got = flash_decode(q, k, v, kv_len)
    err = float((got - ref.flash_decode_ref(q, k, v, kv_len)).abs().max())
    if err > tol:
        raise AssertionError(f"flash_decode at B {B}, S {S}, H {H}: error {err}")
    lib, reason = sdpa_call(torch, q, k, v, L)
    if lib is not None:
        lib_err = float((lib()[:, :, 0].float() - got).abs().max())
        if lib_err > max(tol, 1e-4):
            raise AssertionError(f"SDPA disagrees with the kernel by {lib_err}")
    nbytes, nops = flash_decode_bytes_ops(q, k, kv_len)
    tiles = fd_module.head_tiles(H // K)[0]
    n_split = fd_module.split_count(B, K, S, torch.cuda.get_device_properties(0)
                                    .multi_processor_count, tiles)
    out = {"shape": {"B": B, "S": S, "kv_len": L, "H": H, "K": K, "hd": hd,
                     "dtype": "f32" if f32 else "bf16"},
           "splits": n_split, "busy_splits": fd_module.busy_splits(L, S, n_split, hd),
           "head_tiles": tiles, "max_abs_err": err,
           "ms": t.ms(lambda: flash_decode(q, k, v, kv_len), reps),
           "plain_ms": t.ms(lambda: ref.flash_decode_ref(q, k, v, kv_len), reps),
           "library_ms": t.ms(lib, reps) if lib is not None else None,
           "library": "F.scaled_dot_product_attention(enable_gqa=True)"
                      if lib is not None else reason,
           "bound_bytes_ms": nbytes / HBM_BYTES_PER_S * 1e3,
           "bound_f32_ops_ms": nops / FP32_OPS_PER_S * 1e3}
    out["bound_ms"], out["bound_by"] = bound_ms(nbytes, nops,
                                                FP32_OPS_PER_S if f32 else BF16_OPS_PER_S)
    return out


def shape_summary(t: dict) -> dict:
    """The kernels line's numbers of one ``shape_times`` result: medians."""
    return {k: t[k]["median"] if isinstance(t[k], dict) else t[k]
            for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}


def shadowed_flash_decode(torch, ops, ref):
    """Wrap ``ops.decode_attention`` so that each kernel call also runs the
    plain version on the same inputs. Returns (restore, worst, calls):
    ``worst`` holds the largest difference so far (on the card, no sync),
    ``calls`` counts the calls."""
    kernel_call = ops.decode_attention
    worst = torch.zeros((), device="cuda")
    calls = [0]

    def shadowed(q, k, v, kv_len, *, use_kernel=True):
        out = kernel_call(q, k, v, kv_len, use_kernel=use_kernel)
        torch.maximum(worst, (out - ref.flash_decode_ref(q, k, v, kv_len)).abs().max(),
                      out=worst)
        calls[0] += 1
        return out

    def restore():
        ops.decode_attention = kernel_call
    ops.decode_attention = shadowed
    return restore, worst, calls


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

    def finite(name, logits, n=T):
        if tuple(logits.shape) != (B, n, cfg.vocab_size) or not bool(torch.isfinite(logits).all()):
            raise AssertionError(f"{name}: logits {tuple(logits.shape)} not finite")

    # (a) f32 cache: the card against the same run on the CPU, over the first
    # LM_F32_TOKENS positions
    Tf = LM_F32_TOKENS
    ops.reset_launch_counts()
    card_f32 = serve_lm.decode(model, init_cache(cfg, B, S, torch.float32, "cuda"),
                               tok_gpu[:, :Tf])
    torch.cuda.synchronize()
    launches_f32 = ops.launch_counts()["flash_decode"]
    if launches_f32 != cfg.num_layers * Tf:
        raise AssertionError(f"f32 run launched flash_decode {launches_f32} times, "
                             f"not {cfg.num_layers * Tf}")
    t0 = time.perf_counter()
    host = serve_lm.build(cfg, seed=0, torch_device="cpu")
    cpu_f32 = serve_lm.decode(host, init_cache(cfg, B, S, torch.float32, "cpu"), tokens[:, :Tf])
    cpu_s = time.perf_counter() - t0
    del host
    finite("card f32", card_f32, Tf)
    finite("cpu f32", cpu_f32, Tf)
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
    restore, worst, _ = shadowed_flash_decode(torch, ops, ref)
    try:
        serve_lm.decode(model, init_cache(cfg, B, S, device="cuda"), tok_gpu)
    finally:
        restore()
    per_call = float(worst)
    if per_call > FLASH_DECODE_TOL["path"]:
        raise AssertionError(f"flash_decode on the LM path: {per_call} from its plain "
                             f"version > {FLASH_DECODE_TOL['path']}")
    emit({"phase": "lm_main_path", "arch": cfg.name, "layers": cfg.num_layers,
          "batch": B, "positions": T, "f32_positions": Tf, "cache_len": S,
          "weights": "f32, seed 0",
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
    path_shape = shape_times(torch, B, S, T, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim,
                             timer, 0)
    d32 = SHAPES["decode_32k"]
    long_shape = shape_times(torch, d32.global_batch, d32.seq_len, d32.seq_len, cfg.num_heads,
                             cfg.num_kv_heads, cfg.head_dim, timer, 10)
    q, k, v, kv_len = decode_inputs(torch, d32.global_batch, d32.seq_len, d32.seq_len,
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
    mqa_shape = shape_times(torch, LM_BATCH, 8192, 8192, g34.num_heads, g34.num_kv_heads,
                            g34.head_dim, timer, 10)
    torch.cuda.empty_cache()

    # "kernels_direct": the wrapper called straight from Python, as before the
    # kernels were operators of the dispatcher (torch.library)
    registered = ops.decode_attention

    def direct(q, k, v, kv_len, *, use_kernel=True, return_lse=False):
        return fd_module.flash_decode(q, k, v, kv_len, return_lse=return_lse)
    caches = {name: init_cache(cfg, B, S, device="cuda")
              for name in ("kernels", "kernels_direct", "plain")}
    walls = {name: [] for name in caches}
    try:
        for t in range(T):                     # in turns, same tokens
            for name, cache in caches.items():
                model.use_kernels = name != "plain"
                ops.decode_attention = direct if name == "kernels_direct" else registered
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                decode_step(model, cache, tok_gpu[:, t:t + 1], t)
                torch.cuda.synchronize()
                if t >= 8:                     # first steps warm up
                    walls[name].append((time.perf_counter() - t0) * 1e3)
    finally:
        ops.decode_attention = registered
    wall_ms = {k: statistics.median(v) for k, v in walls.items()}
    del caches["kernels_direct"]
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


def moe_choices(torch, moe_mod):
    """Record, at each MoE layer call, the experts each token chose
    ([tokens, k], -1 where dropped) and its gates, on the host. Returns
    (calls, restore)."""
    assign = moe_mod.topk_assign
    calls = []

    def recorded(gates, top_k, capacity):
        out = assign(gates, top_k, capacity)
        token, expert, rnd, _ = out
        G, S, E = gates.shape
        choice = torch.full((G * S, top_k), -1, dtype=torch.int64, device=gates.device)
        choice[token, rnd] = expert
        calls.append((choice.cpu(), gates.reshape(G * S, E).cpu()))
        return out

    def restore():
        moe_mod.topk_assign = assign
    moe_mod.topk_assign = recorded
    return calls, restore


def routing_diffs(card_calls, cpu_calls) -> list:
    """[call, token, card's experts, CPU's experts, gate gap] for each token
    whose experts differ; the gap is the largest, over the rounds that
    differ, of the CPU gates' difference between the two experts."""
    if len(card_calls) != len(cpu_calls):
        raise AssertionError(f"{len(card_calls)} MoE calls on the card, {len(cpu_calls)} "
                             f"on the CPU")
    diffs = []
    for i, ((a, _), (c, gates)) in enumerate(zip(card_calls, cpu_calls)):
        for tok in (a != c).any(dim=1).nonzero()[:, 0].tolist():
            rounds = (a[tok] != c[tok]).nonzero()[:, 0]
            gap = max(abs(float(gates[tok, a[tok, r]]) - float(gates[tok, c[tok, r]]))
                      for r in rounds.tolist())
            diffs.append([i, tok, a[tok].tolist(), c[tok].tolist(), gap])
    return diffs


def moe_device_share(torch, transformer_mod, run, nb: int) -> dict:
    """Per step of ``run`` (``nb`` steps) under ``torch.profiler`` with host
    and device activity: the device µs of the kernels launched inside the
    MoE layers (``moe_ffn`` wrapped in a ``record_function``) against all
    kernels' device µs."""
    from torch.profiler import ProfilerActivity, profile, record_function
    moe_ffn = transformer_mod.moe_ffn

    def ranged(*args, **kw):
        with record_function("moe_ffn"):
            return moe_ffn(*args, **kw)
    transformer_mod.moe_ffn = ranged
    try:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            run()
            torch.cuda.synchronize()
    finally:
        transformer_mod.moe_ffn = moe_ffn
    cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
    events = prof.events()
    moe_us = sum(e.device_time_total for e in events
                 if e.device_type == cpu and e.name == "moe_ffn")
    busy_us = sum(e.time_range.elapsed_us() for e in events
                  if e.device_type == cuda and e.name != "moe_ffn")
    return {"moe_device_us": moe_us / nb, "device_busy_us": busy_us / nb,
            "moe_share": moe_us / busy_us if busy_us else None}


def f32_decode(torch, serve_lm, T, moe_mod, model, cfg, tokens, routed: bool):
    """``tokens`` decoded through ``model`` into an f32 cache of their
    length: (logits, each MoE layer call's experts and gates if ``routed``)."""
    calls, restore = moe_choices(torch, moe_mod) if routed else ([], lambda: None)
    try:
        logits = serve_lm.decode(model, T.init_cache(cfg, tokens.shape[0], tokens.shape[1],
                                                     torch.float32, tokens.device), tokens)
    finally:
        restore()
    return logits, calls


def record_units(torch, T, n_units: int, steps):
    """Record, at the decode steps ``steps``, each layer call of
    ``decode_step`` (an SSD layer, an attention block or a VLM cross layer):
    its block, input, cache before and after, output and (attention)
    position. A step's calls are counted off ``n_units`` at a time. Returns
    (records, restore)."""
    ssm_block, attn_block, cross_block = T._ssm_block, T._attn_block, T._cross_block_cached
    records, seen = [], [0]

    def clone(cache):
        return {k: v.clone() for k, v in cache.items()}

    def keep():
        step = seen[0] // n_units
        seen[0] += 1
        return step in steps

    def ssm(blk, x, cfg, ssd_cache=None):
        if ssd_cache is None or not keep():
            return ssm_block(blk, x, cfg, ssd_cache=ssd_cache)
        before = clone(ssd_cache)
        out = ssm_block(blk, x, cfg, ssd_cache=ssd_cache)
        records.append(("ssm", blk, x.clone(), before, out.clone(), clone(ssd_cache), None))
        return out

    def attn(blk, x, positions, cfg, kv_cache=None, cache_index=None, use_kernel=True,
             static_moe=False):
        if kv_cache is None or not keep():
            return attn_block(blk, x, positions, cfg, kv_cache=kv_cache,
                              cache_index=cache_index, use_kernel=use_kernel,
                              static_moe=static_moe)
        before = clone(kv_cache)
        out = attn_block(blk, x, positions, cfg, kv_cache=kv_cache,
                         cache_index=cache_index, use_kernel=use_kernel,
                         static_moe=static_moe)
        records.append(("attn", blk, x.clone(), before, out[0].clone(), clone(kv_cache),
                        (positions.clone(), cache_index)))
        return out

    def cross(blk, x, kv, cfg, use_kernel=True):
        if not keep():
            return cross_block(blk, x, kv, cfg, use_kernel=use_kernel)
        out = cross_block(blk, x, kv, cfg, use_kernel=use_kernel)
        records.append(("cross", blk, x.clone(), clone(kv), out.clone(), clone(kv), None))
        return out

    def restore():
        T._ssm_block, T._attn_block, T._cross_block_cached = ssm_block, attn_block, cross_block
    T._ssm_block, T._attn_block, T._cross_block_cached = ssm, attn, cross
    return records, restore


def rerun_unit(torch, T, record, blk, cfg, device, dtype=None):
    """One recorded layer call again through ``blk`` on ``device``, from the
    recorded input and cache (their floating tensors cast to ``dtype`` if
    given): (output, cache after)."""
    kind, _, x, before, _, _, extra = record

    def move(t):                               # a copy: the call updates its cache
        cast = dtype if dtype is not None and t.is_floating_point() else t.dtype
        return t.to(device, cast, copy=True)
    cache = {k: move(v) for k, v in before.items()}
    with torch.no_grad():
        if kind == "ssm":
            return T._ssm_block(blk, move(x), cfg, ssd_cache=cache), cache
        if kind == "cross":
            return T._cross_block_cached(blk, move(x), cache, cfg), cache
        positions, index = extra
        got, _, _ = T._attn_block(blk, move(x), positions.to(device), cfg, kv_cache=cache,
                                  cache_index=index)
        return got, cache


def replay_units(torch, T, records, blocks: dict, cfg) -> dict:
    """Each recorded CPU layer call again on the card, from the CPU's input
    and cache (``blocks`` maps a CPU block to the card's): the largest
    difference of the outputs and of the caches after, by layer kind."""
    worst = {}
    for rec in records:
        kind, blk, _, _, out, after, _ = rec
        got, cache = rerun_unit(torch, T, rec, blocks[id(blk)], cfg, "cuda")
        gaps = [float((got.cpu() - out).abs().max())] + [
            float((cache[k].cpu().float() - after[k].float()).abs().max()) for k in after]
        worst[kind] = max(worst.get(kind, 0.0), *gaps)
    return worst


def f64_layer_gaps(torch, T, records, blocks64: dict, card_blocks: dict, cfg) -> dict:
    """Each recorded CPU layer call again in float64 on the CPU (``blocks64``
    maps a CPU block to its float64 copy's): the largest difference from it
    of the card's f32 output on the same input and cache, and of the CPU's
    recorded f32 output, by layer kind."""
    card, cpu = {}, {}
    for rec in records:
        kind, blk, _, _, out, _, _ = rec
        want, _ = rerun_unit(torch, T, rec, blocks64[id(blk)], cfg, "cpu", torch.float64)
        got, _ = rerun_unit(torch, T, rec, card_blocks[id(blk)], cfg, "cuda")
        card[kind] = max(card.get(kind, 0.0), float((got.cpu().double() - want).abs().max()))
        cpu[kind] = max(cpu.get(kind, 0.0), float((out.double() - want).abs().max()))
    return {"card_f32": card, "cpu_f32": cpu}


def bf16_path_runs(torch, T, card, new_cache, tok, want: int, label: str, finite) -> dict:
    """(b) of the LM family phases: the bf16 serving cache through
    ``serve_lm.decode``, the main path, ``flash_decode`` launched exactly
    ``want`` times (the counters zeroed just before, read just after); on a
    path with the kernel, the plain version (``use_kernels=False``, no
    launch) and then every kernel call shadowed by its plain version.
    ``new_cache()`` gives a fresh cache; ``finite(name, logits)`` checks
    the logits."""
    from repro_torch import serve_lm
    from repro_torch.kernels import ops, ref
    cache = new_cache()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    kern = serve_lm.decode(card, cache, tok)
    torch.cuda.synchronize()
    out = {"path_s": time.perf_counter() - t0, "launches": ops.launch_counts()["flash_decode"],
           "drift": None, "top1": None, "per_call": None}
    if out["launches"] != want:
        raise AssertionError(f"{label}: the path launched flash_decode {out['launches']} "
                             f"times, not {want}")
    finite("card bf16 kernel", kern)
    if not want:
        return out
    cache = new_cache()
    card.use_kernels = False
    plain = serve_lm.decode(card, cache, tok)
    card.use_kernels = True
    torch.cuda.synchronize()
    if ops.launch_counts()["flash_decode"] != out["launches"]:
        raise AssertionError(f"{label}: use_kernels=False launched a kernel")
    finite("card bf16 plain", plain)
    out["drift"] = float((kern - plain).abs().max())
    out["top1"] = float((kern.argmax(-1) == plain.argmax(-1)).float().mean())
    del kern, plain
    cache = new_cache()
    restore, worst, shadow_calls = shadowed_flash_decode(torch, ops, ref)
    try:
        serve_lm.decode(card, cache, tok)
    finally:
        restore()
    out["per_call"] = float(worst)
    if shadow_calls[0] != want or out["per_call"] > FLASH_DECODE_TOL["path"]:
        raise AssertionError(f"{label}: {shadow_calls[0]} flash_decode calls (want {want}), "
                             f"{out['per_call']} from the plain version")
    return out


def step_walls(torch, T, card, new_cache, tok, per_step: int, label: str):
    """(d) of the LM family phases: ``decode_step`` walls with and without
    the kernel, in turns, over FAMILY_TIMED steps (the first FAMILY_WARM
    untimed), then a profile of FAMILY_PROFILED more of the kernel's steps,
    which must hold ``per_step`` ``flash_decode`` kernels a step. Returns
    (walls, their medians, the profile, ``steps(n)`` running n more of the
    kernel's steps)."""
    caches = {"kernels": new_cache(), "plain": new_cache()}
    walls = {"kernels": [], "plain": []}
    for t in range(FAMILY_TIMED):
        for name, c in caches.items():
            card.use_kernels = name == "kernels"
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            T.decode_step(card, c, tok[:, t:t + 1], t)
            torch.cuda.synchronize()
            if t >= FAMILY_WARM:
                walls[name].append((time.perf_counter() - t0) * 1e3)
    card.use_kernels = True
    wall_ms = {k: statistics.median(v) for k, v in walls.items()}
    cache, p0 = caches["kernels"], [FAMILY_TIMED]

    def steps(n):
        for p in range(p0[0], p0[0] + n):
            T.decode_step(card, cache, tok[:, p:p + 1], p)
        p0[0] += n
    prof = device_profile(torch, lambda: steps(FAMILY_PROFILED), FAMILY_PROFILED,
                          named=("flash_decode",))
    if prof["ops_named"]["flash_decode"] != per_step:
        raise AssertionError(f"{label}: {prof['ops_named']['flash_decode']} flash_decode "
                             f"kernels a step in the profile, not {per_step}")
    prof["idle_share"] = (1.0 - prof["device_busy_us"] / (wall_ms["kernels"] * 1e3)
                          if prof["device_ops"] else None)
    return walls, wall_ms, prof, steps


def lm_families(torch, np, timer, smi) -> dict:
    """Phase ``lm_families``; returns the ``flash_decode`` launches of its
    main runs (b) by arch, the kernel's largest difference from its plain
    version there, and its times at the two new shapes."""
    from repro_torch import lm_train, serve_lm
    from repro_torch.configs import get_config
    from repro_torch.models import moe as moe_mod
    from repro_torch.models import transformer as T
    from repro_torch.optim.optimizers import value_and_grad
    from repro_torch.tree import leaves

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    B, Tb, S = FAMILY_BATCH, FAMILY_TOKENS, FAMILY_MAX_LEN
    launches, err, times = {}, 0.0, {}
    for arch, (depth, per_step) in FAMILIES.items():
        t_arch = time.perf_counter()
        f64 = arch == FAMILY_F64_ARCH
        Tf = FAMILY_F64_TOKENS if f64 else FAMILY_F32_TOKENS
        cfg = dataclasses.replace(get_config(arch), num_layers=depth)
        t0 = time.perf_counter()
        card = serve_lm.build(cfg, seed=0, torch_device="cuda")
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        host = T.LM(cfg, device="cpu", params=T.tree_of(card))
        n_params = sum(p.numel() for p in card.parameters())
        tokens = torch.from_numpy(serve_lm.make_tokens(cfg, batch=B, tokens=Tb, seed=1))
        tok = tokens.cuda()

        def finite(name, logits, n):
            if tuple(logits.shape) != (B, n, cfg.vocab_size) or \
                    not bool(torch.isfinite(logits).all()):
                raise AssertionError(f"{arch} {name}: logits {tuple(logits.shape)} not finite")

        # (a) f32 caches: the card against the same run on the CPU; for the
        # MoE archs the experts each token chose at each layer call; and every
        # layer call of four steps (the first two, the middle, the last) again
        # on the card from the CPU's input and cache
        routed = cfg.family == "moe"
        units = T._units(card)
        layer_steps = (0, 1, Tf // 2 - 1, Tf - 1)
        card_f32, card_calls = f32_decode(torch, serve_lm, T, moe_mod, card, cfg, tok[:, :Tf],
                                          routed)
        records, restore = record_units(torch, T, len(units), layer_steps)
        t0 = time.perf_counter()
        try:
            cpu_f32, cpu_calls = f32_decode(torch, serve_lm, T, moe_mod, host, cfg,
                                            tokens[:, :Tf], routed)
        finally:
            restore()
        cpu_s = time.perf_counter() - t0
        finite("card f32", card_f32, Tf)
        finite("cpu f32", cpu_f32, Tf)
        card_vs_cpu = float((card_f32.cpu() - cpu_f32).abs().max())
        diffs = routing_diffs(card_calls, cpu_calls) if routed else []
        if any(d[-1] >= FAMILY_TIE_GAP for d in diffs):
            raise AssertionError(f"{arch}: experts chosen on the card and the CPU differ "
                                 f"beyond a tie: {diffs[:8]}")
        blocks = {id(h): c for (_, h), (_, c) in zip(T._units(host), units)}
        by_layer = replay_units(torch, T, records, blocks, cfg)
        if len(records) != len(units) * len(layer_steps) or \
                max(by_layer.values()) > LM_CARD_VS_CPU_TOL:
            raise AssertionError(f"{arch}: {len(records)} layer calls replayed on the card, "
                                 f"largest gap {by_layer} > {LM_CARD_VS_CPU_TOL}")
        yard64 = None
        if f64:
            # the float64 yardstick: a float64 CPU copy of the same weights
            # replays (a)'s recorded layer calls, decodes the same positions
            # and prefills them
            t0 = time.perf_counter()
            host64 = T.LM(cfg, device="cpu", params=T.tree_of(host)).double()
            blocks64 = {id(h): h64 for (_, h), (_, h64) in zip(T._units(host), T._units(host64))}
            layer64 = f64_layer_gaps(torch, T, records, blocks64, blocks, cfg)
            dec64 = serve_lm.decode(host64, T.init_cache(cfg, B, Tf, torch.float64, "cpu"),
                                    tokens[:, :Tf])
            pre64 = T.forward(host64, tokens[:, :Tf])
            del host64, blocks64
            yard64 = {"layers": layer64,
                      "decode": {"card_f32": float((card_f32.cpu().double() - dec64).abs().max()),
                                 "cpu_f32": float((cpu_f32.double() - dec64).abs().max())},
                      "f64_decode_vs_prefill": float((dec64 - pre64).abs().max()),
                      "f64_s": time.perf_counter() - t0}
        del records, card_calls, cpu_calls
        # the f32 reordering yardstick: the CPU's own decode against its
        # prefill, drops off (a decode step routes one token a group, so it
        # never drops); the end-to-end limits of (a) and (c) are
        # LM_CARD_VS_CPU_TOL or twice it, whichever is larger
        t0 = time.perf_counter()
        host.cfg = card.cfg = dataclasses.replace(cfg, moe_capacity_factor=100.0)
        try:
            cpu_prefill = T.forward(host, tokens[:, :Tf])
            # (c) decode against prefill on the card
            prefill = T.forward(card, tok[:, :Tf])
        finally:
            host.cfg = card.cfg = cfg
        yardstick = float((cpu_prefill - cpu_f32).abs().max())
        limit = max(LM_CARD_VS_CPU_TOL, 2.0 * yardstick)
        decode_vs_prefill = float((prefill - card_f32).abs().max())
        prefill_s = time.perf_counter() - t0
        if yard64 is not None:
            # mamba2: (a) and (c) held against the float64 run, each run of
            # the card within FAMILY_F64_TOL of it (so card vs CPU and
            # decode vs prefill within twice that)
            yard64["prefill"] = {"card_f32": float((prefill.cpu().double() - pre64).abs().max()),
                                 "cpu_f32": float((cpu_prefill.double() - pre64).abs().max())}
            limit = 2.0 * FAMILY_F64_TOL
            card64 = max(yard64["decode"]["card_f32"], yard64["prefill"]["card_f32"])
            if card64 > FAMILY_F64_TOL:
                raise AssertionError(f"{arch}: the card's f32 run {card64} from the float64 "
                                     f"run > {FAMILY_F64_TOL}: {yard64}")
            del dec64, pre64
        if card_vs_cpu > limit or decode_vs_prefill > limit:
            raise AssertionError(f"{arch}: f32 logits card vs CPU {card_vs_cpu}, decode vs "
                                 f"prefill on the card {decode_vs_prefill}, limit {limit} "
                                 f"(the CPU's decode vs prefill {yardstick})")
        del host, cpu_f32, cpu_prefill, prefill, card_f32

        # (b) the bf16 serving cache through serve_lm.decode: the main path,
        # the plain version, then every kernel call shadowed
        def new_cache():
            return T.init_cache(cfg, B, S, device="cuda")
        runs = bf16_path_runs(torch, T, card, new_cache, tok, per_step * Tb, arch,
                              lambda name, logits: finite(name, logits, Tb))
        launches[arch] = runs["launches"]
        if per_step:
            err = max(err, runs["per_call"])

        # (d) decode_step walls with and without the kernel, in turns, then
        # profiles of the kernel's steps
        walls, wall_ms, prof, steps = step_walls(torch, T, card, new_cache, tok, per_step, arch)
        if routed:
            prof["moe"] = moe_device_share(torch, T, lambda: steps(FAMILY_PROFILED),
                                           FAMILY_PROFILED)
        if per_step:
            times[arch] = shape_times(torch, B, S, Tb, cfg.num_heads, cfg.num_kv_heads,
                                      cfg.head_dim, timer, 0)
        emit({"phase": "lm_families", "part": "decode", "card": smi, "arch": arch,
              "family": cfg.family, "layers": depth, "of_layers": get_config(arch).num_layers,
              "params": n_params, "weights": "f32, seed 0", "batch": B,
              "a_f32_positions": Tf, "a_card_vs_cpu_max_abs": card_vs_cpu,
              "a_layer_steps": layer_steps, "a_layer_calls_replayed": len(units) * len(layer_steps),
              "a_layer_card_vs_cpu_max_abs": by_layer,
              "a_routing_diffs": diffs, "a_routing_ties": len(diffs),
              "cpu_decode_vs_prefill_max_abs": yardstick, "end_to_end_limit": limit,
              "f64_yardstick": yard64, "f64_tolerance": FAMILY_F64_TOL if f64 else None,
              "c_decode_vs_prefill_max_abs": decode_vs_prefill,
              "b_positions": Tb, "b_cache_len": S, "b_launches": launches[arch],
              "b_kernel_vs_plain_per_call_max_abs": runs["per_call"],
              "b_logits_max_abs_kernel_vs_plain": runs["drift"],
              "b_top1_agreement": runs["top1"],
              "d_decode_step_ms_median": wall_ms,
              "d_decode_step_ms_min": {k: min(v) for k, v in walls.items()},
              "d_decode_steps": len(walls["kernels"]), "d_profile": prof,
              "d_flash_decode": times.get(arch),
              "build_s": build_s, "cpu_run_s": cpu_s, "prefill_s": prefill_s,
              "path_s": runs["path_s"],
              "arch_s": time.perf_counter() - t_arch})
        del card, steps
        torch.cuda.empty_cache()

    # (e) training: lm_train.build on each reduced config, card vs CPU; then
    # a full-width mamba2 step over two 256-token chunks, every grad finite
    step0 = {}
    for arch in FAMILIES:
        cfg = get_config(arch).reduced()
        losses = []
        for dev in ("cuda", "cpu"):
            state, step = lm_train.build(cfg, device=dev)
            _, m = step(state, lm_train.lm_batch(cfg, 2, 32, 0, dev))
            losses.append(float(m["loss"]))
        step0[arch] = losses
        if not abs(losses[0] - losses[1]) <= TRAIN_CPU_TOL:
            raise AssertionError(f"{cfg.name} step 0: card {losses[0]}, CPU {losses[1]}")
    arch, depth, tb, ts = FAMILY_TRAIN
    cfg = dataclasses.replace(get_config(arch), num_layers=depth)
    state, step = lm_train.build(cfg, device="cuda")
    batch = lm_train.lm_batch(cfg, tb, ts, 0, "cuda")
    loss, grads = value_and_grad(lambda p, b: T.loss_fn(p, b, cfg), state["params"], batch)
    bad = [i for i, g in enumerate(leaves(grads)) if not bool(torch.isfinite(g).all())]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, m = step(state, batch)
    train_loss = float(m["loss"])
    step_s = time.perf_counter() - t0
    if bad or not np.isfinite(float(loss)) or not np.isfinite(float(m["grad_norm"])):
        raise AssertionError(f"{arch} at {depth} layers, chunk {cfg.ssm_chunk}, seq {ts}: "
                             f"loss {float(loss)}, non-finite grads at leaves {bad}")
    emit({"phase": "lm_families", "part": "e_training", "card": smi,
          "step0_loss_card_cpu": step0, "full_width": {
              "arch": arch, "layers": depth, "batch": tb, "seq": ts,
              "ssm_chunk": cfg.ssm_chunk, "loss": float(loss), "step_loss": train_loss,
              "grad_norm": float(m["grad_norm"]), "grad_leaves": len(leaves(grads)),
              "all_grads_finite": not bad, "step_s": step_s},
          "phase_s": time.perf_counter() - t_phase})
    del state, grads
    torch.cuda.empty_cache()
    return {"launches": launches, "max_abs_err": err, "times": times}


def host_memory_gb() -> dict:
    """The host's memory as ``free -g`` reports it: total, used, available."""
    out = subprocess.run(["free", "-g"], capture_output=True, text=True, check=True,
                         timeout=60).stdout
    fields = next(line.split() for line in out.splitlines() if line.startswith("Mem:"))
    return {"total": int(fields[1]), "used": int(fields[2]), "available": int(fields[-1])}


def lm_vlm_encoder(torch, np, timer, smi) -> dict:
    """Phase ``lm_vlm_encoder``; returns the ``flash_decode`` launches of
    its main run (b), the kernel's largest difference from its plain
    version there, and its times at the VLM's two shapes."""
    from repro_torch import lm_train, serve_lm
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as T
    from repro_torch.optim.optimizers import value_and_grad
    from repro_torch.tree import leaves

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    B, Tf, Tb, S = VLM_BATCH, VLM_F32_TOKENS, VLM_TOKENS, VLM_MAX_LEN
    full = get_config(VLM_ARCH)
    cfg = dataclasses.replace(full, num_layers=VLM_SECTIONS * full.cross_attn_every)
    memory = host_memory_gb()
    need_gb = 1.2 * cfg.param_count() * 4 / 2**30   # the draw, then the CPU copy
    if memory["available"] < need_gb:
        raise AssertionError(f"{VLM_ARCH}: {memory['available']} GiB of host memory "
                             f"available, the section's f32 weights need {need_gb:.1f}")
    t0 = time.perf_counter()
    card = serve_lm.build(cfg, seed=0, torch_device="cuda")
    with torch.no_grad():                      # seeded, nonzero, on both copies
        for blk in card.cross:
            blk.gate.fill_(VLM_GATE)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    host = T.LM(cfg, device="cpu", params=T.tree_of(card))
    n_params = sum(p.numel() for p in card.parameters())
    tokens = torch.from_numpy(serve_lm.make_tokens(cfg, batch=B, tokens=Tb, seed=1))
    images = torch.from_numpy(serve_lm.make_images(cfg, batch=B, seed=VLM_IMAGE_SEED))
    tok, img = tokens.cuda(), images.cuda()
    units = T._units(card)
    want = len(units) * Tb                     # 5 self calls and 1 cross call a step

    def finite(name, logits, n):
        if tuple(logits.shape) != (B, n, cfg.vocab_size) or \
                not bool(torch.isfinite(logits).all()):
            raise AssertionError(f"{VLM_ARCH} {name}: logits {tuple(logits.shape)} not finite")

    # (a) f32 caches: the image K/V fill, the logits, and every layer call of
    # four steps replayed on the card from the CPU's input and cache
    layer_steps = (0, 1, Tf // 2 - 1, Tf - 1)
    card_cache = T.init_cache(cfg, B, Tf, torch.float32, "cuda")
    cpu_cache = T.init_cache(cfg, B, Tf, torch.float32, "cpu")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    serve_lm.fill_images(card, card_cache, tok, img)
    torch.cuda.synchronize()
    fill_card_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    serve_lm.fill_images(host, cpu_cache, tokens, images)
    fill_cpu_s = time.perf_counter() - t0
    fill_gap = max(float((card_cache.cross_k.cpu() - cpu_cache.cross_k).abs().max()),
                   float((card_cache.cross_v.cpu() - cpu_cache.cross_v).abs().max()))
    card_f32 = serve_lm.decode(card, card_cache, tok[:, :Tf])
    records, restore = record_units(torch, T, len(units), layer_steps)
    t0 = time.perf_counter()
    try:
        cpu_f32 = serve_lm.decode(host, cpu_cache, tokens[:, :Tf])
    finally:
        restore()
    cpu_s = time.perf_counter() - t0
    finite("card f32", card_f32, Tf)
    finite("cpu f32", cpu_f32, Tf)
    card_vs_cpu = float((card_f32.cpu() - cpu_f32).abs().max())
    blocks = {id(h): c for (_, h), (_, c) in zip(T._units(host), units)}
    by_layer = replay_units(torch, T, records, blocks, cfg)
    if len(records) != len(units) * len(layer_steps) or \
            max(fill_gap, card_vs_cpu, *by_layer.values()) > LM_CARD_VS_CPU_TOL:
        raise AssertionError(f"{VLM_ARCH}: image K/V card vs CPU {fill_gap}, logits "
                             f"{card_vs_cpu}, {len(records)} layer calls replayed, largest "
                             f"gap {by_layer}; limit {LM_CARD_VS_CPU_TOL}")
    del records, host, cpu_cache, cpu_f32
    # (c) decode against prefill on the card, f32
    t0 = time.perf_counter()
    prefill = T.forward(card, tok[:, :Tf], images=img)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    decode_vs_prefill = float((prefill - card_f32).abs().max())
    if decode_vs_prefill > LM_CARD_VS_CPU_TOL:
        raise AssertionError(f"{VLM_ARCH}: decode vs prefill on the card {decode_vs_prefill}")
    del prefill, card_f32, card_cache

    # (b) the bf16 serving cache, its image K/V filled first: the main path,
    # the plain version, then every kernel call shadowed
    def bf16_cache():
        return serve_lm.fill_images(card, T.init_cache(cfg, B, S, device="cuda"), tok, img)
    runs = bf16_path_runs(torch, T, card, bf16_cache, tok, want, VLM_ARCH,
                          lambda name, logits: finite(name, logits, Tb))

    # (d) decode_step walls with and without the kernel, in turns, then a
    # profile of the kernel's steps; the kernel at the two new shapes
    walls, wall_ms, prof, steps = step_walls(torch, T, card, bf16_cache, tok, len(units),
                                             VLM_ARCH)
    H, K, hd, Ti = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, cfg.num_image_tokens
    times = {"self": shape_times(torch, B, S, Tb, H, K, hd, timer, 0),
             "cross_bf16": shape_times(torch, B, Ti, Ti, H, K, hd, timer, 0),
             "cross_f32": shape_times(torch, B, Ti, Ti, H, K, hd, timer, 0, torch.float32)}
    emit({"phase": "lm_vlm_encoder", "part": "vlm", "card": smi, "arch": VLM_ARCH,
          "layers": cfg.num_layers, "cross_layers": T.n_cross(cfg),
          "of_layers": full.num_layers, "params": n_params,
          "param_count_section": cfg.param_count(), "param_count_full": full.param_count(),
          "weights": f"f32, seed 0, every cross gate {VLM_GATE}",
          "host_memory_gb": memory, "batch": B, "image_tokens": Ti,
          "images": f"make_images(seed={VLM_IMAGE_SEED})",
          "a_f32_positions": Tf, "a_image_kv_card_vs_cpu_max_abs": fill_gap,
          "a_card_vs_cpu_max_abs": card_vs_cpu, "a_layer_steps": layer_steps,
          "a_layer_calls_replayed": len(units) * len(layer_steps),
          "a_layer_card_vs_cpu_max_abs": by_layer, "limit": LM_CARD_VS_CPU_TOL,
          "c_decode_vs_prefill_max_abs": decode_vs_prefill,
          "b_positions": Tb, "b_cache_len": S, "b_launches": runs["launches"],
          "b_kernel_vs_plain_per_call_max_abs": runs["per_call"],
          "b_logits_max_abs_kernel_vs_plain": runs["drift"], "b_top1_agreement": runs["top1"],
          "d_decode_step_ms_median": wall_ms,
          "d_decode_step_ms_min": {k: min(v) for k, v in walls.items()},
          "d_decode_steps": len(walls["kernels"]), "d_profile": prof,
          "d_flash_decode": times,
          "build_s": build_s, "fill_card_s": fill_card_s, "fill_cpu_s": fill_cpu_s,
          "cpu_run_s": cpu_s, "prefill_s": prefill_s, "path_s": runs["path_s"],
          "vlm_s": time.perf_counter() - t_phase})
    del card, steps
    torch.cuda.empty_cache()

    # the encoder, uncut: prefill of 8 x 1,000 frames timed and profiled,
    # card vs CPU at 2 x 500; it launches no kernel
    t_enc = time.perf_counter()
    ecfg = get_config(ENC_ARCH)
    t0 = time.perf_counter()
    enc = serve_lm.build(ecfg, seed=0, torch_device="cuda")
    torch.cuda.synchronize()
    enc_build_s = time.perf_counter() - t0
    frames = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (ENC_BATCH, ENC_FRAMES, ecfg.d_model), dtype=np.float32))
    fr = frames.cuda()
    ops.reset_launch_counts()
    prefill_ms = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits = T.forward(enc, frames=fr)
        torch.cuda.synchronize()
        prefill_ms.append((time.perf_counter() - t0) * 1e3)
    enc_launches = ops.launch_counts()
    if any(enc_launches.values()):
        raise AssertionError(f"{ENC_ARCH}: the encoder launched a kernel: {enc_launches}")
    if tuple(logits.shape) != (ENC_BATCH, ENC_FRAMES, ecfg.vocab_size) or \
            not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"{ENC_ARCH}: logits {tuple(logits.shape)} not finite")
    del logits
    enc_prof = device_profile(torch, lambda: T.forward(enc, frames=fr), 1)
    enc_prof["idle_share"] = (1.0 - enc_prof["device_busy_us"] / (min(prefill_ms[1:]) * 1e3)
                              if enc_prof["device_ops"] else None)
    host = T.LM(ecfg, device="cpu", params=T.tree_of(enc))
    small = frames[:ENC_CPU_BATCH, :ENC_CPU_FRAMES]
    t0 = time.perf_counter()
    want_small = T.forward(host, frames=small)
    enc_cpu_s = time.perf_counter() - t0
    enc_gap = float((T.forward(enc, frames=small.cuda()).cpu() - want_small).abs().max())
    if enc_gap > LM_CARD_VS_CPU_TOL:
        raise AssertionError(f"{ENC_ARCH}: prefill card vs CPU {enc_gap} > "
                             f"{LM_CARD_VS_CPU_TOL}")
    n_enc = sum(p.numel() for p in enc.parameters())
    del host, enc, fr, want_small
    torch.cuda.empty_cache()

    # training: one full-width step at 8 x 1,000 frames, every grad finite;
    # the reduced configs' step-0 loss card vs CPU
    torch.cuda.reset_peak_memory_stats()
    state, step = lm_train.build(ecfg, device="cuda")
    batch = lm_train.lm_batch(ecfg, ENC_BATCH, ENC_FRAMES, 0, "cuda")
    loss, grads = value_and_grad(lambda p, b: T.loss_fn(p, b, ecfg), state["params"], batch)
    bad = [i for i, g in enumerate(leaves(grads)) if not bool(torch.isfinite(g).all())]
    n_leaves = len(leaves(grads))
    del grads
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, m = step(state, batch)
    train_loss = float(m["loss"])
    step_s = time.perf_counter() - t0
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    if bad or not np.isfinite(float(loss)) or not np.isfinite(float(m["grad_norm"])):
        raise AssertionError(f"{ENC_ARCH} train step: loss {float(loss)}, non-finite grads "
                             f"at leaves {bad}")
    del state, batch, m
    torch.cuda.empty_cache()
    step0 = {}
    for arch, tol in ((ENC_ARCH, ENC_STEP0_TOL), (VLM_ARCH, TRAIN_CPU_TOL)):
        rcfg = get_config(arch).reduced()
        losses = []
        for dev in ("cuda", "cpu"):
            st, fn = lm_train.build(rcfg, device=dev)
            _, mr = fn(st, lm_train.lm_batch(rcfg, 2, 32, 0, dev))
            losses.append(float(mr["loss"]))
        step0[arch] = losses
        if not abs(losses[0] - losses[1]) <= tol:
            raise AssertionError(f"{rcfg.name} step 0: card {losses[0]}, CPU {losses[1]}")
    emit({"phase": "lm_vlm_encoder", "part": "encoder", "card": smi, "arch": ENC_ARCH,
          "layers": ecfg.num_layers, "params": n_enc, "weights": "f32, seed 0",
          "launches": enc_launches, "kernels": "none: encoder prefill and training "
                                               "launch no kernel of the port",
          "prefill_batch": ENC_BATCH, "prefill_frames": ENC_FRAMES,
          "prefill_ms": prefill_ms, "prefill_profile": enc_prof,
          "card_vs_cpu_shape": [ENC_CPU_BATCH, ENC_CPU_FRAMES],
          "card_vs_cpu_max_abs": enc_gap, "limit": LM_CARD_VS_CPU_TOL, "cpu_s": enc_cpu_s,
          "train": {"batch": ENC_BATCH, "frames": ENC_FRAMES, "loss": float(loss),
                    "step_loss": train_loss, "grad_leaves": n_leaves,
                    "all_grads_finite": not bad, "step_s": step_s,
                    "peak_gib": peak_gib},
          "step0_loss_card_cpu": step0,
          "step0_tolerance": {ENC_ARCH: ENC_STEP0_TOL, VLM_ARCH: TRAIN_CPU_TOL},
          "build_s": enc_build_s, "encoder_s": time.perf_counter() - t_enc,
          "phase_s": time.perf_counter() - t_phase})
    return {"launches": runs["launches"], "max_abs_err": runs["per_call"], "times": times}


def launch_values(torch, np, cfg, shape):
    """Whole real tensors for ``steps.build_step(values=...)``: the params
    pytree from ``init_params`` (seed 0) in bf16, a zero optimizer state,
    seeded tokens and labels; a decode cell's cache holds seeded keys and
    values at positions 0..S-2 (1,023 of 1,024 written)."""
    from repro_torch.launch.steps import ACT_DTYPE
    from repro_torch.models import transformer as T
    from repro_torch.tree import tree_map
    rng = np.random.default_rng(22)
    B, S = shape.global_batch, shape.seq_len

    def ints(*dims):
        return torch.from_numpy(rng.integers(0, cfg.vocab_size, dims).astype(np.int32)).cuda()

    def values(args):
        params = tree_map(lambda t: t.to(ACT_DTYPE).cuda(),
                          T.init_params(cfg, torch.Generator().manual_seed(0)))
        if shape.kind == "train":
            state, _ = args
            zeros = tree_map(lambda t: torch.zeros(t.shape, dtype=t.dtype, device="cuda"),
                             state["opt"])
            return ({"params": params, "opt": zeros,
                     "step": torch.zeros((), dtype=torch.int32, device="cuda")},
                    {"tokens": ints(B, S), "labels": ints(B, S)})
        _, cache, _ = args
        kv = cache["kv"]
        g = torch.Generator(device="cuda").manual_seed(23)
        filled = {name: torch.randn(kv[name].shape, generator=g, device="cuda").to(kv[name].dtype)
                  for name in ("k", "v")}
        filled["pos"] = torch.arange(S, dtype=torch.int32, device="cuda").expand(
            kv["pos"].shape).contiguous()
        filled["valid"] = (filled["pos"] < S - 1).to(torch.int8)
        return (params, {"kv": filled},
                {"tokens": ints(B, 1), "pos": torch.tensor(S - 1, dtype=torch.int32).cuda()})
    return values


def launch_cell(torch, np, kind: str, mesh) -> dict:
    """(b) of phase ``launch`` for one cell: the dry-run's prediction on
    fake tensors against the same step run for real on the card."""
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.kernels import ops, ref
    from repro_torch.launch import dryrun, steps
    from repro_torch.models import layers
    from repro_torch.models import transformer as T
    from repro_torch.tree import tree_map
    cfg = get_config(LAUNCH_ARCH)
    override = ({"global_batch": LAUNCH_BATCH} if kind == "train" else
                {"global_batch": LAUNCH_BATCH, "seq_len": LAUNCH_CACHE})
    shape = dataclasses.replace(SHAPES["train_4k" if kind == "train" else "decode_32k"],
                                **override)
    pred = dryrun.run_cell(LAUNCH_ARCH, shape.name, False, shape_override=override,
                           mesh=mesh, device="cuda")
    if pred["status"] != "ok":
        raise AssertionError(f"launch (b) {kind}: the fake cell {pred['status']}: "
                             f"{pred.get('traceback')}")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    step, args, _, out_pl, plan = steps.build_step(
        cfg, shape, mesh, values=launch_values(torch, np, cfg, shape))
    plain = None
    if kind == "decode":                   # the same weights and cache, plain
        params, cache, data = args
        plain = (tree_map(lambda t: t.to_local(), params),
                 T.cache_from_tree(cfg, tree_map(lambda t: t.to_local().clone(), cache),
                                   shape.seq_len - 1),
                 data["tokens"].to_local())
    layers.set_logical_rules(plan.rules())
    try:
        # the peak above what is held now (the arguments, the plain copy and
        # what earlier phases left), plus the arguments: the predicted terms
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        real = dryrun.trace_step(step, args, out_pl)
        torch.cuda.synchronize()
        launches = ops.launch_counts()["flash_decode"]
        measured = torch.cuda.max_memory_allocated() - held + real.arg_bytes
        walls = []
        for _ in range(LAUNCH_TIMED):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step(*args)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
    finally:
        layers.set_logical_rules(None)
    predicted = pred["memory"]["peak_per_device"]
    gap = (predicted - measured) / measured
    roof = pred["roofline"]
    res = {"cell": f"{LAUNCH_ARCH} {kind} {shape.global_batch} x {shape.seq_len}",
           "flops_fake": pred["hlo_flops_per_device"], "flops_real": real.flops,
           "peak_predicted": predicted, "peak_measured": measured, "peak_gap": gap,
           "memory_predicted": pred["memory"], "depths_traced": pred["depths_traced"],
           "fake_cell_s": pred["cell_s"], "real_traced_s": real.trace_s,
           "roofline_s": max(roof["compute_s"], roof["memory_s"], roof["collective_s"]),
           "roofline": roof, "wall_s": statistics.median(walls), "walls_s": walls,
           "launches": launches}
    if pred["hlo_flops_per_device"] != real.flops:
        raise AssertionError(f"launch (b) {kind}: fake FLOPs {pred['hlo_flops_per_device']} "
                             f"!= real {real.flops}")
    if abs(gap) > LAUNCH_MEM_TOL:
        raise AssertionError(f"launch (b) {kind}: predicted peak {predicted} vs measured "
                             f"{measured} ({gap:+.3f})")
    if kind == "decode":
        if launches != cfg.num_layers:
            raise AssertionError(f"launch (b): the decode step launched flash_decode "
                                 f"{launches} times, not {cfg.num_layers}")
        logits = real.outputs[0].to_local()
        want, _ = T.decode_step(T._TreeView(plain[0], cfg), plain[1], plain[2],
                                shape.seq_len - 1)
        if not torch.equal(logits, want):
            raise AssertionError("launch (b): DTensor decode logits differ from the plain "
                                 f"step's by {float((logits - want).abs().max())}")
        k, v = plain[1].k[0], plain[1].v[0]
        q = torch.randn((LAUNCH_BATCH, cfg.num_heads, cfg.head_dim), device="cuda")
        lens = torch.full((LAUNCH_BATCH,), shape.seq_len, dtype=torch.int32, device="cuda")
        out, lse = ops.decode_attention(q, k, v, lens, return_lse=True)
        out_ref, lse_ref = ref.flash_decode_ref(q, k, v, lens, return_lse=True)
        res["lse_max_abs_err"] = float((lse - lse_ref).abs().max())
        res["out_max_abs_err"] = float((out - out_ref).abs().max())
        if res["lse_max_abs_err"] > LAUNCH_LSE_TOL:
            raise AssertionError(f"launch (b): kernel lse {res['lse_max_abs_err']} from plain")
        res["logits_bit_equal"] = True
    return res


def launch_phase(torch, np, smi) -> dict:
    """Phase ``launch``: (a) the dry-run sweep in a subprocess, (b) the
    tool against the card on two one-card cells, while the sweep runs."""
    import glob
    import shutil

    import torch.distributed as dist

    from repro_torch.launch.mesh import make_host_mesh
    t_phase = time.perf_counter()
    out_dir = os.path.join(ROOT, "build", "dryrun")
    shutil.rmtree(out_dir, ignore_errors=True)
    workers = max(1, (os.cpu_count() or 2) - 1)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    with open(os.path.join(ROOT, "build", "dryrun.log"), "w") as log:
        sweep = subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--mesh", "both",
             "--workers", str(workers), "--out", out_dir],
            cwd=ROOT, env=env, stdout=log, stderr=subprocess.STDOUT)
        try:
            mesh = make_host_mesh()
            try:
                cells_b = [launch_cell(torch, np, kind, mesh) for kind in ("train", "decode")]
            finally:
                dist.destroy_process_group()
            rc = sweep.wait(timeout=max(1.0, LAUNCH_SWEEP_TIMEOUT -
                                        (time.perf_counter() - t_phase)))
        finally:
            if sweep.poll() is None:
                sweep.kill()
                sweep.wait()
    sweep_s = time.perf_counter() - t_phase
    cells = [json.load(open(f)) for f in sorted(glob.glob(os.path.join(out_dir, "*.json")))]
    status = {c["status"] for c in cells}
    if rc != 0 or len(cells) != 80 or not status <= {"ok", "skipped"}:
        bad = [(c["arch"], c["shape"], c["mesh"], c.get("error")) for c in cells
               if c["status"] not in ("ok", "skipped")]
        raise AssertionError(f"launch (a): sweep rc {rc}, {len(cells)} cells, failed: {bad}")
    rows = [[c["arch"], c["shape"], c["mesh"], c["status"],
             c["memory"]["fits"] if c["status"] == "ok" else c["reason"],
             c["roofline"]["bottleneck"] if c["status"] == "ok" else None,
             c.get("trace_s"), c["memory"]["peak_per_device"] if c["status"] == "ok" else None]
            for c in cells]
    emit({"phase": "launch", "part": "a_sweep", "card": smi, "workers": workers,
          "sweep_s": sweep_s, "ok": sum(c["status"] == "ok" for c in cells),
          "skipped": sum(c["status"] == "skipped" for c in cells),
          "not_fitting": [r[:3] for r in rows if r[3] == "ok" and not r[4]],
          "cells": rows})
    emit({"phase": "launch", "part": "b_tool_vs_card", "card": smi, "cells": cells_b,
          "phase_s": time.perf_counter() - t_phase})
    return {"launches": cells_b[1]["launches"], "lse_max_abs_err": cells_b[1]["lse_max_abs_err"],
            "out_max_abs_err": cells_b[1]["out_max_abs_err"]}


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
    from repro_torch.kernels.densify import densify
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
    dn_cases = densify_cases(torch, np, rng)
    dn_bad = {}
    for label, *args in dn_cases:
        got = densify(*args)
        want = ref.densify_ref(*args)
        torch.cuda.synchronize()
        for name, g, w in zip(("idx", "valid", "bad"), got, want):
            if g.dtype != w.dtype or g.shape != w.shape or not torch.equal(g, w):
                raise AssertionError(f"densify {label}: {name} differs from the plain version")
        dn_bad[label] = int(got[2])
    emit({"phase": "kernels_vs_plain",
          "gather_pool_cases": [c[0] for c in gp_cases],
          "cache_probe_cases": [c[0] for c in cp_cases],
          "densify_cases_bad_keys": dn_bad,
          "max_abs_err": err})
    timer = Timer(torch)
    if sys.argv[1:] == ["--kernels"]:          # phases 1-3 and the kernel times only
        emit({"phase": "timing", "card": smi, **dlrm_kernel_times(torch, timer, gp_cases,
                                                                  cp_cases, dn_cases)})
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
    times = dlrm_kernel_times(torch, timer, gp_cases, cp_cases, dn_cases)
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

    del gp_cases, cp_cases, dn_cases, probed   # m1_batch holds about 6.5 GB
    del model, engine, model_cpu, engine_cpu, engine_plain
    torch.cuda.empty_cache()

    # trace_path: trace-driven serving at the M1 inventory
    tr = trace_path(torch, np, timer, smi)

    # sharded_path: the sharded engine at the M1 inventory
    sh = sharded_path(torch, np, smi)

    # host_plane: the SDM host plane beside the device engine at M1
    hp = host_plane(torch, np, smi)

    # fleet_plane: the trace routed over hosts, each on its own device engine
    fl = fleet_plane(torch, np, smi, tr)

    # train_path: training at train_dlrm's full arch and smollm-135m's width,
    # then the trained tables served through the DLRM kernels
    tp = train_path(torch, np, smi)

    # 6-8. the LM decode path and its flash_decode kernel
    fd = lm_phases(torch, np, timer, smi)

    # lm_families: the MoE, SSM and hybrid LM families at full width
    fam = lm_families(torch, np, timer, smi)

    # lm_vlm_encoder: the VLM (one section at full width) and the encoder
    ve = lm_vlm_encoder(torch, np, timer, smi)

    # launch: the fake-mesh dry-run sweep and the tool against the card
    la = launch_phase(torch, np, smi)

    emit({"phase": "done", "script_s": time.perf_counter() - t_script})
    emit({"kernels": [
        {"name": "gather_pool", "route": "cuda",
         "source": "src/repro_torch/csrc/gather_pool.cu",
         "replaces": "src/repro/kernels/gather_pool.py:57",
         "launches": launches["gather_pool"] + tr["launches"]["gather_pool"]
         + sh["launches"]["gather_pool"] + hp["launches"]["gather_pool"] + fl["launches"]["gather_pool"]
         + tp["launches"]["gather_pool"],
         "launches_by_path": {"dlrm_uniform": launches["gather_pool"],
                              "trace_path": tr["launches"]["gather_pool"],
                              "sharded_path": sh["launches"]["gather_pool"],
                              "host_plane": hp["launches"]["gather_pool"],
                              "fleet_plane": fl["launches"]["gather_pool"],
                              "train_path": tp["launches"]["gather_pool"]},
         "max_abs_err": max(err["gather_pool"], tr["err"]["gather_pool"], sh["err"]["gather_pool"],
                            hp["err"]["gather_pool"], fl["err"]["gather_pool"], tp["err"]["gather_pool"]),
         **kernel_entry(times, "gather_pool", tr["times"]),
         "device_us_per_call_in_step": device_us["gather_pool"],
         "device_us_per_call_trace_path": tr["device_us"]["gather_pool"],
         "device_us_per_call_sharded_path": {lay: us["gather_pool"]
                                             for lay, us in sh["device_us"].items()}},
        {"name": "cache_probe", "route": "cuda",
         "source": "src/repro_torch/csrc/cache_probe.cu",
         "replaces": "src/repro/kernels/cache_probe.py:58",
         "launches": launches["cache_probe"] + tr["launches"]["cache_probe"]
         + sh["launches"]["cache_probe"] + hp["launches"]["cache_probe"] + fl["launches"]["cache_probe"]
         + tp["launches"]["cache_probe"],
         "launches_by_path": {"dlrm_uniform": launches["cache_probe"],
                              "trace_path": tr["launches"]["cache_probe"],
                              "sharded_path": sh["launches"]["cache_probe"],
                              "host_plane": hp["launches"]["cache_probe"],
                              "fleet_plane": fl["launches"]["cache_probe"],
                              "train_path": tp["launches"]["cache_probe"]},
         "max_abs_err": max(err["cache_probe"], tr["err"]["cache_probe"], sh["err"]["cache_probe"],
                            hp["err"]["cache_probe"], fl["err"]["cache_probe"], tp["err"]["cache_probe"]),
         **kernel_entry(times, "cache_probe", tr["times"]),
         "device_us_per_call_in_step": device_us["cache_probe"],
         "device_us_per_call_trace_path": tr["device_us"]["cache_probe"],
         "device_us_per_call_sharded_path": {lay: us["cache_probe"]
                                             for lay, us in sh["device_us"].items()}},
        {"name": "densify", "route": "cuda",
         "source": "src/repro_torch/csrc/densify.cu",
         "replaces": "src/repro/runtime/engine.py (dense_from_chunk, the host's densify)",
         "launches": tr["launches"]["densify"] + sh["launches"]["densify"]
         + hp["launches"]["densify"] + fl["launches"]["densify"],
         "launches_by_path": {"trace_path": tr["launches"]["densify"],
                              "sharded_path": sh["launches"]["densify"],
                              "host_plane": hp["launches"]["densify"],
                              "fleet_plane": fl["launches"]["densify"]},
         "differing_per_call": max(tr["err"]["densify"], sh["err"]["densify"],
                                   hp["err"]["densify"], fl["err"]["densify"]),
         "chunks": {k: {"ms": t["ms"]["median"], "plain_ms": t["plain_ms"]["median"],
                        "bound_ms": t["bound_ms"], "bound_by": t["bound_by"]}
                    for k, t in times["densify"].items()},
         "trace_path": {"ms": tr["times"]["densify"]["ms"]["median"],
                        "plain_ms": tr["times"]["densify"]["plain_ms"]["median"],
                        "bound_ms": tr["times"]["densify"]["bound_ms"]},
         "timer_floor_ms": times["timer_floor_ms"]["median"],
         "device_us_per_call_trace_path": tr["device_us"]["densify"],
         "device_us_per_call_sharded_path": {lay: us["densify"]
                                             for lay, us in sh["device_us"].items()}},
        {"name": "flash_decode", "route": "cuda",
         "source": "src/repro_torch/csrc/flash_decode.cu",
         "replaces": "src/repro/kernels/flash_decode.py:88",
         **fd, "launches": fd["launches"] + sum(fam["launches"].values()) + ve["launches"]
         + la["launches"],
         "launches_by_path": {"lm_main_path": fd["launches"], "lm_families": fam["launches"],
                              "lm_vlm_encoder": ve["launches"], "launch": la["launches"]},
         "max_abs_err": max(fd["max_abs_err"], fam["max_abs_err"], ve["max_abs_err"],
                            la["out_max_abs_err"]),
         "lse_max_abs_err": la["lse_max_abs_err"],
         "lm_families": {arch: shape_summary(t) for arch, t in fam["times"].items()},
         "lm_vlm_encoder": {shape: shape_summary(t) for shape, t in ve["times"].items()}},
    ]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
