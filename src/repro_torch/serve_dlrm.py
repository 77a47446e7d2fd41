"""Serve a DLRM's user embeddings through the device serving engine and
score item batches: the port's serving path end to end.

The DLRM's user tables are int8-quantized into the simulated SM tier and
served batch by batch through ``DeviceServingEngine`` (HBM row cache,
``cache_probe`` + ``gather_pool`` CUDA kernels, Eq. 3 IO accounting); each
batch's first query then scores an item batch with ``DLRM.serve_query``
(B_U = 1, Eq. 2). Weights and traffic (uniform random rows) are seeded.

With ``--archetype`` it serves a workload trace instead: the archetype's
traffic over the paper's M1 inventory (61 user tables, Table 6 statistics,
``--table-bytes`` in all), one float table of ``--dim`` per user table,
chunk by chunk through ``DeviceServingEngine.serve_columnar``. The trace
path scores no items; per-query latency is Eq. 3's ``max(item_time_us,
sm_time_us)``. With ``--shards N`` the trace goes through a
``ShardedServingEngine`` of N shards in the ``--layout`` layout instead, one
shard per card (or every shard on the CPU with ``--device cpu``).

With ``--host-plane`` the trace path becomes the reference example's
(``examples/serve_dlrm.py``): the SDM host serving plane
(``SDMEmbeddingStore`` behind a ``ServeScheduler``: FM row cache, pooled
cache, admission ledger, on the host whatever ``--device`` says) serves the
trace chunk by chunk, the device engine serves the same chunks beside it on
``--device``, and a small DLRM scores an item batch per chunk there. The
host plane prices SM IO analytically or, with ``--latency-mode sampled``,
through the event-driven device queues (at the paper's 240 QPS a host), with
a model-update write stream (``--updating``) and the §4.1 tuning knobs
(``--tuned``). It ends with the Table 8 fleet-power model's statement.

With ``--fleet-hosts N`` the trace is routed over a fleet of N simulated
HW-SS hosts (``runtime.cluster.ClusterSim.run_device_plane``), each serving
its share through its own device engine on ``--device`` (8 MiB HBM cache,
Nand x 2); with ``--mesh-host-shards K`` the last host is a ``K``-shard
mesh slice in the ``--layout`` layout, its shards spread over the cards. It prints each
host's queries, SM IOs, engine hit rate, shards and p50/p99 latency, and
with ``--telemetry`` the merged telemetry registry's counters.

Run: PYTHONPATH=src python -m repro_torch.serve_dlrm \
         [--queries 128 --batch 32 --item-batch 50 --device cuda]
     PYTHONPATH=src python -m repro_torch.serve_dlrm --archetype zipf_steady \
         [--queries 512 --table-bytes 4e9 --dim 128 --stream 0 --device cuda]
         [--shards 0 --layout row]
         [--host-plane --latency-mode sampled --updating --tuned]
         [--fleet-hosts 3 --mesh-host-shards 2 --routing round_robin
          --telemetry]
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.io_sim import DEVICES
from repro_torch.core.power import HW_L, HW_SS, Workload, run_scenario
from repro_torch.core.sdm import QueryStats, SDMConfig, SDMEmbeddingStore
from repro_torch.devices import DeviceTuning, UpdateSpec
from repro_torch.launch import EMBED_LAYOUTS, make_embed_mesh
from repro_torch.models.dlrm import DLRM, DLRMArch
from repro_torch.runtime.cluster import (ClusterConfig, ClusterSim,
                                         HostSpec, host_compute_qps)
from repro_torch.runtime.engine import (DeviceServingEngine, EngineConfig,
                                        dense_from_chunk)
from repro_torch.runtime.serve_sched import ServeConfig, ServeScheduler
from repro_torch.runtime.sharded_engine import ShardedServingEngine
from repro_torch.workloads import (ARCHETYPES, Trace, TraceStream,
                                   WorkloadSpec, build_trace,
                                   tenant_table_metas)


@dataclasses.dataclass
class BatchResult:
    pooled: np.ndarray            # [B, Tu, E] pooled user bags
    stats: List[QueryStats]       # per query
    max_err: float                # max |pooled - engine.reference_pool|
    scores: np.ndarray            # [Bi] CTR scores of the first query's items


def build(arch: DLRMArch, *, seed: int = 0, torch_device="cuda",
          cfg: Optional[EngineConfig] = None):
    """The model (weights from a generator seeded with ``seed``) and an engine
    over its user tables on the Nand SM device model."""
    model = DLRM(arch, device=torch_device,
                 generator=torch.Generator().manual_seed(seed))
    n_user = len(arch.user_tables)
    engine = DeviceServingEngine({i: model.tables[i] for i in range(n_user)},
                                 DEVICES["nand_flash"], cfg,
                                 torch_device=torch_device)
    return model, engine


def make_traffic(arch: DLRMArch, *, queries: int, batch: int,
                 item_batch: int, seed: int) -> List[dict]:
    """Batches of uniform random rows: ``user`` [B, Tu, P] int32, ``items``
    [Ti, item_batch, P] int32 and ``dense`` [item_batch, num_dense] f32."""
    rng = np.random.default_rng(seed)
    out = []
    for start in range(0, queries, batch):
        nb = min(batch, queries - start)
        user = np.stack([rng.integers(0, r, (nb, arch.pooling))
                         for r in arch.user_tables], axis=1).astype(np.int32)
        items = np.stack([rng.integers(0, r, (item_batch, arch.pooling))
                          for r in arch.item_tables]).astype(np.int32)
        dense = rng.standard_normal((item_batch, arch.num_dense)).astype(np.float32)
        out.append({"user": user, "items": items, "dense": dense})
    return out


def serve(model: DLRM, engine: DeviceServingEngine, traffic: List[dict], *,
          bg_iops: float = 10_000.0) -> List[BatchResult]:
    dev = engine.torch_device
    results = []
    with torch.no_grad():
        for tb in traffic:
            pooled, stats = engine.serve_batch(tb["user"], bg_iops=bg_iops)
            err = float(np.abs(pooled - engine.reference_pool(tb["user"])).max())
            scores = model.serve_query(torch.from_numpy(tb["user"][0]).to(dev),
                                       torch.from_numpy(tb["items"]).to(dev),
                                       torch.from_numpy(tb["dense"]).to(dev))
            results.append(BatchResult(pooled, stats, err, scores.cpu().numpy()))
    return results


# -- the trace path --------------------------------------------------------


@dataclasses.dataclass
class TraceResult:
    latency_us: np.ndarray        # [Q] f64, Eq. 3: max(item_time_us, sm_time_us)
    sm_time_us: np.ndarray        # [Q] f64
    sm_ios: np.ndarray            # [Q] i64
    chunks: int                   # serve_columnar calls
    pooled: Optional[List[np.ndarray]] = None   # [B, T, dim] per chunk


def m1_spec(name: str, *, queries: int, table_bytes: float = 4e9) -> WorkloadSpec:
    """Archetype ``name`` with every tenant on the paper's M1 inventory (61
    user and 30 item tables, Table 6 statistics, ``table_bytes`` in all), as
    the reference's ``examples/serve_dlrm.py`` builds its traffic."""
    spec = ARCHETYPES[name]
    return dataclasses.replace(
        spec, num_queries=queries,
        tenants=tuple(dataclasses.replace(
            t, model="dlrm-m1", num_user_tables=61, num_item_tables=30,
            table_bytes=table_bytes) for t in spec.tenants))


def trace_tables(spec: WorkloadSpec, dim: int, *, seed: int = 0,
                 torch_device="cuda") -> Dict[int, torch.Tensor]:
    """One ``[num_rows, dim]`` float table per user table of ``spec``'s
    inventory (every tenant's), from a generator seeded with ``seed`` on
    ``torch_device``."""
    dev = resolve_device(torch_device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    return {m.table_id: torch.randn((m.num_rows, dim), generator=gen,
                                    device=dev)
            for ms in tenant_table_metas(spec).values()
            for m in ms if m.kind == "user"}


def build_trace_engine(spec: WorkloadSpec, dim: int, *, seed: int = 0,
                       torch_device="cuda",
                       cfg: Optional[EngineConfig] = None, shards: int = 0,
                       layout: str = "row", devices: Optional[Sequence] = None
                       ) -> Union[DeviceServingEngine, ShardedServingEngine]:
    """An engine over ``trace_tables(spec, dim)``, on the Nand SM device
    model; the tables are freed once quantized into the engine's store.

    ``shards=0`` builds a ``DeviceServingEngine``; ``shards >= 1`` a
    ``ShardedServingEngine`` in ``layout`` over ``make_embed_mesh(shards,
    torch_device, devices=devices)`` (the tables then come from the first
    shard's device), holding the same tables."""
    mesh = (make_embed_mesh(shards, torch_device, devices=devices)
            if shards else None)
    dev = mesh.devices[0] if mesh else resolve_device(torch_device)
    tables = trace_tables(spec, dim, seed=seed, torch_device=dev)
    if mesh:
        return ShardedServingEngine(tables, DEVICES["nand_flash"], cfg,
                                    mesh=mesh, layout=layout)
    return DeviceServingEngine(tables, DEVICES["nand_flash"], cfg,
                               torch_device=dev)


def serve_trace(engine: Union[DeviceServingEngine, ShardedServingEngine],
                trace: Union[Trace, TraceStream], chunk: int = 32,
                bg_iops: float = 10_000.0, *,
                keep_pooled: bool = False) -> TraceResult:
    """Serve a trace (or a stream, piece by piece, in bounded memory) in
    arrival-order chunks of ``chunk`` queries through ``serve_columnar``.
    A stream's pieces must hold whole chunks, so it is served in the same
    chunks as its materialized trace."""
    if isinstance(trace, TraceStream):
        if trace.piece % chunk:
            raise ValueError(f"stream piece {trace.piece} is not a multiple "
                             f"of chunk {chunk}")
        parts = (p.trace for p in trace.pieces())
    else:
        parts = (trace,)
    sm_t, ios, pooled = [], [], []
    with torch.no_grad():
        for part in parts:
            for ch in part.chunks(chunk):
                p, t, n = engine.serve_columnar(ch.columnar, bg_iops)
                sm_t.append(t)
                ios.append(n)
                if keep_pooled:
                    pooled.append(p)
    sm_time = np.concatenate(sm_t) if sm_t else np.zeros(0, np.float64)
    return TraceResult(np.maximum(engine.cfg.item_time_us, sm_time), sm_time,
                       np.concatenate(ios) if ios else np.zeros(0, np.int64),
                       len(sm_t), pooled if keep_pooled else None)


def _main_trace(args) -> None:
    spec = m1_spec(args.archetype, queries=args.queries,
                   table_bytes=args.table_bytes)
    engine = build_trace_engine(spec, args.dim, seed=0,
                                torch_device=args.device, shards=args.shards,
                                layout=args.layout)
    trace = (TraceStream(spec, piece=args.stream) if args.stream
             else build_trace(spec))
    res = serve_trace(engine, trace, args.batch)
    where = (f"{engine.n} {args.layout}-layout shards on "
             f"{', '.join(map(str, engine.devices))}" if args.shards
             else str(engine.torch_device))
    print(f"served {len(res.sm_ios)} {args.archetype} queries (batch="
          f"{args.batch}, {res.chunks} chunks) over {len(engine.table_ids)} "
          f"tables, {int(engine.rows_per_table.sum())} rows of {args.dim} on "
          f"{where}")
    if len(res.sm_ios):
        p50, p95, p99 = np.percentile(res.latency_us, [50, 95, 99])
        print(f"  p50/p95/p99 latency: {p50:6.0f} / {p95:6.0f} / {p99:6.0f} us "
              f"(Eq. 3, analytic SM model)")
        print(f"  SM IOs:              {int(res.sm_ios.sum())}")
    print(f"  device engine:       hit rate {engine.hit_rate:.4f}")


# -- the host serving plane beside the device engine ---------------------------

# the reference example's scoring model (examples/serve_dlrm.py:66-69)
SCORING_ARCH = DLRMArch(user_tables=(50_000,) * 6, item_tables=(50_000,) * 3,
                        embed_dim=32, pooling=8, bottom_mlp=(128, 64, 32),
                        top_mlp=(128, 1))
SAMPLED_QPS = 240.0     # Table 8's M1 rate a host, the sampled plane's offer
# pooled bags of tens of rows: the reference's tolerance for serve_columnar
# (tests/test_sharded_engine.py:198)
POOL_TOL = dict(rtol=1e-5, atol=1e-5)


def host_plane_spec(name: str, *, queries: int, table_bytes: float = 4e9,
                    latency_mode: str = "analytic") -> WorkloadSpec:
    """``m1_spec``; in sampled mode offered at the paper's 240 QPS a host, as
    the reference example does (the event-driven queues saturate a 2-device
    Nand plane past a few hundred QPS of the full M1 inventory)."""
    spec = m1_spec(name, queries=queries, table_bytes=table_bytes)
    if latency_mode == "sampled":
        spec = dataclasses.replace(spec, arrival=dataclasses.replace(
            spec.arrival, rate_qps=SAMPLED_QPS))
    return spec


def build_host_plane(trace: Trace, *, latency_mode: str = "analytic",
                     updating: bool = False, tuned: bool = False,
                     seed: int = 3):
    """The reference example's host plane over ``trace``'s inventory: an
    ``SDMEmbeddingStore`` (Nand SM, 128 MiB FM row cache, 16 MiB pooled
    cache; in sampled mode the update write stream and the §4.1 knobs on
    request) behind a ``ServeScheduler``. Returns ``(store, sched)``."""
    store = SDMEmbeddingStore(
        trace.all_metas(), DEVICES["nand_flash"],
        SDMConfig(fm_cache_bytes=128 << 20, pooled_cache_bytes=16 << 20,
                  latency_mode=latency_mode,
                  update=(UpdateSpec(model_size_gb=1000.0)
                          if updating else None),
                  tuning=(DeviceTuning(max_outstanding=12, read_priority=True)
                          if tuned else None)),
        seed=seed)
    return store, ServeScheduler(store, ServeConfig(inter_op_parallel=True,
                                                    item_compute_us=200.0))


@dataclasses.dataclass
class HostPlaneResult:
    queries: int
    chunks: int
    tiers: List[str]              # the host store's tier per chunk
    max_dev_err: float            # max |pooled - engine.reference_pool|
    max_dev_gap: float            # the same over POOL_TOL: <= 1 is within it
    mean_score: float             # mean CTR score over the scored item batches
    engine_sm_ios: int
    host_ms: List[float]          # wall of sched.serve_columnar per chunk
    device_ms: List[float]        # wall of engine.serve_columnar per chunk


def serve_host_plane(sched: ServeScheduler,
                     engine: Union[DeviceServingEngine, ShardedServingEngine],
                     trace: Trace, chunk: int = 32, *,
                     model: Optional[DLRM] = None, item_batch: int = 50,
                     bg_iops: float = 10_000.0, seed: int = 2
                     ) -> HostPlaneResult:
    """Serve ``trace`` chunk by chunk through the host plane
    (``sched.serve_columnar`` at the trace's arrival times) and, beside it,
    through the device engine on the same chunks, each chunk's pooled bags
    held to ``engine.reference_pool``. With ``model`` (a DLRM of
    ``SCORING_ARCH``'s geometry) one query's item batch a chunk is scored on
    the model's device from uniform rows of a generator seeded ``seed``.
    Each chunk's two serving calls are timed on the host's clock (the
    engine's returns host arrays, so its wall includes the device's work)."""
    rng = np.random.default_rng(seed)
    T = len(engine.table_ids)
    tiers, err, gap, scores, ios, n = [], 0.0, 0.0, [], 0, 0
    host_ms, device_ms = [], []
    with torch.no_grad():
        for ch in trace.chunks(chunk):
            t0 = time.perf_counter()
            sched.serve_columnar(ch.columnar, bg_iops=bg_iops,
                                 arrivals_us=ch.arrival_us, collect=False)
            t1 = time.perf_counter()
            pooled, _, sm_ios = engine.serve_columnar(ch.columnar, bg_iops)
            t2 = time.perf_counter()
            host_ms.append((t1 - t0) * 1e3)
            device_ms.append((t2 - t1) * 1e3)
            tiers.append(sched.store.last_tier)
            idx, valid = dense_from_chunk(ch.columnar, engine.table_slot, T)
            want = engine.reference_pool(idx, valid)
            diff = np.abs(pooled - want)
            err = max(err, float(diff.max()))
            gap = max(gap, float((diff / (POOL_TOL["atol"] + POOL_TOL["rtol"]
                                          * np.abs(want))).max()))
            ios += int(sm_ios.sum())
            n += ch.columnar.n_queries
            if model is not None:
                a = model.arch
                dev = next(model.parameters()).device
                u = rng.integers(0, a.user_tables[0],
                                 (len(a.user_tables), a.pooling))
                it = rng.integers(0, a.item_tables[0],
                                  (len(a.item_tables), item_batch, a.pooling))
                dense = rng.standard_normal((item_batch, a.num_dense))
                s = model.serve_query(
                    torch.as_tensor(u, dtype=torch.int32, device=dev),
                    torch.as_tensor(it, dtype=torch.int32, device=dev),
                    torch.as_tensor(dense, dtype=torch.float32, device=dev))
                scores.append(float(s.mean()))
    return HostPlaneResult(n, len(tiers), tiers, err, gap,
                           float(np.mean(scores)) if scores else 0.0, ios,
                           host_ms, device_ms)


def fleet_power(store: SDMEmbeddingStore):
    """The Table 8 power model (``core/power.py``) at the store's row hit
    rate (at least 0.9), as the reference example states it: a model
    output, not a measurement. Returns the HW-L and HW-SS+SDM scenarios."""
    w = Workload("m1", sm_tables=50, avg_pool=42, row_bytes=59,
                 cache_hit_rate=max(store.row_hit_rate, 0.9),
                 total_qps=240 * 1200)
    base = run_scenario("HW-L", HW_L, w, use_sdm=False, qps_override=240)
    sdm = run_scenario("HW-SS+SDM", HW_SS, w, use_sdm=True)
    return base, sdm


def _main_host_plane(args) -> None:
    spec = host_plane_spec(args.archetype, queries=args.queries,
                           table_bytes=args.table_bytes,
                           latency_mode=args.latency_mode)
    trace = build_trace(spec)
    store, sched = build_host_plane(trace, latency_mode=args.latency_mode,
                                    updating=args.updating, tuned=args.tuned)
    engine = build_trace_engine(spec, args.dim, seed=0,
                                torch_device=args.device, shards=args.shards,
                                layout=args.layout)
    dev = engine.devices[0]
    model = DLRM(SCORING_ARCH, device=dev,
                 generator=torch.Generator().manual_seed(1))
    res = serve_host_plane(sched, engine, trace, args.batch, model=model,
                           item_batch=args.item_batch)
    print(f"served {res.queries} queries of trace '{trace.name}' "
          f"(batch={args.batch}, offered {trace.offered_qps:.0f} QPS) "
          f"x {args.item_batch} items")
    print(f"  SM latency plane:    {args.latency_mode}"
          + (f" (updating={args.updating}, tuned={args.tuned})"
             if args.latency_mode == "sampled" else ""))
    if store.io.sim is not None and store.io.sim.update is not None:
        u = store.io.sim.update
        print(f"  update write plane:  {u.waves} waves, {u.gc_events} GC "
              f"pauses")
    print(f"  p50/p95/p99 latency: {sched.percentile(50):6.0f} / "
          f"{sched.percentile(95):6.0f} / {sched.percentile(99):6.0f} us")
    print(f"  row-cache hit rate:  {store.row_hit_rate:.3f}")
    print(f"  pooled hit rate:     {store.pooled_hit_rate:.3f}")
    print(f"  inflight IOs (now):  {sched.inflight}  deferred: {sched.deferred}")
    print(f"  feasible QPS (p95):  {sched.qps_at_latency():.0f}")
    print(f"  device engine:       hit rate {engine.hit_rate:.3f}, "
          f"max |pooled - ref| = {res.max_dev_err:.2e} on {dev}")
    print(f"  mean CTR score:      {res.mean_score:.4f}")
    base, sdm = fleet_power(store)
    print(f"  fleet power: HW-L={base.total_power:.0f} -> "
          f"HW-SS+SDM={sdm.total_power:.0f} "
          f"(saving {1 - sdm.total_power/base.total_power:.1%}, paper: 20%)")


# -- a fleet of hosts, each serving its share on its own device engine -------

# the reference example's fleet host (examples/fleet_control.py:33-34): an
# HW-SS host over Nand x 2 whose 8 MiB cache budget becomes the engine's
FLEET_HOST = HostSpec(name="h", host=HW_SS, device="nand_flash",
                      num_devices=2, fm_cache_bytes=8 << 20)
FLEET_ROUTINGS = ("round_robin", "tenant_sticky", "per_tenant")


def build_fleet(hosts: int, *, mesh_host_shards: int = 0,
                layout: str = "row", routing: str = "round_robin",
                chunk: int = 32, telemetry=None) -> ClusterSim:
    """A ``ClusterSim`` of ``hosts`` ``FLEET_HOST`` hosts named h0, h1, ...;
    with ``mesh_host_shards`` K > 0 the last one is a mesh slice of
    ``mesh_shape=(K,)`` in ``layout``. ``telemetry`` is the cluster's
    telemetry setting (None: off, bit-invisible)."""
    if hosts < 1:
        raise ValueError(f"a fleet needs at least one host, got {hosts}")
    specs = [dataclasses.replace(FLEET_HOST, name=f"h{i}")
             for i in range(hosts)]
    if mesh_host_shards:
        specs[-1] = dataclasses.replace(specs[-1],
                                        mesh_shape=(mesh_host_shards,),
                                        shard_layout=layout)
    return ClusterSim(ClusterConfig(hosts=tuple(specs), routing=routing,
                                    chunk=chunk, telemetry=telemetry))


def fleet_engine_config(use_kernels: bool = True) -> EngineConfig:
    """The engine config ``HostSim.attach_engine`` gives a ``FLEET_HOST``
    by default (the kernels on), or the same with the plain versions."""
    h = FLEET_HOST
    return EngineConfig(hbm_cache_bytes=h.fm_cache_bytes,
                        num_devices=h.num_devices,
                        item_time_us=1e6 / host_compute_qps(h.host),
                        use_kernels=use_kernels)


def _main_fleet(args) -> None:
    spec = m1_spec(args.archetype, queries=args.queries,
                   table_bytes=args.table_bytes)
    trace = build_trace(spec)
    tables = trace_tables(spec, args.dim, seed=0, torch_device=args.device)
    sim = build_fleet(args.fleet_hosts, mesh_host_shards=args.mesh_host_shards,
                      layout=args.layout, routing=args.routing,
                      chunk=args.batch,
                      telemetry=True if args.telemetry else None)
    # a mesh host's shard k goes on card k mod count, so one card can hold
    # every shard; on the CPU make_embed_mesh puts every shard there
    devices = None
    if resolve_device(args.device).type == "cuda" and args.mesh_host_shards:
        count = torch.cuda.device_count()
        devices = [torch.device("cuda", k % count)
                   for k in range(args.mesh_host_shards)]
    with torch.no_grad():
        rep = sim.run_device_plane(trace, tables, bg_iops=10_000.0,
                                   torch_device=args.device, devices=devices)
    print(f"served {rep.queries} {args.archetype} queries over "
          f"{len(rep.hosts)} hosts ({args.routing}, batch={args.batch}) on "
          f"{args.device}: {len(tables)} tables of {args.dim}")
    for h in rep.hosts:
        print(f"  {h.name:<4} queries {h.queries:5d}  SM IOs {h.sm_ios:8d}  "
              f"engine hit rate {h.engine_hit_rate:.4f}  shards "
              f"{h.mesh_devices}  p50/p99 {h.p50_us:6.0f} / {h.p99_us:6.0f} us")
    print(f"  fleet p50/p99/p99.9: {rep.p50_us:6.0f} / {rep.p99_us:6.0f} / "
          f"{rep.p999_us:6.0f} us (Eq. 3, analytic SM model)")
    if rep.telemetry is not None:
        for k, v in sorted(rep.telemetry.registry.counters.items()):
            print(f"  telemetry {k}: {v}")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--queries", type=int, default=128)
    ap.add_argument("--batch", type=int, default=32, help="serving batch size")
    ap.add_argument("--item-batch", type=int, default=50)
    ap.add_argument("--rows", type=int, default=100_000,
                    help="rows per embedding table (DLRMArch default 100000)")
    ap.add_argument("--device", default="cuda", help="torch device")
    ap.add_argument("--archetype", choices=sorted(ARCHETYPES),
                    help="serve this workload trace over the M1 inventory "
                         "instead of uniform rows")
    ap.add_argument("--table-bytes", type=float, default=4e9,
                    help="trace path: bytes of the M1 inventory")
    ap.add_argument("--dim", type=int, default=128,
                    help="trace path: row width of every table")
    ap.add_argument("--stream", type=int, default=0, metavar="PIECE",
                    help="trace path: generate and serve the trace as a "
                         "stream in pieces of PIECE queries (0: whole)")
    ap.add_argument("--shards", type=int, default=0,
                    help="trace path: serve through a sharded engine of this "
                         "many shards, one per card (0: the single-device "
                         "engine)")
    ap.add_argument("--layout", choices=EMBED_LAYOUTS, default="row",
                    help="trace path: the sharded store's layout")
    ap.add_argument("--host-plane", action="store_true",
                    help="trace path: serve the trace through the SDM host "
                         "plane too, beside the device engine, and score "
                         "items (the reference example's path)")
    ap.add_argument("--latency-mode", default="analytic",
                    choices=("analytic", "sampled"),
                    help="host plane: closed-form SM latency means or the "
                         "event-driven device simulator")
    ap.add_argument("--updating", action="store_true",
                    help="host plane, sampled mode: stream endurance-bounded "
                         "model-update writes into the device plane")
    ap.add_argument("--tuned", action="store_true",
                    help="host plane, sampled mode: apply the §4.1 tuning "
                         "knobs (outstanding-IO throttle + read-priority)")
    ap.add_argument("--fleet-hosts", type=int, default=0,
                    help="trace path: route the trace over a fleet of this "
                         "many hosts, each serving on its own device engine")
    ap.add_argument("--mesh-host-shards", type=int, default=0,
                    help="fleet: make the last host a mesh slice of this "
                         "many shards (0: a single-device host)")
    ap.add_argument("--routing", choices=FLEET_ROUTINGS,
                    default="round_robin", help="fleet: the router")
    ap.add_argument("--telemetry", action="store_true",
                    help="fleet: record telemetry and print its counters")
    args = ap.parse_args(argv)
    fleet_flags = (args.mesh_host_shards or args.telemetry
                   or args.routing != "round_robin")
    if args.fleet_hosts and not args.archetype:
        ap.error("--fleet-hosts serves a trace: give --archetype")
    if fleet_flags and not args.fleet_hosts:
        ap.error("--mesh-host-shards, --routing and --telemetry need "
                 "--fleet-hosts")
    if args.fleet_hosts and (args.shards or args.host_plane or args.stream):
        ap.error("--fleet-hosts takes neither --shards, --host-plane nor "
                 "--stream")
    if args.fleet_hosts:
        _main_fleet(args)
        return
    if args.shards and not args.archetype:
        ap.error("--shards serves a trace: give --archetype")
    host_flags = (args.latency_mode != "analytic" or args.updating
                  or args.tuned)
    if args.host_plane and not args.archetype:
        ap.error("--host-plane serves a trace: give --archetype")
    if host_flags and not args.host_plane:
        ap.error("--latency-mode, --updating and --tuned need --host-plane")
    if args.host_plane and args.stream:
        ap.error("--host-plane serves a materialized trace: drop --stream")
    if args.host_plane:
        _main_host_plane(args)
        return
    if args.archetype:
        _main_trace(args)
        return

    arch = DLRMArch(user_tables=(args.rows,) * 8, item_tables=(args.rows,) * 4)
    model, engine = build(arch, seed=0, torch_device=args.device)
    traffic = make_traffic(arch, queries=args.queries, batch=args.batch,
                           item_batch=args.item_batch, seed=1)
    results = serve(model, engine, traffic)
    stats = [s for r in results for s in r.stats]
    lat = np.array([s.latency_us for s in stats])
    print(f"served {len(stats)} queries (batch={args.batch}) x "
          f"{args.item_batch} items on {engine.torch_device}")
    if stats:
        print(f"  p50/p99 latency:     {np.percentile(lat, 50):6.0f} / "
              f"{np.percentile(lat, 99):6.0f} us (Eq. 3, analytic SM model)")
        print(f"  SM IOs:              {sum(s.sm_ios for s in stats)}")
        print(f"  mean CTR score:      "
              f"{np.mean([r.scores.mean() for r in results]):.4f}")
    print(f"  device engine:       hit rate {engine.hit_rate:.3f}, max |pooled "
          f"- ref| = {max((r.max_err for r in results), default=0.0):.2e}")


if __name__ == "__main__":
    main()
