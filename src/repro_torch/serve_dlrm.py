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

Run: PYTHONPATH=src python -m repro_torch.serve_dlrm \
         [--queries 128 --batch 32 --item-batch 50 --device cuda]
     PYTHONPATH=src python -m repro_torch.serve_dlrm --archetype zipf_steady \
         [--queries 512 --table-bytes 4e9 --dim 128 --stream 0 --device cuda]
         [--shards 0 --layout row]
"""
from __future__ import annotations

import argparse
import dataclasses
from typing import List, Optional, Sequence, Union

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.io_sim import DEVICES
from repro_torch.core.sdm import QueryStats
from repro_torch.launch import EMBED_LAYOUTS, make_embed_mesh
from repro_torch.models.dlrm import DLRM, DLRMArch
from repro_torch.runtime.engine import DeviceServingEngine, EngineConfig
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


def build_trace_engine(spec: WorkloadSpec, dim: int, *, seed: int = 0,
                       torch_device="cuda",
                       cfg: Optional[EngineConfig] = None, shards: int = 0,
                       layout: str = "row", devices: Optional[Sequence] = None
                       ) -> Union[DeviceServingEngine, ShardedServingEngine]:
    """An engine over one ``[num_rows, dim]`` float table per user table of
    ``spec``'s inventory (every tenant's), on the Nand SM device model. The
    tables come from a generator seeded with ``seed`` on ``torch_device`` and
    are freed once quantized into the engine's store.

    ``shards=0`` builds a ``DeviceServingEngine``; ``shards >= 1`` a
    ``ShardedServingEngine`` in ``layout`` over ``make_embed_mesh(shards,
    torch_device, devices=devices)`` (the tables then come from the first
    shard's device), holding the same tables."""
    mesh = (make_embed_mesh(shards, torch_device, devices=devices)
            if shards else None)
    dev = mesh.devices[0] if mesh else resolve_device(torch_device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    tables = {m.table_id: torch.randn((m.num_rows, dim), generator=gen,
                                      device=dev)
              for ms in tenant_table_metas(spec).values()
              for m in ms if m.kind == "user"}
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
    args = ap.parse_args(argv)
    if args.shards and not args.archetype:
        ap.error("--shards serves a trace: give --archetype")
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
