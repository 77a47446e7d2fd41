"""Serve a DLRM's user embeddings through the device serving engine and
score item batches: the port's serving path end to end.

The DLRM's user tables are int8-quantized into the simulated SM tier and
served batch by batch through ``DeviceServingEngine`` (HBM row cache,
``cache_probe`` + ``gather_pool`` CUDA kernels, Eq. 3 IO accounting); each
batch's first query then scores an item batch with ``DLRM.serve_query``
(B_U = 1, Eq. 2). Weights and traffic (uniform random rows) are seeded.

Run: PYTHONPATH=src python -m repro_torch.serve_dlrm \
         [--queries 128 --batch 32 --item-batch 50 --device cuda]
"""
from __future__ import annotations

import argparse
import dataclasses
from typing import List, Optional

import numpy as np
import torch

from repro_torch.core.io_sim import DEVICES
from repro_torch.core.sdm import QueryStats
from repro_torch.models.dlrm import DLRM, DLRMArch
from repro_torch.runtime.engine import DeviceServingEngine, EngineConfig


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


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--queries", type=int, default=128)
    ap.add_argument("--batch", type=int, default=32, help="serving batch size")
    ap.add_argument("--item-batch", type=int, default=50)
    ap.add_argument("--rows", type=int, default=100_000,
                    help="rows per embedding table (DLRMArch default 100000)")
    ap.add_argument("--device", default="cuda", help="torch device")
    args = ap.parse_args(argv)

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
