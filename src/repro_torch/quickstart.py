"""Quickstart: the SDM embedding store in 60 lines.

Builds an M1-like table inventory, places user tables on SM (Nand flash
model) with an FM row cache + pooled-embedding cache, serves synthetic
queries and prints the paper's key steady-state statistics.

The port's copy of the reference's ``examples/quickstart.py``: the same
seeded run prints the same lines. The store is numpy on the host, as the
reference's is, so the example takes no device.

Run: PYTHONPATH=src python -m repro_torch.quickstart
"""
import numpy as np

from repro_torch.core import (DEVICES, PlacementConfig, SDMConfig, SDMEmbeddingStore,
                        sample_table_metas)
from repro_torch.core.io_sim import required_iops


def main():
    rng = np.random.default_rng(0)
    metas = sample_table_metas(
        rng, num_user=61, num_item=30,
        user_dim_bytes=(90, 172), item_dim_bytes=(90, 172),
        user_pool=42, item_pool=9, total_bytes=8e9)  # scaled-down M1

    store = SDMEmbeddingStore(
        metas, DEVICES["nand_flash"],
        SDMConfig(fm_cache_bytes=256 << 20,
                  pooled_cache_bytes=32 << 20, pooled_len_threshold=4,
                  placement=PlacementConfig(policy="sm_only_with_cache"),
                  num_devices=2),
        seed=0)

    qps = 120
    print("serving synthetic queries (user tables on SM, items on FM)...")
    history = []
    for i in range(400):
        # ~15% of queries re-rank a recent user context: identical index
        # sequences -> pooled-embedding cache hits (paper §4.4)
        if history and rng.random() < 0.15:
            q = history[rng.integers(0, len(history))]
        else:
            q = store.synth_query()
            if len(history) < 500:
                history.append(q)
        stats = store.serve_query(q, bg_iops=required_iops(qps, 50, 42, 0.1))
        if (i + 1) % 100 == 0:
            print(f"  q{i+1:4d}: latency={stats.latency_us:7.0f}us "
                  f"row_hit={store.row_hit_rate:.3f} "
                  f"pooled_hit={store.pooled_hit_rate:.3f}")

    print(f"\nsteady state: row-cache hit rate   = {store.row_hit_rate:.3f} "
          f"(paper M1: >0.96 after warmup)")
    print(f"              pooled-cache hit rate = {store.pooled_hit_rate:.3f} "
          f"(paper: ~0.05)")
    print(f"              SM IOs issued         = {store.stats.sm_ios}")
    print(f"              bus overhead (ampl.)  = {store.io.bus_overhead:.2%} "
          f"(§4.1.1 small-granularity reads)")


if __name__ == "__main__":
    main()
