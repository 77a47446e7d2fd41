"""Per-query serving statistics (copy of the reference's ``QueryStats``).

The host serving plane (``SDMEmbeddingStore``) is not ported yet; the device
engine reports through this dataclass in the same shape as the host plane.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class QueryStats:
    latency_us: float = 0.0
    sm_ios: int = 0
    row_hits: int = 0
    row_lookups: int = 0
    pooled_hits: int = 0
    pooled_lookups: int = 0
    sm_time_us: float = 0.0              # slowest SM IO batch (pre-overlap)
    # data-integrity plane counters (zero until that plane is ported)
    corrupt_reads: int = 0
    retry_steps: int = 0
    hedged_reads: int = 0
    repair_ios: int = 0
