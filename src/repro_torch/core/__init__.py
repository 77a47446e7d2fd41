"""SDM core of the port — the paper's contribution: tiered software-defined
memory for embedding-dominated inference (scheduling, caches, IO, placement,
power), with the HBM row cache of the device engine."""
from repro_torch.core.cache import (CacheGeometry, TorchRowCache,  # noqa: F401
                                    dual_cache_geometry)
from repro_torch.core.cache_sim import (BatchedRowCache,  # noqa: F401
                                        SetAssocSimCache, SimRowCache)
from repro_torch.core.columnar import (ColumnarChunk, ColumnarQueries,  # noqa: F401
                                       TableView)
from repro_torch.core.io_sim import (DEVICES, DeviceModel, IOEngine,  # noqa: F401
                                     IOQueueConfig, required_iops)
from repro_torch.core.locality import (TableMeta, sample_table_metas,  # noqa: F401
                                       zipf_indices)
from repro_torch.core.placement import (FM_DIRECT, SM_CACHED,  # noqa: F401
                                        SM_UNCACHED, PlacementConfig, assign)
from repro_torch.core.pooled_cache import (PooledEmbeddingCache,  # noqa: F401
                                           order_invariant_hash,
                                           order_invariant_hash_batch)
from repro_torch.core.quant import dequantize_rows, quantize_rows, row_bytes  # noqa: F401
from repro_torch.core.sdm import QueryStats, SDMConfig, SDMEmbeddingStore  # noqa: F401
