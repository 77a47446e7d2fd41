"""Device-resident batched serving engine (HBM row cache + CUDA kernels).

Embedding tables live int8 row-quantized in a (simulated) SM tier, hot
dequantized rows live in an HBM row cache (``TorchRowCache``), and one step
serves a whole ``[batch, tables, pooling]`` index block on the torch device:

    probe   -- ``cache_probe`` kernel: per query key, its cache set's tags are
               compared and the hit row read (§4.3).
    gather  -- misses go to the ``gather_pool`` kernel, which fuses gather +
               rowwise dequant + pooling over the quantized backing store
               (§4.4); hit and padded positions point at a zero sentinel row.
    dedupe  -- a repeated missed key costs one SM IO, charged to its first
               occurrence in (query, table, position) order.
    fill    -- the fetched rows are dequantized and inserted (LRU ways).

The pooled output is the hit-side pool plus the miss-side pool. Only the
``[B, T]`` miss counts and the pooled block come back to the host, where the
analytic ``IOEngine`` prices each query's IO under Eq. 3.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.cache import TorchRowCache, dual_cache_geometry
from repro_torch.core.io_sim import DeviceModel, IOEngine, IOQueueConfig
from repro_torch.core.quant import quantize_rows, row_bytes
from repro_torch.core.sdm import QueryStats
from repro_torch.kernels import ops


@dataclasses.dataclass
class EngineConfig:
    hbm_cache_bytes: int = 8 << 20       # HBM budget for the row cache
    ways: int = 8
    use_kernels: bool = True             # False -> the kernels' plain versions
    num_devices: int = 2
    item_time_us: float = 200.0
    io_queue: IOQueueConfig = dataclasses.field(default_factory=IOQueueConfig)


class DeviceServingEngine:
    """Batched multi-query, multi-table serving over device kernels.

    ``tables``: {table_id: [rows, dim] float array or tensor} -- every table
    shares one embedding dim (one backing store, one cache geometry).
    ``device`` is the SM device model; ``torch_device`` is where the store,
    the cache and the step live (``cuda`` unless the caller asks for the
    CPU)."""

    def __init__(self, tables: Dict[int, object], device: DeviceModel,
                 cfg: Optional[EngineConfig] = None, *, torch_device="cuda"):
        cfg = EngineConfig() if cfg is None else cfg
        if not tables:
            raise ValueError("need at least one table")
        dims = {t.shape[1] for t in tables.values()}
        if len(dims) != 1:
            raise ValueError(f"tables must share one embedding dim, got {dims}")
        self.cfg = cfg
        self.torch_device = dev = resolve_device(torch_device)
        self.dim = dims.pop()
        self.table_ids: List[int] = list(tables)
        self.rows_per_table = np.array([tables[t].shape[0]
                                        for t in self.table_ids], np.int64)

        # quantize and stack into one backing store + zero sentinel row
        qts = [quantize_rows(torch.as_tensor(tables[t], device=dev).detach())
               for t in self.table_ids]
        self.payload = torch.cat([q["payload"] for q in qts]
                                 + [qts[0]["payload"].new_zeros((1, self.dim))])
        zero = torch.zeros(1, dtype=torch.float32, device=dev)
        self.scale = torch.cat([q["scale"] for q in qts] + [zero])
        self.bias = torch.cat([q["bias"] for q in qts] + [zero])
        self.sentinel = int(self.payload.shape[0]) - 1          # the zero row
        self.offsets = torch.as_tensor(
            np.r_[0, np.cumsum(self.rows_per_table)[:-1]], dtype=torch.int64,
            device=dev)

        self.row_bytes = row_bytes(self.dim, bits=8)
        geo = dual_cache_geometry(cfg.hbm_cache_bytes, dim=self.dim,
                                  row_payload_bytes=self.row_bytes,
                                  ways=cfg.ways)
        self.cache = TorchRowCache(geo, device=dev)
        self.state = self.cache.init()
        self.io = IOEngine(device, cfg.num_devices, cfg.io_queue)
        self.stats = QueryStats()        # store-level totals, host-plane shape
        self.table_slot = {t: i for i, t in enumerate(self.table_ids)}

    # -- device step ----------------------------------------------------------

    def _step(self, idx: torch.Tensor, valid: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
        """idx [B, T, P] int32, valid [B, T, P] bool, both on the device ->
        (pooled [B, T, D] f32, deduped miss counts [B, T]). The cache is
        keyed by table slot (0..T-1), not table id."""
        cache, use_kernels = self.cache, self.cfg.use_kernels
        B, T, P = idx.shape
        # padded positions may hold any value (the reference's gathers clamp
        # them; torch's raise): they are masked out of pooling, IO and the
        # fill, so read row 0 of their table instead
        idx = torch.where(valid, idx, 0)
        tids = torch.arange(T, dtype=torch.int32, device=idx.device
                            ).view(1, T, 1).expand(B, T, P)
        tq, rq, vq = tids.reshape(-1), idx.reshape(-1), valid.reshape(-1)
        vals, hit, _ = cache.lookup_device(self.state, tq, rq,
                                           use_kernel=use_kernels, valid=vq)
        # hit-side pool straight from HBM cache data
        pooled_hit = (vals * hit[:, None]).reshape(B, T, P, -1).sum(dim=2)
        # miss-side pool fused over the quantized backing store; hits and
        # padded positions point at the zero sentinel row
        grow = (self.offsets[tids.long()] + idx).reshape(-1)    # global row
        gidx = torch.where(hit | ~vq, self.sentinel, grow)
        pooled_miss = ops.embedding_gather_pool(
            self.payload, self.scale, self.bias,
            gidx.reshape(B * T, P).to(torch.int32),
            use_kernel=use_kernels).reshape(B, T, -1)
        # unique-miss coalescing: group equal global rows with a stable sort;
        # the group head is the first occurrence (-1 is one dead group)
        miss = vq & ~hit
        gkey = torch.where(miss, grow, -1)
        order = torch.argsort(gkey, stable=True)
        ks = gkey[order]
        head = torch.ones_like(ks, dtype=torch.bool)
        head[1:] = ks[1:] != ks[:-1]
        first = torch.empty_like(head)
        first[order] = head
        io_mask = miss & first
        # fill: dequantize the fetched rows and insert them; duplicates are
        # masked out so one key fills one way. The reference's compiled step
        # contracts q * scale + bias into one fused multiply-add; an 8-bit
        # integer times a float32 is exact in float64, so the float64 sum
        # rounds once to the same float32 (exactly so unless bias and
        # product differ in magnitude by more than 2**21)
        deq = (self.payload[grow].to(torch.float64)
               * self.scale[grow].to(torch.float64)[:, None]
               + self.bias[grow].to(torch.float64)[:, None]).to(torch.float32)
        cache.insert(self.state, tq, rq, deq, mask=io_mask)
        miss_counts = io_mask.reshape(B, T, P).sum(dim=2)
        return pooled_hit + pooled_miss, miss_counts

    # -- serving --------------------------------------------------------------

    def serve_batch(self, idx: np.ndarray, bg_iops: float = 0.0,
                    valid: Optional[np.ndarray] = None
                    ) -> Tuple[np.ndarray, List[QueryStats]]:
        """idx: [B, T, P] int32 of per-table local row ids (T in the order of
        ``table_ids``). Returns (pooled [B, T, dim] f32, per-query stats).
        ``valid`` (bool [B, T, P], optional) masks padded positions out of
        pooling, caching and IO accounting."""
        idx = np.asarray(idx, np.int32)
        if idx.ndim != 3:
            raise ValueError(f"idx must be [B, T, P], got shape {idx.shape}")
        if idx.shape[1] != len(self.table_ids):
            raise ValueError(
                f"idx has {idx.shape[1]} tables, engine has "
                f"{len(self.table_ids)}")
        valid = (np.ones(idx.shape, bool) if valid is None
                 else np.asarray(valid, bool))
        live = np.where(valid, idx, 0)
        if (live < 0).any() or (live >= self.rows_per_table[None, :, None]).any():
            raise ValueError("row index out of range")
        if idx.shape[0] == 0:            # degenerate empty batch: no device
            return (np.zeros((0, idx.shape[1], self.dim), np.float32), [])
        dev = self.torch_device
        pooled, miss = self._step(torch.from_numpy(idx).to(dev),
                                  torch.from_numpy(valid).to(dev))
        return pooled.cpu().numpy(), self._account(miss.cpu().numpy(), bg_iops)

    def _account(self, miss: np.ndarray, bg_iops: float) -> List[QueryStats]:
        """Per-query IO + Eq. 3 latency accounting for a ``[B, T]`` block of
        deduped miss counts; accumulates store-level ``stats`` exactly like
        the host plane's ``serve_query`` running totals."""
        # one coalesced submission across all (query, table) pairs
        rb = np.full(miss.size, self.row_bytes, np.int64)
        lats, _ = self.io.submit_batch_multi(miss.reshape(-1), rb, bg_iops)
        sm_lat = lats.reshape(miss.shape).max(axis=1)
        stats = []
        for b in range(miss.shape[0]):
            # Eq. 3: user-side SM time overlaps item-side compute; only the
            # excess surfaces
            q = QueryStats(latency_us=max(self.cfg.item_time_us, sm_lat[b]),
                           sm_ios=int(miss[b].sum()),
                           sm_time_us=float(sm_lat[b]))
            self.stats.latency_us += q.latency_us
            self.stats.sm_ios += q.sm_ios
            stats.append(q)
        return stats

    def reference_pool(self, idx: np.ndarray,
                       valid: Optional[np.ndarray] = None) -> np.ndarray:
        """Plain-tensor oracle for :meth:`serve_batch`'s pooled output:
        dequantize every gathered row and sum, no cache involved."""
        dev = self.torch_device
        idx = torch.as_tensor(np.asarray(idx), dtype=torch.int64, device=dev)
        if valid is not None:
            valid = torch.as_tensor(np.asarray(valid, bool), device=dev)
            idx = torch.where(valid, idx, 0)
        grow = self.offsets[None, :, None] + idx                # [B, T, P]
        deq = (self.payload[grow].to(torch.float32)
               * self.scale[grow][..., None] + self.bias[grow][..., None])
        if valid is not None:
            deq = deq * valid[..., None]
        return deq.sum(dim=2).cpu().numpy()

    # -- reporting ------------------------------------------------------------

    @property
    def hit_rate(self) -> float:
        h = int(self.state["hits"])
        m = int(self.state["misses"])
        return h / (h + m) if h + m else 0.0
