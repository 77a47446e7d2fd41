"""Sharded serving engine: the paper's scale-out regime (§7, Table 9) over a
shard mesh (``launch.mesh.make_embed_mesh``).

The quantized backing store is spread over the mesh's shards in one of two
layouts (``launch.sharding.EMBED_LAYOUTS``):

* **row** -- every shard owns a contiguous row slice of *every* table (slice
  size ``ceil(rows_t / n)``). A key ``(t, r)`` belongs to shard
  ``r // slice_t``; each shard probes its own HBM row cache and pools its
  owned misses from its store slice, and the partial pools are summed.
* **table** -- every shard owns whole tables (contiguous blocks of
  ``ceil(T / n)`` table slots); each table's pool is taken from its owner.

Each shard runs the single-device engine's step on its own device: the
``cache_probe`` and ``gather_pool`` kernels plus the unique-miss dedupe and
the fill. Foreign and padded keys are probed as the cache's NULL key (never
hit, never counted) and point at the shard's zero sentinel row (pool
nothing). Ownership partitions keys across shards, so the union of the
shards' first-occurrence dedupes over global row ids is the single-device
dedupe. The store is quantized as the single-device one is and holds its
rows at the same pitch (``engine.row_pitch``), so it is bit-equal to it;
the pools drop the pad columns.

One process drives every shard (shard k on ``mesh.devices[k]``) and
combines the partial pools on the first shard's device, as the reference's
single controller does with ``lax.psum`` / ``lax.all_gather``; no process
group is involved.

IO accounting: the shards' ``[B, T]`` miss blocks go through one
``IOEngine.submit_batch_multi`` over all (shard, query, table) elements in
shard-major order. A query's SM time is the max over shards and tables, its
``sm_ios`` the sum.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.cache import TorchRowCache, dual_cache_geometry
from repro_torch.core.columnar import ColumnarChunk
from repro_torch.core.io_sim import DeviceModel, IOEngine
from repro_torch.core.quant import row_bytes
from repro_torch.core.sdm import QueryStats
from repro_torch.kernels import ops
from repro_torch.launch.mesh import EmbedMesh, make_embed_mesh
from repro_torch.launch.sharding import check_layout
from repro_torch.runtime.engine import (EngineConfig, dense_from_chunk,
                                        fill_misses, new_store, quantize_into,
                                        row_pitch)


class ShardedServingEngine:
    """Batched serving over a shard mesh; ``serve_batch`` and
    ``serve_columnar`` take and return what ``DeviceServingEngine``'s do.

    Per shard k: ``payload[k]`` [L+1, pitch] uint8, ``scale[k]`` and
    ``bias[k]`` [L+1] f32 (row L is the zero sentinel), ``caches[k]`` and its
    state ``state[k]`` (rows at the pitch, as ``DeviceServingEngine``'s), all
    on ``mesh.devices[k]``. ``mesh`` defaults to
    ``make_embed_mesh()``: one shard per card."""

    def __init__(self, tables: Dict[int, object], device: DeviceModel,
                 cfg: Optional[EngineConfig] = None, *,
                 mesh: Optional[EmbedMesh] = None, layout: str = "row"):
        cfg = EngineConfig() if cfg is None else cfg
        check_layout(layout)
        if not tables:
            raise ValueError("need at least one table")
        dims = {t.shape[1] for t in tables.values()}
        if len(dims) != 1:
            raise ValueError(f"tables must share one embedding dim, got {dims}")
        self.cfg = cfg
        self.layout = layout
        self.mesh = make_embed_mesh() if mesh is None else mesh
        if self.mesh.axis_names != ("shard",):
            raise ValueError("mesh must have the single axis ('shard',)")
        self.n = n = self.mesh.shape["shard"]
        self.devices = tuple(self.mesh.devices)
        self.dim = dims.pop()
        self.table_ids: List[int] = list(tables)
        self.table_slot = {t: i for i, t in enumerate(self.table_ids)}
        self.rows_per_table = np.array([tables[t].shape[0]
                                        for t in self.table_ids], np.int64)
        T = len(self.table_ids)
        # global row ids (offsets into the unsharded concatenation) key the
        # cross-shard miss dedupe; they never index device memory
        self.g_offsets = np.r_[0, np.cumsum(self.rows_per_table)[:-1]].astype(
            np.int64)

        # pieces[ti]: (shard, first row, end row, local offset) of table ti
        pieces: List[List[Tuple[int, int, int, int]]] = []
        if layout == "row":
            # shard k owns rows [k*slice_t, (k+1)*slice_t) of every table
            self.slice_rows = np.array(
                [max(1, -(-int(r) // n)) for r in self.rows_per_table], np.int64)
            loff = np.r_[0, np.cumsum(self.slice_rows)[:-1]].astype(np.int64)
            L = int(self.slice_rows.sum())
            for ti in range(T):
                s, r = int(self.slice_rows[ti]), int(self.rows_per_table[ti])
                pieces.append([(k, k * s, min(k * s + s, r), int(loff[ti]))
                               for k in range(n) if k * s < r])
            self.owner_of_table = None
        else:  # table layout: shard k owns table slots [k*Tl, (k+1)*Tl)
            Tl = max(1, -(-T // n))
            self.owner_of_table = np.minimum(
                np.arange(T, dtype=np.int64) // Tl, n - 1)
            loff = np.zeros(T, np.int64)
            shard_rows = np.zeros(n, np.int64)
            for ti in range(T):
                k = int(self.owner_of_table[ti])
                loff[ti] = shard_rows[k]
                shard_rows[k] += int(self.rows_per_table[ti])
            L = int(shard_rows.max())
            for ti in range(T):
                pieces.append([(int(self.owner_of_table[ti]), 0,
                                int(self.rows_per_table[ti]), int(loff[ti]))])
            self.slice_rows = None
            # owners rise with the slot: shard k's tables are one block
            self._table_blocks = [
                (int(np.searchsorted(self.owner_of_table, k, "left")),
                 int(np.searchsorted(self.owner_of_table, k, "right")))
                for k in range(n)]
        self.local_offsets = loff
        self.sentinel = L

        # quantize each table's slices straight into the shards' stores at
        # the pitch, on the first shard's device (``quantize_into``: the
        # rows of the whole table, bit-identical to the single-device
        # store): no second whole copy of the store is made
        self.pitch = row_pitch(self.dim)
        stores = [new_store(L + 1, self.dim, d) for d in self.devices]
        for ti, t in enumerate(self.table_ids):
            table = torch.as_tensor(tables[t], device=self.devices[0]).detach()
            for k, lo, hi, dst in pieces[ti]:
                quantize_into(stores[k], table, lo, hi, dst)
        self.payload = [p for p, _, _ in stores]
        self.scale = [s for _, s, _ in stores]
        self.bias = [b for _, _, b in stores]

        # the step's per-table constants, on each shard's device
        def on(dev, a, dtype):
            return torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)
        self._consts = [{
            "g_off": on(d, self.g_offsets, torch.int64),
            "l_off": on(d, loff, torch.int64),
            "slice_rows": (on(d, self.slice_rows, torch.int32)
                           if layout == "row" else None),
            "owner": (on(d, self.owner_of_table, torch.int32)
                      if layout == "table" else None),
        } for d in self.devices]

        self.row_bytes = row_bytes(self.dim, bits=8)
        geo = dual_cache_geometry(cfg.hbm_cache_bytes, dim=self.pitch,
                                  row_payload_bytes=self.row_bytes,
                                  ways=cfg.ways)
        self.caches = [TorchRowCache(geo, device=d) for d in self.devices]
        self.state = [c.init() for c in self.caches]
        self.io = IOEngine(device, cfg.num_devices, cfg.io_queue)
        self.stats = QueryStats()
        self.telemetry = None          # obs handle; None = bit-invisible

    # -- device step ----------------------------------------------------------

    def _shard_step(self, k: int, idx: torch.Tensor, valid: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Shard k's step. idx [B, T, P] int32 with padded positions zeroed,
        valid [B, T, P] bool, both on the shard's device -> (partial pool
        [B, T, D] f32 of the shard's keys, its deduped miss counts [B, T])."""
        c, cache, state = self._consts[k], self.caches[k], self.state[k]
        payload, scale, bias = self.payload[k], self.scale[k], self.bias[k]
        use_kernels, D = self.cfg.use_kernels, self.dim
        B, T, P = idx.shape
        tids = torch.arange(T, dtype=torch.int32, device=idx.device
                            ).view(1, T, 1).expand(B, T, P)
        t_long = tids.long()
        if self.layout == "row":
            # integer // and % by a tensor of slice sizes
            slice_rows = c["slice_rows"].view(1, T, 1)
            own = (idx // slice_rows) == k
            lrow = c["l_off"][t_long] + idx % slice_rows
        else:
            own = c["owner"][t_long] == k
            lrow = c["l_off"][t_long] + idx
        v = (valid & own).reshape(-1)
        tq, rq = tids.reshape(-1), idx.reshape(-1)
        vals, hit, _ = cache.lookup_device(state, tq, rq,
                                           use_kernel=use_kernels, valid=v)
        pooled_hit = (vals * hit[:, None]).reshape(B, T, P, -1).sum(dim=2)[..., :D]
        lr = lrow.reshape(-1)
        gidx = torch.where(hit | ~v, self.sentinel, lr)
        pooled_miss = ops.embedding_gather_pool(
            payload, scale, bias, gidx.reshape(B * T, P).to(torch.int32),
            use_kernel=use_kernels).reshape(B, T, -1)[..., :D]
        # unique-miss dedupe over *global* row ids: ownership partitions
        # keys, so the shards' dedupes union to the single-device dedupe
        miss = v & ~hit
        grow = c["g_off"][t_long.reshape(-1)] + rq
        gkey = torch.where(miss, grow, -1)
        order = torch.argsort(gkey, stable=True)
        ks = gkey[order]
        head = torch.ones_like(ks, dtype=torch.bool)
        head[1:] = ks[1:] != ks[:-1]
        first = torch.empty_like(head)
        first[order] = head
        io_mask = miss & first
        # fill from the shard's unique misses alone, as the single engine
        # does (``engine.fill_misses``). A foreign key of the table layout
        # may point past this shard's rows (the reference's gather clamps
        # it); it is never a miss of this shard, so it is never read
        fill_misses(cache, state, (payload, scale, bias), tq, rq, lr,
                    io_mask, D)
        return pooled_hit + pooled_miss, io_mask.reshape(B, T, P).sum(dim=2)

    def _combine(self, parts: List[torch.Tensor]) -> torch.Tensor:
        """The shards' partial pools -> the pooled block on the first shard's
        device: summed in shard order (row layout), or each table's columns
        from its owner, whose tables are one contiguous block (table)."""
        dev = self.devices[0]
        if self.layout == "row":
            pooled = parts[0]
            for p in parts[1:]:
                pooled = pooled + p.to(dev)
            return pooled
        return torch.cat([parts[k][:, lo:hi].to(dev)
                          for k, (lo, hi) in enumerate(self._table_blocks)], dim=1)

    # -- serving --------------------------------------------------------------

    def serve_batch(self, idx: np.ndarray, bg_iops: float = 0.0,
                    valid: Optional[np.ndarray] = None
                    ) -> Tuple[np.ndarray, List[QueryStats]]:
        """Same contract as ``DeviceServingEngine.serve_batch``; IO charges
        each shard's misses separately (a query waits on its slowest
        shard)."""
        idx = np.asarray(idx, np.int32)
        if idx.ndim != 3:
            raise ValueError(f"idx must be [B, T, P], got shape {idx.shape}")
        if idx.shape[1] != len(self.table_ids):
            raise ValueError(
                f"idx has {idx.shape[1]} tables, engine has "
                f"{len(self.table_ids)}")
        valid = (np.ones(idx.shape, bool) if valid is None
                 else np.asarray(valid, bool))
        # padded positions may hold any value: they are masked out of
        # ownership, pooling, IO and the fill, so they read row 0
        live = np.where(valid, idx, 0)
        if (live < 0).any() or (live >= self.rows_per_table[None, :, None]).any():
            raise ValueError("row index out of range")
        if idx.shape[0] == 0:
            return (np.zeros((0, idx.shape[1], self.dim), np.float32), [])
        live_t, valid_t = torch.from_numpy(live), torch.from_numpy(valid)
        on_device = {d: (live_t.to(d), valid_t.to(d)) for d in set(self.devices)}
        parts, misses = [], []
        for k, d in enumerate(self.devices):
            part, miss = self._shard_step(k, *on_device[d])
            parts.append(part)
            misses.append(miss.to(self.devices[0]))
        pooled = self._combine(parts)
        miss = torch.stack(misses).cpu().numpy()               # [n, B, T]
        return pooled.cpu().numpy(), self._account(miss, bg_iops)

    def serve_columnar(self, chunk: ColumnarChunk, bg_iops: float = 0.0
                       ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Columnar chunk entry: ``(pooled [B, T, dim] f32, sm_time_us [B]
        f64, sm_ios [B] i64)``, as ``DeviceServingEngine.serve_columnar``."""
        T = len(self.table_ids)
        if chunk.n_queries == 0:
            return (np.zeros((0, T, self.dim), np.float32),
                    np.zeros(0, np.float64), np.zeros(0, np.int64))
        idx, valid = dense_from_chunk(chunk, self.table_slot, T)
        pooled, stats = self.serve_batch(idx, bg_iops, valid=valid)
        return (pooled,
                np.array([s.sm_time_us for s in stats], np.float64),
                np.array([s.sm_ios for s in stats], np.int64))

    def _account(self, miss: np.ndarray, bg_iops: float) -> List[QueryStats]:
        """``miss``: [n, B, T] per-shard deduped miss counts. One coalesced
        submission covers every (shard, query, table) element, shard-major;
        per query, SM time is the max wave over shards x tables (Eq. 3
        overlap against item time) and ``sm_ios`` the sum."""
        rb = np.full(miss.size, self.row_bytes, np.int64)
        lats, _ = self.io.submit_batch_multi(miss.reshape(-1), rb, bg_iops)
        sm_lat = lats.reshape(miss.shape).max(axis=(0, 2))     # [B]
        ios_q = miss.sum(axis=(0, 2))                          # [B]
        if self.telemetry is not None:
            reg = self.telemetry.registry
            reg.inc("engine.batches")
            reg.observe_many("engine.sm_time_us", sm_lat)
            for k, v in enumerate(miss.sum(axis=(1, 2)).tolist()):
                reg.inc(f"engine.shard{k}.sm_ios", int(v))
        stats = []
        for b in range(miss.shape[1]):
            q = QueryStats(latency_us=max(self.cfg.item_time_us, sm_lat[b]),
                           sm_ios=int(ios_q[b]),
                           sm_time_us=float(sm_lat[b]))
            self.stats.latency_us += q.latency_us
            self.stats.sm_ios += q.sm_ios
            stats.append(q)
        return stats

    def reference_pool(self, idx: np.ndarray,
                       valid: Optional[np.ndarray] = None) -> np.ndarray:
        """Plain-tensor oracle: every key dequantized from its owner shard's
        store (the unsharded store's arithmetic) and summed, no cache
        involved."""
        idx = np.asarray(idx, np.int64)
        B, T, P = idx.shape
        valid = (np.ones(idx.shape, bool) if valid is None
                 else np.asarray(valid, bool))
        idx = np.where(valid, idx, 0)
        if self.layout == "row":
            s = self.slice_rows[None, :, None]
            owner = idx // s
            lr = self.local_offsets[None, :, None] + idx % s
        else:
            owner = np.broadcast_to(self.owner_of_table[None, :, None], idx.shape)
            lr = self.local_offsets[None, :, None] + idx
        dev = self.devices[0]
        deq = torch.zeros((B, T, P, self.dim), dtype=torch.float32, device=dev)
        for k, d in enumerate(self.devices):
            sel = torch.from_numpy(valid & (owner == k))
            rows = torch.from_numpy(lr[valid & (owner == k)]).to(d)
            deq[sel.to(dev)] = (self.payload[k][rows, :self.dim].to(torch.float32)
                                * self.scale[k][rows][:, None]
                                + self.bias[k][rows][:, None]).to(dev)
        return deq.sum(dim=2).cpu().numpy()

    # -- reporting ------------------------------------------------------------

    @property
    def hit_rate(self) -> float:
        h = sum(int(s["hits"]) for s in self.state)
        m = sum(int(s["misses"]) for s in self.state)
        return h / (h + m) if h + m else 0.0
