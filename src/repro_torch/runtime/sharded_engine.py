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

This module keeps only what is the sharded engine's own: the layouts,
ownership and local rows, and the combine. Each shard runs the one device
step, ``engine.serve_step`` (the ``cache_probe`` and ``gather_pool``
kernels, the unique-miss dedupe and the fill), on its own device over its
own store and cache. Foreign and padded keys are probed as the cache's NULL
key (never hit, never counted) and point at the shard's zero sentinel row
(pool nothing). Ownership partitions keys across shards, so the union of
the shards' first-occurrence dedupes over global row ids is the
single-device dedupe. The store is quantized as the single-device one is
and holds its rows at the same pitch (``engine.row_pitch``), so it is
bit-equal to it; the pools drop the pad columns.

One process drives every shard (shard k on ``mesh.devices[k]``) and
combines the partial pools on the first shard's device, as the reference's
single controller does with ``lax.psum`` / ``lax.all_gather``; no process
group is involved.

The host path is ``engine.ServingEngineBase``'s, shared with the single
engine: validation, the copies in (once to each distinct device, where
``serve_columnar`` builds the block with the ``densify`` kernel) and out,
and the IO accounting, which prices the shards' ``[n, B, T]`` miss blocks
in one coalesced ``IOEngine`` submission, shard-major (a query's SM time
is the max over shards and tables, its ``sm_ios`` the sum). Only
the counters ``engine.shard{k}.sm_ios`` are this engine's alone. With a
wall recorder on it records the host spans and ``engine.step``, with no
``step.*`` children.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.cache import TorchRowCache
from repro_torch.core.io_sim import DeviceModel
from repro_torch.launch.mesh import EmbedMesh, make_embed_mesh
from repro_torch.launch.sharding import check_layout
from repro_torch.runtime.engine import (EngineConfig, ServingEngineBase,
                                        new_store, quantize_into, serve_step)


class ShardedServingEngine(ServingEngineBase):
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
        check_layout(layout)
        super().__init__(tables, device, cfg)
        self.layout = layout
        self.mesh = make_embed_mesh() if mesh is None else mesh
        if self.mesh.axis_names != ("shard",):
            raise ValueError("mesh must have the single axis ('shard',)")
        self.n = n = self.mesh.shape["shard"]
        self.devices = tuple(self.mesh.devices)
        T = len(self.table_ids)
        # global row ids (offsets into the unsharded concatenation) key the
        # cross-shard miss dedupe; they never index device memory
        g_offsets = np.r_[0, np.cumsum(self.rows_per_table)[:-1]]

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
            "g_off": on(d, g_offsets, torch.int64),
            "l_off": on(d, loff, torch.int64),
            "slice_rows": (on(d, self.slice_rows, torch.int32)
                           if layout == "row" else None),
            "owner": (on(d, self.owner_of_table, torch.int32)
                      if layout == "table" else None),
        } for d in self.devices]

        self.caches = [TorchRowCache(self._geo, device=d) for d in self.devices]
        self.state = [c.init() for c in self.caches]

    # -- device step ----------------------------------------------------------

    def _step(self, blocks, ws):
        """Each shard's ``serve_step`` over its own keys (ownership and local
        rows by the layout; foreign and padded keys masked out), then the
        partial pools combined. No ``step.*`` spans: the shards' laps would
        interleave."""
        parts, misses = [], []
        for k, (idx, valid) in enumerate(blocks):
            c = self._consts[k]
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
            rq = idx.reshape(-1)
            part, miss, _ = serve_step(
                tids.reshape(-1), rq, (valid & own).reshape(-1),
                lrow.reshape(-1), c["g_off"][t_long.reshape(-1)] + rq,
                (B, T, P), (self.payload[k], self.scale[k], self.bias[k]),
                self.sentinel, self.caches[k], self.state[k], self.dim,
                self.cfg.use_kernels)
            parts.append(part)
            misses.append(miss.to(self.devices[0]))
        return self._combine(parts), torch.stack(misses)

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

    def _count_shards(self, reg, miss: np.ndarray) -> None:
        """``engine.shard{k}.sm_ios``: shard k's deduped misses."""
        for k, v in enumerate(miss.sum(axis=(1, 2)).tolist()):
            reg.inc(f"engine.shard{k}.sm_ios", int(v))

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
