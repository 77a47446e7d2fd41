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
    fill    -- the unique misses alone are compacted, dequantized and
               inserted (LRU ways).

The pooled output is the hit-side pool plus the miss-side pool. Only the
``[B, T]`` miss counts and the pooled block come back to the host, where the
analytic ``IOEngine`` prices each query's IO under Eq. 3.

Both engines share this module's code. The step over one store and one
cache is ``serve_step``: ``DeviceServingEngine`` runs it once over its one
store, ``ShardedServingEngine`` once a shard. The host path is
``ServingEngineBase``'s: the entries ``serve_batch`` and
``serve_columnar``, each with its validation and copies in, and their
shared tail ``_finish`` (the step, the copies out, the accounting). An
engine keeps its store layout, its ``_step``, its oracle
``reference_pool`` and ``hit_rate``.

The store and the cache hold each row at a pitch (``row_pitch``): ``dim``
rounded up to a multiple of ``ROW_ALIGN`` elements, so both kernels move
rows in wide vectors whatever ``dim`` is (an odd ``dim`` would drop them to
single bytes and floats). The pad columns are zero in the store and the
cache; the pools drop them, so every result is ``dim`` wide, each column
summed in the same order as at ``dim``. The cache is sized and the SM priced
by ``row_bytes(dim)``, never by the pitch.

``serve_batch`` takes a dense ``[B, T, P]`` block and validates it on the
host (padded positions zeroed once) before copying it in.
``serve_columnar`` is the trace plane's entry and builds the block on the
card: the host does O(segments) work over the chunk's range of the trace's
CSR arrays (``chunk_segments``: table ids to slots, each segment's block
row; ``block_inputs``), copies the keys as int64 and one int32
buffer of row segments and offsets to each distinct device, and the
``densify`` kernel (``ops.csr_densify``) writes the ragged, padded block,
its valid mask and the count of keys outside their tables. One read of the
count raises before the step. ``dense_from_chunk`` builds the same block
on the host: the reference the tests hold the card's block to.

With a ``telemetry`` handle whose ``wall`` recorder is on
(``ObsConfig(wall_spans=True)``), each call records wall-clock spans on
the clock of ``torch.profiler``'s device records: ``engine.serve`` >
``engine.densify``, ``engine.h2d``, ``engine.validate``, ``engine.step``
(> ``step.probe``, ``step.hit_pool``, ``step.miss_pool``, ``step.dedupe``,
``step.fill``), ``engine.d2h``, ``engine.account`` (``serve_batch``:
``engine.validate`` before ``engine.h2d``, no ``engine.serve`` or
``engine.densify``); and the counters ``engine.slots`` (B*T*P),
``engine.valid_keys``, ``engine.h2d_bytes`` (the bytes copied in) and
``engine.filled_rows`` (the unique misses the fill dequantized); it sets
the gauges
``engine.dim`` and ``engine.row_pitch`` (which launch plans ran) once on
each registry it serves into. The sharded engine records the same less the
``step.*`` spans and ``engine.filled_rows``. Without it an engine reads no
clock, and its registry holds what the reference's does.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.cache import TorchRowCache, dual_cache_geometry
from repro_torch.core.columnar import ColumnarChunk
from repro_torch.core.io_sim import DeviceModel, IOEngine, IOQueueConfig
from repro_torch.core.quant import quantize_rows, row_bytes
from repro_torch.core.sdm import QueryStats
from repro_torch.kernels import ops
from repro_torch.obs.tracing import WallSpans

ROW_ALIGN = 4        # elements: stored rows of a multiple of 4 bytes, cached (f32) of 16
QUANT_BLOCK_ROWS = 1 << 20   # rows quantized at once: bounds set-up's f32 temporaries


def row_pitch(dim: int) -> int:
    """Elements a stored or cached row occupies: ``dim`` rounded up to a
    multiple of ``ROW_ALIGN``."""
    return -(-dim // ROW_ALIGN) * ROW_ALIGN


def new_store(rows: int, dim: int, device
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """A zeroed quantized store of ``rows`` rows at ``row_pitch(dim)``:
    ``(payload [rows, pitch] uint8, scale [rows] f32, bias [rows] f32)``."""
    return (torch.zeros((rows, row_pitch(dim)), dtype=torch.uint8,
                        device=device),
            torch.zeros(rows, dtype=torch.float32, device=device),
            torch.zeros(rows, dtype=torch.float32, device=device))


def quantize_into(store: Tuple[torch.Tensor, torch.Tensor, torch.Tensor],
                  table: torch.Tensor, lo: int, hi: int, dst: int) -> None:
    """Quantize rows ``[lo, hi)`` of ``table`` into ``store`` (``new_store``'s)
    from row ``dst`` on, ``QUANT_BLOCK_ROWS`` rows at a time. Quantization is
    row-wise, so the rows are those of the whole table quantized at once;
    the pad columns stay zero."""
    payload, scale, bias = store
    dim = table.shape[1]
    for a in range(lo, hi, QUANT_BLOCK_ROWS):
        b = min(a + QUANT_BLOCK_ROWS, hi)
        q = quantize_rows(table[a:b])
        rows = slice(dst + a - lo, dst + b - lo)
        payload[rows, :dim] = q["payload"]
        scale[rows] = q["scale"]
        bias[rows] = q["bias"]


def fill_rows(store: Tuple[torch.Tensor, torch.Tensor, torch.Tensor],
              rows: torch.Tensor, dim: int) -> torch.Tensor:
    """The cache's f32 rows, at the pitch, for ``rows`` of ``store``. The
    reference's compiled step contracts q * scale + bias into one fused
    multiply-add; an 8-bit integer times a float32 is exact in float64, so
    the float64 sum rounds once to the same float32 (exactly so unless bias
    and product differ in magnitude by more than 2**21). The pad columns,
    which would dequantize to the bias, are zero."""
    payload, scale, bias = store
    deq = (payload[rows].to(torch.float64)
           * scale[rows].to(torch.float64)[:, None]
           + bias[rows].to(torch.float64)[:, None]).to(torch.float32)
    if deq.shape[1] != dim:
        deq[:, dim:] = 0.0
    return deq


def fill_misses(cache: TorchRowCache, state: dict,
                store: Tuple[torch.Tensor, torch.Tensor, torch.Tensor],
                tables: torch.Tensor, rows: torch.Tensor,
                store_rows: torch.Tensor, io_mask: torch.Tensor,
                dim: int) -> int:
    """Fill ``cache`` with a call's unique misses: the positions ``io_mask``
    marks among the step's flat ``(tables, rows)`` keys, whose rows of
    ``store`` are ``store_rows``. The positions are compacted, in order,
    before any fill work, so only they are dequantized (``fill_rows``) and
    offered to ``cache.insert``; the state is the masked insert's over every
    slot, bit for bit (ranks follow the order of appearance, the last writer
    in order wins). The cache's clock advances once, also when nothing
    fills. Returns K, the rows filled; reading it is the fill's one sync."""
    sel = torch.nonzero(io_mask).squeeze(1)
    cache.insert(state, tables[sel], rows[sel],
                 fill_rows(store, store_rows[sel], dim))
    return sel.shape[0]


def serve_step(tables: torch.Tensor, rows: torch.Tensor, valid: torch.Tensor,
               store_rows: torch.Tensor, grow: torch.Tensor,
               shape: Tuple[int, int, int],
               store: Tuple[torch.Tensor, torch.Tensor, torch.Tensor],
               sentinel: int, cache: TorchRowCache, state: dict, dim: int,
               use_kernels: bool, ws: Optional[WallSpans] = None
               ) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """The device step over one store and one cache, for both engines.

    ``tables``, ``rows``: the flat ``[B*T*P]`` cache keys (table slot, row
    of the table). ``valid``: which keys this store serves (padding, and in
    a shard the keys it does not own, masked out). ``store_rows``: each
    key's row of ``store``; ``grow``: its global row, which keys the miss
    dedupe. ``shape`` is the block's ``(B, T, P)``. Returns (pooled
    ``[B, T, dim]`` f32, deduped miss counts ``[B, T]``, K the rows
    filled). With ``ws`` it laps ``step.probe``, ``step.hit_pool``,
    ``step.miss_pool``, ``step.dedupe`` and ``step.fill``."""
    B, T, P = shape
    vals, hit, _ = cache.lookup_device(state, tables, rows,
                                       use_kernel=use_kernels, valid=valid)
    if ws is not None:
        ws.lap("step.probe")
    # hit-side pool straight from HBM cache data, less the pad columns
    pooled_hit = (vals * hit[:, None]).reshape(B, T, P, -1).sum(dim=2)[..., :dim]
    if ws is not None:
        ws.lap("step.hit_pool")
    # miss-side pool fused over the quantized backing store; hits and
    # masked positions point at the zero sentinel row
    gidx = torch.where(hit | ~valid, sentinel, store_rows)
    pooled_miss = ops.embedding_gather_pool(
        *store, gidx.reshape(B * T, P).to(torch.int32),
        use_kernel=use_kernels).reshape(B, T, -1)[..., :dim]
    if ws is not None:
        ws.lap("step.miss_pool")
    # unique-miss coalescing: group equal global rows with a stable sort;
    # the group head is the first occurrence (-1 is one dead group). A
    # shard's keys are its own, so the shards' dedupes union to the single
    # engine's
    miss = valid & ~hit
    gkey = torch.where(miss, grow, -1)
    order = torch.argsort(gkey, stable=True)
    ks = gkey[order]
    head = torch.ones_like(ks, dtype=torch.bool)
    head[1:] = ks[1:] != ks[:-1]
    first = torch.empty_like(head)
    first[order] = head
    io_mask = miss & first
    if ws is not None:
        ws.lap("step.dedupe")
    # fill from the unique misses alone: duplicates are masked out so one
    # key fills one way. A key outside ``valid`` (a foreign key of the
    # sharded table layout may point past this store) is never read
    filled = fill_misses(cache, state, store, tables, rows, store_rows,
                         io_mask, dim)
    if ws is not None:
        ws.lap("step.fill")
    return pooled_hit + pooled_miss, io_mask.reshape(B, T, P).sum(dim=2), filled


class ChunkSegments(NamedTuple):
    """A columnar chunk's segments as the device block needs them."""
    n_queries: int        # B
    P: int                # the block's width: the longest bag, a power of two
    rows: np.ndarray      # [S] int64: each segment's block row, query * T + slot
    offsets: np.ndarray   # [S+1] int64: the segments' keys in the parent's values
    values: np.ndarray    # [K]: the chunk's keys, a view of the parent's values


def chunk_segments(chunk: ColumnarChunk, table_slot: Dict[int, int],
                   num_tables: int) -> ChunkSegments:
    """The chunk's range of its parent trace's CSR arrays, with each
    segment's row of the ``[B * T, P]`` block, in O(segments) host work.

    The chunk's queries own one contiguous range of segments and one of
    keys. ``P`` is the chunk's longest bag rounded up to a power of two (few
    distinct shapes across chunks). Table ids map to slots through one
    ``searchsorted`` over the sorted ids: an id that ``table_slot`` lacks
    raises ``KeyError``, a slot outside ``[0, num_tables)`` ``IndexError``.
    Segments of one query carry distinct table ids, so no two share a row.
    """
    p, qs, B = chunk.parent, chunk.start, chunk.n_queries
    qseg = p.query_seg[qs:qs + B + 1]
    s0, s1 = int(qseg[0]), int(qseg[-1])
    soff = p.seg_offsets[s0:s1 + 1]
    P = 1 << (int(np.diff(soff).max(initial=1)) - 1).bit_length()
    tids = p.seg_table[s0:s1]
    ids = np.fromiter(table_slot, np.int64, len(table_slot))
    slots = np.fromiter(table_slot.values(), np.int64, len(table_slot))
    order = np.argsort(ids)
    ids, slots = ids[order], slots[order]
    at = np.searchsorted(ids, tids)
    found = at < len(ids)
    found[found] = ids[at[found]] == tids[found]
    if not found.all():
        raise KeyError(int(tids[~found].min()))
    seg_slot = slots[at]
    if len(seg_slot) and not 0 <= seg_slot.min() <= seg_slot.max() < num_tables:
        raise IndexError(f"table slot out of range [0, {num_tables})")
    rows = (np.repeat(np.arange(B, dtype=np.int64), np.diff(qseg)) * num_tables
            + seg_slot)
    return ChunkSegments(B, P, rows, soff, p.values[int(soff[0]):int(soff[-1])])


def block_inputs(seg: ChunkSegments, num_tables: int
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """What ``ops.csr_densify`` builds ``seg``'s block from: the chunk's keys,
    contiguous and int64 (the kernel's one key width; narrower keys are
    widened), and one int32 buffer of the B*T block rows' segments
    (-1: none) then the S+1 segment offsets from the chunk's first key."""
    values = np.ascontiguousarray(seg.values, dtype=np.int64)
    n, S = seg.n_queries * num_tables, len(seg.rows)
    meta = np.empty(n + S + 1, np.int32)
    meta[:n] = -1
    meta[seg.rows] = np.arange(S, dtype=np.int32)
    meta[n:] = seg.offsets - seg.offsets[0]
    return values, meta


def dense_from_chunk(chunk: ColumnarChunk, table_slot: Dict[int, int],
                     num_tables: int) -> Tuple[np.ndarray, np.ndarray]:
    """Columnar (CSR) chunk -> dense ``[B, T, P]`` index block + valid mask,
    on the host: the block ``serve_columnar`` builds on the card, and the
    reference the tests hold that block to.

    Absent/padded positions get index 0 with ``valid=False`` -- the device
    step routes them to the zero sentinel row so they contribute nothing
    and cost no IO. One vectorized numpy pass over ``chunk_segments``, with
    no loop over tables: the keys are laid out segment-major in an ``[S,
    P]`` block, each bag a prefix of its row in CSR order (one boolean-mask
    store), and the rows are then scattered to their ``query * T + slot``
    rows of the block. Raises as ``chunk_segments`` does. Equal bit for bit
    to the reference's per-table loop.
    """
    seg = chunk_segments(chunk, table_slot, num_tables)
    B, P = seg.n_queries, seg.P
    lens = np.diff(seg.offsets)
    seg_valid = np.arange(P, dtype=np.int32) < lens.astype(np.int32)[:, None]
    seg_idx = np.zeros((len(lens), P), np.int32)
    seg_idx[seg_valid] = seg.values
    idx = np.zeros((B * num_tables, P), np.int32)
    valid = np.zeros((B * num_tables, P), bool)
    idx[seg.rows] = seg_idx
    valid[seg.rows] = seg_valid
    return (idx.reshape(B, num_tables, P),
            valid.reshape(B, num_tables, P))


@dataclasses.dataclass
class EngineConfig:
    hbm_cache_bytes: int = 8 << 20       # HBM budget for the row cache
    ways: int = 8
    use_kernels: bool = True             # False -> the kernels' plain versions
    num_devices: int = 2
    item_time_us: float = 200.0
    io_queue: IOQueueConfig = dataclasses.field(default_factory=IOQueueConfig)


class ServingEngineBase:
    """The host path both engines share: the entries ``serve_batch`` and
    ``serve_columnar`` (each with its validation and copies in), the copies
    out, the Eq. 3 accounting and the wall spans. A subclass builds its
    store and caches on ``devices`` and supplies ``_step``."""

    devices: Tuple[torch.device, ...]

    def __init__(self, tables: Dict[int, object], device: DeviceModel,
                 cfg: Optional[EngineConfig]):
        cfg = EngineConfig() if cfg is None else cfg
        if not tables:
            raise ValueError("need at least one table")
        dims = {t.shape[1] for t in tables.values()}
        if len(dims) != 1:
            raise ValueError(f"tables must share one embedding dim, got {dims}")
        self.cfg = cfg
        self.dim = dims.pop()
        self.pitch = row_pitch(self.dim)
        self.row_bytes = row_bytes(self.dim, bits=8)
        self.table_ids: List[int] = list(tables)
        self.table_slot = {t: i for i, t in enumerate(self.table_ids)}
        self.rows_per_table = np.array([tables[t].shape[0]
                                        for t in self.table_ids], np.int64)
        self._geo = dual_cache_geometry(cfg.hbm_cache_bytes, dim=self.pitch,
                                        row_payload_bytes=self.row_bytes,
                                        ways=cfg.ways)
        self.io = IOEngine(device, cfg.num_devices, cfg.io_queue)
        self.stats = QueryStats()        # store-level totals, host-plane shape
        self.telemetry = None            # obs handle; None = bit-invisible
        self._wall_calls = 0             # calls served with wall spans on
        self._gauged = None              # the registry given the width gauges
        self._rows_on: Dict[torch.device, torch.Tensor] = {}   # rows_per_table
        self._count_host: Optional[torch.Tensor] = None        # pinned, on a card

    def _step(self, blocks: List[Tuple[torch.Tensor, torch.Tensor]],
              ws: Optional[WallSpans]) -> Tuple[torch.Tensor, torch.Tensor]:
        """``blocks[k]``: the block's ``(idx, valid)`` [B, T, P] on
        ``devices[k]``, padded positions zeroed -> (pooled [B, T, dim] f32,
        deduped miss counts [n, B, T]), both on ``devices[0]``."""
        raise NotImplementedError

    def _count_shards(self, reg, miss: np.ndarray) -> None:
        """Per-shard counters of a ``[n, B, T]`` miss block: none here, so
        the registry holds what the reference's does."""

    def _wall(self) -> Optional[WallSpans]:
        """A new call's wall spans; None unless the ``wall`` recorder is on."""
        tel = self.telemetry
        if tel is None or tel.wall is None:
            return None
        if tel.registry is not self._gauged:     # once a registry: fixed widths
            tel.registry.gauge("engine.dim", self.dim)
            tel.registry.gauge("engine.row_pitch", self.pitch)
            self._gauged = tel.registry
        self._wall_calls += 1
        return WallSpans(tel.wall, self._wall_calls)

    def _empty(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        return (np.zeros((0, len(self.table_ids), self.dim), np.float32),
                np.zeros(0, np.float64), np.zeros(0, np.int64))

    # -- serving --------------------------------------------------------------

    def serve_batch(self, idx: np.ndarray, bg_iops: float = 0.0,
                    valid: Optional[np.ndarray] = None
                    ) -> Tuple[np.ndarray, List[QueryStats]]:
        """idx: [B, T, P] int32 of per-table local row ids (T in the order of
        ``table_ids``). Returns (pooled [B, T, dim] f32, per-query stats).
        ``valid`` (bool [B, T, P], optional) masks padded positions out of
        pooling, caching and IO accounting."""
        pooled, sm_time, sm_ios = self._serve_block(idx, bg_iops, valid,
                                                    self._wall())
        lat = np.maximum(self.cfg.item_time_us, sm_time)
        return pooled, [QueryStats(latency_us=q, sm_ios=n, sm_time_us=t)
                        for q, n, t in zip(lat.tolist(), sm_ios.tolist(),
                                           sm_time.tolist())]

    def serve_columnar(self, chunk: ColumnarChunk, bg_iops: float = 0.0
                       ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Serve a columnar (CSR) chunk through the device step. Returns
        ``(pooled [B, T, dim] f32, sm_time_us [B] f64, sm_ios [B] i64)`` with
        T in ``table_ids`` order (tables a query does not touch pool to
        zero).

        The host does O(segments) work (``chunk_segments``); the chunk's
        keys, as int64, and two int32 words a segment are copied
        to each distinct device, where ``ops.csr_densify`` builds the
        padded ``[B, T, P]`` block (``dense_from_chunk``'s, bit for bit) and
        counts the keys outside their tables. One read of that count raises
        ``ValueError`` before the step, so a bad chunk never reaches the
        cache."""
        if chunk.n_queries == 0:
            return self._empty()
        ws = self._wall()
        if ws is not None:
            ws.open("engine.serve")
        T = len(self.table_ids)
        seg = chunk_segments(chunk, self.table_slot, T)
        B, P = seg.n_queries, seg.P
        values, meta = block_inputs(seg, T)
        if ws is not None:
            ws.lap("engine.densify")
        values_t, meta_t = torch.from_numpy(values), torch.from_numpy(meta)
        copies = {d: (values_t.to(d), meta_t.to(d))
                  for d in dict.fromkeys(self.devices)}
        if ws is not None:
            self.telemetry.registry.inc("engine.h2d_bytes",
                                        len(copies) * (values.nbytes + meta.nbytes))
            ws.lap("engine.h2d")
        blocks, bad = {}, {}
        for d, (v, m) in copies.items():
            idx, valid, bad[d] = ops.csr_densify(
                v, m[:B * T], m[B * T:], self._table_rows(d), P,
                use_kernel=self.cfg.use_kernels)
            blocks[d] = (idx.view(B, T, P), valid.view(B, T, P))
        if self._read_count(bad[self.devices[0]]):
            raise ValueError("row index out of range")
        if ws is not None:
            reg = self.telemetry.registry
            reg.inc("engine.slots", B * T * P)
            reg.inc("engine.valid_keys", len(values))
            ws.lap("engine.validate")
        out = self._finish([blocks[d] for d in self.devices], bg_iops, ws)
        if ws is not None:
            ws.close()
        return out

    def _table_rows(self, device: torch.device) -> torch.Tensor:
        """``rows_per_table`` as an int64 tensor on ``device``, made once."""
        rows = self._rows_on.get(device)
        if rows is None:
            rows = self._rows_on[device] = torch.as_tensor(
                self.rows_per_table, dtype=torch.int64, device=device)
        return rows

    def _read_count(self, count: torch.Tensor) -> int:
        """A device count on the host: the call's one sync before the step.
        On a card it is copied into a pinned word the engine owns, so it
        is no pageable copy out."""
        if count.device.type != "cuda":
            return int(count)
        if self._count_host is None:
            self._count_host = torch.empty((), dtype=count.dtype, pin_memory=True)
        self._count_host.copy_(count, non_blocking=True)
        torch.cuda.current_stream(count.device).synchronize()
        return int(self._count_host)

    def _serve_block(self, idx, bg_iops: float, valid,
                     ws: Optional[WallSpans]
                     ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """The dense entry's host path: validation on the host (padded
        positions zeroed once), the block's copies in, then ``_finish``."""
        idx = np.asarray(idx, np.int32)
        if idx.ndim != 3:
            raise ValueError(f"idx must be [B, T, P], got shape {idx.shape}")
        if idx.shape[1] != len(self.table_ids):
            raise ValueError(
                f"idx has {idx.shape[1]} tables, engine has "
                f"{len(self.table_ids)}")
        valid = (np.ones(idx.shape, bool) if valid is None
                 else np.asarray(valid, bool))
        # padded positions may hold any value (the reference's gathers clamp
        # them; torch's raise): they are masked out of ownership, pooling,
        # IO and the fill, so they read row 0 of their table
        live = np.where(valid, idx, 0)
        if (live < 0).any() or (live >= self.rows_per_table[None, :, None]).any():
            raise ValueError("row index out of range")
        if idx.shape[0] == 0:            # degenerate empty batch: no device
            return self._empty()
        if ws is not None:
            reg = self.telemetry.registry
            reg.inc("engine.slots", idx.size)
            reg.inc("engine.valid_keys", int(np.count_nonzero(valid)))
            ws.lap("engine.validate")
        live_t, valid_t = torch.from_numpy(live), torch.from_numpy(valid)
        copies = {d: (live_t.to(d), valid_t.to(d))
                  for d in dict.fromkeys(self.devices)}
        if ws is not None:
            reg.inc("engine.h2d_bytes", len(copies) * (live.nbytes + valid.nbytes))
            ws.lap("engine.h2d")
        return self._finish([copies[d] for d in self.devices], bg_iops, ws)

    def _finish(self, blocks: List[Tuple[torch.Tensor, torch.Tensor]],
                bg_iops: float, ws: Optional[WallSpans]
                ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Both entries' tail: the step over the blocks on ``devices``, the
        copies out and the accounting."""
        if ws is not None:
            ws.open("engine.step")
        pooled, miss = self._step(blocks, ws)
        if ws is not None:
            ws.close()
        pooled, miss = pooled.cpu().numpy(), miss.cpu().numpy()
        if ws is not None:
            ws.lap("engine.d2h")
        out = (pooled, *self._account(miss, bg_iops))
        if ws is not None:
            ws.lap("engine.account")
        return out

    def _account(self, miss: np.ndarray, bg_iops: float
                 ) -> Tuple[np.ndarray, np.ndarray]:
        """IO + Eq. 3 accounting for ``miss``, the ``[n, B, T]`` deduped
        miss counts of the engine's n stores: one coalesced submission over
        every (store, query, table) element, store-major. Returns each
        query's SM time (the max over stores and tables, f64) and
        ``sm_ios`` (the sum, i64); accumulates store-level ``stats`` one
        query at a time, as the host plane's ``serve_query`` does."""
        rb = np.full(miss.size, self.row_bytes, np.int64)
        lats, _ = self.io.submit_batch_multi(miss.reshape(-1), rb, bg_iops)
        sm_time = lats.reshape(miss.shape).max(axis=(0, 2))
        sm_ios = miss.sum(axis=(0, 2), dtype=np.int64)
        if self.telemetry is not None:
            reg = self.telemetry.registry
            reg.inc("engine.batches")
            reg.observe_many("engine.sm_time_us", sm_time)
            self._count_shards(reg, miss)
        # Eq. 3: user-side SM time overlaps item-side compute; only the
        # excess surfaces
        for q in np.maximum(self.cfg.item_time_us, sm_time).tolist():
            self.stats.latency_us += q
        self.stats.sm_ios += int(sm_ios.sum())
        return sm_time, sm_ios


class DeviceServingEngine(ServingEngineBase):
    """Batched multi-query, multi-table serving over device kernels.

    ``tables``: {table_id: [rows, dim] float array or tensor} -- every table
    shares one embedding dim (one backing store, one cache geometry).
    ``device`` is the SM device model; ``torch_device`` is where the store,
    the cache and the step live (``cuda`` unless the caller asks for the
    CPU)."""

    def __init__(self, tables: Dict[int, object], device: DeviceModel,
                 cfg: Optional[EngineConfig] = None, *, torch_device="cuda"):
        super().__init__(tables, device, cfg)
        self.torch_device = dev = resolve_device(torch_device)
        self.devices = (dev,)

        # one backing store at the pitch, the tables in slot order, then the
        # zero sentinel row
        first = np.r_[0, np.cumsum(self.rows_per_table)[:-1]]
        self.sentinel = R = int(self.rows_per_table.sum())      # the zero row
        store = new_store(R + 1, self.dim, dev)
        for t, lo in zip(self.table_ids, first.tolist()):
            table = torch.as_tensor(tables[t], device=dev).detach()
            quantize_into(store, table, 0, table.shape[0], lo)
        self.payload, self.scale, self.bias = store
        self.offsets = torch.as_tensor(first, dtype=torch.int64, device=dev)

        self.cache = TorchRowCache(self._geo, device=dev)
        self.state = self.cache.init()

    # -- device step ----------------------------------------------------------

    def _step(self, blocks, ws):
        """``serve_step`` over the one store and cache, keyed by table slot
        (0..T-1), not table id; the store rows are the global rows."""
        (idx, valid), = blocks
        B, T, P = idx.shape
        tids = torch.arange(T, dtype=torch.int32, device=idx.device
                            ).view(1, T, 1).expand(B, T, P)
        grow = (self.offsets[tids.long()] + idx).reshape(-1)    # global row
        pooled, miss, filled = serve_step(
            tids.reshape(-1), idx.reshape(-1), valid.reshape(-1), grow, grow,
            (B, T, P), (self.payload, self.scale, self.bias), self.sentinel,
            self.cache, self.state, self.dim, self.cfg.use_kernels, ws)
        if ws is not None:
            self.telemetry.registry.inc("engine.filled_rows", filled)
        return pooled, miss[None]

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
        return deq.sum(dim=2)[..., :self.dim].cpu().numpy()

    # -- reporting ------------------------------------------------------------

    @property
    def hit_rate(self) -> float:
        h = int(self.state["hits"])
        m = int(self.state["misses"])
        return h / (h + m) if h + m else 0.0
