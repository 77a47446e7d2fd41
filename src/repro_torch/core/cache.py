"""Software-managed set-associative row cache (the paper's FM cache, §4.3),
resident on the torch device.

:class:`TorchRowCache` keeps the reference ``JaxRowCache``'s state dict
(``tag_table``, ``tag_row``, ``data``, ``stamp``, ``clock``, ``hits``,
``misses``) and its semantics bit for bit. Unlike the functional reference,
``lookup``/``lookup_device``/``insert`` update the state's tensors in place
(a copy of ``data`` per batch would move the whole cache) and return the
same dict. The probe goes through the ``cache_probe`` kernel; the LRU update
and the insert's ranked-way scatter are plain tensor code here.

Keys are (table_id, row_id) int32 pairs. Geometry follows the paper's dual
cache (Fig. 6): a memory-optimized parameterization (8 B metadata/row) for
rows <= 255 B and a CPU-optimized one (40 B metadata/row) above.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from repro_torch import resolve_device

EMPTY = -1
# Reserved query key that can never match a tag line: tags hold EMPTY (-1) or
# real (table >= 0, row >= 0) ids, so probing (NULL, NULL) is a guaranteed
# miss. Padded positions are probed as this key.
NULL_KEY = -2

MEM_OPT_ROW_LIMIT = 255  # bytes; paper: dim <= 255B -> memory-optimized cache
MEM_OPT_METADATA_B = 8
CPU_OPT_METADATA_B = 40

_U32 = 0xFFFFFFFF


@dataclasses.dataclass(frozen=True)
class CacheGeometry:
    num_sets: int
    ways: int
    dim: int  # cached row payload elements

    @property
    def capacity_rows(self) -> int:
        return self.num_sets * self.ways


def make_key(table_id, row_id) -> torch.Tensor:
    """(table, row) int32 pair -- stacked last-dim-2 tensor."""
    t = torch.as_tensor(table_id, dtype=torch.int32)
    r = torch.as_tensor(row_id, dtype=torch.int32)
    return torch.stack(torch.broadcast_tensors(t, r), dim=-1)


def _mul_u32(x: torch.Tensor, c: int) -> torch.Tensor:
    """``x * c mod 2**32`` for int64 ``x`` in [0, 2**32), without int64
    overflow: the constant is split into 16-bit halves."""
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & _U32


def set_index(tables: torch.Tensor, rows: torch.Tensor, num_sets: int) -> torch.Tensor:
    """Fibonacci-style 32-bit mix of (table, row) -> set id (int64).

    The reference computes in uint32; here every step is int64 reduced mod
    2**32, so negative keys such as ``NULL_KEY`` hash as their uint32 view
    (-2 as 0xFFFFFFFE)."""
    t = tables.to(torch.int64) & _U32
    r = rows.to(torch.int64) & _U32
    h = _mul_u32(t, 0x85EBCA6B) ^ _mul_u32(r, 0x9E3779B9)
    h = h ^ (h >> 16)
    return h % num_sets


class TorchRowCache:
    """Set-associative cache whose state is a dict of tensors on ``device``;
    cached rows are float32."""

    def __init__(self, geometry: CacheGeometry, device="cuda"):
        self.geo = geometry
        self.device = resolve_device(device)

    def init(self) -> dict:
        g, dev = self.geo, self.device
        i32 = dict(dtype=torch.int32, device=dev)
        return {
            "tag_table": torch.full((g.num_sets, g.ways), EMPTY, **i32),
            "tag_row": torch.full((g.num_sets, g.ways), EMPTY, **i32),
            "data": torch.zeros((g.num_sets, g.ways, g.dim),
                                dtype=torch.float32, device=dev),
            "stamp": torch.zeros((g.num_sets, g.ways), **i32),
            "clock": torch.zeros((), **i32),
            "hits": torch.zeros((), **i32),
            "misses": torch.zeros((), **i32),
        }

    @staticmethod
    def _match(state: dict, sets, tables, rows) -> torch.Tensor:
        return ((state["tag_table"][sets] == tables[:, None]) &
                (state["tag_row"][sets] == rows[:, None]))         # [N, W]

    @staticmethod
    def _touch(state: dict, sets, way, hit) -> None:
        """Advance the clock and stamp the hit ways with it."""
        state["clock"] += 1
        state["stamp"][sets[hit], way[hit]] = state["clock"]

    def _count(self, state: dict, hit, miss) -> None:
        state["hits"] += hit.sum(dtype=torch.int32)
        state["misses"] += miss.sum(dtype=torch.int32)

    def lookup(self, state: dict, tables: torch.Tensor, rows: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor, dict]:
        """tables/rows: [N] int32 -> (values [N, D], hit [N] bool, state)."""
        tables, rows = tables.to(torch.int32), rows.to(torch.int32)
        sets = set_index(tables, rows, self.geo.num_sets)
        match = self._match(state, sets, tables, rows)
        hit = match.any(dim=1)
        way = match.to(torch.int32).argmax(dim=1)                 # first match
        values = torch.where(hit[:, None], state["data"][sets, way], 0)
        self._touch(state, sets, way, hit)
        self._count(state, hit, ~hit)
        return values, hit, state

    def lookup_device(self, state: dict, tables: torch.Tensor,
                      rows: torch.Tensor, *, use_kernel: bool = True,
                      valid=None) -> Tuple[torch.Tensor, torch.Tensor, dict]:
        """Probe through the ``cache_probe`` kernel (§4.3 hot path); the LRU
        metadata update stays in plain tensor code, matching :meth:`lookup`.

        ``valid`` (bool [N], optional) masks out padded keys: they are probed
        as :data:`NULL_KEY` (guaranteed miss), never touch the LRU stamps, and
        count toward neither hits nor misses."""
        from repro_torch.kernels import ops
        tables, rows = tables.to(torch.int32), rows.to(torch.int32)
        if valid is not None:
            valid = valid.to(torch.bool)
            tables = torch.where(valid, tables, NULL_KEY)
            rows = torch.where(valid, rows, NULL_KEY)
        sets = set_index(tables, rows, self.geo.num_sets)
        values, hit_i = ops.row_cache_probe(
            state["tag_table"], state["tag_row"], state["data"],
            tables, rows, sets.to(torch.int32), use_kernel=use_kernel)
        hit = hit_i.to(torch.bool)
        way = self._match(state, sets, tables, rows).to(torch.int32).argmax(dim=1)
        self._touch(state, sets, way, hit)
        if valid is None:
            self._count(state, hit, ~hit)
        else:
            self._count(state, hit & valid, ~hit & valid)
        return values, hit, state

    def insert(self, state: dict, tables: torch.Tensor, rows: torch.Tensor,
               values: torch.Tensor, mask=None) -> dict:
        """Insert rows (LRU way eviction). mask=False entries are skipped;
        with no mask every row is inserted, and inserting the rows a mask
        selects, in order, leaves the state as the masked insert does.

        New keys landing in the same set within one batch take distinct ways:
        each gets its rank among the batch's new keys for that set (in order
        of appearance) and claims the rank-th least-recently-stamped way;
        ranks past the associativity wrap. Where two entries still target one
        (set, way) -- a wrapped rank, or a duplicate key -- the last one in
        order wins, as in the reference's scatter; it is chosen explicitly
        here because duplicate targets of one scatter land in no fixed order
        on CUDA."""
        g = self.geo
        tables, rows = tables.to(torch.int32), rows.to(torch.int32)
        n = tables.shape[0]
        dev = tables.device
        sets = set_index(tables, rows, g.num_sets)
        match = self._match(state, sets, tables, rows)
        already = match.any(dim=1)
        new = ~already if mask is None else mask & ~already
        # rank each new masked key within its set: sort keys by set id
        # (stable), number the positions inside each run
        rank_key = torch.where(new, sets, g.num_sets)              # park others
        order = torch.argsort(rank_key, stable=True)
        sorted_sets = rank_key[order]
        pos = torch.arange(n, device=dev)
        run_start = torch.ones(n, dtype=torch.bool, device=dev)
        run_start[1:] = sorted_sets[1:] != sorted_sets[:-1]
        start_pos = torch.cummax(torch.where(run_start, pos, 0), dim=0).values
        rank = torch.empty_like(pos)
        rank[order] = pos - start_pos
        lru_order = torch.argsort(state["stamp"][sets], dim=1, stable=True)
        way_new = lru_order.gather(1, (rank % g.ways)[:, None])[:, 0]
        way = torch.where(already, match.to(torch.int32).argmax(dim=1), way_new)
        # masked-out entries are dropped; of the writers to one slot the last
        # in order is kept, so the scatter below has distinct targets
        sel = pos if mask is None else torch.nonzero(mask).squeeze(1)
        slot = sets[sel] * g.ways + way[sel]
        by_slot = torch.argsort(slot, stable=True)
        ordered = slot[by_slot]
        last = torch.ones_like(ordered, dtype=torch.bool)
        last[:-1] = ordered[:-1] != ordered[1:]
        keep = sel[by_slot[last]]
        s_k, w_k = sets[keep], way[keep]
        state["clock"] += 1
        state["tag_table"][s_k, w_k] = tables[keep]
        state["tag_row"][s_k, w_k] = rows[keep]
        state["data"][s_k, w_k] = values[keep].to(torch.float32)
        state["stamp"][s_k, w_k] = state["clock"]
        return state


def dual_cache_geometry(fm_budget_bytes: int, dim: int, row_payload_bytes: int,
                        ways: int = 8) -> CacheGeometry:
    """Size a cache to an FM byte budget, with the paper's dual-cache metadata
    overheads (Fig. 6): rows <=255 B use the memory-optimized parameterization."""
    meta = MEM_OPT_METADATA_B if row_payload_bytes <= MEM_OPT_ROW_LIMIT else CPU_OPT_METADATA_B
    per_row = row_payload_bytes + meta
    rows = max(ways, fm_budget_bytes // per_row)
    num_sets = max(1, rows // ways)
    return CacheGeometry(num_sets=num_sets, ways=ways, dim=dim)
