"""The yardstick: the card's peaks and the bytes and operations that one
served chunk needs, counted from the chunk's own keys and its hits and
misses (as the reference replay decides them). Frozen here, so a later
change to the program cannot move it.

Rule (as ``chip_smoke.py``'s bounds): each input byte read once, each output
byte written once, at the card's memory rate; the zero sentinel row that
hit and padded slots point at is read once, not once a slot.
"""
from __future__ import annotations

import dataclasses

HBM_BYTES_PER_S = 3.35e12        # H100 SXM HBM3 (NVIDIA data sheet)
FP32_OPS_PER_S = 67e12           # H100 SXM float32 outside the tensor cores
HEADER_BYTES = 8                 # a stored row's f32 scale and bias


@dataclasses.dataclass(frozen=True)
class ChunkCounts:
    """What one ``serve_columnar`` call served. Rows are counted at their own
    table's width (``*_values``: int8 values, 8 B of scale and bias beside
    each stored row), not at the store's padded width: the bytes a call
    needs, whatever the program reads."""
    queries: int            # B
    tables: int             # T
    width: int              # P: the padded bag width of the call's block
    dim: int                # the widest table's values (the sentinel row's)
    valid: int              # keys (valid positions)
    hits: int               # valid positions that hit the cache
    hit_rows: int           # distinct cached rows read by the hits
    unique_misses: int      # distinct missed rows (SM reads, rows filled)
    sets_probed: int        # distinct sets the call's probes read (padded slots' set too)
    sets_valid: int         # distinct sets the valid probes read
    bag_values: int         # sum over the B x T bags of their table's values
    hit_values: int         # sum over the hit positions of their table's values
    miss_values: int        # sum over the missed positions of their table's values
    hit_row_values: int     # sum over the distinct hit rows of their table's values
    miss_row_values: int    # sum over the distinct missed rows of their table's values

    @property
    def positions(self) -> int:
        return self.queries * self.tables * self.width

    @property
    def bags(self) -> int:
        return self.queries * self.tables

    @property
    def misses(self) -> int:
        return self.valid - self.hits


def gather_pool_bytes(c: ChunkCounts) -> int:
    """The fused gather-dequant-pool over the store: a [B*T, P] int32 index
    block, each distinct missed row read (its values and 8 B of scale and
    bias; the zero sentinel once, at the widest row), each bag's pooled
    values out in f32."""
    sentinel = 1 if c.positions > c.misses else 0
    return (c.positions * 4 + c.miss_row_values + HEADER_BYTES * c.unique_misses
            + sentinel * (c.dim + HEADER_BYTES) + c.bag_values * 4)


def cache_probe_bytes(c: ChunkCounts, ways: int) -> int:
    """The probe of every slot of the block: table, row and set ids in (12 B
    a probe), each distinct set's two tag lines once, each distinct hit row
    once (f32), and for every probe a row of its table's values and a hit
    flag out."""
    return (c.positions * 12 + c.sets_probed * 2 * ways * 4 + c.hit_row_values * 4
            + c.width * c.bag_values * 4 + c.positions * 4)


def step_bytes(c: ChunkCounts, ways: int) -> int:
    """What the whole step needs: each key's row id (4 B), each distinct set
    the keys probe (its two tag lines), each distinct cached row the hits
    read (f32), each unique miss's stored row (values + 8 B) and its fill (an
    f32 row, two tags and a stamp), and the pooled bags out in f32."""
    return (c.valid * 4 + c.sets_valid * 2 * ways * 4 + c.hit_row_values * 4
            + c.miss_row_values + HEADER_BYTES * c.unique_misses
            + c.miss_row_values * 4 + 12 * c.unique_misses
            + c.bag_values * 4)


def step_flops(c: ChunkCounts) -> int:
    """Dequant-and-pool arithmetic: a hit row is summed (1 a value), a missed
    row dequantized and summed (3), a filled row dequantized (2)."""
    return c.hit_values + 3 * c.miss_values + 2 * c.miss_row_values


def least_seconds(nbytes: float, flops: float) -> float:
    return max(nbytes / HBM_BYTES_PER_S, flops / FP32_OPS_PER_S)
