"""The benchmark's inputs, made from ``--seed``: the embedding tables and the
query traffic. Nothing here imports the program under test.

Frozen copies (later changes to the program do not move the yardstick):

* :func:`sample_table_metas` is copied from
  ``src/repro_torch/core/locality.py`` (``sample_table_metas``); the
  configurations hold its output, the table inventory, explicitly.
* :func:`permute_ranks` is the rank permutation of
  ``src/repro_torch/workloads/trace.py`` (``zipf_indices_drift``:
  ``_DRIFT_SALT``, ``_PERM_MULT``), computed in wrapping int64 on the device.
* The block seeding follows ``src/repro_torch/workloads/stream.py``
  (``TraceStream``): block ``i`` draws from its own seed, so a block never
  depends on how many blocks follow it.

The Zipf ranks are drawn by inverting each table's Zipf CDF on the device
(``torch.searchsorted``), not with numpy's ``Generator.zipf``: a block of
millions of keys takes milliseconds on the card. The law is Zipf truncated
to the table, ``P(rank k) = k**-alpha / sum_{j <= n} j**-alpha`` for ``k <=
n``. The program's ``zipf_steady`` instead clamps the ranks past the table
into its last row (``np.minimum(rng.zipf(alpha), n) - 1``), which makes that
row the hottest of the table; the benchmark does not copy the clamp.

Every table keeps its own row width (``dim_bytes``: int8 values plus 8 B of
scale and bias). The program's store holds one width, so the tables are
handed to it padded with zero columns to the widest row of the inventory.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np

TABLE_BLOCK_ROWS = 1 << 20       # rows of one seeded block of the f32 tables
HEADER_BYTES = 8                 # a stored row's f32 scale and bias
_DRIFT_SALT = 0xA24BAED4963EE407
_PERM_MULT = 0x9E3779B97F4A7C15
_LOW47 = (1 << 47) - 1           # a logical shift by 17 of a 64-bit word
SALT_TABLES, SALT_TRAFFIC = 101, 102


def _as_i64(x: int) -> int:
    """The int64 whose two's-complement bits are the uint64 ``x``."""
    return x - (1 << 64) if x >= 1 << 63 else x


def sub_seed(seed: int, salt: int, index: int) -> int:
    """A 63-bit generator seed for part ``index`` of what ``salt`` names,
    from the run's ``seed`` (any non-negative integer)."""
    ss = np.random.SeedSequence([int(seed), salt, int(index)])
    return int(ss.generate_state(1, np.uint64)[0]) & ((1 << 63) - 1)


# -- the table inventory ---------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class TableMeta:
    table_id: int
    num_rows: int
    dim_bytes: int
    pooling_factor: int
    zipf_alpha: float
    kind: str


def sample_table_metas(rng: np.random.Generator, *, num_user: int, num_item: int,
                       user_dim_bytes, item_dim_bytes, user_pool: int,
                       item_pool: int, total_bytes: float,
                       user_byte_frac: float = 0.7, alpha_range=(1.05, 1.5),
                       item_alpha_boost: float = 0.25) -> List[TableMeta]:
    """A model's table inventory with Table 6's statistics: log-normal sizes,
    user tables ~70% of the bytes, a per-table row width, pooling factor
    (Poisson around the mean) and Zipf alpha."""
    metas = []
    sizes = rng.lognormal(mean=0.0, sigma=1.6, size=num_user + num_item)
    user_sizes = sizes[:num_user] / sizes[:num_user].sum() * total_bytes * user_byte_frac
    item_sizes = sizes[num_user:] / sizes[num_user:].sum() * total_bytes * (1 - user_byte_frac)
    tid = 0
    for n, dims, pool, kind, szs, aboost in (
            (num_user, user_dim_bytes, user_pool, "user", user_sizes, 0.0),
            (num_item, item_dim_bytes, item_pool, "item", item_sizes, item_alpha_boost)):
        for i in range(n):
            db = int(rng.integers(dims[0], dims[1] + 1))
            rows = max(64, int(szs[i] / db))
            pf = max(1, int(rng.poisson(pool)))
            alpha = float(rng.uniform(*alpha_range)) + aboost
            metas.append(TableMeta(tid, rows, db, pf, alpha, kind))
            tid += 1
    return metas


def inventory_from_sampler(params: dict) -> List[List]:
    """``[rows, pooling, alpha, dim_bytes]`` of each user table, as a
    configuration's ``inventory.sampler`` parameters give them."""
    p = dict(params)
    rng = np.random.default_rng(np.random.SeedSequence(p.pop("seed_sequence")))
    metas = sample_table_metas(rng, **p)
    return [[m.num_rows, m.pooling_factor, m.zipf_alpha, m.dim_bytes]
            for m in metas if m.kind == "user"]


@dataclasses.dataclass(frozen=True)
class Inventory:
    """The served tables of a configuration, in table-slot order. ``values``
    are each table's int8 values a row (its row width less the 8 B of scale
    and bias); ``dim``, the store's width, is the widest of them."""
    rows: np.ndarray        # [T] int64
    pooling: np.ndarray     # [T] int64
    alpha: np.ndarray       # [T] float64
    values: np.ndarray      # [T] int64
    dim: int

    @classmethod
    def from_config(cls, cfg: dict) -> "Inventory":
        t = np.asarray(cfg["tables"], dtype=object)
        values = np.asarray(t[:, 3], np.int64) - HEADER_BYTES
        if int(cfg["dim"]) != int(values.max()):
            raise ValueError(f"dim {cfg['dim']} is not the widest table's "
                             f"{int(values.max())} values")
        return cls(np.asarray(t[:, 0], np.int64), np.asarray(t[:, 1], np.int64),
                   np.asarray(t[:, 2], np.float64), values, int(cfg["dim"]))

    @property
    def num_tables(self) -> int:
        return len(self.rows)

    @property
    def offsets(self) -> np.ndarray:
        """First global row of each table."""
        return np.r_[0, np.cumsum(self.rows)[:-1]].astype(np.int64)

    @property
    def total_rows(self) -> int:
        return int(self.rows.sum())


# -- the tables ----------------------------------------------------------------------


def table_block(torch, inv: Inventory, seed: int, block: int, device) -> "torch.Tensor":
    """Rows ``[block * TABLE_BLOCK_ROWS, ...)`` of the concatenated f32
    tables, standard normal, from the block's own generator."""
    lo = block * TABLE_BLOCK_ROWS
    n = min(TABLE_BLOCK_ROWS, inv.total_rows - lo)
    out = torch.empty((n, inv.dim), dtype=torch.float32, device=device)
    fill_table_block(torch, inv, out, seed, block)
    return out


def fill_table_block(torch, inv: Inventory, out, seed: int, block: int) -> None:
    """Standard normal values; each row's columns past its table's width 0."""
    g = torch.Generator(device=out.device).manual_seed(sub_seed(seed, SALT_TABLES, block))
    out.normal_(generator=g)
    lo = block * TABLE_BLOCK_ROWS
    hi = lo + out.shape[0]
    off = inv.offsets
    for t in np.flatnonzero((off < hi) & (off + inv.rows > lo) & (inv.values < inv.dim)):
        a, b = max(int(off[t]), lo) - lo, min(int(off[t] + inv.rows[t]), hi) - lo
        out[a:b, int(inv.values[t]):] = 0.0


def make_tables(torch, inv: Inventory, seed: int, device) -> Dict[int, "torch.Tensor"]:
    """Every table as a ``[rows, dim]`` f32 view of one tensor on ``device``,
    filled block by block (a few large calls)."""
    big = torch.empty((inv.total_rows, inv.dim), dtype=torch.float32, device=device)
    for b in range(-(-inv.total_rows // TABLE_BLOCK_ROWS)):
        lo = b * TABLE_BLOCK_ROWS
        fill_table_block(torch, inv, big[lo:lo + TABLE_BLOCK_ROWS], seed, b)
    off = inv.offsets
    return {t: big[off[t]:off[t] + inv.rows[t]] for t in range(inv.num_tables)}


# -- the traffic -----------------------------------------------------------------------


def permute_ranks(torch, ranks, epochs, num_rows):
    """Row ids of Zipf ranks: ``zipf_indices_drift``'s hash permutation
    ``(((rank + epoch * SALT) * MULT mod 2**64) >> 17) mod num_rows``, in
    int64 arithmetic that wraps as uint64 does."""
    x = ranks.to(torch.int64)
    if epochs is not None:
        x = x + epochs.to(torch.int64) * _as_i64(_DRIFT_SALT)
    x = x * _as_i64(_PERM_MULT)
    x = torch.bitwise_and(torch.bitwise_right_shift(x, 17), _LOW47)
    return torch.remainder(x, num_rows)


def permute_ranks_numpy(ranks: np.ndarray, epochs: np.ndarray,
                        num_rows: np.ndarray) -> np.ndarray:
    """:func:`permute_ranks` in numpy uint64, as the program computes it."""
    x = ranks.astype(np.uint64) + epochs.astype(np.uint64) * np.uint64(_DRIFT_SALT)
    x = (x * np.uint64(_PERM_MULT)) >> np.uint64(17)
    return (x % num_rows.astype(np.uint64)).astype(np.int64)


@dataclasses.dataclass
class Block:
    """A block of queries in columnar (CSR) form, as raw host arrays."""
    values: np.ndarray       # [nnz] int32 row ids
    seg_offsets: np.ndarray  # [S + 1] int64
    seg_table: np.ndarray    # [S] int64 table slot
    query_seg: np.ndarray    # [queries + 1] int64

    def chunk(self, q0: int, q1: int):
        """Raw arrays of queries ``[q0, q1)``: values (int64, as the program's
        traces carry them), segment offsets, segment tables, query
        segments."""
        s0, s1 = int(self.query_seg[q0]), int(self.query_seg[q1])
        e0, e1 = int(self.seg_offsets[s0]), int(self.seg_offsets[s1])
        return (self.values[e0:e1].astype(np.int64),
                self.seg_offsets[s0:s1 + 1] - e0,
                self.seg_table[s0:s1].copy(),
                self.query_seg[q0:q1 + 1] - s0)


class TrafficGen:
    """The general generator: a traffic file's parameters over a
    configuration's inventory, block by block on ``device``.

    Parameters (the traffic file): ``law`` (``zipf`` or ``uniform``),
    ``pool_sigma`` (log-normal spread of each bag's length around the table's
    pooling factor; 0 keeps it fixed), ``drift_period_queries`` and
    ``drift_blend`` (the Zipf hot set rotates every that many queries, a
    blend of draws taking the next epoch's), ``chunk`` (queries a call),
    ``block_queries`` (queries a block)."""

    def __init__(self, torch, inv: Inventory, traffic: dict, seed: int, device):
        self.torch, self.inv, self.seed, self.device = torch, inv, int(seed), device
        self.law = traffic["law"]
        if self.law not in ("zipf", "uniform"):
            raise ValueError(f"unknown key law {self.law!r}")
        self.pool_sigma = float(traffic.get("pool_sigma", 0.0))
        self.period = int(traffic.get("drift_period_queries", 0))
        self.blend = float(traffic.get("drift_blend", 0.0)) if self.period else 0.0
        self.chunk = int(traffic["chunk"])
        self.block_queries = int(traffic["block_queries"])
        if self.block_queries % self.chunk:
            raise ValueError("block_queries must be a multiple of chunk")
        self.tables = inv.num_tables
        self.rows_d = torch.as_tensor(inv.rows, device=device)
        self.pool_d = torch.as_tensor(inv.pooling, dtype=torch.float64, device=device)
        if self.law == "zipf":
            self._cdf, self._cdf_off = self._zipf_cdfs()

    def _zipf_cdfs(self):
        """Every table's rank CDF over its own ``n`` ranks, each shifted by its
        slot (table t's values lie in (t, t + 1]), concatenated: one
        ``searchsorted`` draws the ranks of every table at once."""
        torch, inv = self.torch, self.inv
        parts, off = [], [0]
        for t in range(inv.num_tables):
            n, a = int(inv.rows[t]), float(inv.alpha[t])
            k = torch.arange(1, n + 1, dtype=torch.float64, device=self.device)
            cdf = torch.cumsum(k.pow(-a), 0)
            cdf /= cdf[-1].clone()
            cdf[-1] = 1.0
            parts.append(cdf + t)
            off.append(off[-1] + n)
        return torch.cat(parts), torch.as_tensor(off[:-1], device=self.device)

    def block(self, index: int) -> Block:
        torch, T, nq = self.torch, self.tables, self.block_queries
        dev = self.device
        g = torch.Generator(device=dev).manual_seed(sub_seed(self.seed, SALT_TRAFFIC, index))
        seg_t = torch.arange(T, device=dev).repeat(nq)                 # [S]
        if self.pool_sigma > 0:
            z = torch.randn(nq * T, dtype=torch.float64, generator=g, device=dev)
            lens = torch.clamp(torch.round(self.pool_d[seg_t]
                                           * torch.exp(self.pool_sigma * z)), min=1)
            lens = lens.to(torch.int64)
        else:
            lens = torch.as_tensor(self.inv.pooling, device=dev).repeat(nq)
        el_t = torch.repeat_interleave(seg_t, lens)                    # [E]
        E = int(el_t.numel())
        u = torch.rand(E, dtype=torch.float64, generator=g, device=dev)
        n_el = self.rows_d[el_t]
        if self.law == "zipf":
            pos = torch.searchsorted(self._cdf, el_t.to(torch.float64) + u, right=True)
            # the bounds guard against rounding only: u < 1 = each CDF's end
            ranks = torch.minimum(torch.clamp(pos - self._cdf_off[el_t], min=0), n_el - 1)
            epochs = None
            if self.period:
                q = torch.repeat_interleave(torch.arange(nq, device=dev),
                                            lens.view(nq, T).sum(1)) + index * nq
                epochs = q // self.period
                if self.blend > 0:
                    epochs = epochs + (torch.rand(E, dtype=torch.float64, generator=g,
                                                  device=dev) < self.blend)
            rows = permute_ranks(torch, ranks, epochs, n_el)
        else:
            rows = torch.minimum(torch.floor(u * n_el).to(torch.int64), n_el - 1)
        offs = torch.cat([lens.new_zeros(1), torch.cumsum(lens, 0)])
        return Block(rows.to(torch.int32).cpu().numpy(), offs.cpu().numpy().astype(np.int64),
                     seg_t.cpu().numpy().astype(np.int64),
                     np.arange(nq + 1, dtype=np.int64) * T)


class ChunkSource:
    """The run's chunks in order: chunk ``i`` is chunk ``i % per_block`` of
    block ``i // per_block``; blocks are made on first use and kept (the
    reference replays them)."""

    def __init__(self, gen: TrafficGen):
        self.gen = gen
        self.per_block = gen.block_queries // gen.chunk
        self.blocks: List[Block] = []

    def ready(self, i: int) -> bool:
        return i // self.per_block < len(self.blocks)

    def make_next_block(self) -> None:
        self.blocks.append(self.gen.block(len(self.blocks)))

    def raw(self, i: int):
        while not self.ready(i):
            self.make_next_block()
        b, c = divmod(i, self.per_block)
        q0 = c * self.gen.chunk
        return self.blocks[b].chunk(q0, q0 + self.gen.chunk)


def chunk_positions(raw, tables: int):
    """Valid positions of a chunk in the program's flattened ``(query, table
    slot, position in the bag)`` order: (query, slot, row) int64 arrays and
    the block width ``P`` the program pads to (the chunk's longest bag,
    rounded up to a power of two)."""
    values, seg_offsets, seg_table, query_seg = raw
    lens = np.diff(seg_offsets)
    nq = len(query_seg) - 1
    seg_q = np.repeat(np.arange(nq, dtype=np.int64), np.diff(query_seg))
    pos = np.arange(len(values), dtype=np.int64) - np.repeat(seg_offsets[:-1], lens)
    q = np.repeat(seg_q, lens)
    t = np.repeat(seg_table, lens)
    pmax = int(lens.max()) if len(lens) else 1
    order = np.argsort((q * tables + t) * pmax + pos, kind="stable")
    P = 1 << (max(pmax, 1) - 1).bit_length()
    return q[order], t[order], values[order].astype(np.int64), P

