"""The plain reference of the SDM serving step, for deciding ``correct``.

Plain PyTorch and numpy; it imports nothing of the program and takes
nothing the program made. From the run's seed it makes the same f32 tables
again (``sdmb_inputs``), quantizes them itself, replays the row cache's
decisions over every chunk the program served (set hash, LRU stamps, the
ranked fill), dedupes the misses, prices them with the analytic SM model,
and pools the sampled chunks in float64. Where the configuration brings a
scoring head, the head's own reference (``sdm_bench/heads/<name>.py``,
plain PyTorch) scores those pooled bags in float64.

Frozen copies of the rules the configuration states (copied from the
program, so later changes to it do not move the yardstick):

* :func:`quantize_rows`: ``src/repro_torch/core/quant.py`` (row-wise
  asymmetric, round half to even, scale divided by a tensor).
* :func:`cache_geometry`: ``src/repro_torch/core/cache.py``
  (``dual_cache_geometry``).
* :func:`set_index` and the fill rule of :class:`CacheReplay`:
  ``src/repro_torch/core/cache.py`` (``set_index``, ``TorchRowCache.insert``).
* :func:`sm_latency_us`: ``src/repro_torch/core/io_sim.py``
  (``IOEngine._latencies``, analytic mode) and
  ``src/repro_torch/runtime/engine.py`` (``_account``).
"""
from __future__ import annotations

import numpy as np

import sdmb_inputs as inputs

EMPTY = -1
NULL_KEY = -2
MEM_OPT_ROW_LIMIT, MEM_OPT_METADATA_B, CPU_OPT_METADATA_B = 255, 8, 40
_U32 = 0xFFFFFFFF


def cache_geometry(budget_bytes: int, dim: int, ways: int):
    """(sets, ways) of the HBM row cache for a byte budget of int8 rows of
    ``dim`` (8 B of scale and bias a row; the dual cache's per-row metadata:
    8 B up to 255-byte rows, 40 B above)."""
    rb = dim + 8
    meta = MEM_OPT_METADATA_B if rb <= MEM_OPT_ROW_LIMIT else CPU_OPT_METADATA_B
    rows = max(ways, budget_bytes // (rb + meta))
    return max(1, rows // ways), ways


def quantize_rows(torch, x, bits: int = 8):
    """x [R, D] f32 -> (payload uint8 [R, D or D/2], scale f32 [R], bias f32 [R])."""
    levels = (1 << bits) - 1
    x = x.to(torch.float32)
    lo = x.amin(dim=1, keepdim=True)
    hi = x.amax(dim=1, keepdim=True)
    scale = torch.where(hi > lo, (hi - lo) / torch.full_like(hi, levels),
                        torch.ones_like(hi))
    q = torch.clamp(torch.round((x - lo) / scale), 0, levels).to(torch.uint8)
    if bits == 4:
        if q.shape[1] % 2:
            q = torch.cat([q, q.new_zeros((q.shape[0], 1))], dim=1)
        q = q[:, 0::2] | (q[:, 1::2] << 4)
    return q, scale[:, 0], lo[:, 0]


def unpack4(torch, payload, dim: int):
    q = torch.stack([payload & 0xF, payload >> 4], dim=-1)
    return q.reshape(payload.shape[0], -1)[:, :dim]


def _mul_u32(x, c: int):
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & _U32


def set_index(torch, tables, rows, num_sets: int):
    """The cache's 32-bit mix of (table slot, row) -> set (int64)."""
    t = tables.to(torch.int64) & _U32
    r = rows.to(torch.int64) & _U32
    h = _mul_u32(t, 0x85EBCA6B) ^ _mul_u32(r, 0x9E3779B9)
    h = h ^ (h >> 16)
    return h % num_sets


def sm_latency_us(miss: np.ndarray, sm: dict, bg_iops: float) -> np.ndarray:
    """Per query, the slowest table's SM read time (Eq. 3's SM term) for a
    ``[B, T]`` block of deduped miss counts, under the analytic model."""
    n = miss.reshape(-1).astype(np.int64)
    lat = np.zeros(n.shape, np.float64)
    nz = n > 0
    if nz.any():
        nd = sm["num_devices"]
        per_dev = -(-n[nz] // nd)
        outstanding = np.minimum(per_dev, sm["max_outstanding_per_table"])
        waves = -(-per_dev // np.maximum(1, outstanding))
        rho = min((bg_iops / nd) / sm["iops_max"], 0.999)
        base = sm["base_latency_us"] / (1.0 - rho) ** sm["alpha"]
        l = np.full(per_dev.shape, base, np.float64)
        burst = outstanding > sm["max_outstanding"]
        l[burst] *= (outstanding[burst] / sm["max_outstanding"]) ** 2
        lat[nz] = waves * l
    return lat.reshape(miss.shape).max(axis=1)


class CacheReplay:
    """The row cache's tags and LRU stamps (no data: a hit's row equals the
    stored row's dequantization), advanced one served chunk at a time."""

    def __init__(self, torch, num_sets: int, ways: int, table_offsets, device):
        self.torch, self.S, self.W = torch, num_sets, ways
        i32 = dict(dtype=torch.int32, device=device)
        self.tag_t = torch.full((num_sets, ways), EMPTY, **i32)
        self.tag_r = torch.full((num_sets, ways), EMPTY, **i32)
        self.stamp = torch.zeros((num_sets, ways), dtype=torch.int64, device=device)
        self.clock = 0
        self.offsets = torch.as_tensor(table_offsets, dtype=torch.int64, device=device)
        self.device = device

    def step(self, t, r):
        """Valid positions of one chunk in the program's flattened order:
        table slots ``t`` and rows ``r`` (int64 tensors). Returns (hit, io,
        sets): bool [n] hits, bool [n] the first occurrence of each missed
        row (one SM read each, the rows filled), int64 [n] sets."""
        torch, W = self.torch, self.W
        n = t.numel()
        sets = set_index(torch, t, r, self.S)
        match = (self.tag_t[sets] == t[:, None].to(torch.int32)) & \
                (self.tag_r[sets] == r[:, None].to(torch.int32))
        hit = match.any(dim=1)
        way = match.to(torch.int32).argmax(dim=1)
        self.clock += 1
        self.stamp[sets[hit], way[hit]] = self.clock
        # one SM read per distinct missed global row, charged to its first
        # occurrence in order
        grow = self.offsets[t] + r
        miss_pos = torch.nonzero(~hit).squeeze(1)
        mg = grow[miss_pos]
        o = torch.argsort(mg, stable=True)
        head = torch.ones(mg.numel(), dtype=torch.bool, device=self.device)
        head[1:] = mg[o][1:] != mg[o][:-1]
        io = torch.zeros(n, dtype=torch.bool, device=self.device)
        io[miss_pos[o[head]]] = True
        # fill: the k-th new row of a set (in order) takes the k-th least
        # recently stamped way (k mod W); of the writers to one way the last
        # in order stays
        ins = torch.nonzero(io).squeeze(1)
        s_i = sets[ins]
        o = torch.argsort(s_i, stable=True)
        ss = s_i[o]
        run = torch.ones(ss.numel(), dtype=torch.bool, device=self.device)
        run[1:] = ss[1:] != ss[:-1]
        pos = torch.arange(ss.numel(), device=self.device)
        start = torch.cummax(torch.where(run, pos, 0), dim=0).values
        rank = torch.empty_like(pos)
        rank[o] = pos - start
        lru = torch.argsort(self.stamp[s_i], dim=1, stable=True)
        w_i = lru.gather(1, (rank % W)[:, None])[:, 0]
        slot = s_i * W + w_i
        o2 = torch.argsort(slot, stable=True)
        sl = slot[o2]
        last = torch.ones(sl.numel(), dtype=torch.bool, device=self.device)
        last[:-1] = sl[:-1] != sl[1:]
        keep = o2[last]
        self.clock += 1
        k = ins[keep]
        self.tag_t.view(-1)[slot[keep]] = t[k].to(torch.int32)
        self.tag_r.view(-1)[slot[keep]] = r[k].to(torch.int32)
        self.stamp.view(-1)[slot[keep]] = self.clock
        return hit, io, sets


class RefStore:
    """Every row of the inventory quantized by the reference itself, from the
    seeded tables made again block by block on ``device``."""

    def __init__(self, torch, inv, seed: int, device, bits: int = 8):
        self.torch, self.dim, self.bits = torch, inv.dim, bits
        pay, sc, bi = [], [], []
        for b in range(-(-inv.total_rows // inputs.TABLE_BLOCK_ROWS)):
            x = inputs.table_block(torch, inv, seed, b, device)
            p, s, o = quantize_rows(torch, x, bits)
            pay.append(p)
            sc.append(s)
            bi.append(o)
            del x
        self.payload = torch.cat(pay)
        self.scale = torch.cat(sc)
        self.bias = torch.cat(bi)

    def _terms(self, grow, dtype):
        p = self.payload[grow]
        if self.bits == 4:
            p = unpack4(self.torch, p, self.dim)
        return (p.to(dtype) * self.scale[grow].to(dtype)[:, None],
                self.bias[grow].to(dtype)[:, None])

    def rows(self, grow, dtype):
        """Dequantized rows ``[n, D]`` in ``dtype`` (each product and sum
        rounded once in it)."""
        qs, b = self._terms(grow, dtype)
        return qs + b

    def magnitudes(self, grow):
        """``|q * scale| + |bias|`` of each dequantized value, in float64:
        the scale of the rounding a float32 dequant of it can carry (the sum
        may cancel far below its terms)."""
        qs, b = self._terms(grow, self.torch.float64)
        return qs.abs() + b.abs()


def pool(torch, rows, bag, n_bags: int):
    """Sum ``rows`` [n, D] into ``n_bags`` bags by ``bag`` [n]."""
    out = torch.zeros((n_bags, rows.shape[1]), dtype=rows.dtype, device=rows.device)
    out.index_add_(0, bag, rows)
    return out


def pooled_gap(torch, got, ref, l1) -> float:
    """The largest ``|got - ref|`` over ``l1``, the bag's sum of its terms'
    magnitudes (the scale of the float32 rounding a dequantized, pooled
    value can carry), over every element. ``score_gap`` is the same quotient
    over a head's logits, ``l1`` the head run on magnitudes."""
    got = torch.as_tensor(got, device=ref.device).to(torch.float64)
    if got.shape != ref.shape:
        return float("inf")
    gap = (got - ref).abs() / torch.clamp(l1, min=1e-30)
    gap = torch.where(torch.isfinite(got), gap, torch.full_like(gap, float("inf")))
    return float(gap.max()) if gap.numel() else 0.0


def control_pool(torch, store, kind: str, grow, bag, n_bags: int):
    """A control's pooled bags: the reference in the precision below the one
    the configuration states -- ``bf16_rows``: rows held in bfloat16 (the HBM
    cache at half its bytes a row), summed in float32; ``int4_store``: the
    store quantized to 4 bits, dequantized and summed in float32."""
    if kind == "bf16_rows":
        rows = store.rows(grow, torch.float32).to(torch.bfloat16).to(torch.float32)
    elif kind == "int4_store":        # ``store`` quantized with bits=4
        rows = store.rows(grow, torch.float32)
    else:
        raise ValueError(f"unknown control {kind!r}")
    return pool(torch, rows, bag, n_bags)


# -- a scoring head --------------------------------------------------------------------


def round_tf32(torch, x):
    """``x`` rounded to TF32 (float32 with a 10-bit mantissa, to nearest,
    ties to even), in ``x``'s dtype: the same bits on the CPU and the card."""
    b = x.to(torch.float32).contiguous().view(torch.int32)
    b = torch.bitwise_and(b + 0xFFF + torch.bitwise_and(b >> 13, 1), ~0x1FFF)
    return b.view(torch.float32).to(x.dtype)


class TF32Ops:
    """``torch`` as a head sees it, with both operands of every
    ``torch.matmul`` rounded to TF32 (the product taken in the operands'
    dtype): the ``tf32_head`` control. A head multiplies through
    ``torch.matmul`` of the namespace it is given, so ``calls`` counts its
    products."""

    def __init__(self, torch):
        self._torch = torch
        self.calls = 0

    def __getattr__(self, name):
        return getattr(self._torch, name)

    def matmul(self, a, b):
        self.calls += 1
        return self._torch.matmul(round_tf32(self._torch, a), round_tf32(self._torch, b))


class Head:
    """A configuration's scoring head: its ``scoring`` block and its plain
    reference, ``sdm_bench/heads/<reference>.py``, which gives
    ``param_shapes(spec)`` (name, shape, fan-in of each parameter, in the
    order they are drawn) and ``logits(torch, pooled [B, T, D], dense [B,
    num_dense], weights, spec)`` -> ``[B]``. ``spec`` is the block's, with
    ``num_dense`` added."""

    def __init__(self, module, block: dict):
        self.module = module
        self.num_dense = int(block["num_dense"])
        self.dense_law = block["dense_law"]
        spec = dict(block["spec"])
        if spec.setdefault("num_dense", self.num_dense) != self.num_dense:
            raise ValueError(f"the head's spec has num_dense {spec['num_dense']}, "
                             f"the block {self.num_dense}")
        self.spec = spec
        self.limit = float(block["limits"]["score_gap"])

    def param_shapes(self):
        return self.module.param_shapes(self.spec)

    def weights64(self, torch, seed: int, device):
        """The weights the program was given, drawn again, in float64."""
        return {k: w.to(torch.float64) for k, w in
                inputs.head_weights(torch, self.param_shapes(), seed, device).items()}

    def logits(self, torch, pooled, dense, weights):
        """The head in the dtype of its inputs, matmuls as ``torch`` does them."""
        return self.module.logits(torch, pooled, dense, weights, self.spec)

    def tf32_logits(self, torch, pooled, dense, weights):
        ops = TF32Ops(torch)
        out = self.module.logits(ops, pooled, dense, weights, self.spec)
        if not ops.calls:
            raise ValueError("the head made no product through torch.matmul: the "
                             "tf32_head control cannot round its operands")
        return out
