"""Streaming (bounded-memory) workload generation.

:class:`TraceStream` is the chunked generator form of
:func:`~repro_torch.workloads.archetypes.build_trace`: it emits a spec's queries
as a sequence of piece-sized :class:`~repro_torch.workloads.trace.Trace` objects,
generated block-by-block, so a 10M-query trace is produced — and served,
piece by piece through ``serve_dlrm.serve_trace`` — in O(block) memory
instead of O(trace).

Determinism layout
------------------
Generation happens in fixed-size internal *blocks* (``block`` queries).
Block ``i`` draws from its own ``SeedSequence([seed, 11, i])`` (body:
tenant mix, pooling spread, row ids) and ``SeedSequence([seed, 12, i])``
(arrivals); the only state carried between blocks is the tiny arrival
clock (Poisson: last arrival; diurnal: candidate clock; MMPP: clock +
state + interval end). A block's content therefore never depends on the
requested ``piece`` size, so re-slicing the block stream into any piece
size — including one piece of size N (:meth:`TraceStream.materialize`) —
yields bit-identical queries. That invariance, plus the columnar serve
plane's chunking-invariance, is what makes streamed and materialized
cluster reports exactly equal.

The block generator is fully vectorized (one ``rng.zipf`` call per
(tenant, table) per block) unlike ``build_trace``'s per-query loop; the
loop is deliberately left untouched because the golden traces of earlier
PRs depend on its RNG consumption order. A ``TraceStream`` consequently
realizes a *different* (equally valid) trace than ``build_trace`` for the
same spec — parity holds within the streaming plane, not across the two
generators.

A copy of ``repro.workloads.stream``, block seeds and draw order included
(``tests/test_torch_workloads.py``).
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, List, Optional, Tuple

import numpy as np

from repro_torch.core.columnar import ColumnarQueries
from repro_torch.core.locality import TableMeta
from repro_torch.workloads.archetypes import (ArrivalSpec, WorkloadSpec,
                                        tenant_table_metas)
from repro_torch.workloads.trace import (Trace, concat_traces, slice_trace,
                                   zipf_indices_drift_flat)


def _arrival_block(a: ArrivalSpec, n: int, carry, rng: np.random.Generator
                   ) -> Tuple[np.ndarray, object]:
    """``n`` arrivals continuing from ``carry`` (None = stream start).

    A pure function of (carry, this block's rng): the same carry-in always
    produces the same arrivals and carry-out, regardless of how many more
    blocks follow — the piece-size-invariance keystone."""
    if a.process == "poisson":
        t0 = 0.0 if carry is None else carry
        arr = t0 + np.cumsum(rng.exponential(1e6 / a.rate_qps, size=n))
        return arr, float(arr[-1])
    if a.process == "diurnal":
        peak = a.rate_qps * (1.0 + a.diurnal_amplitude)

        def rate(t: np.ndarray) -> np.ndarray:
            return a.rate_qps * (1.0 + a.diurnal_amplitude
                                 * np.sin(2 * np.pi * (t + a.diurnal_phase_us)
                                          / a.diurnal_period_us))

        tc = 0.0 if carry is None else carry
        out: List[np.ndarray] = []
        got = 0
        while got < n:
            m = max(64, int((n - got) * 1.8))
            cand = tc + np.cumsum(rng.exponential(1e6 / peak, size=m))
            keep = cand[rng.random(m) * peak < rate(cand)]
            if got + len(keep) >= n:
                # resume the next block right after the last kept arrival
                keep = keep[:n - got]
                tc = float(keep[-1])
            else:
                tc = float(cand[-1])
            out.append(keep)
            got += len(keep)
        return np.concatenate(out), tc
    if a.process == "mmpp":
        span = a.mean_quiet_us + a.mean_burst_us
        quiet = a.rate_qps * span / (a.mean_quiet_us
                                     + a.burst_mult * a.mean_burst_us)
        rates = (quiet, quiet * a.burst_mult)
        means = (a.mean_quiet_us, a.mean_burst_us)
        # carry = (clock, state, interval end); the 0/0/0 start flips into
        # the burst state immediately, matching mmpp_arrivals' burst start
        tpos, state, t_end = (0.0, 0, 0.0) if carry is None else carry
        out = []
        got = 0
        while got < n:
            if tpos >= t_end:
                tpos, state = t_end, state ^ 1
                t_end = tpos + rng.exponential(means[state])
            need = n - got
            m = max(16, int(need * 1.2) + 8)
            ts = tpos + np.cumsum(rng.exponential(1e6 / rates[state], size=m))
            overran = bool(ts[-1] >= t_end)
            keep = ts[ts < t_end]
            if len(keep) >= need:
                keep = keep[:need]
                tpos = float(keep[-1])
            else:
                tpos = t_end if overran else float(ts[-1])
            out.append(keep)
            got += len(keep)
        return np.concatenate(out), (tpos, state, t_end)
    raise ValueError(f"unknown arrival process {a.process!r}")


@dataclasses.dataclass(frozen=True)
class StreamPiece:
    """One piece of a streamed trace: a standalone Trace plus the global
    index of its first query (offset-aware routing needs it)."""
    start: int
    trace: Trace


class TraceStream:
    """Bounded-memory generator form of a workload spec.

    ``pieces()`` yields :class:`StreamPiece`\\ s of ``piece`` queries each
    (last one short); iterating again regenerates the identical stream, so
    multi-pass/warmup replays need no materialization. ``materialize()``
    concatenates the stream into one Trace (tests/small runs only —
    O(trace) memory)."""

    def __init__(self, spec: WorkloadSpec, piece: int = 65536,
                 block: int = 8192):
        if any(t.arrival is not None for t in spec.tenants):
            raise ValueError("TraceStream supports shared arrival processes "
                             "only (per-tenant ArrivalSpecs merge whole "
                             "streams — materialize via build_trace)")
        if piece <= 0 or block <= 0:
            raise ValueError("piece and block must be positive")
        self.spec = spec
        self.piece = int(piece)
        self.block = int(block)
        self.metas = tenant_table_metas(spec)
        tens = spec.tenants
        w = np.array([t.weight for t in tens], np.float64)
        self._w = w / w.sum()
        umetas = [[m for m in self.metas[t.name] if m.kind == "user"]
                  for t in tens]
        self._umetas = umetas
        # flat per-(tenant, table) template: tenant ti's tables occupy
        # [tstarts[ti], tstarts[ti] + tcounts[ti]) of the flat arrays
        self._tcounts = np.array([len(u) for u in umetas], np.int64)
        self._tstarts = np.concatenate(
            [[0], np.cumsum(self._tcounts)])[:-1].astype(np.int64)
        flat = [m for u in umetas for m in u]
        self._ftid = np.array([m.table_id for m in flat], np.int64)
        self._fpf = np.array([m.pooling_factor for m in flat], np.float64)
        self._sigma = np.array([t.pool_sigma for t in tens], np.float64)
        self._period = np.array([t.drift_period_us for t in tens], np.float64)
        self._blend = np.array(
            [t.drift_blend if t.drift_period_us > 0 else 0.0 for t in tens],
            np.float64)

    @property
    def name(self) -> str:
        return self.spec.name

    def __len__(self) -> int:
        return self.spec.num_queries

    def all_metas(self) -> List[TableMeta]:
        """Union inventory, same shape as ``Trace.all_metas``."""
        return [m for ms in self.metas.values() for m in ms]

    # -- generation -----------------------------------------------------------

    def _gen_block(self, bi: int, carry) -> Tuple[Trace, object]:
        """Generate fixed-size block ``bi`` given the arrival carry state."""
        spec = self.spec
        n = self.block
        k = len(spec.tenants)
        arng = np.random.default_rng(
            np.random.SeedSequence([spec.seed, 12, bi]))
        arrivals, carry = _arrival_block(spec.arrival, n, carry, arng)
        brng = np.random.default_rng(
            np.random.SeedSequence([spec.seed, 11, bi]))
        tenant = brng.choice(k, size=n, p=self._w).astype(np.int64)
        nseg = self._tcounts[tenant]
        query_seg = np.concatenate([[0], np.cumsum(nseg)])
        n_seg = int(query_seg[-1])
        trep = np.repeat(tenant, nseg)          # tenant per segment
        li = np.arange(n_seg) - np.repeat(query_seg[:-1], nseg)
        fidx = self._tstarts[trep] + li         # flat (tenant, table) slot
        seg_table = self._ftid[fidx]
        pf = self._fpf[fidx]
        sig = self._sigma[trep]
        if self._sigma.any():
            z = brng.standard_normal(n_seg)
            drawn = np.maximum(1, np.rint(pf * np.exp(sig * z)))
            lens = np.where(sig > 0, drawn, pf).astype(np.int64)
        else:
            lens = pf.astype(np.int64)
        seg_offsets = np.concatenate([[0], np.cumsum(lens)])
        per = self._period[tenant]
        ep = np.zeros(n, np.int64)
        drifting = per > 0
        if drifting.any():
            ep[drifting] = (arrivals[drifting]
                            // per[drifting]).astype(np.int64)
        values = np.empty(int(seg_offsets[-1]), np.int64)
        for ti in range(k):
            qsel = np.nonzero(tenant == ti)[0]
            if not len(qsel):
                continue
            for j, meta in enumerate(self._umetas[ti]):
                sids = query_seg[qsel] + j      # the j-th segment per query
                sizes = lens[sids]
                ids = zipf_indices_drift_flat(
                    brng, meta.num_rows, meta.zipf_alpha, sizes, ep[qsel],
                    self._blend[ti])
                off = np.concatenate([[0], np.cumsum(sizes)])
                pos = (np.repeat(seg_offsets[sids] - off[:-1], sizes)
                       + np.arange(len(ids)))
                values[pos] = ids
        cq = ColumnarQueries(values, seg_offsets, seg_table, query_seg)
        tr = Trace(spec.name, spec.seed, arrivals, tenant,
                   tuple(t.name for t in spec.tenants), cq, self.metas)
        return tr, carry

    def _blocks(self) -> Iterator[Trace]:
        n = self.spec.num_queries
        carry: Optional[object] = None
        emitted = 0
        bi = 0
        while emitted < n:
            tr, carry = self._gen_block(bi, carry)
            if emitted + len(tr) > n:
                tr = slice_trace(tr, 0, n - emitted)
            yield tr
            emitted += len(tr)
            bi += 1

    def pieces(self) -> Iterator[StreamPiece]:
        """Yield the trace as consecutive ``piece``-query Traces."""
        n = self.spec.num_queries
        gen = self._blocks()
        buf: List[Trace] = []
        have = 0
        start = 0
        while start < n:
            take = min(self.piece, n - start)
            while have < take:
                b = next(gen)
                buf.append(b)
                have += len(b)
            merged = concat_traces(buf)
            if have > take:
                piece, buf = (slice_trace(merged, 0, take),
                              [slice_trace(merged, take, have)])
            else:
                piece, buf = merged, []
            have -= take
            yield StreamPiece(start, piece)
            start += take

    def materialize(self) -> Trace:
        """The whole stream as one Trace (O(trace) memory — tests only)."""
        return concat_traces([p.trace for p in self.pieces()])
