"""Parameterized workload archetypes -> reproducible traces.

A :class:`WorkloadSpec` describes fleet-shaped traffic as three orthogonal
axes:

* **arrival shape** (:class:`ArrivalSpec`): steady Poisson, diurnal
  (sinusoidal nonhomogeneous Poisson) or MMPP-bursty;
* **per-tenant access pattern** (:class:`TenantSpec`): which Table 6 model
  the tenant's tables are statistically drawn from, its traffic weight,
  Zipf popularity drift (hot-set rotation period) and pooling-factor mix
  (lognormal spread around each table's mean pooling factor);
* **tenancy**: one tenant reproduces the single-model benchmarks; several
  tenants with weights model the multi-model co-location of Table 11.

:func:`build_trace` compiles a spec + seed into a
:class:`~repro_torch.workloads.trace.Trace`; the same (spec, seed) always yields
bit-identical traces. ``ARCHETYPES`` holds the named grid the reference's
scenario benchmark sweeps.

A copy of ``repro.workloads.archetypes``: the RNG draws come in the same
order, so a spec and seed give the reference's trace bit for bit
(``tests/test_torch_workloads.py``).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import numpy as np

from repro_torch.configs.base import DLRM_REGISTRY
from repro_torch.core.columnar import ColumnarQueries
from repro_torch.core.locality import TableMeta, sample_table_metas
from repro_torch.workloads.trace import (Trace, interleave_arrivals, mmpp_arrivals,
                                   nonhomogeneous_arrivals, poisson_arrivals,
                                   zipf_indices_drift)

# Global table-id namespace: tenant i owns [i * TENANT_TID_BASE, ...).
TENANT_TID_BASE = 1 << 14


@dataclasses.dataclass(frozen=True)
class ArrivalSpec:
    process: str = "poisson"          # poisson | diurnal | mmpp
    rate_qps: float = 2_000.0
    # diurnal: rate(t) = rate_qps * (1 + amplitude * sin(2 pi (t+phase) / period))
    diurnal_period_us: float = 2e5
    diurnal_amplitude: float = 0.6
    diurnal_phase_us: float = 0.0
    # mmpp (bursty): quiet <-> burst state switching
    burst_mult: float = 8.0
    mean_burst_us: float = 2e4
    mean_quiet_us: float = 8e4


@dataclasses.dataclass(frozen=True)
class TenantSpec:
    name: str
    model: str = "dlrm-m1"            # key into configs.dlrm_models (Table 6)
    weight: float = 1.0               # relative traffic share
    num_user_tables: int = 6          # scaled-down inventory for simulation
    num_item_tables: int = 3
    table_bytes: float = 2e8          # total inventory bytes (scaled down)
    drift_period_us: float = 0.0      # 0 = static popularity
    drift_blend: float = 0.3          # fraction pre-sampling the next epoch
    pool_sigma: float = 0.0           # lognormal pooling-mix spread (0 = fixed)
    # Independent per-tenant arrival stream (statistical multiplexing, Table
    # 11): when set, this tenant's queries follow its own arrival process and
    # the trace is the merge of all tenant streams; when every tenant leaves
    # it None, one shared process is thinned by tenant weight.
    arrival: "ArrivalSpec | None" = None


@dataclasses.dataclass(frozen=True)
class WorkloadSpec:
    name: str
    arrival: ArrivalSpec = ArrivalSpec()
    tenants: Tuple[TenantSpec, ...] = (TenantSpec("t0"),)
    num_queries: int = 512
    seed: int = 0


def tenant_table_metas(spec: WorkloadSpec) -> Dict[str, List[TableMeta]]:
    """Instantiate each tenant's table inventory with the statistics of its
    Table 6 model (dim ranges, pooling factors), remapped into the tenant's
    global table-id range so inventories can share one store/cache."""
    out: Dict[str, List[TableMeta]] = {}
    for ti, t in enumerate(spec.tenants):
        cfg = DLRM_REGISTRY[t.model]
        rng = np.random.default_rng(np.random.SeedSequence([spec.seed, 7, ti]))
        metas = sample_table_metas(
            rng, num_user=t.num_user_tables, num_item=t.num_item_tables,
            user_dim_bytes=cfg.user_dim_bytes, item_dim_bytes=cfg.item_dim_bytes,
            user_pool=cfg.user_avg_pool, item_pool=cfg.item_avg_pool,
            total_bytes=t.table_bytes)
        base = ti * TENANT_TID_BASE
        out[t.name] = [dataclasses.replace(m, table_id=base + m.table_id)
                       for m in metas]
    return out


def _make_arrivals(rng: np.random.Generator, a: ArrivalSpec,
                   n: int) -> np.ndarray:
    if a.process == "poisson":
        return poisson_arrivals(rng, n, a.rate_qps)
    if a.process == "diurnal":
        peak = a.rate_qps * (1.0 + a.diurnal_amplitude)

        def rate(t: np.ndarray) -> np.ndarray:
            return a.rate_qps * (1.0 + a.diurnal_amplitude
                                 * np.sin(2 * np.pi * (t + a.diurnal_phase_us)
                                          / a.diurnal_period_us))

        return nonhomogeneous_arrivals(rng, n, peak, rate)
    if a.process == "mmpp":
        return mmpp_arrivals(rng, n, a.rate_qps, a.burst_mult,
                             a.mean_burst_us, a.mean_quiet_us)
    raise ValueError(f"unknown arrival process {a.process!r}")


def build_trace(spec: WorkloadSpec) -> Trace:
    """Compile a spec into a reproducible trace (user-side requests only —
    item tables run on the FM side and are not part of the SM query).

    The trace is assembled directly in columnar (CSR) form: per-query index
    draws append to one flat value stream + segment table-id/offset arrays
    (the RNG consumption order is unchanged, so traces stay bit-identical
    across the columnar refactor)."""
    rng = np.random.default_rng(np.random.SeedSequence([spec.seed, 1]))
    w = np.array([t.weight for t in spec.tenants], np.float64)
    if any(t.arrival is not None for t in spec.tenants):
        # independent per-tenant streams, merged — tenant bursts/phases can
        # de-synchronize, which is what co-location multiplexes away
        share = w / w.sum()
        counts = np.floor(share * spec.num_queries).astype(int)
        counts[0] += spec.num_queries - int(counts.sum())
        parts = []
        for ti, t in enumerate(spec.tenants):
            trng = np.random.default_rng(
                np.random.SeedSequence([spec.seed, 3, ti]))
            parts.append(_make_arrivals(trng, t.arrival or spec.arrival,
                                        int(counts[ti])))
        arrivals, tenant = interleave_arrivals(parts)
    else:
        arrivals = _make_arrivals(rng, spec.arrival, spec.num_queries)
        tenant = rng.choice(len(spec.tenants), size=spec.num_queries,
                            p=w / w.sum())
    metas = tenant_table_metas(spec)

    user_metas = [[m for m in metas[t.name] if m.kind == "user"]
                  for t in spec.tenants]
    vals: List[np.ndarray] = []               # one entry per (query, table)
    seg_tables: List[int] = []
    nseg = np.empty(spec.num_queries, np.int64)
    for q in range(spec.num_queries):
        ti = int(tenant[q])
        t = spec.tenants[ti]
        epoch = (int(arrivals[q] // t.drift_period_us)
                 if t.drift_period_us > 0 else 0)
        nseg[q] = len(user_metas[ti])
        for m in user_metas[ti]:
            pf = m.pooling_factor
            if t.pool_sigma > 0:
                pf = max(1, int(round(pf * rng.lognormal(0.0, t.pool_sigma))))
            seg_tables.append(m.table_id)
            vals.append(zipf_indices_drift(
                rng, m.num_rows, m.zipf_alpha, pf, epoch,
                t.drift_blend if t.drift_period_us > 0 else 0.0))

    lens = np.fromiter((len(v) for v in vals), np.int64, count=len(vals))
    queries = ColumnarQueries(
        np.concatenate(vals) if vals else np.zeros(0, np.int64),
        np.concatenate([[0], np.cumsum(lens)]),
        np.asarray(seg_tables, np.int64),
        np.concatenate([[0], np.cumsum(nseg)]))
    return Trace(spec.name, spec.seed, arrivals, tenant.astype(np.int64),
                 tuple(t.name for t in spec.tenants), queries, metas)


# -- the named archetype grid -------------------------------------------------

def _m1_tenant(**kw) -> TenantSpec:
    return TenantSpec("m1", model="dlrm-m1", **kw)


ARCHETYPES: Dict[str, WorkloadSpec] = {
    # steady Zipf traffic — the regime the existing benchmarks replayed
    "zipf_steady": WorkloadSpec(
        "zipf_steady", ArrivalSpec("poisson"), (_m1_tenant(),)),
    # temporal popularity drift: the hot set rotates every ~0.5 s of trace
    "zipf_drift": WorkloadSpec(
        "zipf_drift", ArrivalSpec("poisson"),
        (_m1_tenant(drift_period_us=5e5, pool_sigma=0.25),)),
    # day-shaped arrivals (peak/trough rate swing)
    "diurnal": WorkloadSpec(
        "diurnal", ArrivalSpec("diurnal"), (_m1_tenant(pool_sigma=0.25),)),
    # bursty MMPP arrivals (§4.1's burst-smoothing regime)
    "bursty": WorkloadSpec(
        "bursty", ArrivalSpec("mmpp"), (_m1_tenant(),)),
    # multi-model tenancy: Table 6 models co-located, Table 11's regime
    "multi_tenant": WorkloadSpec(
        "multi_tenant", ArrivalSpec("poisson"),
        (TenantSpec("m1", model="dlrm-m1", weight=0.5, pool_sigma=0.2),
         TenantSpec("m2", model="dlrm-m2", weight=0.3, num_user_tables=8,
                    drift_period_us=1e6),
         TenantSpec("m3", model="dlrm-m3", weight=0.2, num_user_tables=4))),
}
