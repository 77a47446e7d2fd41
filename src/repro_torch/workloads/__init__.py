"""Trace-driven workload engine of the port: fleet-shaped traffic for the
device serving engine.

Generates reproducible, seedable :class:`~repro_torch.workloads.trace.Trace`
objects from parameterized archetypes (Zipf with popularity drift, diurnal
and MMPP-bursty arrivals, pooling-factor mixes, multi-model tenancy drawn
from the paper's Table 6 models) in columnar (CSR) form, and streams long
ones in bounded memory (:class:`~repro_torch.workloads.stream.TraceStream`).
``repro_torch.serve_dlrm.serve_trace`` feeds them chunk by chunk to
``DeviceServingEngine.serve_columnar`` and ``runtime.cluster.ClusterSim``
routes them over hosts under timed failure schedules (``failures.py``).
Copies of ``repro.workloads``.
"""
from repro_torch.workloads.trace import (Trace, TraceChunk,  # noqa: F401
                                         interleave_arrivals, mmpp_arrivals,
                                         nonhomogeneous_arrivals,
                                         poisson_arrivals, windowed_qps,
                                         zipf_indices_drift)
from repro_torch.workloads.archetypes import (ARCHETYPES, TENANT_TID_BASE,  # noqa: F401
                                              ArrivalSpec, TenantSpec,
                                              WorkloadSpec, build_trace,
                                              tenant_table_metas)
from repro_torch.workloads.stream import TraceStream  # noqa: F401
from repro_torch.workloads.failures import (FailureEvent, FailureSpec,  # noqa: F401
                                            seeded_failures)
