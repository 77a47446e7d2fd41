"""Operate a simulated serving fleet through the control plane, end to end:

1. **failover** — inject a seeded mid-trace crash (plus a slow-host window
   and an IO-error burst) into a 3-host multi-tenant fleet; the router
   fails the dead host's traffic over to replicas and replays its
   in-flight window, so no query is lost and the fleet p99 stays bounded;
2. **degraded mode** — re-run the same outage serving *stale* rows on the
   pressured replicas (`DegradePolicy`) and show the counters;
3. **autoscale** — follow the diurnal archetype with the reactive
   autoscaler and compare host-seconds against the static max fleet;
4. **plan** — size the minimum-power {Nand, Optane, DRAM} fleet meeting a
   10 ms p99 SLO at Table 8's demand (`plan_capacity`).

Everything is seeded: re-running prints identical numbers. The port's copy
of the reference's ``examples/fleet_control.py``: the same four legs print
the same lines. The control plane is numpy on the host; ``--device`` names
the device the fleet's engines would serve on (``cuda`` unless the caller
asks for the CPU), and with no GPU the default raises, as every entry point
of the port does.

Run: PYTHONPATH=src python -m repro_torch.fleet_control [--queries 2000]
         [--device cuda]
"""
import argparse
import dataclasses

import numpy as np

from repro_torch import resolve_device
from repro_torch.core.power import HW_L, HW_SS
from repro_torch.runtime.cluster import ClusterConfig, ClusterSim, HostSpec
from repro_torch.runtime.control import (AutoscalePolicy, DegradePolicy,
                                         autoscale_run, plan_capacity)
from repro_torch.workloads import (ARCHETYPES, FailureEvent, FailureSpec,
                                   build_trace, seeded_failures)


def _fleet(k, routing="round_robin"):
    hosts = tuple(HostSpec(name=f"h{i}", host=HW_SS, device="nand_flash",
                           fm_cache_bytes=8 << 20) for i in range(k))
    return ClusterSim(ClusterConfig(hosts=hosts, routing=routing, chunk=64))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--queries", type=int, default=2000)
    ap.add_argument("--device", default="cuda", help="torch device")
    args = ap.parse_args(argv)
    resolve_device(args.device)

    trace = build_trace(dataclasses.replace(ARCHETYPES["multi_tenant"],
                                            num_queries=args.queries))
    d = trace.duration_us
    cluster = _fleet(3)

    # -- 1. outage: crash + slow host + IO-error burst ------------------------
    failures = FailureSpec(events=(
        FailureEvent(host="h1", kind="crash", start_us=0.4 * d,
                     end_us=0.7 * d, inflight_window_us=0.02 * d),
        FailureEvent(host="h0", kind="slow", start_us=0.1 * d,
                     end_us=0.25 * d, slow_bg_iops=50_000.0),
        FailureEvent(host="h2", kind="io_errors", start_us=0.5 * d,
                     end_us=0.8 * d, error_rate=0.1,
                     retry_penalty_us=1000.0),
    ))
    base = cluster.run(trace)
    hit = cluster.run(trace, failures=failures)
    print("-- outage (crash h1 + slow h0 + io errors h2) --")
    print(f"queries served {hit.queries}/{len(trace)}  (lost: "
          f"{len(trace) - hit.queries})")
    print(f"crashes={hit.crashes} failed_over={hit.failed_over} "
          f"replayed={hit.replayed} io_retries={hit.io_error_retries}")
    print(f"p99 healthy {base.p99_us:.0f}us -> outage {hit.p99_us:.0f}us")

    # -- 2. the same outage, degraded-mode serving ----------------------------
    deg = cluster.run(trace, failures=failures,
                      degrade=DegradePolicy(mode="stale"))
    print("\n-- degraded mode (serve stale under failover pressure) --")
    print(f"stale_served={deg.stale_served} "
          f"degraded_chunks={deg.degraded_chunks} p99={deg.p99_us:.0f}us")

    # seeded schedules for fleet-scale experiments:
    sched = seeded_failures([f"h{i}" for i in range(3)], d, seed=7,
                            mtbf_us=d / 2, mttr_us=d / 20)
    print(f"seeded_failures(seed=7): {len(sched.events)} events")

    # -- 3. reactive autoscaler on the diurnal archetype ----------------------
    diurnal = build_trace(dataclasses.replace(ARCHETYPES["diurnal"],
                                              num_queries=args.queries,
                                              seed=2))
    peak = len(diurnal) / diurnal.duration_us * 1e6
    policy = AutoscalePolicy(host_capacity_qps=peak / 2.0,
                             window_us=diurnal.duration_us / 24.0,
                             cooldown_us=diurnal.duration_us / 24.0,
                             initial_hosts=2, max_hosts=4)
    res = autoscale_run(_fleet(4), diurnal, policy)
    print("\n-- autoscale (diurnal) --")
    print(f"schedule {np.asarray(res.schedule).tolist()}")
    print(f"p99={res.report.p99_us:.0f}us  host-seconds "
          f"{res.host_seconds:.2f} vs static {res.static_host_seconds:.2f} "
          f"({res.host_seconds_saved / res.static_host_seconds:.0%} saved)")

    # -- 4. capacity planner over the SLO grid --------------------------------
    candidates = {
        "nand": HostSpec("nand", HW_SS, device="nand_flash",
                         fm_cache_bytes=8 << 20),
        "optane": HostSpec("optane",
                           dataclasses.replace(HW_SS, ssd_kind="optane"),
                           device="optane_ssd", fm_cache_bytes=8 << 20),
        "dram": HostSpec("dram", HW_L, device=None),
    }
    plan = plan_capacity(trace, candidates, demand_qps=240 * 1200,
                         slo_us=10_000.0, passes=1, warmup=False, count=2)
    print("\n-- capacity plan (10ms p99 SLO, Table 8 demand) --")
    for o in plan.options:
        mark = " <- best" if o.name == plan.best else ""
        print(f"{o.name:>7}: power={o.fleet_power:7.1f} "
              f"hosts={o.fleet_hosts:7.1f} tail={o.tail_us:7.1f}us "
              f"slo={'met' if o.meets_slo else 'MISSED'}{mark}")
    print(f"best mix: {plan.best_mix}")


if __name__ == "__main__":
    main()
