"""Port vs reference: the fleet's device plane and the fleet entry points.

``ClusterSim.run_device_plane`` routes a trace over hosts and serves each
host's share through its own device engine (``HostSim.attach_engine``): a
``DeviceServingEngine``, or a ``ShardedServingEngine`` for a host whose spec
has a ``mesh_shape``. At the shape of ``tests/test_sharded_engine.py``'s
device-plane case (``zipf_steady``, 48 queries, ``table_bytes`` 3e5, D 16,
the same numpy tables on both sides) every ``HostReport`` field (``sm_ios``,
p50/p95/p99, ``engine_hit_rate``, ``mesh_devices``, ...) and the fleet
percentiles must equal the reference's, and with telemetry on so must the
merged registry. The port's engines run on the CPU, where the kernels'
wrappers take their plain versions (the reference's engines are built with
``use_kernels=False``). A 2-shard mesh host needs two JAX devices, so the
reference's side of that case runs in a subprocess with forced host devices.

Also: a 1-host fleet equals the trace path's engine, and the entry points
``python -m repro_torch.fleet_control`` (the same lines as the reference's
``examples/fleet_control.py``) and ``serve_dlrm --fleet-hosts`` on the CPU.
"""
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro.core import power as jpower
from repro.runtime import cluster as jcluster
from repro.workloads import ARCHETYPES as JARCH
from repro.workloads import build_trace as jbuild
from repro_torch import fleet_control, serve_dlrm
from repro_torch.core import power as tpower
from repro_torch.runtime import cluster as tcluster
from repro_torch.workloads import ARCHETYPES as TARCH
from repro_torch.workloads import build_trace as tbuild

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
SRC = os.path.join(ROOT, "src")
PORT = dict(power=tpower, cluster=tcluster, arch=TARCH, build=tbuild)
REF = dict(power=jpower, cluster=jcluster, arch=JARCH, build=jbuild)


def small_trace(p, queries=48):
    spec = p["arch"]["zipf_steady"]
    return p["build"](dataclasses.replace(
        spec, num_queries=queries,
        tenants=tuple(dataclasses.replace(
            t, table_bytes=3e5, num_user_tables=2, num_item_tables=1)
            for t in spec.tenants)))


def numpy_tables(trace, dim=16, seed=4):
    rng = np.random.default_rng(seed)
    return {m.table_id: rng.standard_normal((m.num_rows, dim)).astype(np.float32)
            for m in trace.all_metas()}


def fleet(p, mesh_shards=1, routing="round_robin", telemetry=None,
          layout="row"):
    c = p["cluster"]
    plain = c.HostSpec(name="plain", host=p["power"].HW_SS,
                       fm_cache_bytes=2 << 20)
    mesh = dataclasses.replace(plain, name="mesh", mesh_shape=(mesh_shards,),
                               shard_layout=layout)
    return c.ClusterSim(c.ClusterConfig(hosts=(plain, mesh), routing=routing,
                                        telemetry=telemetry))


def summary(rep):
    """JSON-ready: every host's report, the fleet percentiles, the merged
    registry (None without telemetry)."""
    out = {"hosts": [dataclasses.asdict(h) for h in rep.hosts],
           "pct": [rep.p50_us, rep.p95_us, rep.p99_us, rep.p999_us],
           "registry": (None if rep.telemetry is None
                        else rep.telemetry.registry.as_dict())}
    return json.loads(json.dumps(out))


def port_summary(mesh_shards, routing, telemetry, layout="row"):
    tr = small_trace(PORT)
    rep = fleet(PORT, mesh_shards, routing, telemetry, layout).run_device_plane(
        tr, numpy_tables(tr), chunk=16, torch_device="cpu")
    return summary(rep)


def ref_summary(mesh_shards, routing, telemetry, layout="row"):
    tr = small_trace(REF)
    rep = fleet(REF, mesh_shards, routing, telemetry, layout).run_device_plane(
        tr, numpy_tables(tr), chunk=16)
    return summary(rep)


MESH_CASES = [("row", "round_robin", True), ("table", "round_robin", None)]


def _mesh_worker() -> dict:
    """The reference's 2-shard mesh-host cases, run where JAX has 8 CPU
    devices."""
    return {f"{layout}-{routing}-{tel}": ref_summary(2, routing, tel, layout)
            for layout, routing, tel in MESH_CASES}


@pytest.fixture(scope="module")
def mesh_ref():
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    code = (f"import json, sys; sys.path.insert(0, {HERE!r})\n"
            "import test_torch_fleet as m\n"
            "print(json.dumps(m._mesh_worker()))\n")
    proc = subprocess.run([sys.executable, "-c", code], env=env, cwd=HERE,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


# -- the device plane against the reference's ------------------------------------


@pytest.mark.parametrize("telemetry", [None, True], ids=["off", "on"])
@pytest.mark.parametrize("routing", ["round_robin", "tenant_sticky"])
def test_device_plane_matches_reference(routing, telemetry):
    got = port_summary(1, routing, telemetry)
    want = ref_summary(1, routing, telemetry)
    assert got == want
    by = {h["name"]: h for h in got["hosts"]}
    # one tenant: the sticky router sends everything to one host, and the
    # idle one reports the zero placeholder
    assert by["mesh"]["mesh_devices"] == (1 if by["mesh"]["queries"] else 0)
    assert (by["mesh"]["queries"] == 0) == (routing == "tenant_sticky")
    assert sum(h["queries"] for h in got["hosts"]) == 48
    assert any(h["sm_ios"] > 0 for h in got["hosts"])
    if telemetry:
        assert got["registry"]["counters"]["serve.queries"] == 48
        assert "engine.sm_time_us" in got["registry"]["histograms"]


@pytest.mark.parametrize("layout,routing,telemetry", MESH_CASES)
def test_mesh_host_matches_reference(mesh_ref, layout, routing, telemetry):
    got = port_summary(2, routing, telemetry, layout)
    assert got == mesh_ref[f"{layout}-{routing}-{telemetry}"]
    by = {h["name"]: h for h in got["hosts"]}
    assert by["mesh"]["mesh_devices"] == 2
    if telemetry:
        c = got["registry"]["counters"]
        assert c["engine.shard0.sm_ios"] + c["engine.shard1.sm_ios"] == \
            by["mesh"]["sm_ios"]


def test_telemetry_leaves_device_plane_reports_unchanged():
    on, off = port_summary(2, "round_robin", True), port_summary(
        2, "round_robin", None)
    assert on["hosts"] == off["hosts"] and on["pct"] == off["pct"]
    assert off["registry"] is None


def test_one_host_fleet_equals_the_trace_engine():
    """The fleet's one host serves the whole trace in the same chunks as the
    trace path's engine: the same misses and hit rate, whatever the table
    values."""
    spec = serve_dlrm.m1_spec("zipf_steady", queries=96, table_bytes=3e6)
    tr = tbuild(spec)
    tables = serve_dlrm.trace_tables(spec, 8, torch_device="cpu")
    rep = serve_dlrm.build_fleet(1).run_device_plane(tr, tables,
                                                     torch_device="cpu")
    engine = serve_dlrm.build_trace_engine(spec, 8, torch_device="cpu")
    res = serve_dlrm.serve_trace(engine, tr, 32)
    (h,) = rep.hosts
    assert (h.queries, h.sm_ios, h.engine_hit_rate, h.mesh_devices) == \
        (96, int(res.sm_ios.sum()), engine.hit_rate, 1)
    assert 0.0 < h.engine_hit_rate < 1.0


def test_attach_engine_defaults_run_the_kernels():
    """The default ``EngineConfig`` of a host's engine asks for the kernels
    (on CPU tensors the wrappers take their plain versions) and mirrors the
    host's store; ``devices`` places a mesh host's shards."""
    tr = small_trace(PORT)
    spec = tcluster.HostSpec(name="m", host=tpower.HW_SS,
                             fm_cache_bytes=2 << 20, mesh_shape=(2,))
    sim = tcluster.HostSim(spec, tr.all_metas(), 10_000.0)
    eng = sim.attach_engine(numpy_tables(tr), torch_device="cpu",
                            devices=["cpu", "cpu"])
    assert eng.cfg.use_kernels and eng.n == 2
    assert eng.cfg.hbm_cache_bytes == 2 << 20
    assert eng.cfg.item_time_us == 1e6 / tcluster.host_compute_qps(tpower.HW_SS)
    assert all(d == torch.device("cpu") for d in eng.devices)
    fleet_host = tcluster.HostSim(serve_dlrm.FLEET_HOST, tr.all_metas(), 10_000.0)
    assert fleet_host.attach_engine(numpy_tables(tr), torch_device="cpu").cfg == \
        serve_dlrm.fleet_engine_config()


# -- entry points ---------------------------------------------------------------------


def test_fleet_control_prints_the_reference_lines(capsys):
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu")
    ref = subprocess.run(
        [sys.executable, os.path.join(ROOT, "examples", "fleet_control.py"),
         "--queries", "400"], env=env, cwd=ROOT, capture_output=True,
        text=True, timeout=300)
    assert ref.returncode == 0, ref.stderr[-3000:]
    fleet_control.main(["--queries", "400", "--device", "cpu"])
    got = capsys.readouterr().out
    assert got == ref.stdout
    assert "queries served 400/400" in got


def test_fleet_entry_points_need_a_device():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA"):
        fleet_control.main(["--queries", "8"])
    with pytest.raises(RuntimeError, match="CUDA"):
        serve_dlrm.main(["--archetype", "zipf_steady", "--queries", "8",
                         "--table-bytes", "3e5", "--dim", "8",
                         "--fleet-hosts", "2"])


def test_serve_dlrm_fleet_cli_on_cpu(capsys):
    serve_dlrm.main(["--device", "cpu", "--archetype", "zipf_steady",
                     "--queries", "96", "--table-bytes", "3e5", "--dim", "16",
                     "--fleet-hosts", "3", "--mesh-host-shards", "2",
                     "--telemetry"])
    out = capsys.readouterr().out
    assert "served 96 zipf_steady queries over 3 hosts (round_robin" in out
    assert out.count("queries    32") == 3
    assert "telemetry engine.shard1.sm_ios" in out
    with pytest.raises(SystemExit):
        serve_dlrm.main(["--device", "cpu", "--mesh-host-shards", "2"])
    with pytest.raises(SystemExit):
        serve_dlrm.main(["--device", "cpu", "--archetype", "zipf_steady",
                         "--fleet-hosts", "2", "--shards", "2"])
