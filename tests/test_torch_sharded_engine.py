"""Port vs reference: the sharded serving engine
(``repro_torch.runtime.sharded_engine`` vs ``repro.runtime.sharded_engine``)
and its shard mesh (``repro_torch.launch``).

Same numpy tables and index blocks on both sides. Per-query ``sm_ios``,
``sm_time_us`` and ``latency_us``, the store totals, the hit rate and each
shard's cache state exactly equal; pooled bags within the reference's
``rtol=1e-5, atol=1e-5`` (``tests/test_sharded_engine.py``).

The reference's multi-shard mesh needs ``XLA_FLAGS=--xla_force_host_
platform_device_count=8`` before JAX starts, so the multi-shard parity runs
once, in a subprocess that imports this module and prints one JSON of
results (:func:`_parity_worker`); parametrized tests read it, one case per
(layout, shards[, archetype]). The in-process tests use the one CPU device
of the reference (1-way meshes).
"""
import dataclasses
import json
import os
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

from repro.core import io_sim as jio
from repro.launch.mesh import make_embed_mesh as jmesh
from repro.runtime import engine as jeng
from repro.runtime.sharded_engine import ShardedServingEngine as JSharded
from repro.workloads import ARCHETYPES as JARCH
from repro.workloads import build_trace as jbuild
from repro_torch import serve_dlrm
from repro_torch.core import io_sim as tio
from repro_torch.launch import EMBED_LAYOUTS, make_embed_mesh
from repro_torch.runtime import engine as teng
from repro_torch.runtime.sharded_engine import ShardedServingEngine
from repro_torch.workloads import ARCHETYPES as TARCH
from repro_torch.workloads import build_trace as tbuild
from test_torch_engine import all_slot_fill, spy_fill_rows

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "..", "src")
POOL_TOL = dict(rtol=1e-5, atol=1e-5)
STATE_KEYS = ("tag_table", "tag_row", "data", "stamp", "clock", "hits", "misses")
KERNEL_SHARDS = (2, 8)
STORE_DIMS = (8, 13)              # 13: rows held at a pitch of 16
SWEEP_SHARDS = (2, 4, 8)
SWEEP_ARCHETYPES = ("zipf_steady", "bursty", "multi_tenant")


def _tables(rng, rows, dim=8):
    return {t: rng.standard_normal((r, dim)).astype(np.float32)
            for t, r in enumerate(rows)}


def _pair(tables, n, layout, device="nand_flash", **cfg):
    """(reference engine on an n-way mesh, port engine on n CPU shards)."""
    j = JSharded(tables, jio.DEVICES[device], jeng.EngineConfig(**cfg),
                 mesh=jmesh(n), layout=layout)
    t = ShardedServingEngine(tables, tio.DEVICES[device],
                             teng.EngineConfig(**cfg),
                             mesh=make_embed_mesh(n, "cpu"), layout=layout)
    return j, t


def _per_query(stats) -> list:
    return [(q.sm_ios, q.sm_time_us, q.latency_us) for q in stats]


def _mismatches(j, t, jout, tout, idx, valid=None) -> list:
    """What differs between one batch's results of the reference ``j`` and
    the port ``t``: ``*out`` are ``(pooled, [(sm_ios, sm_time_us,
    latency_us)] per query)``. Empty when the port holds every tolerance."""
    (jp, jq), (tp, tq) = jout, tout
    bad = []
    if tq != jq:
        bad.append("per-query sm_ios, sm_time_us or latency_us")
    if tp.shape != jp.shape or tp.dtype != jp.dtype:
        bad.append(f"pooled {tp.shape} {tp.dtype} vs {jp.shape} {jp.dtype}")
    elif not np.allclose(tp, jp, **POOL_TOL):
        bad.append(f"pooled off by {np.abs(tp - jp).max()}")
    elif not np.allclose(tp, t.reference_pool(idx, valid), **POOL_TOL):
        bad.append("pooled vs reference_pool")
    if (t.stats.sm_ios, t.stats.latency_us) != (j.stats.sm_ios, j.stats.latency_us):
        bad.append("stats")
    if t.hit_rate != j.hit_rate:
        bad.append(f"hit rate {t.hit_rate} vs {j.hit_rate}")
    if (t.io.total_ios, t.io.total_bus_bytes) != (j.io.total_ios, j.io.total_bus_bytes):
        bad.append("IO totals")
    for k in range(t.n):
        for key in STATE_KEYS:
            want = np.asarray(j.state[key])[k]
            got = _at_dim(t.state[k][key].numpy(), want, key == "data")
            if got is None or got.dtype != want.dtype or \
                    not np.array_equal(got, want):
                bad.append(f"shard {k} {key}")
    return bad


def _at_dim(got, want, rows):
    """The port's ``got`` over the reference's columns when it holds
    ``rows`` at the pitch, or None if a pad column past them is not zero."""
    if not rows:
        return got
    if got[..., want.shape[-1]:].any():
        return None
    return got[..., :want.shape[-1]]


def _small_spec(archetypes, name, queries):
    """The reference's small-trace cut (``tests/test_sharded_engine.py``):
    3 user tables and 1 item table per tenant, 3e5 bytes of inventory."""
    spec = archetypes[name]
    return dataclasses.replace(
        spec, num_queries=queries,
        tenants=tuple(dataclasses.replace(
            t, table_bytes=3e5, num_user_tables=3, num_item_tables=1)
            for t in spec.tenants))


def _parity_worker() -> dict:
    """The multi-shard cases, run where the reference has 8 CPU devices.
    Returns ``{case: {"bad": [...], ...}}`` (see :func:`_mismatches`)."""
    out = {}

    def run(case, fn):
        try:
            out[case] = fn()
        except Exception as e:          # one failing case must not hide the rest
            out[case] = {"bad": [f"{type(e).__name__}: {e}"]}

    # the kernel path on a tiny block: the reference's Pallas kernels in
    # interpret mode, the port's plain versions (CPU tensors); then the
    # same block again, now served from the shards' caches
    rows = [40, 64]
    idx = np.stack([np.random.default_rng(1).integers(0, r, (4, 4))
                    for r in rows], axis=1).astype(np.int32)

    def kernel_case(layout, n, dim=8):
        j, t = _pair(_tables(np.random.default_rng(0), rows, dim), n, layout,
                     hbm_cache_bytes=64 << 10, use_kernels=True)
        bad, ios = [], []
        for _ in range(2):
            (jp, js), (tp, ts) = j.serve_batch(idx), t.serve_batch(idx)
            bad += _mismatches(j, t, (jp, _per_query(js)),
                               (tp, _per_query(ts)), idx)
            ios.append(sum(q.sm_ios for q in ts))
        return {"bad": bad, "sm_ios": ios}

    for layout in EMBED_LAYOUTS:
        for n in KERNEL_SHARDS:
            run(f"kernel-{layout}-{n}", lambda: kernel_case(layout, n))
        run(f"kernel-{layout}-2-13", lambda: kernel_case(layout, 2, 13))

    # the store's packing at 3 shards of uneven tables (one of one row)
    def packing_case(layout, dim):
        j, t = _pair(_tables(np.random.default_rng(4), [7, 20, 1, 13], dim), 3,
                     layout)
        bad = []
        if t.sentinel != j.sentinel or \
                t.local_offsets.tolist() != j.local_offsets.tolist():
            bad.append("sentinel or local offsets")
        for k in range(3):
            for name in ("payload", "scale", "bias"):
                want = np.asarray(getattr(j, name))[k]
                got = _at_dim(getattr(t, name)[k].numpy(), want,
                              name == "payload")
                if got is None or got.dtype != want.dtype or \
                        not np.array_equal(got, want):
                    bad.append(f"shard {k} {name}")
        return {"bad": bad, "pitch": t.payload[0].shape[1]}

    for layout in EMBED_LAYOUTS:
        for dim in STORE_DIMS:
            run(f"packing-{layout}-{dim}", lambda: packing_case(layout, dim))

    # the plain path over archetype traces through serve_columnar, with a
    # cache small enough to evict
    def sweep_case(name, layout, n):
        tt = tbuild(_small_spec(TARCH, name, 48))
        jt = jbuild(_small_spec(JARCH, name, 48))
        rng = np.random.default_rng(2)
        tables = {m.table_id: rng.standard_normal((m.num_rows, 16)).astype(
            np.float32) for m in jt.all_metas() if m.kind == "user"}
        j, t = _pair(tables, n, layout, "optane_ssd",
                     hbm_cache_bytes=1 << 14, use_kernels=False)
        bad = []
        for tc, jc in zip(tt.chunks(24), jt.chunks(24)):
            tp, ttm, tios = t.serve_columnar(tc.columnar, bg_iops=5e4)
            jp, jtm, jios = j.serve_columnar(jc.columnar, bg_iops=5e4)
            if (tios.dtype, ttm.dtype) != (jios.dtype, jtm.dtype):
                bad.append("serve_columnar dtypes")
            idx, valid = teng.dense_from_chunk(tc.columnar, t.table_slot,
                                               len(t.table_ids))
            bad += _mismatches(j, t, (jp, list(zip(jios.tolist(), jtm.tolist()))),
                               (tp, list(zip(tios.tolist(), ttm.tolist()))),
                               idx, valid)
        return {"bad": bad, "hit_rate": t.hit_rate, "sm_ios": t.stats.sm_ios}

    for name in SWEEP_ARCHETYPES:
        for layout in EMBED_LAYOUTS:
            for n in SWEEP_SHARDS:
                run(f"sweep-{name}-{layout}-{n}",
                    lambda: sweep_case(name, layout, n))
    return out


@pytest.fixture(scope="module")
def parity():
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    code = (f"import json, sys; sys.path.insert(0, {HERE!r})\n"
            "import test_torch_sharded_engine as m\n"
            "print(json.dumps(m._parity_worker()))\n")
    proc = subprocess.run([sys.executable, "-c", code], env=env, cwd=HERE,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("n", KERNEL_SHARDS)
@pytest.mark.parametrize("layout", EMBED_LAYOUTS)
def test_kernel_path_matches_reference(parity, layout, n):
    res = parity[f"kernel-{layout}-{n}"]
    assert res["bad"] == []
    cold, warm = res["sm_ios"]
    assert cold > 0 and warm == 0          # the re-serve hits every key


@pytest.mark.parametrize("layout", EMBED_LAYOUTS)
def test_kernel_path_at_odd_dim_matches_reference(parity, layout):
    """Two shards at 13 values a row (rows held at a pitch of 16): the
    pooled bags, IO and each shard's cache state over the reference's 13
    columns are the reference's, cold and then warm."""
    res = parity[f"kernel-{layout}-2-13"]
    assert res["bad"] == []
    cold, warm = res["sm_ios"]
    assert cold > 0 and warm == 0


@pytest.mark.parametrize("layout", EMBED_LAYOUTS)
def test_store_packing_matches_reference(parity, layout):
    """Each shard's slice of the quantized store, the local offsets and the
    sentinel are the reference's, at 3 shards of uneven tables; at an odd
    ``dim`` the rows sit at the pitch, their pad columns zero."""
    for dim in STORE_DIMS:
        res = parity[f"packing-{layout}-{dim}"]
        assert res["bad"] == [] and res["pitch"] == teng.row_pitch(dim), dim


@pytest.mark.parametrize("n", SWEEP_SHARDS)
@pytest.mark.parametrize("layout", EMBED_LAYOUTS)
@pytest.mark.parametrize("name", SWEEP_ARCHETYPES)
def test_serve_columnar_matches_reference(parity, name, layout, n):
    res = parity[f"sweep-{name}-{layout}-{n}"]
    assert res["bad"] == []
    assert 0.0 < res["hit_rate"] < 1.0 and res["sm_ios"] > 0


# -- in process: the reference on its one CPU device --------------------------


def test_layout_and_mesh_validation():
    tables = _tables(np.random.default_rng(0), [16])
    cpu = make_embed_mesh(1, "cpu")
    for eng, mesh in ((JSharded, jmesh(1)), (ShardedServingEngine, cpu)):
        with pytest.raises(ValueError):
            eng(tables, jio.DEVICES["nand_flash"], mesh=mesh, layout="diag")
        with pytest.raises(ValueError):
            eng({}, jio.DEVICES["nand_flash"], mesh=mesh)
    other = types.SimpleNamespace(axis_names=("data", "model"),
                                  shape={"data": 1, "model": 1}, devices=cpu.devices)
    with pytest.raises(ValueError, match="single axis"):
        ShardedServingEngine(tables, tio.DEVICES["nand_flash"], mesh=other)
    with pytest.raises(ValueError, match="embedding dim"):
        ShardedServingEngine({0: np.zeros((4, 8), np.float32),
                              1: np.zeros((4, 6), np.float32)},
                             tio.DEVICES["nand_flash"], mesh=cpu)


@pytest.mark.parametrize("layout", EMBED_LAYOUTS)
def test_degenerate_batches(layout):
    tables = _tables(np.random.default_rng(3), [16, 16])
    j, t = _pair(tables, 1, layout, use_kernels=False)
    assert t.hit_rate == 0.0                         # before any batch
    pooled, stats = t.serve_batch(np.zeros((0, 2, 4), np.int32))
    assert pooled.shape == (0, 2, 8) and pooled.dtype == np.float32 and stats == []
    idx = np.arange(6, dtype=np.int32).reshape(3, 2, 1)            # P = 1
    (jp, js), (tp, ts) = j.serve_batch(idx), t.serve_batch(idx)
    assert tp.shape == (3, 2, 8) and len(ts) == 3
    assert _mismatches(j, t, (jp, _per_query(js)), (tp, _per_query(ts)), idx) == []
    with pytest.raises(ValueError):
        t.serve_batch(np.zeros((1, 3, 2), np.int32))   # table mismatch
    with pytest.raises(ValueError):
        t.serve_batch(np.full((1, 2, 2), 99, np.int32))  # out of range
    with pytest.raises(ValueError):
        t.serve_batch(np.zeros((2, 2), np.int32))        # not [B, T, P]
    # padded positions may hold garbage
    idx = np.full((1, 2, 2), -7, np.int32)
    valid = np.zeros((1, 2, 2), bool)
    idx[0, 0, 0], valid[0, 0, 0] = 15, True
    pooled, stats = t.serve_batch(idx, valid=valid)
    assert stats[0].sm_ios == 1 and not pooled[0, 1].any()


@pytest.mark.parametrize("layout", EMBED_LAYOUTS)
def test_one_shard_matches_single_device_and_reference(layout):
    """A 1-shard engine is the single-device engine: pooled bags exactly
    equal to the port's ``DeviceServingEngine`` and within the tolerance of
    the reference's 1-way ``ShardedServingEngine``; ``sm_ios``,
    ``sm_time_us``, latency and cache state exactly equal to both. At an
    odd ``dim`` both hold rows at the same pitch."""
    for dim in STORE_DIMS:
        _one_shard_case(layout, dim)


def _one_shard_case(layout, dim):
    rows = [40, 64, 24]
    cfg = dict(hbm_cache_bytes=1 << 11, use_kernels=False)
    tables = _tables(np.random.default_rng(1), rows, dim)
    j, t = _pair(tables, 1, layout, **cfg)
    single = teng.DeviceServingEngine(tables, tio.DEVICES["nand_flash"],
                                      teng.EngineConfig(**cfg), torch_device="cpu")
    rng = np.random.default_rng(2)
    for _ in range(2):
        idx = np.stack([rng.integers(0, r, (6, 4)) for r in rows],
                       axis=1).astype(np.int32)
        jp, js = j.serve_batch(idx, bg_iops=5e4)
        tp, ts = t.serve_batch(idx, bg_iops=5e4)
        sp, ss = single.serve_batch(idx, bg_iops=5e4)
        assert _mismatches(j, t, (jp, _per_query(js)), (tp, _per_query(ts)),
                           idx) == []
        np.testing.assert_array_equal(tp, sp)
        assert _per_query(ts) == _per_query(ss)
        for key in STATE_KEYS:
            assert torch.equal(t.state[0][key], single.state[key]), key
    assert t.stats.sm_ios == single.stats.sm_ios and 0.0 < t.hit_rate < 1.0
    for a, b in ((t.payload[0], single.payload), (t.scale[0], single.scale),
                 (t.bias[0], single.bias)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("layout", EMBED_LAYOUTS)
def test_blocked_quantize_gives_the_same_shard_stores(monkeypatch, layout):
    """Each shard's slice quantized in blocks of a few rows, from a first
    row inside the table, is the store of slices quantized at once."""
    tables = _tables(np.random.default_rng(6), [7, 20, 1, 13], 13)
    whole = ShardedServingEngine(tables, tio.DEVICES["nand_flash"],
                                 mesh=make_embed_mesh(3, "cpu"), layout=layout)
    monkeypatch.setattr(teng, "QUANT_BLOCK_ROWS", 3)
    blocked = ShardedServingEngine(tables, tio.DEVICES["nand_flash"],
                                   mesh=make_embed_mesh(3, "cpu"), layout=layout)
    for k in range(3):
        for name in ("payload", "scale", "bias"):
            assert torch.equal(getattr(blocked, name)[k],
                               getattr(whole, name)[k]), (k, name)


@pytest.mark.parametrize("layout", EMBED_LAYOUTS)
def test_fill_over_unique_misses_equals_all_slot_fill(monkeypatch, layout):
    """Through the helper both engines share (``engine.fill_misses``), each
    of 2 shards fills from its unique misses alone: every shard's cache
    state equals the all-slot fill's bit for bit after each call, the
    served results too, and ``fill_rows`` is handed the call's summed
    ``sm_ios`` rows over the shards. The last call all hits: it fills
    nothing and still advances each shard's clock."""
    dim, rows = 13, [40, 64, 24]
    tables = _tables(np.random.default_rng(5), rows, dim)
    cfg = teng.EngineConfig(hbm_cache_bytes=3 * 4 * (dim + 16), ways=4,
                            use_kernels=False)
    rng = np.random.default_rng(6)
    cold = np.stack([rng.integers(0, r, (4, 8)) for r in rows], axis=1)
    warm = np.where(rng.random(cold.shape) < 0.5, cold,
                    np.stack([rng.integers(0, r, (4, 8)) for r in rows], axis=1))
    one, one_valid = np.zeros_like(cold), np.zeros(cold.shape, bool)
    # a row of table 1 the first two calls never touch: one miss, then hits
    one[:2, 1, :3] = min(set(range(rows[1])) - set(cold[:, 1].ravel())
                         - set(warm[:, 1].ravel()))
    one_valid[:2, 1, :3] = True
    calls = [(cold, None), (warm, rng.random(cold.shape) < 0.8),
             (one, one_valid), (one, one_valid)]

    def run(fill):
        with monkeypatch.context() as m:
            m.setattr(teng, "fill_misses", fill)
            seen = spy_fill_rows(m)
            eng = ShardedServingEngine(tables, tio.DEVICES["nand_flash"], cfg,
                                       mesh=make_embed_mesh(2, "cpu"),
                                       layout=layout)
            assert (eng.caches[0].geo.num_sets, eng.caches[0].geo.ways) == (3, 4)
            out = []
            for idx, valid in calls:
                pooled, stats = eng.serve_batch(idx.astype(np.int32), 5e4, valid)
                out.append((pooled, _per_query(stats),
                            [{k: v.clone() for k, v in st.items()}
                             for st in eng.state], seen[-2:]))
        return out

    want, got = run(all_slot_fill), run(teng.fill_misses)
    slots = cold.size
    for (pg, qg, sg, fg), (pw, qw, sw, fw) in zip(got, want):
        np.testing.assert_array_equal(pg, pw)
        assert qg == qw
        for k in range(2):
            for key in STATE_KEYS:
                assert torch.equal(sg[k][key], sw[k][key]), (k, key)
            assert not sg[k]["data"][..., dim:].any()
        assert fw == [slots, slots]
        assert sum(fg) == sum(q[0] for q in qg)
    filled = [sum(f) for *_, f in got]
    assert 2 * 3 * 4 < filled[0] < slots and filled[1] > 0
    assert filled[2:] == [1, 0]
    for k in range(2):
        assert int(got[3][2][k]["clock"]) == int(got[2][2][k]["clock"]) + 2


def test_make_embed_mesh_on_cpu_and_explicit_devices():
    mesh = make_embed_mesh(3, "cpu")
    assert mesh.axis_names == ("shard",) and mesh.shape == {"shard": 3}
    assert mesh.devices == (torch.device("cpu"),) * 3
    assert make_embed_mesh(0, "cpu").shape == {"shard": 1}
    mesh = make_embed_mesh(devices=["cpu", "cpu"])
    assert mesh.shape == {"shard": 2}
    assert make_embed_mesh(1, devices=["cpu", "cpu"]).shape == {"shard": 1}
    with pytest.raises(ValueError):
        make_embed_mesh(3, devices=["cpu", "cpu"])
    with pytest.raises(ValueError):
        make_embed_mesh(-1, "cpu")


def test_no_gpu_raises(monkeypatch):
    """Without a GPU, the default mesh and an engine without a mesh raise
    rather than fall back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_embed_mesh()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_embed_mesh(devices=["cuda:0"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ShardedServingEngine(_tables(np.random.default_rng(0), [8]),
                             tio.DEVICES["nand_flash"])


@pytest.mark.parametrize("layout", EMBED_LAYOUTS)
def test_build_trace_engine_sharded(layout):
    """``build_trace_engine(shards=n)`` shards the same seeded tables as the
    single-device engine: the same oracle pool of a trace chunk."""
    spec = _small_spec(TARCH, "multi_tenant", 16)
    single = serve_dlrm.build_trace_engine(spec, 4, seed=0, torch_device="cpu")
    sharded = serve_dlrm.build_trace_engine(spec, 4, seed=0, torch_device="cpu",
                                            shards=3, layout=layout)
    assert isinstance(sharded, ShardedServingEngine) and sharded.n == 3
    assert sharded.table_ids == single.table_ids
    chunk = next(iter(tbuild(spec).chunks(16))).columnar
    idx, valid = teng.dense_from_chunk(chunk, single.table_slot,
                                       len(single.table_ids))
    np.testing.assert_array_equal(sharded.reference_pool(idx, valid),
                                  single.reference_pool(idx, valid))


def test_serve_dlrm_sharded_cli_on_cpu(capsys):
    serve_dlrm.main(["--device", "cpu", "--archetype", "zipf_steady",
                     "--queries", "48", "--table-bytes", "3e5", "--dim", "16",
                     "--shards", "2", "--layout", "table"])
    out = capsys.readouterr().out
    assert "served 48 zipf_steady queries (batch=32, 2 chunks) over 61 tables" in out
    assert "2 table-layout shards" in out
    assert "p50/p95/p99 latency" in out and "hit rate" in out
    with pytest.raises(SystemExit):
        serve_dlrm.main(["--device", "cpu", "--shards", "2"])
