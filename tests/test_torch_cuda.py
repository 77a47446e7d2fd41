"""The port's CUDA kernels, serving engine and LM decode on the card,
against their plain PyTorch versions and the same run on the CPU. Marked
``cuda``: each test skips when no GPU is present. Run on a GPU machine with
``PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py``."""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import serve_lm
from repro_torch.configs import get_config
from repro_torch.core.io_sim import DEVICES
from repro_torch.kernels import build, ops, ref
from repro_torch.kernels import flash_decode as fd
from repro_torch.kernels import gather_pool as gp_module
from repro_torch.kernels.cache_probe import cache_probe
from repro_torch.kernels.flash_decode import flash_decode
from repro_torch.kernels.gather_pool import gather_pool
from repro_torch.launch import make_embed_mesh
from repro_torch.models.transformer import init_cache
from repro_torch.runtime.engine import (DeviceServingEngine, EngineConfig,
                                        dense_from_chunk)
from repro_torch.runtime.sharded_engine import ShardedServingEngine
from repro_torch.workloads import ARCHETYPES, build_trace

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("D", [8, 24, 64, 96])
@pytest.mark.parametrize("dtype", [np.uint8, np.int8])
def test_gather_pool_kernel_matches_plain(cuda, D, dtype):
    rng = np.random.default_rng(D)
    R, N, P = 1000, 37, 9
    lo, hi = (0, 256) if dtype == np.uint8 else (-127, 128)
    args = [torch.from_numpy(a).to(cuda) for a in (
        rng.integers(lo, hi, (R, D)).astype(dtype),
        rng.random(R).astype(np.float32),
        rng.standard_normal(R).astype(np.float32),
        rng.integers(0, R, (N, P)).astype(np.int32))]
    got = gather_pool(*args)
    torch.testing.assert_close(got, ref.gather_pool_ref(*args),
                               rtol=1e-5, atol=1e-4)


def test_cache_probe_kernel_matches_plain(cuda):
    rng = np.random.default_rng(1)
    S, W, D, N = 16, 8, 24, 200
    tt = rng.integers(0, 3, (S, W)).astype(np.int32)
    tr = rng.integers(0, 20, (S, W)).astype(np.int32)
    args = [torch.from_numpy(a).to(cuda) for a in (
        tt, tr, rng.standard_normal((S, W, D)).astype(np.float32),
        rng.integers(0, 3, N).astype(np.int32),
        rng.integers(0, 20, N).astype(np.int32),
        rng.integers(0, S, N).astype(np.int32))]
    vals, hit = cache_probe(*args)
    vals_ref, hit_ref = ref.cache_probe_ref(*args)
    assert torch.equal(hit, hit_ref) and int(hit.sum()) > 0
    torch.testing.assert_close(vals, vals_ref, rtol=0.0, atol=1e-6)


def _gather_args(cuda, R, D, N, P, dtype, seed, payload=None):
    g = torch.Generator(device=cuda).manual_seed(seed)
    lo, hi = (0, 256) if dtype == torch.uint8 else (-128, 128)
    if payload is None:
        payload = torch.empty((R, D), dtype=dtype, device=cuda)
    payload.copy_(torch.randint(lo, hi, (R, D), generator=g, device=cuda).to(dtype))
    return (payload, torch.rand(R, generator=g, device=cuda),
            torch.randn(R, generator=g, device=cuda),
            torch.randint(0, R, (N, P), generator=g, device=cuda, dtype=torch.int32))


def _in_order(payload, scale, bias, idx):
    """The plain ops in the kernel's order: acc = acc + (q * s + b) over p."""
    acc = torch.zeros((idx.shape[0], payload.shape[1]), device=payload.device)
    for p in range(idx.shape[1]):
        i = idx[:, p].long()
        acc = acc + (payload[i].float() * scale[i][:, None] + bias[i][:, None])
    return acc


@pytest.mark.parametrize("D", [1, 3, 16, 24, 64, 96, 128, 164])
@pytest.mark.parametrize("dtype", [torch.uint8, torch.int8])
@pytest.mark.parametrize("P", [0, 1, 8, 33, 42])
def test_gather_pool_kernel_is_the_in_order_sum(cuda, D, dtype, P):
    args = _gather_args(cuda, 500, D, 37, P, dtype, D * 100 + P)
    got = gather_pool(*args)
    assert torch.equal(got, _in_order(*args))
    torch.testing.assert_close(got, ref.gather_pool_ref(*args), rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("D", [16, 64, 128, 164])
def test_gather_pool_kernel_misaligned_store(cuda, D):
    R = 300
    payload = torch.empty(R * D + 1, dtype=torch.uint8, device=cuda)[1:].view(R, D)
    args = _gather_args(cuda, R, D, 50, 42, torch.uint8, D, payload=payload)
    assert gp_module.launch_plan(D, 1, payload.data_ptr(), 50, 42).vec == 1
    assert torch.equal(gather_pool(*args), _in_order(*args))


@pytest.mark.parametrize("D", [64, 2048])
def test_gather_pool_kernel_ragged_last_block(cuda, D):
    """N = 2,117 bags: four-bag blocks at D 64, the last one holding one;
    at D 2,048 a bag's 16 warps span four blocks."""
    args = _gather_args(cuda, 4000, D, 2117, 9, torch.int8, 7)
    plan = gp_module.launch_plan(D, 1, args[0].data_ptr(), 2117, 9)
    assert (plan.bags_per_block, plan.warps_per_bag) == ((4, 1) if D == 64 else (1, 16))
    assert torch.equal(gather_pool(*args), _in_order(*args))


def _probe_args(cuda, S, W, D, N, seed, hit_share=0.5, empty_share=0.1):
    g = torch.Generator(device=cuda).manual_seed(seed)

    def ints(lo, hi, shape):
        return torch.randint(lo, hi, shape, generator=g, device=cuda, dtype=torch.int32)
    tt, tr = ints(0, 4, (S, W)), ints(0, 1000, (S, W))
    tt[torch.rand((S, W), generator=g, device=cuda) < empty_share] = -1
    data = torch.randn((S, W, D), generator=g, device=cuda)
    sets, way = ints(0, S, (N,)), ints(0, W, (N,)).long()
    qt, qr = ints(0, 4, (N,)), ints(1000, 2000, (N,))
    hit = torch.rand(N, generator=g, device=cuda) < hit_share
    slot = (sets.long()[hit], way[hit])
    qt[hit], qr[hit] = tt[slot], tr[slot]
    return tt, tr, data, qt, qr, sets


def _probe_matches_plain(args):
    vals, hit = cache_probe(*args)
    vals_ref, hit_ref = ref.cache_probe_ref(*args)
    assert torch.equal(hit, hit_ref)
    torch.testing.assert_close(vals, vals_ref, rtol=0.0, atol=1e-6)
    return vals, hit


@pytest.mark.parametrize("W", [1, 2, 4, 8, 16, 32])
@pytest.mark.parametrize("D", [1, 24, 64, 128])
@pytest.mark.parametrize("N", [1, 31, 33, 2048])
def test_cache_probe_kernel_shapes(cuda, W, D, N):
    _probe_matches_plain(_probe_args(cuda, 64, W, D, N, W * 1000 + D * 10 + N))


@pytest.mark.parametrize("hit_share,want", [(1.0, 1), (0.0, 0)])
def test_cache_probe_kernel_all_hit_all_miss(cuda, hit_share, want):
    vals, hit = _probe_matches_plain(_probe_args(cuda, 64, 8, 64, 300, 3, hit_share, 0.0))
    assert bool((hit == want).all())
    if not want:
        assert not vals.any()


def test_cache_probe_kernel_sums_two_matching_ways(cuda):
    tt = torch.full((3, 4), -1, dtype=torch.int32, device=cuda)
    tr = torch.full((3, 4), -1, dtype=torch.int32, device=cuda)
    tt[2, [1, 3]], tr[2, [1, 3]] = 5, 9
    data = torch.randn((3, 4, 24), device=cuda)
    q = torch.tensor([5, 5, 5], dtype=torch.int32, device=cuda)
    r = torch.tensor([9, 9, 9], dtype=torch.int32, device=cuda)
    sets = torch.tensor([2, 0, 2], dtype=torch.int32, device=cuda)
    vals, hit = _probe_matches_plain((tt, tr, data, q, r, sets))
    assert hit.tolist() == [1, 0, 1]
    assert torch.equal(vals[0], data[2, 1] + data[2, 3]) and not vals[1].any()


def test_engine_on_card_matches_cpu(cuda):
    rng = np.random.default_rng(2)
    tables = {t: rng.standard_normal((300, 24)).astype(np.float32)
              for t in range(3)}
    cfg = EngineConfig(hbm_cache_bytes=1 << 13)
    card = DeviceServingEngine(tables, DEVICES["nand_flash"], cfg,
                               torch_device=cuda)
    host = DeviceServingEngine(tables, DEVICES["nand_flash"], cfg,
                               torch_device="cpu")
    ops.reset_launch_counts()
    for _ in range(3):
        idx = rng.integers(0, 300, (8, 3, 8)).astype(np.int32)
        valid = rng.random(idx.shape) < 0.9
        pc, sc = card.serve_batch(idx, 1e4, valid=valid)
        ph, sh = host.serve_batch(idx, 1e4, valid=valid)
        assert [s.sm_ios for s in sc] == [s.sm_ios for s in sh]
        assert [s.latency_us for s in sc] == [s.latency_us for s in sh]
        np.testing.assert_allclose(pc, ph, atol=1e-5)
    counts = ops.launch_counts()
    assert counts["gather_pool"] == counts["cache_probe"] == 3
    for k, v in card.state.items():
        assert torch.equal(v.cpu(), host.state[k]), k


def _decode_inputs(cuda, B, H, K, hd, S, qdt, kvdt, seed):
    """Seeded q/k/v; kv_len random per row, rows 0-3 at 0, 1, S and S + 5."""
    g = torch.Generator(device=cuda).manual_seed(seed)
    q = torch.randn((B, H, hd), generator=g, device=cuda).to(qdt)
    k = torch.randn((B, S, K, hd), generator=g, device=cuda).to(kvdt)
    v = torch.randn((B, S, K, hd), generator=g, device=cuda).to(kvdt)
    lens = torch.randint(0, S + 3, (B,), generator=g, device=cuda)
    lens[: min(B, 4)] = torch.tensor([0, 1, S, S + 5], device=cuda)[: min(B, 4)]
    return q, k, v, lens.to(torch.int32)


@pytest.mark.parametrize("B,H,K,hd,S", [
    (1, 4, 4, 32, 512), (2, 8, 2, 64, 1024), (2, 16, 1, 128, 512),   # G 1, 4, 16
    (8, 9, 3, 64, 1024), (4, 6, 2, 16, 77),            # G = 3; ragged S
    (5, 32, 8, 64, 300),                               # granite-3-2b: G 4
    (4, 48, 1, 128, 1000),                             # granite-34b: G 48
    (3, 20, 2, 40, 129), (4, 9, 1, 24, 200),           # lanes padded to 8, 4
    (180, 9, 3, 64, 150),                              # B*K fills the card: 1 split
])
@pytest.mark.parametrize("qdt,kvdt", [(torch.float32, torch.float32),
                                      (torch.float32, torch.bfloat16),
                                      (torch.bfloat16, torch.float32),
                                      (torch.bfloat16, torch.bfloat16)])
def test_flash_decode_kernel_matches_plain(cuda, B, H, K, hd, S, qdt, kvdt):
    q, k, v, kv_len = _decode_inputs(cuda, B, H, K, hd, S, qdt, kvdt, S + hd)
    got = flash_decode(q, k, v, kv_len)
    tol = 2e-2 if torch.bfloat16 in (qdt, kvdt) else 1e-5
    torch.testing.assert_close(got, ref.flash_decode_ref(q, k, v, kv_len),
                               rtol=tol, atol=tol)


def test_flash_decode_counters_reset_between_calls(cuda):
    """Three calls back to back on one stream, with different split counts
    (8, 16, 6 on 132 SMs) and B*K, each held to the plain version: a counter
    left nonzero by one would make a later row merge too early or never
    write out."""
    shapes = [(6, 9, 3, 64, 2048), (2, 8, 2, 64, 4096), (30, 9, 3, 64, 2048)]
    calls = []
    for i, (B, H, K, hd, S) in enumerate(shapes):
        q, k, v, kv_len = _decode_inputs(cuda, B, H, K, hd, S, torch.float32,
                                         torch.float32, i)
        calls.append(((q, k, v, kv_len), flash_decode(q, k, v, kv_len)))
    for args, got in calls:
        torch.testing.assert_close(got, ref.flash_decode_ref(*args), rtol=1e-5, atol=1e-5)
    for buf in fd._COUNTERS.values():
        assert not buf.any()


def test_flash_decode_rules_match_the_kernel(cuda):
    q, k, v, kv_len = _decode_inputs(cuda, 1, 2, 1, 16, 8, torch.float32,
                                     torch.float32, 0)
    flash_decode(q, k, v, kv_len)
    lib = build.load("flash_decode", fd._SIGNATURES)
    for hd in range(16, 129, 8):
        assert lib.flash_decode_tile_positions(hd) == fd.tile_positions(hd)
        assert lib.flash_decode_smem_bytes(fd.MAX_HEADS, hd, 4) <= fd.MAX_SMEM_BYTES


def test_lm_decode_on_card_matches_cpu(cuda):
    cfg = get_config("smollm-135m").reduced()
    tokens = torch.from_numpy(serve_lm.make_tokens(cfg, batch=3, tokens=20, seed=5))
    card = serve_lm.build(cfg, seed=1, torch_device=cuda)
    host = serve_lm.build(cfg, seed=1, torch_device="cpu")
    ops.reset_launch_counts()
    got = serve_lm.decode(card, init_cache(cfg, 3, 37, dtype=torch.float32, device=cuda),
                          tokens.to(cuda))
    assert ops.launch_counts()["flash_decode"] == cfg.num_layers * 20
    want = serve_lm.decode(host, init_cache(cfg, 3, 37, dtype=torch.float32, device="cpu"),
                           tokens)
    torch.testing.assert_close(got.cpu(), want, rtol=0, atol=1e-4)


@pytest.mark.parametrize("name,P", [("zipf_steady", 64), ("diurnal", 128)])
def test_serve_columnar_on_card_matches_cpu(cuda, name, P):
    """A small archetype trace (3 user tables of the M1 statistics, 3e5 bytes)
    served chunk by chunk on the card and on the CPU: ``sm_ios``,
    ``sm_time_us``, hit rate and cache state equal, pooled within the
    reference's columnar tolerance. The diurnal trace's pooling mix pads P to
    128, two of ``gather_pool``'s 64-row tiles."""
    spec = ARCHETYPES[name]
    spec = dataclasses.replace(spec, num_queries=48, tenants=tuple(
        dataclasses.replace(t, table_bytes=3e5, num_user_tables=3,
                            num_item_tables=1) for t in spec.tenants))
    trace = build_trace(spec)
    rng = np.random.default_rng(4)
    tables = {m.table_id: rng.standard_normal((m.num_rows, 32)).astype(np.float32)
              for m in trace.all_metas() if m.kind == "user"}
    cfg = EngineConfig(hbm_cache_bytes=1 << 14)
    card = DeviceServingEngine(tables, DEVICES["nand_flash"], cfg, torch_device=cuda)
    host = DeviceServingEngine(tables, DEVICES["nand_flash"], cfg, torch_device="cpu")
    ops.reset_launch_counts()
    chunks = list(trace.chunks(16))
    for ch in chunks:
        idx, valid = dense_from_chunk(ch.columnar, card.table_slot, 3)
        assert idx.shape == (16, 3, P)
        pc, tc, ic = card.serve_columnar(ch.columnar, 1e4)
        ph, th, ih = host.serve_columnar(ch.columnar, 1e4)
        np.testing.assert_array_equal(ic, ih)
        np.testing.assert_array_equal(tc, th)
        np.testing.assert_allclose(pc, ph, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(pc, card.reference_pool(idx, valid),
                                   rtol=1e-5, atol=1e-5)
    counts = ops.launch_counts()
    assert counts["gather_pool"] == counts["cache_probe"] == len(chunks)
    assert card.hit_rate == host.hit_rate and 0.0 < card.hit_rate < 1.0
    for k, v in card.state.items():
        assert torch.equal(v.cpu(), host.state[k]), k


@pytest.mark.parametrize("layout", ["row", "table"])
def test_sharded_engine_kernels_match_plain_on_card(cuda, layout):
    """Four shards sharing the card, a small archetype trace: the kernel
    engine launches each kernel once a shard a batch and equals the plain
    engine in ``sm_ios``, ``sm_time_us`` and each shard's cache state;
    pooled within the reference's columnar tolerance of each other and of
    ``reference_pool``."""
    spec = ARCHETYPES["zipf_steady"]
    spec = dataclasses.replace(spec, num_queries=48, tenants=tuple(
        dataclasses.replace(t, table_bytes=3e5, num_user_tables=3,
                            num_item_tables=1) for t in spec.tenants))
    trace = build_trace(spec)
    rng = np.random.default_rng(5)
    tables = {m.table_id: rng.standard_normal((m.num_rows, 32)).astype(np.float32)
              for m in trace.all_metas() if m.kind == "user"}
    mesh = make_embed_mesh(devices=[cuda] * 4)
    kern, plain = (ShardedServingEngine(
        tables, DEVICES["nand_flash"],
        EngineConfig(hbm_cache_bytes=1 << 14, use_kernels=use), mesh=mesh,
        layout=layout) for use in (True, False))
    ops.reset_launch_counts()
    chunks = list(trace.chunks(16))
    for ch in chunks:
        pk, tk, ik = kern.serve_columnar(ch.columnar, 1e4)
        pp, tp, ip = plain.serve_columnar(ch.columnar, 1e4)
        np.testing.assert_array_equal(ik, ip)
        np.testing.assert_array_equal(tk, tp)
        idx, valid = dense_from_chunk(ch.columnar, kern.table_slot, 3)
        np.testing.assert_allclose(pk, pp, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(pk, kern.reference_pool(idx, valid),
                                   rtol=1e-5, atol=1e-5)
    counts = ops.launch_counts()
    assert counts["gather_pool"] == counts["cache_probe"] == 4 * len(chunks)
    assert kern.hit_rate == plain.hit_rate and 0.0 < kern.hit_rate < 1.0
    for k in range(4):
        for key, v in kern.state[k].items():
            assert torch.equal(v, plain.state[k][key]), (k, key)


def test_make_embed_mesh_needs_a_card_per_shard(cuda):
    count = torch.cuda.device_count()
    assert make_embed_mesh().devices == tuple(
        torch.device("cuda", k) for k in range(count))
    with pytest.raises(ValueError):
        make_embed_mesh(count + 1)
    shared = make_embed_mesh(count + 1, devices=["cuda:0"] * (count + 1))
    assert shared.shape == {"shard": count + 1}


@pytest.mark.parametrize("seed", range(4))
def test_cache_probe_path_matches_host_mirror(cuda, seed):
    """The host mirror on the card (``chip_smoke.py`` phase ``host_plane``
    (c) at a small geometry): per-access hit/miss of ``TorchRowCache``
    probing through the ``cache_probe`` kernel equals ``SetAssocSimCache``
    at the device's set index, with heavy set collisions."""
    from test_torch_host_cache import mirror_run, resident_keys
    from repro_torch.core.cache import CacheGeometry
    rng = np.random.default_rng(seed)
    tables = rng.integers(0, 4, 600).astype(np.int32)
    rows = (rng.zipf(1.2, 600) % 300).astype(np.int32)
    ops.reset_launch_counts()
    got, want, state, sim = mirror_run(CacheGeometry(16, 4, 8), tables, rows,
                                       device=cuda)
    assert ops.launch_counts()["cache_probe"] == 600
    assert got == want
    assert (int(state["hits"]), int(state["misses"])) == (sim.hits, sim.misses)
    assert sim.misses > len(np.unique(sim._key(tables, rows)))   # evictions
    np.testing.assert_array_equal(resident_keys(state), sim.tags)


@pytest.mark.parametrize("layout", ["row", "table"])
def test_fleet_device_plane_on_card(cuda, layout):
    """``ClusterSim.run_device_plane`` over three hosts, round robin, the
    last a 2-shard mesh slice with both shards on the card: the kernel
    engines launch each kernel once a chunk a shard and equal the
    ``use_kernels=False`` engines and the same fleet on the CPU in every
    ``HostReport`` field, the fleet percentiles and the merged registry."""
    from repro_torch import serve_dlrm
    spec = ARCHETYPES["zipf_steady"]
    spec = dataclasses.replace(spec, num_queries=96, tenants=tuple(
        dataclasses.replace(t, table_bytes=3e5, num_user_tables=3,
                            num_item_tables=1) for t in spec.tenants))
    trace = build_trace(spec)
    rng = np.random.default_rng(6)
    tables = {m.table_id: rng.standard_normal((m.num_rows, 32)).astype(np.float32)
              for m in trace.all_metas() if m.kind == "user"}

    def run(device, **kw):
        sim = serve_dlrm.build_fleet(3, mesh_host_shards=2, layout=layout,
                                     chunk=16, telemetry=True)
        rep = sim.run_device_plane(trace, tables, torch_device=device,
                                   devices=[device] * 2 if device == cuda
                                   else None, **kw)
        return ([dataclasses.asdict(h) for h in rep.hosts],
                [rep.p50_us, rep.p95_us, rep.p99_us, rep.p999_us],
                rep.telemetry.registry.as_dict())

    ops.reset_launch_counts()
    kern = run(cuda)
    counts = ops.launch_counts()
    assert counts["gather_pool"] == counts["cache_probe"] == 2 + 2 + 2 * 2
    plain = run(cuda, engine_cfg=serve_dlrm.fleet_engine_config(False))
    assert ops.launch_counts() == counts
    assert kern == plain == run("cpu")
    assert [h["mesh_devices"] for h in kern[0]] == [1, 1, 2]
    assert all(0.0 < h["engine_hit_rate"] < 1.0 for h in kern[0])


# ---------------------------------------------------------------------------
# training on the card
# ---------------------------------------------------------------------------

TRAIN_ARCH = dict(user_tables=(400,) * 3, item_tables=(400,) * 2, embed_dim=8,
                  bottom_mlp=(16, 8), top_mlp=(16, 1), pooling=4)


@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "mixtral-8x22b", "mamba2-1.3b",
                                  "zamba2-1.2b"])
def test_lm_family_decode_on_card_matches_cpu(cuda, arch):
    """The MoE, SSM and hybrid families decoded on the card and on the CPU
    from one seed, f32 caches: logits within 1e-4; ``flash_decode`` once a
    full-attention layer (or shared-block call) a step, never on mixtral's
    window or mamba2."""
    from repro_torch.models.transformer import _units
    cfg = get_config(arch).reduced()
    tokens = torch.from_numpy(serve_lm.make_tokens(cfg, batch=3, tokens=20, seed=5))
    card = serve_lm.build(cfg, seed=1, torch_device=cuda)
    host = serve_lm.build(cfg, seed=1, torch_device="cpu")
    calls = 0 if cfg.sliding_window else sum(kind == "attn" for kind, _ in _units(card))
    ops.reset_launch_counts()
    got = serve_lm.decode(card, init_cache(cfg, 3, 37, dtype=torch.float32, device=cuda),
                          tokens.to(cuda))
    assert ops.launch_counts()["flash_decode"] == calls * 20
    want = serve_lm.decode(host, init_cache(cfg, 3, 37, dtype=torch.float32, device="cpu"),
                           tokens)
    torch.testing.assert_close(got.cpu(), want, rtol=0, atol=1e-4)


@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "mixtral-8x22b", "mamba2-1.3b",
                                  "zamba2-1.2b"])
def test_lm_family_train_step_on_card_matches_cpu(cuda, arch):
    from repro_torch import lm_train
    cfg = get_config(arch).reduced()
    losses = []
    for dev in (cuda, "cpu"):
        state, step = lm_train.build(cfg, device=dev)
        _, m = step(state, lm_train.lm_batch(cfg, 2, 32, 0, dev))
        losses.append(float(m["loss"]))
    assert abs(losses[0] - losses[1]) < 1e-4, losses


def _dlrm_trainer(device, ckpt_dir, total=12, failure_hook=None):
    from repro_torch import train_dlrm
    from repro_torch.models.dlrm import DLRMArch
    return train_dlrm.build(DLRMArch(**TRAIN_ARCH), steps=total, batch=16,
                            ckpt_dir=str(ckpt_dir), device=device, ckpt_every=4,
                            failure_hook=failure_hook)


def test_dlrm_train_steps_on_card_match_cpu(cuda, tmp_path):
    """A few ``train_dlrm`` steps (AdamW, cosine schedule) on the card and
    on the CPU from the same seed: every loss within 1e-5, every leaf 1e-5."""
    from repro_torch.tree import leaves
    card = _dlrm_trainer(cuda, tmp_path / "card", total=6)
    cpu = _dlrm_trainer("cpu", tmp_path / "cpu", total=6)
    a, b = card.run(), cpu.run()
    for ma, mb in zip(a["metrics"], b["metrics"]):
        assert abs(ma["loss"] - mb["loss"]) < 1e-5 and \
            abs(ma["grad_norm"] - mb["grad_norm"]) < 1e-5
    for x, y in zip(leaves(card.state), leaves(cpu.state)):
        assert x.device.type == "cuda"
        torch.testing.assert_close(x.cpu(), y, rtol=0, atol=1e-5)


def test_dlrm_crash_resume_bitwise_on_card(cuda, tmp_path):
    """A run killed at step 7 and resumed from its step-4 checkpoint ends
    equal, bit for bit, to an uninterrupted run on the card."""
    from repro_torch.tree import leaves

    class Boom(RuntimeError):
        pass

    def fail(step):
        if step == 7:
            raise Boom()
    with pytest.raises(Boom):
        _dlrm_trainer(cuda, tmp_path / "b", failure_hook=fail).run()
    resumed = _dlrm_trainer(cuda, tmp_path / "b")
    out = resumed.run()
    assert out["metrics"][0]["step"] == 4 and out["final_step"] == 12
    ref = _dlrm_trainer(cuda, tmp_path / "a")
    ref.run()
    for x, y in zip(leaves(resumed.state), leaves(ref.state)):
        assert torch.equal(x, y)
