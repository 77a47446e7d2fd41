"""Port vs reference: the kernels' plain versions and dispatch
(``repro_torch.kernels``) against the Pallas kernels in interpret mode and
their jnp oracles (``repro.kernels``), on the cases of
``tests/test_kernels.py``. On the CPU the port's wrappers take the plain
version and launch nothing; the CUDA kernels themselves are held against the
plain versions on the card (``tests/test_torch_cuda.py``, ``chip_smoke.py``)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.cache_probe import cache_probe as jax_cache_probe
from repro.kernels.gather_pool import gather_pool as jax_gather_pool
from repro_torch.kernels import build, ops, ref
from repro_torch.kernels import cache_probe as cp_module
from repro_torch.kernels import gather_pool as gp_module
from repro_torch.kernels.cache_probe import cache_probe
from repro_torch.kernels.gather_pool import gather_pool

RNG = np.random.default_rng(42)
GATHER_TOL = dict(rtol=1e-5, atol=1e-4)           # tests/test_kernels.py:34


def _gather_inputs(R, D, N, P, dtype):
    lo, hi = (0, 255) if dtype == np.uint8 else (-127, 127)
    return (RNG.integers(lo, hi, (R, D)).astype(dtype),
            (RNG.random(R) * 0.1).astype(np.float32),
            RNG.standard_normal(R).astype(np.float32),
            RNG.integers(0, R, (N, P)).astype(np.int32))


def _torch(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


@pytest.fixture(autouse=True)
def _no_launches():
    ops.reset_launch_counts()
    yield
    assert ops.launch_counts() == {"gather_pool": 0, "cache_probe": 0,
                                   "flash_decode": 0, "densify": 0}


# ---------------------------------------------------------------------------
# gather_pool
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("R,D,N,P", [
    (16, 8, 1, 1), (64, 128, 8, 5), (128, 96, 4, 20), (1000, 64, 16, 3),
])
@pytest.mark.parametrize("dtype", [np.uint8, np.int8])
def test_gather_pool_matches_pallas(R, D, N, P, dtype):
    arrays = _gather_inputs(R, D, N, P, dtype)
    want = jax_gather_pool(*[jnp.asarray(a) for a in arrays], interpret=True)
    got = ops.embedding_gather_pool(*_torch(*arrays))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **GATHER_TOL)
    np.testing.assert_allclose(
        ref.gather_pool_ref(*_torch(*arrays)).numpy(),
        np.asarray(jref.gather_pool_ref(*[jnp.asarray(a) for a in arrays])),
        **GATHER_TOL)


def test_gather_pool_duplicate_indices():
    payload = RNG.integers(0, 255, (8, 16)).astype(np.uint8)
    scale, bias = np.ones(8, np.float32), np.zeros(8, np.float32)
    idx = np.array([[3, 3, 3, 3]], np.int32)
    want = jax_gather_pool(*map(jnp.asarray, (payload, scale, bias, idx)),
                           interpret=True)
    got = ops.embedding_gather_pool(*_torch(payload, scale, bias, idx))
    np.testing.assert_allclose(got.numpy()[0], 4.0 * payload[3], rtol=1e-6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)


def test_gather_pool_d96_no_lane_padding():
    # the reference pads D to 128 lanes and slices back; the port has no pad
    arrays = _gather_inputs(32, 96, 4, 6, np.uint8)
    want = jops.embedding_gather_pool(*map(jnp.asarray, arrays))
    got = ops.embedding_gather_pool(*_torch(*arrays))
    assert tuple(got.shape) == (4, 96)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **GATHER_TOL)


def test_gather_pool_use_kernel_false_is_plain():
    arrays = _torch(*_gather_inputs(50, 24, 7, 3, np.int8))
    np.testing.assert_array_equal(
        ops.embedding_gather_pool(*arrays, use_kernel=False).numpy(),
        ref.gather_pool_ref(*arrays).numpy())


# ---------------------------------------------------------------------------
# cache_probe
# ---------------------------------------------------------------------------


def _probe_both(tt, tr, data, qt, qr, sets):
    want_v, want_h = jax_cache_probe(*map(jnp.asarray, (tt, tr, data, qt, qr, sets)),
                                     interpret=True)
    got_v, got_h = ops.row_cache_probe(*_torch(tt, tr, data, qt, qr, sets))
    assert got_h.dtype == torch.int32
    np.testing.assert_array_equal(got_h.numpy(), np.asarray(want_h))
    np.testing.assert_allclose(got_v.numpy(), np.asarray(want_v), rtol=1e-6)
    return got_v.numpy(), got_h.numpy()


@pytest.mark.parametrize("S,W,D,N", [(4, 2, 8, 4), (16, 4, 64, 16), (64, 8, 128, 9)])
def test_cache_probe_matches_pallas(S, W, D, N):
    _probe_both(RNG.integers(0, 4, (S, W)).astype(np.int32),
                RNG.integers(0, 64, (S, W)).astype(np.int32),
                RNG.standard_normal((S, W, D)).astype(np.float32),
                RNG.integers(0, 4, (N,)).astype(np.int32),
                RNG.integers(0, 64, (N,)).astype(np.int32),
                RNG.integers(0, S, (N,)).astype(np.int32))


def test_cache_probe_guaranteed_hit_and_miss():
    tt = np.full((2, 2), -1, np.int32)
    tr = np.full((2, 2), -1, np.int32)
    tt[1, 0], tr[1, 0] = 7, 42
    data = np.arange(16, dtype=np.float32).reshape(2, 2, 4)
    v, h = _probe_both(tt, tr, data, np.array([7, 7], np.int32),
                       np.array([42, 43], np.int32), np.array([1, 1], np.int32))
    assert h.tolist() == [1, 0]
    np.testing.assert_array_equal(v[0], data[1, 0])
    np.testing.assert_array_equal(v[1], 0.0)


def test_cache_probe_sums_two_matching_ways():
    tt = np.full((3, 4), -1, np.int32)
    tr = np.full((3, 4), -1, np.int32)
    tt[2, [1, 3]] = 5
    tr[2, [1, 3]] = 9
    data = RNG.standard_normal((3, 4, 6)).astype(np.float32)
    v, h = _probe_both(tt, tr, data, np.array([5, 5], np.int32),
                       np.array([9, 9], np.int32), np.array([2, 0], np.int32))
    assert h.tolist() == [1, 0]
    np.testing.assert_allclose(v[0], data[2, 1] + data[2, 3], rtol=1e-6)


# ---------------------------------------------------------------------------
# the CUDA wrappers refuse what their kernels do not take
# ---------------------------------------------------------------------------


def test_gather_pool_wrapper_rejects_bad_operands():
    payload, scale, bias, idx = _torch(*_gather_inputs(10, 8, 2, 3, np.uint8))
    with pytest.raises(ValueError, match="CUDA"):
        gather_pool(payload, scale, bias, idx)                  # CPU tensors
    with pytest.raises(TypeError):
        gather_pool(payload.float(), scale, bias, idx)
    with pytest.raises(TypeError):
        gather_pool(payload, scale.double(), bias, idx)
    with pytest.raises(TypeError):
        gather_pool(payload, scale, bias, idx.long())
    with pytest.raises(ValueError):
        gather_pool(payload, scale[:5], bias, idx)
    with pytest.raises(ValueError):
        gather_pool(payload.t(), scale, bias, idx)              # not [R, D]
    with pytest.raises(ValueError, match="contiguous"):
        gather_pool(payload[:, ::2], scale, bias, idx)


def test_cache_probe_wrapper_rejects_bad_operands():
    S, W, D, N = 4, 2, 8, 3
    tt, tr, data, qt, qr, sets = _torch(
        np.zeros((S, W), np.int32), np.zeros((S, W), np.int32),
        np.zeros((S, W, D), np.float32), np.zeros(N, np.int32),
        np.zeros(N, np.int32), np.zeros(N, np.int32))
    with pytest.raises(ValueError, match="CUDA"):
        cache_probe(tt, tr, data, qt, qr, sets)
    with pytest.raises(TypeError):
        cache_probe(tt, tr, data.double(), qt, qr, sets)
    with pytest.raises(TypeError):
        cache_probe(tt, tr, data, qt.long(), qr, sets)
    with pytest.raises(ValueError):
        cache_probe(tt[:2], tr, data, qt, qr, sets)
    with pytest.raises(ValueError):
        cache_probe(tt, tr, data, qt, qr[:2], sets)
    wide = torch.zeros((S, 33), dtype=torch.int32)
    with pytest.raises(ValueError, match="ways"):
        cache_probe(wide, wide, torch.zeros((S, 33, D)), qt, qr, sets)


def _densify_inputs():
    """Two queries over 3 tables: row 1 (query 0, slot 1) and row 3 (query 1,
    slot 0) hold bags of 2 and 3 keys, the rest none."""
    values = torch.tensor([5, 6, 7, 8, 9], dtype=torch.int64)
    row_seg = torch.tensor([-1, 0, -1, 1, -1, -1], dtype=torch.int32)
    offsets = torch.tensor([0, 2, 5], dtype=torch.int32)
    rows = torch.tensor([10, 7, 10], dtype=torch.int64)
    return values, row_seg, offsets, rows


def test_densify_wrapper_rejects_bad_operands():
    from repro_torch.kernels.densify import densify
    values, row_seg, offsets, rows = _densify_inputs()
    with pytest.raises(ValueError, match="CUDA"):
        densify(values, row_seg, offsets, rows, 4)               # CPU tensors
    with pytest.raises(TypeError):
        densify(values.to(torch.int16), row_seg, offsets, rows, 4)
    with pytest.raises(TypeError, match="int64"):
        densify(values.int(), row_seg, offsets, rows, 4)          # one key width
    with pytest.raises(TypeError):
        densify(values, row_seg.long(), offsets, rows, 4)
    with pytest.raises(TypeError):
        densify(values, row_seg, offsets, rows.int(), 4)
    with pytest.raises(ValueError, match="power of two"):
        densify(values, row_seg, offsets, rows, 3)
    with pytest.raises(ValueError):
        densify(values.view(5, 1), row_seg, offsets, rows, 4)


def test_densify_plain_version_and_operator_on_the_cpu():
    """The operator on CPU tensors is the plain version: each bag a prefix
    of its row, the block's other slots zero and False, and the keys at or
    past their table's rows counted; the fake implementation gives the
    shapes and dtypes alone."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    args = _densify_inputs()
    idx, valid, bad = ops.csr_densify(*args, 4)
    want = torch.zeros((6, 4), dtype=torch.int32)
    want[1, :2] = torch.tensor([5, 6])
    want[3, :3] = torch.tensor([7, 8, 9])
    assert torch.equal(idx, want) and torch.equal(valid, want != 0)
    assert bad.dtype == torch.int32 and bad.shape == () and int(bad) == 0
    rows = args[3].clone()
    rows[0] = 8                                    # slot 0 (row 3) holds 7, 8, 9
    assert int(ops.csr_densify(*args[:3], rows, 4)[2]) == 2
    for got, plain in zip(ops.csr_densify(*args, 4),
                          ops.csr_densify(*args, 4, use_kernel=False)):
        assert torch.equal(got, plain)
    with FakeTensorMode() as mode:
        fake = [mode.from_tensor(a) for a in args]
        f_idx, f_valid, f_bad = torch.ops.repro_torch.densify(*fake, 8)
    assert (f_idx.shape, f_idx.dtype) == ((6, 8), torch.int32)
    assert (f_valid.shape, f_valid.dtype) == ((6, 8), torch.bool)
    assert (f_bad.shape, f_bad.dtype) == ((), torch.int32)


# what each kernel's source names as the reference code it replaces: a Pallas
# kernel, or for ``densify`` the reference's host densify
REPLACES = {"gather_pool": "src/repro/kernels/gather_pool.py",
            "cache_probe": "src/repro/kernels/cache_probe.py",
            "flash_decode": "src/repro/kernels/flash_decode.py",
            "densify": "src/repro/runtime/engine.py"}


def test_build_targets_hopper_from_checkout_sources():
    assert "arch=compute_90a,code=sm_90a" in build.NVCC_FLAGS
    assert set(build.KERNELS) == set(REPLACES)
    for name in build.KERNELS:
        assert (build.CSRC / f"{name}.cu").exists()
        path = build.library_path(name)
        assert path.parent == build.BUILD_DIR and path.suffix == ".so"
        assert path == build.library_path(name)     # keyed on content only
        text = (build.CSRC / f"{name}.cu").read_text()
        assert REPLACES[name] in text               # names what it replaces


# ---------------------------------------------------------------------------
# the launch plans the wrappers hand their kernels (plain Python, no device)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("D", [1, 3, 16, 24, 64, 96, 128, 164])
@pytest.mark.parametrize("offset,align", [(0, 16), (1, 1), (2, 2), (4, 4), (8, 8), (24, 8)])
def test_gather_pool_plan_vector_width(D, offset, align):
    base = (1 << 20) + offset
    plan = gp_module.launch_plan(D, 1, base, 256, 8)
    widest = max(v for v in (1, 2, 4, 8, 16) if D % v == 0)
    assert plan.vec == min(widest, align)
    assert D % plan.vec == 0 and base % plan.vec == 0
    # the bag's warps cover the row, each at most 128 bytes in 32 vectors,
    # and the last warp holds part of it
    cols = min(32, gp_module.SLICE_BYTES // plan.vec)
    per_warp = -(-(D // plan.vec) // plan.warps_per_bag)
    assert per_warp <= cols
    assert per_warp * (plan.warps_per_bag - 1) < D // plan.vec


@pytest.mark.parametrize("P,chunks", [(0, 0), (1, 1), (8, 1), (32, 1), (33, 2),
                                      (42, 2), (64, 2), (65, 3)])
def test_gather_pool_plan_splits_indices_into_chunks(P, chunks):
    assert gp_module.launch_plan(128, 1, 0, 7808, P).chunks == chunks


@pytest.mark.parametrize("D,N,P,plan", [
    (64, 256, 8, (16, 1, 1, 1)),         # the serving path: 256 one-warp blocks
    (128, 7808, 42, (16, 4, 1, 2)),      # m1_batch: 1,952 blocks of 4 bags
    (128, 528, 42, (16, 2, 1, 2)),       # 264 blocks of 2 bags
    (164, 7808, 42, (4, 2, 2, 2)),       # a 164-byte row: two warps a bag
    (2048, 7808, 8, (16, 1, 16, 1)),     # 2 KB rows: a bag spans four 4-warp blocks
])
def test_gather_pool_plan_blocks(D, N, P, plan):
    got = gp_module.launch_plan(D, 1, 0, N, P)
    assert tuple(got) == plan
    assert (got.bags_per_block * got.warps_per_bag <= gp_module.MAX_WARPS
            or got.bags_per_block == 1)
    assert -(-N // got.bags_per_block) >= gp_module.MIN_BLOCKS or got.bags_per_block == 1


@pytest.mark.parametrize("W", [1, 2, 4, 8, 16, 32])
def test_cache_probe_plan_queries_per_warp(W):
    big = cp_module.launch_plan(W, 128, 327_936)
    assert big == (32, 32 // W, 4)
    path = cp_module.launch_plan(W, 64, 2048)
    assert path.probes_at_once == 32 // W
    assert path.probes_at_once <= path.queries_per_warp <= 32
    warps = -(-2048 // path.queries_per_warp)
    assert warps >= cp_module.MIN_WARPS or path.queries_per_warp == path.probes_at_once


@pytest.mark.parametrize("W,at_once", [(0, 32), (3, 8), (5, 4), (9, 2), (17, 1)])
def test_cache_probe_plan_rounds_ways_up(W, at_once):
    assert cp_module.launch_plan(W, 64, 1 << 20).probes_at_once == at_once


@pytest.mark.parametrize("D,base,vec", [(128, 0, 4), (24, 0, 4), (6, 0, 2), (1, 0, 1),
                                        (64, 8, 2), (64, 4, 1), (0, 0, 4)])
def test_cache_probe_plan_vector_width(D, base, vec):
    assert cp_module.launch_plan(8, D, 2048, base).vec == vec


def test_cache_probe_plan_refuses_33_ways():
    with pytest.raises(ValueError, match="ways"):
        cp_module.launch_plan(33, 64, 2048)
