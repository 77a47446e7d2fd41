"""The port's CUDA kernels and serving engine on the card, against their
plain PyTorch versions and the same engine on the CPU. Marked ``cuda``: each
test skips when no GPU is present. Run on a GPU machine with
``PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py``."""
import numpy as np
import pytest
import torch

from repro_torch.core.io_sim import DEVICES
from repro_torch.kernels import ops, ref
from repro_torch.kernels.cache_probe import cache_probe
from repro_torch.kernels.gather_pool import gather_pool
from repro_torch.runtime.engine import DeviceServingEngine, EngineConfig

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
    assert min(ops.launch_counts().values()) == 3
    for k, v in card.state.items():
        assert torch.equal(v.cpu(), host.state[k]), k
