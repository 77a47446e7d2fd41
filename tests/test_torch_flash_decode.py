"""Port vs reference: ``flash_decode``'s plain version and dispatch
(``repro_torch.kernels``) against the Pallas kernel in interpret mode and its
jnp oracle (``repro.kernels``), on the cases of ``tests/test_kernels.py``
plus G = 3 (smollm-135m's 9 query heads over 3 KV heads). On the CPU the
port's wrapper takes the plain version and launches nothing; the CUDA kernel
itself is held against the plain version on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.flash_decode import flash_decode as jax_flash_decode
from repro.models import layers as jlayers
from repro_torch.kernels import build, ops, ref
from repro_torch.kernels import flash_decode as fd
from repro_torch.kernels.flash_decode import flash_decode, split_count
from repro_torch.models import layers as tlayers

RNG = np.random.default_rng(7)
TOL = {"f32": 1e-5, "bf16": 2e-2}                  # tests/test_kernels.py:124
DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


@pytest.fixture(autouse=True)
def _no_launches():
    ops.reset_launch_counts()
    yield
    assert ops.launch_counts()["flash_decode"] == 0


def _inputs(B, H, K, hd, S, kv_len, dtype):
    """Seeded q/k/v/kv_len as (jax arrays, torch tensors); bf16 is rounded
    the same way (to nearest even) on both sides."""
    jdt, tdt = DTYPES[dtype]
    arrays = [RNG.standard_normal(shape).astype(np.float32)
              for shape in ((B, H, hd), (B, S, K, hd), (B, S, K, hd))]
    kl = np.asarray(kv_len, np.int32)
    jx = [jnp.asarray(a, jdt) for a in arrays] + [jnp.asarray(kl)]
    tx = [torch.from_numpy(a).to(tdt) for a in arrays] + [torch.from_numpy(kl)]
    return jx, tx


@pytest.mark.parametrize("B,H,K,hd,S,blk", [
    (1, 4, 4, 32, 512, 128),   # MHA
    (2, 8, 2, 64, 1024, 256),  # GQA 4:1
    (2, 16, 1, 128, 512, 256),  # MQA
    (3, 9, 3, 64, 512, 128),   # GQA 3:1, smollm-135m's heads
])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_decode_attention_matches_pallas(B, H, K, hd, S, blk, dtype):
    jx, tx = _inputs(B, H, K, hd, S, RNG.integers(1, S + 1, B), dtype)
    want = jax_flash_decode(*jx, block_s=blk, interpret=True)
    got = ops.decode_attention(*tx)
    assert got.dtype == torch.float32 and tuple(got.shape) == (B, H, hd)
    tol = TOL[dtype]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=tol, atol=tol)
    np.testing.assert_allclose(ref.flash_decode_ref(*tx).numpy(),
                               np.asarray(jref.flash_decode_ref(*jx)),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_kv_len_edges(dtype):
    """kv_len 0 (every score -1e30: the plain mean of v over all S), 1, S and
    > S (behaves as S), against the reference's oracle and Pallas kernel."""
    B, H, K, hd, S = 4, 6, 2, 32, 256
    jx, tx = _inputs(B, H, K, hd, S, [0, 1, S, S + 7], dtype)
    got = ops.decode_attention(*tx).numpy()
    tol = TOL[dtype]
    for want in (jref.flash_decode_ref(*jx),
                 jax_flash_decode(*jx, block_s=64, interpret=True)):
        np.testing.assert_allclose(got, np.asarray(want), rtol=tol, atol=tol)
    v = tx[2].to(torch.float32)
    mean_v = v[0].mean(dim=0).repeat_interleave(H // K, dim=0)        # [H, hd]
    np.testing.assert_allclose(got[0], mean_v.numpy(), rtol=1e-5, atol=1e-6)
    last_v = v[1, 0].repeat_interleave(H // K, dim=0)                 # one key
    np.testing.assert_allclose(got[1], last_v.numpy(), rtol=1e-5, atol=1e-6)
    as_s = ref.flash_decode_ref(*(t[3:] for t in tx[:3]),
                                torch.tensor([S], dtype=torch.int32))[0]
    np.testing.assert_allclose(got[3], as_s.numpy(), rtol=1e-6, atol=1e-6)


def test_masked_tail_is_ignored():
    B, H, K, hd, S = 1, 2, 2, 16, 256
    _, (q, k, v, _) = _inputs(B, H, K, hd, S, [10], "f32")
    kl = torch.tensor([10], dtype=torch.int32)
    out = ops.decode_attention(q, k, v, kl)
    k2, v2 = k.clone(), v.clone()
    k2[:, 10:] = 99.0
    v2[:, 10:] = -99.0
    np.testing.assert_allclose(out.numpy(), ops.decode_attention(q, k2, v2, kl).numpy(),
                               rtol=1e-5)


def test_plain_version_matches_model_attention():
    """flash_decode == attention_core for one query token, in the port and
    against the reference's attention_core (tests/test_kernels.py:144)."""
    B, H, K, hd, S, kv_len = 2, 9, 3, 32, 512, 300
    q = RNG.standard_normal((B, 1, H, hd)).astype(np.float32)
    k = RNG.standard_normal((B, S, K, hd)).astype(np.float32)
    v = RNG.standard_normal((B, S, K, hd)).astype(np.float32)
    qpos = np.full((B, 1), kv_len - 1, np.int32)
    kpos = np.broadcast_to(np.arange(S, dtype=np.int32)[None], (B, S)).copy()
    valid = kpos < kv_len
    port = tlayers.attention_core(*map(torch.from_numpy, (q, k, v, qpos, kpos)),
                                  causal=True, kv_valid=torch.from_numpy(valid))
    kern = ops.decode_attention(torch.from_numpy(q[:, 0]), torch.from_numpy(k),
                                torch.from_numpy(v),
                                torch.full((B,), kv_len, dtype=torch.int32))
    np.testing.assert_allclose(port[:, 0].numpy(), kern.numpy(), rtol=2e-5, atol=2e-5)
    want = jlayers.attention_core(*map(jnp.asarray, (q, k, v, qpos, kpos)),
                                  causal=True, kv_valid=jnp.asarray(valid))
    np.testing.assert_allclose(kern.numpy(), np.asarray(want)[:, 0],
                               rtol=2e-5, atol=2e-5)


def test_use_kernel_false_is_plain():
    _, tx = _inputs(2, 4, 2, 16, 40, [5, 40], "bf16")
    np.testing.assert_array_equal(ops.decode_attention(*tx, use_kernel=False).numpy(),
                                  ref.flash_decode_ref(*tx).numpy())


def test_wrapper_rejects_bad_operands():
    _, (q, k, v, kl) = _inputs(2, 4, 2, 16, 40, [5, 40], "f32")
    with pytest.raises(ValueError, match="CUDA"):
        flash_decode(q, k, v, kl)                                   # CPU tensors
    with pytest.raises(TypeError):
        flash_decode(q.double(), k, v, kl)
    with pytest.raises(TypeError):
        flash_decode(q, k, v.to(torch.bfloat16), kl)                # k, v differ
    with pytest.raises(TypeError):
        flash_decode(q, k, v, kl.long())
    with pytest.raises(ValueError):
        flash_decode(q, k[:1], v[:1], kl)                            # B differs
    with pytest.raises(ValueError, match="multiple of K"):
        flash_decode(q[:, :3], k, v, kl)
    with pytest.raises(ValueError, match="head dim"):
        flash_decode(q[..., :12].contiguous(), k[..., :12].contiguous(),
                     v[..., :12].contiguous(), kl)
    with pytest.raises(ValueError, match="contiguous"):
        flash_decode(q, k.transpose(1, 2).contiguous().transpose(1, 2), v, kl)


def test_split_count_fills_the_card():
    sms = 132
    assert split_count(8, 3, 1024, sms) == 4         # serving path: spans of 256
    assert split_count(128, 3, 32_768, sms) == 2     # decode_32k: 768 blocks
    assert split_count(8, 3, 20, sms) == 1           # no split under 256 positions
    assert split_count(8, 3, 600, sms) == 2
    assert split_count(1024, 16, 4096, sms) == 1
    assert split_count(8, 1, 8192, sms, tiles=6) == 11   # granite-34b: 528 blocks


@pytest.mark.parametrize("kv_len,S,n_split,hd,busy", [
    (256, 1024, 4, 64, 1),        # the LM path's longest row: one split, no merge
    (264, 1024, 4, 64, 1),        # no split of a few positions past 256
    (600, 1024, 4, 64, 2),        # two spans of 320 and 280
    (1, 1024, 4, 64, 1),
    (0, 1024, 4, 64, 4),          # kv_len 0 walks all S
    (2000, 1024, 4, 64, 4),       # kv_len > S walks S
    (32_768, 32_768, 2, 64, 2),   # decode_32k
    (600, 1024, 4, 16, 2),        # hd 16: spans of a whole 256-position tile
    (8192, 8192, 11, 128, 11),    # granite-34b: spans of 768 (24 tiles of 32)
    (77, 77, 5, 24, 1),
])
def test_busy_splits_follow_the_walked_length(kv_len, S, n_split, hd, busy):
    assert fd.busy_splits(kv_len, S, n_split, hd) == busy
    assert fd.busy_splits(kv_len, S, n_split, hd) <= n_split


@pytest.mark.parametrize("hd,tile", [(16, 256), (24, 128), (32, 128), (40, 64),
                                     (64, 64), (72, 32), (128, 32)])
def test_tile_positions(hd, tile):
    assert fd.tile_positions(hd) == tile


@pytest.mark.parametrize("G,tiles,heads", [(1, 1, 1), (3, 1, 3), (4, 1, 4),
                                           (8, 1, 8), (9, 2, 5), (16, 2, 8),
                                           (48, 6, 8)])
def test_head_tiles(G, tiles, heads):
    assert fd.head_tiles(G) == (tiles, heads)
    assert heads <= fd.MAX_HEADS and tiles * heads >= G > (tiles - 1) * heads


def test_counter_buffer_per_device_and_stream(monkeypatch):
    monkeypatch.setattr(fd, "_COUNTERS", {})
    cpu = torch.device("cpu")
    a = fd.counter_buffer(cpu, 1, 24)
    assert a.dtype == torch.int32 and a.numel() == 24 and not a.any()
    assert fd.counter_buffer(cpu, 1, 10) is a        # big enough: kept
    b = fd.counter_buffer(cpu, 2, 10)                # another stream: its own
    assert b is not a and b.numel() == 10
    a[3] = 7                                          # as a fault would leave it
    c = fd.counter_buffer(cpu, 1, 100)               # grown: new and zeroed
    assert c is not a and c.numel() == 100 and not c.any()
    assert fd.counter_buffer(cpu, 1, 24) is c and fd.counter_buffer(cpu, 2, 5) is b


def test_kernel_is_built_from_the_checkout():
    assert "flash_decode" in build.KERNELS
    text = (build.CSRC / "flash_decode.cu").read_text()
    assert "src/repro/kernels/flash_decode.py" in text
    assert "__expf" not in text and "use_fast_math" not in " ".join(build.NVCC_FLAGS)
    assert "combine_kernel" not in text and "cp.async.cg.shared.global" in text
