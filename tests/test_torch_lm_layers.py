"""Port vs reference: the transformer layers (``repro_torch.models.layers``
vs ``repro.models.layers``) in f32 at 1e-5, on the same numpy inputs."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import layers as jl
from repro_torch.configs import get_config
from repro_torch.kernels import ops
from repro_torch.models import layers as tl

RNG = np.random.default_rng(11)
TOL = dict(rtol=1e-5, atol=1e-5)


def _normal(*shape, scale=1.0):
    return (RNG.standard_normal(shape) * scale).astype(np.float32)


def _both(*arrays):
    return [jnp.asarray(a) for a in arrays], [torch.from_numpy(a) for a in arrays]


def _close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)


def test_rms_norm():
    (jx, jw), (tx, tw) = _both(_normal(3, 5, 48, scale=3.0), _normal(48))
    _close(tl.rms_norm(tx, tw, 1e-5), jl.rms_norm(jx, jw, 1e-5))
    _close(tl.rms_norm(tx, tw, 1e-6), jl.rms_norm(jx, jw, 1e-6))


@pytest.mark.parametrize("hd", [16, 64, 128])
def test_rope_freqs_are_bit_equal(hd):
    np.testing.assert_array_equal(tl.rope_freqs(hd, 10_000.0).numpy(),
                                  np.asarray(jl.rope_freqs(hd, 10_000.0)))


@pytest.mark.parametrize("hd", [16, 64])
def test_apply_rope_up_to_32k(hd):
    B, S, H = 2, 64, 3
    x = _normal(B, S, H, hd)
    pos = RNG.integers(0, 32_768, (B, S)).astype(np.int32)
    pos[0, :4] = [0, 1, 32_767, 16_384]
    (jx, jp), (tx, tp) = _both(x, pos)
    got = tl.apply_rope(tx, tp, 10_000.0)
    _close(got, jl.apply_rope(jx, jp, 10_000.0))
    # rotate-half: element i pairs with element i + hd/2, not with i + 1
    half = hd // 2
    ang = float(pos[0, 2]) * tl.rope_freqs(hd, 10_000.0)[0]
    x0 = torch.from_numpy(x[0, 2, 0])
    want0 = x0[0] * torch.cos(ang) - x0[half] * torch.sin(ang)
    np.testing.assert_allclose(float(got[0, 2, 0, 0]), float(want0), rtol=1e-5, atol=1e-5)


def _attn_inputs(B, Sq, Skv, H, K, hd):
    return (_normal(B, Sq, H, hd), _normal(B, Skv, K, hd), _normal(B, Skv, K, hd))


@pytest.mark.parametrize("H,K", [(4, 4), (6, 2), (8, 1)])
def test_attention_core_causal_gqa(H, K):
    B, S, hd = 2, 24, 16
    q, k, v = _attn_inputs(B, S, S, H, K, hd)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S)).copy()
    j, t = _both(q, k, v, pos)
    _close(tl.attention_core(*t, t[3], causal=True),
           jl.attention_core(*j, j[3], causal=True))
    _close(tl.attention_core(*t, t[3], causal=False),
           jl.attention_core(*j, j[3], causal=False))
    _close(tl.attention_core(*t, t[3], causal=True, sliding_window=5),
           jl.attention_core(*j, j[3], causal=True, sliding_window=5))


def test_attention_core_kv_valid():
    B, Skv, H, K, hd = 3, 40, 6, 3, 16
    q, k, v = _attn_inputs(B, 1, Skv, H, K, hd)
    qpos = np.array([[5], [17], [39]], np.int32)
    kpos = np.broadcast_to(np.arange(Skv, dtype=np.int32), (B, Skv)).copy()
    valid = kpos <= qpos
    valid[1, 3] = False                             # a hole the mask must keep
    j, t = _both(q, k, v, qpos, kpos, valid)
    _close(tl.attention_core(*t[:5], causal=True, kv_valid=t[5]),
           jl.attention_core(*j[:5], causal=True, kv_valid=j[5]))


def test_attention_core_chunked_path():
    """Sq a multiple of q_chunk and above it: the chunked loop, against the
    reference's scan over chunks and the unchunked result."""
    B, S, H, K, hd, chunk = 2, 32, 4, 2, 16, 8
    q, k, v = _attn_inputs(B, S, S, H, K, hd)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S)).copy()
    j, t = _both(q, k, v, pos)
    got = tl.attention_core(*t, t[3], causal=True, q_chunk=chunk)
    _close(got, jl.attention_core(*j, j[3], causal=True, q_chunk=chunk))
    _close(got, tl.attention_core(*t, t[3], causal=True))


@pytest.mark.parametrize("gated", [True, False])
def test_ffn(gated):
    d, f = 32, 80
    params = {"w1": _normal(d, f, scale=d ** -0.5), "w2": _normal(f, d, scale=f ** -0.5)}
    if gated:
        params["w3"] = _normal(d, f, scale=d ** -0.5)
    x = _normal(2, 5, d, scale=2.0)
    jp = {n: jnp.asarray(a) for n, a in params.items()}
    tp = {n: torch.from_numpy(a) for n, a in params.items()}
    _close(tl.ffn(tp, torch.from_numpy(x), gated), jl.ffn(jp, jnp.asarray(x), gated))


def _attn_params(cfg, bias):
    d, H, K, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    p = {"wq": _normal(d, H, hd, scale=d ** -0.5), "wk": _normal(d, K, hd, scale=d ** -0.5),
         "wv": _normal(d, K, hd, scale=d ** -0.5),
         "wo": _normal(H, hd, d, scale=(H * hd) ** -0.5)}
    if bias:
        p.update(bq=_normal(H, hd, scale=0.1), bk=_normal(K, hd, scale=0.1),
                 bv=_normal(K, hd, scale=0.1))
    return ({n: jnp.asarray(a) for n, a in p.items()},
            {n: torch.from_numpy(a) for n, a in p.items()})


@pytest.mark.parametrize("arch,heads", [("smollm-135m", (6, 2)),
                                        ("qwen1.5-0.5b", (4, 4)),
                                        ("granite-34b", (4, 1))])
def test_self_attention_with_cache(arch, heads):
    """Prefill without a cache, then decode steps through a cache: outputs
    within 1e-5, and the cache (written in place in the port) equal."""
    H, K = heads
    cfg = dataclasses.replace(get_config(arch).reduced(), num_heads=H, num_kv_heads=K)
    jcfg = dataclasses.replace(jget_config(arch).reduced(), num_heads=H, num_kv_heads=K)
    jp, tp = _attn_params(cfg, cfg.qkv_bias)
    B, S, max_len = 2, 6, 16
    x = _normal(B, S, cfg.d_model)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S)).copy()
    out, none = tl.self_attention(tp, torch.from_numpy(x), torch.from_numpy(pos), cfg)
    want, _ = jl.self_attention(jp, jnp.asarray(x), jnp.asarray(pos), jcfg)
    assert none is None
    _close(out, want)

    tcache = tl.init_kv_cache(cfg, B, max_len, dtype=torch.float32)
    jcache = jl.init_kv_cache(jcfg, B, max_len, dtype=jnp.float32)
    ops.reset_launch_counts()
    for t in range(S):
        xt, pt = x[:, t:t + 1], np.full((B, 1), t, np.int32)
        out, tcache = tl.self_attention(tp, torch.from_numpy(xt), torch.from_numpy(pt),
                                        cfg, kv_cache=tcache, cache_index=t)
        want, jcache = jl.self_attention(jp, jnp.asarray(xt), jnp.asarray(pt), jcfg,
                                         kv_cache=jcache, cache_index=jnp.int32(t))
        _close(out, want)
    assert ops.launch_counts()["flash_decode"] == 0          # CPU: plain version
    for name in ("pos", "valid"):
        np.testing.assert_array_equal(tcache[name].numpy(), np.asarray(jcache[name]))
    for name in ("k", "v"):
        _close(tcache[name], jcache[name])


def test_self_attention_cache_overflow_raises():
    cfg = get_config("smollm-135m").reduced()
    _, tp = _attn_params(cfg, False)
    cache = tl.init_kv_cache(cfg, 1, 4, dtype=torch.float32)
    x = torch.from_numpy(_normal(1, 1, cfg.d_model))
    with pytest.raises(ValueError, match="does not fit"):
        tl.self_attention(tp, x, torch.full((1, 1), 4, dtype=torch.int32), cfg,
                          kv_cache=cache, cache_index=4)


def test_init_kv_cache_matches_reference():
    cfg = dataclasses.replace(get_config("smollm-135m").reduced(), sliding_window=8)
    jcfg = dataclasses.replace(jget_config("smollm-135m").reduced(), sliding_window=8)
    got = tl.init_kv_cache(cfg, 3, 32)
    want = jl.init_kv_cache(jcfg, 3, 32)
    for name, t in got.items():
        assert tuple(t.shape) == want[name].shape                 # window-capped
        assert str(t.dtype).split(".")[-1] == str(want[name].dtype)
        assert not t.any()
