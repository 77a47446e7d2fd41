"""Transformer layers: norms, RoPE, attention, FFN, the KV cache.

The port of ``src/repro/models/layers.py``. Parameters are plain mappings of
tensors (a dict or an ``nn.ParameterDict``) in the reference's layouts:
``wq`` [d, H, hd], ``wk``/``wv`` [d, K, hd], ``wo`` [H, hd, d],
activations [B, S, H, hd], the cache [B, S, K, hd]. The reference's sharding
hooks (``logical_constraint``, ``cotangent_constraint``) are identities
without a mesh and have no counterpart here.

A decode call (one query position against a cache, causal, no sliding
window) goes through the ``flash_decode`` kernel (``kernels.ops``); every
other attention goes through :func:`attention_core`.
"""
from __future__ import annotations

import math
from typing import Mapping, Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.kernels.ref import NEG_INF


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    dtype = x.dtype
    x = x.to(torch.float32)
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * weight.to(torch.float32)).to(dtype)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    # divide by a tensor: on CUDA a host-scalar divisor becomes a reciprocal multiply
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / \
        torch.full((), head_dim, dtype=torch.float32, device=device)
    return 1.0 / (theta ** exponent)  # [head_dim // 2]


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: [B, S, H, hd]; positions: [B, S] (int). Rotate-half RoPE: element
    i of the first half pairs with element i of the second half (i and
    i + hd/2), both rotated by the angle ``position * freqs[i]``."""
    freqs = rope_freqs(x.shape[-1], theta, device=x.device)       # [hd/2]
    angles = positions[..., None].to(torch.float32) * freqs       # [B, S, hd/2]
    sin = torch.sin(angles)[:, :, None, :]
    cos = torch.cos(angles)[:, :, None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Attention core (prefill and the paths the kernel does not take)
# ---------------------------------------------------------------------------


ATTN_Q_CHUNK = 1024  # query-block size of the chunked path


def _attn_block_math(q, k, v, q_pos, kv_pos, *, causal, sliding_window, kv_valid,
                     scale):
    """One dense attention block: q [B, Cq, H, hd] vs kv [B, Skv, H, hd],
    scores and softmax in f32."""
    scores = torch.einsum("bqhd,bshd->bhqs", q.to(torch.float32),
                          k.to(torch.float32)) * scale
    mask = torch.ones((q.shape[0], q.shape[1], k.shape[1]), dtype=torch.bool,
                      device=q.device)
    dpos = q_pos[:, :, None] - kv_pos[:, None, :]       # [B, Cq, Skv]
    if causal:
        mask &= dpos >= 0
    if sliding_window:
        mask &= dpos < sliding_window
    if kv_valid is not None:
        mask &= kv_valid[:, None, :]
    scores = scores.masked_fill(~mask[:, None, :, :], NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqs,bshd->bqhd", probs, v.to(probs.dtype))


def attention_core(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   q_positions: torch.Tensor, kv_positions: torch.Tensor, *,
                   causal: bool = True, sliding_window: int = 0,
                   kv_valid: Optional[torch.Tensor] = None,
                   q_chunk: int = ATTN_Q_CHUNK) -> torch.Tensor:
    """Masked softmax attention. q [B, Sq, H, hd], k/v [B, Skv, K, hd],
    positions [B, Sq] / [B, Skv], kv_valid [B, Skv] bool (masks unwritten
    cache). GQA repeats each KV head to its H // K query heads (query head h
    reads KV head h // (H // K)). A query span longer than ``q_chunk`` (and
    a multiple of it) runs chunk by chunk, so one [Cq, Skv] score block is
    live at a time; each row still sees the whole KV span, so the softmax is
    exact."""
    B, Sq, H, hd = q.shape
    K = k.shape[2]
    if K != H:
        k = k.repeat_interleave(H // K, dim=2)
        v = v.repeat_interleave(H // K, dim=2)
    scale = 1.0 / math.sqrt(hd)
    kw = dict(causal=causal, sliding_window=sliding_window, kv_valid=kv_valid,
              scale=scale)
    if Sq <= q_chunk or Sq % q_chunk != 0:
        out = _attn_block_math(q, k, v, q_positions, kv_positions, **kw)
        return out.to(q.dtype)
    chunks = [_attn_block_math(q[:, i:i + q_chunk], k, v,
                               q_positions[:, i:i + q_chunk], kv_positions, **kw)
              for i in range(0, Sq, q_chunk)]
    return torch.cat(chunks, dim=1).to(q.dtype)


def attention_qkv(params: Mapping[str, torch.Tensor], x: torch.Tensor,
                  kv_src: Optional[torch.Tensor] = None):
    """Project hidden states to q (from x) and k, v (from kv_src or x)."""
    src = x if kv_src is None else kv_src
    q = torch.einsum("bsd,dhk->bshk", x, params["wq"])
    k = torch.einsum("bsd,dhk->bshk", src, params["wk"])
    v = torch.einsum("bsd,dhk->bshk", src, params["wv"])
    if "bq" in params:
        q = q + params["bq"]
        k = k + params["bk"]
        v = v + params["bv"]
    return q, k, v


def attention_out(params: Mapping[str, torch.Tensor], attn: torch.Tensor) -> torch.Tensor:
    return torch.einsum("bshk,hkd->bsd", attn, params["wo"])


def self_attention(params: Mapping[str, torch.Tensor], x: torch.Tensor,
                   positions: torch.Tensor, cfg, *,
                   kv_cache: Optional[dict] = None,
                   cache_index: Optional[int] = None,
                   use_kernel: bool = True):
    """Self-attention. With ``kv_cache`` (one layer's ``k``, ``v``, ``pos``,
    ``valid``) the new keys and values are written at host index
    ``cache_index`` (ring slot ``cache_index % S_max`` for a window-sized
    sliding cache) and the query attends over the cache.

    The cache is updated in place, as views of the caller's tensors; it is
    returned as the reference returns its new cache. A single query
    position on a causal, full-attention layer goes through the
    ``flash_decode`` kernel with ``kv_len = cache_index + 1`` for every row:
    that equals the reference's causal + ``valid`` mask because positions
    0..cache_index were written in order (the caller checks this). Other
    calls, sliding-window layers among them (their ring breaks the prefix),
    take :func:`attention_core` over the whole masked cache.

    Returns (output [B, S, d], the cache or None)."""
    q, k, v = attention_qkv(params, x)
    if not cfg.is_encoder_only:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    if kv_cache is None:
        attn = attention_core(q, k, v, positions, positions, causal=cfg.causal,
                              sliding_window=cfg.sliding_window)
        return attention_out(params, attn), None

    ck, cv = kv_cache["k"], kv_cache["v"]
    B, Sq = q.shape[:2]
    S_max = ck.shape[1]
    ring = bool(cfg.sliding_window) and S_max <= cfg.sliding_window
    slot = cache_index % S_max if ring else cache_index
    if not 0 <= slot <= S_max - Sq:
        raise ValueError(f"cache index {cache_index} with {Sq} new positions "
                         f"does not fit a cache of {S_max}")
    ck[:, slot:slot + Sq] = k.to(ck.dtype)               # in place
    cv[:, slot:slot + Sq] = v.to(cv.dtype)
    kv_cache["pos"][:, slot:slot + Sq] = positions.to(kv_cache["pos"].dtype)
    kv_cache["valid"][:, slot:slot + Sq] = 1
    if Sq == 1 and cfg.causal and not cfg.sliding_window:
        kv_len = torch.full((B,), cache_index + 1, dtype=torch.int32, device=q.device)
        attn = ops.decode_attention(q[:, 0], ck, cv, kv_len, use_kernel=use_kernel)
        attn = attn[:, None].to(q.dtype)
    else:
        attn = attention_core(q, ck, cv, positions, kv_cache["pos"],
                              causal=cfg.causal, sliding_window=cfg.sliding_window,
                              kv_valid=kv_cache["valid"].to(torch.bool))
    return attention_out(params, attn), kv_cache


def init_kv_cache(cfg, batch: int, max_len: int, n: int = 1, *, dtype=torch.bfloat16,
                  device=None, keep_leading: bool = False) -> dict:
    """A KV cache, zero: ``k``/``v`` [B, S, K, hd] of ``dtype``, ``pos``
    [B, S] int32 and ``valid`` [B, S] int8. ``n`` leading replicas (one per
    layer, or per shared-block call) add a leading [n] dim, which
    ``keep_leading`` keeps at n = 1 too. A sliding-window config caps S at
    its window."""
    K, hd = cfg.num_kv_heads, cfg.head_dim
    if cfg.sliding_window:
        max_len = min(max_len, cfg.sliding_window)
    lead = (n,) if n > 1 or keep_leading else ()
    shape = lead + (batch, max_len, K, hd)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
        "pos": torch.zeros(lead + (batch, max_len), dtype=torch.int32, device=device),
        "valid": torch.zeros(lead + (batch, max_len), dtype=torch.int8, device=device),
    }


# ---------------------------------------------------------------------------
# FFN
# ---------------------------------------------------------------------------


def ffn(params: Mapping[str, torch.Tensor], x: torch.Tensor, gated: bool) -> torch.Tensor:
    """SwiGLU when ``gated``, else the tanh-approximated GELU MLP (the
    reference's ``jax.nn.gelu`` default)."""
    h = torch.einsum("bsd,df->bsf", x, params["w1"])
    if gated:
        h = F.silu(h) * torch.einsum("bsd,df->bsf", x, params["w3"])
    else:
        h = F.gelu(h, approximate="tanh")
    return torch.einsum("bsf,fd->bsd", h, params["w2"])
