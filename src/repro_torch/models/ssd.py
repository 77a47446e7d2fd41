"""Mamba2 / SSD (state-space duality) layer.

The port of ``src/repro/models/ssd.py``. Training and prefill run the
chunked SSD algorithm (arXiv:2405.21060 §6): the sequence is cut into
chunks of ``ssm_chunk``; within a chunk the terms are dense products, and
a per-head state [hd, N] carries across chunks through a loop over them.
Decode is the O(1) recurrent update over a cache of the state and the
convolutions' last W - 1 inputs. Projections are separate weights
(z/x/B/C/dt), as the reference keeps them; d_inner = expand * d_model,
heads = d_inner / ssm_head_dim, one B/C group.

One departure: the intra-chunk decay is ``exp(where(tri, seg, -inf))``
where the reference computes ``where(tri, exp(seg), 0)``. Above the
diagonal ``seg`` is a positive sum of ``-dA`` that overflows ``exp`` at the
configs' chunk of 256, and the reference's masked ``inf`` times a zero
cotangent makes its grads NaN; masking before the ``exp`` gives the same
values, and grads that are finite there (ROADMAP.md section 3).
"""
from __future__ import annotations

import math
from typing import Mapping, Optional

import torch
import torch.nn.functional as F


def ssd_shapes(cfg) -> dict:
    """Parameter shapes of one SSD layer, in the reference's layouts."""
    d, di, N, H, W = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_conv
    return {"z_proj": (d, di), "x_proj": (d, di), "b_proj": (d, N), "c_proj": (d, N),
            "dt_proj": (d, H), "conv_x": (W, di), "conv_x_b": (di,), "conv_b": (W, N),
            "conv_b_b": (N,), "conv_c": (W, N), "conv_c_b": (N,), "A_log": (H,),
            "D": (H,), "dt_bias": (H,), "out_proj": (di, d)}


ZERO_INIT = ("conv_x_b", "conv_b_b", "conv_c_b", "A_log", "dt_bias")


def init_ssd(cfg, generator: torch.Generator, leading=()) -> dict:
    """One SSD layer's weights (``leading`` dims in front of each), drawn as
    the reference's ``init_ssd``: projections and convolution taps
    N(0, 1/fan_in) (fan-in the first dim), biases, ``A_log`` and ``dt_bias``
    zero, ``D`` one."""
    out = {}
    for name, shape in ssd_shapes(cfg).items():
        full = tuple(leading) + shape
        if name in ZERO_INIT:
            out[name] = torch.zeros(full)
        elif name == "D":
            out[name] = torch.ones(full)
        else:
            out[name] = torch.randn(full, generator=generator) * (1.0 / math.sqrt(max(1, shape[0])))
    return out


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv over time. x [B, S, C], w [W, C]."""
    W, S = w.shape[0], x.shape[1]
    pad = F.pad(x, (0, 0, W - 1, 0))
    out = torch.zeros_like(x)
    for i in range(W):
        out = out + pad[:, i:i + S, :] * w[i]
    return F.silu(out + b)


def ssd_forward(params: Mapping[str, torch.Tensor], u: torch.Tensor, cfg,
                initial_state: Optional[torch.Tensor] = None):
    """u [B, S, d_model] -> (y [B, S, d_model], final state [B, H, hd, N]).
    A sequence that is not a multiple of the chunk is padded to one and the
    padded outputs trimmed, as the reference does."""
    B, S, d = u.shape
    di, N, H, hd = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
    Q = min(cfg.ssm_chunk, S)
    if S % Q:
        out, state = ssd_forward(params, F.pad(u, (0, 0, 0, Q - S % Q)), cfg, initial_state)
        return out[:, :S], state
    nc = S // Q
    acc = torch.promote_types(u.dtype, torch.float32)   # f32, or f64 for f64 input

    z = torch.einsum("bsd,dk->bsk", u, params["z_proj"])
    x = _causal_conv(torch.einsum("bsd,dk->bsk", u, params["x_proj"]),
                     params["conv_x"], params["conv_x_b"])
    Bm = _causal_conv(torch.einsum("bsd,dn->bsn", u, params["b_proj"]),
                      params["conv_b"], params["conv_b_b"])
    Cm = _causal_conv(torch.einsum("bsd,dn->bsn", u, params["c_proj"]),
                      params["conv_c"], params["conv_c_b"])
    dt = torch.einsum("bsd,dh->bsh", u, params["dt_proj"])

    dt = F.softplus(dt.to(acc) + params["dt_bias"].to(acc))
    A = -torch.exp(params["A_log"].to(acc))                   # [H]
    dA = dt * A                                               # [B, S, H]

    xc = x.reshape(B, nc, Q, H, hd).to(acc)
    Bc = Bm.reshape(B, nc, Q, N).to(acc)
    Cc = Cm.reshape(B, nc, Q, N).to(acc)
    dtc = dt.reshape(B, nc, Q, H)
    dAc = dA.reshape(B, nc, Q, H)
    dA_cs = torch.cumsum(dAc, dim=2)                          # [B, nc, Q, H]
    xdt = xc * dtc[..., None]                                 # dt-weighted input

    # intra-chunk: L[i, j] = exp(dA_cs[i] - dA_cs[j]) for i >= j, else 0,
    # masked before the exp (the module docstring's departure)
    seg = dA_cs[:, :, :, None, :] - dA_cs[:, :, None, :, :]   # [B, nc, Q, Q, H]
    tri = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=u.device))
    L = torch.exp(seg.masked_fill(~tri[None, None, :, :, None], -math.inf))
    CB = torch.einsum("bcin,bcjn->bcij", Cc, Bc)              # [B, nc, Q, Q]
    M = CB[..., None] * L
    y_intra = torch.einsum("bcijh,bcjhp->bcihp", M, xdt)      # [B, nc, Q, H, hd]

    # chunk states
    decay_to_end = torch.exp(dA_cs[:, :, -1:, :] - dA_cs)     # [B, nc, Q, H]
    states = torch.einsum("bcqn,bcqhp->bchpn", Bc, decay_to_end[..., None] * xdt)

    # inter-chunk recurrence, emitting the state before each chunk
    chunk_decay = torch.exp(torch.sum(dAc, dim=2))            # [B, nc, H]
    h = (torch.zeros((B, H, hd, N), dtype=acc, device=u.device) if initial_state is None
         else initial_state.to(acc))
    h_prevs = []
    for c in range(nc):
        h_prevs.append(h)
        h = h * chunk_decay[:, c, :, None, None] + states[:, c]
    h_prev = torch.stack(h_prevs, dim=1)                      # [B, nc, H, hd, N]

    in_decay = torch.exp(dA_cs)                               # [B, nc, Q, H]
    y_inter = torch.einsum("bcqn,bchpn->bcqhp", Cc, h_prev) * in_decay[..., None]

    y = (y_intra + y_inter).reshape(B, S, H, hd)
    y = y + xc.reshape(B, S, H, hd) * params["D"].to(acc)[None, None, :, None]
    y = y.reshape(B, S, di).to(u.dtype) * F.silu(z)
    out = torch.einsum("bsk,kd->bsd", y, params["out_proj"])
    return out, h.to(u.dtype)


def init_ssd_cache(cfg, batch: int, *, n: int = 1, dtype=torch.bfloat16,
                   device=None) -> dict:
    """``n`` layers' decode caches, zero: the state [n, B, H, hd, N] and each
    convolution's last W - 1 inputs [n, B, W - 1, C], of ``dtype``."""
    H, hd, N, W = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state, cfg.ssm_conv
    shapes = {"state": (H, hd, N), "conv_x": (W - 1, cfg.d_inner),
              "conv_b": (W - 1, N), "conv_c": (W - 1, N)}
    return {name: torch.zeros((n, batch) + s, dtype=dtype, device=device)
            for name, s in shapes.items()}


def _conv_step(buf: torch.Tensor, new: torch.Tensor, w, b) -> torch.Tensor:
    """buf [B, W-1, C] rolling history, updated in place; new [B, C]."""
    full = torch.cat([buf.to(new.dtype), new[:, None, :]], dim=1)
    out = F.silu(torch.einsum("bwc,wc->bc", full, w) + b)
    buf.copy_(full[:, 1:])
    return out


def ssd_decode_step(params: Mapping[str, torch.Tensor], u: torch.Tensor,
                    cache: Mapping[str, torch.Tensor], cfg) -> torch.Tensor:
    """u [B, 1, d_model] -> y [B, 1, d_model]: the O(1) recurrent update of
    one layer. ``cache`` (one layer's ``state``, ``conv_x``, ``conv_b``,
    ``conv_c``) is updated in place, the state kept in the cache's dtype
    between steps, as the reference stores it."""
    B = u.shape[0]
    di, H, hd = cfg.d_inner, cfg.ssm_heads, cfg.ssm_head_dim
    acc = torch.promote_types(u.dtype, torch.float32)   # f32, or f64 for f64 input

    z = torch.einsum("bsd,dk->bsk", u, params["z_proj"])
    x_raw = torch.einsum("bsd,dk->bsk", u, params["x_proj"])[:, 0]
    b_raw = torch.einsum("bsd,dn->bsn", u, params["b_proj"])[:, 0]
    c_raw = torch.einsum("bsd,dn->bsn", u, params["c_proj"])[:, 0]
    dt = torch.einsum("bsd,dh->bsh", u, params["dt_proj"])[:, 0]

    x = _conv_step(cache["conv_x"], x_raw, params["conv_x"], params["conv_x_b"])
    Bm = _conv_step(cache["conv_b"], b_raw, params["conv_b"], params["conv_b_b"])
    Cm = _conv_step(cache["conv_c"], c_raw, params["conv_c"], params["conv_c_b"])
    x = x.reshape(B, H, hd)

    dt = F.softplus(dt.to(acc) + params["dt_bias"].to(acc))  # [B, H]
    A = -torch.exp(params["A_log"].to(acc))
    decay = torch.exp(dt * A)

    h = cache["state"].to(acc)
    dx = dt[..., None] * x.to(acc)                           # [B, H, hd]
    h_new = h * decay[..., None, None] + torch.einsum("bhp,bn->bhpn", dx, Bm.to(acc))
    y = torch.einsum("bhpn,bn->bhp", h_new, Cm.to(acc))
    y = y + x.to(acc) * params["D"].to(acc)[None, :, None]
    y = y.reshape(B, 1, di).to(u.dtype) * F.silu(z)
    cache["state"].copy_(h_new)
    return torch.einsum("bsk,kd->bsd", y, params["out_proj"])
