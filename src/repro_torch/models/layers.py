"""Transformer layers: norms, RoPE, attention, FFN, the KV cache.

The port of ``src/repro/models/layers.py``. Parameters are plain mappings of
tensors (a dict or an ``nn.ParameterDict``) in the reference's layouts:
``wq`` [d, H, hd], ``wk``/``wv`` [d, K, hd], ``wo`` [H, hd, d],
activations [B, S, H, hd], the cache [B, S, K, hd].

Activation sharding is annotated as in the reference, through
:func:`logical_constraint` and its kin, which map logical axis names to the
axes of a ``DeviceMesh`` through the rules :func:`set_logical_rules`
installs (``launch.sharding.ShardingPlan.rules``). With no rules, or on a
tensor that is not a DTensor, every helper returns its input unchanged, so
plain tensors take exactly the path they took before. Bodies that DTensor's
sharding propagation cannot cover (the attention core, the decode cache
write, decode attention) run on each device's local shard through
:func:`local_call` (``local_map``), their inputs first placed as the rules
say.

A decode call (one query position against a cache, causal, no sliding
window; or a VLM cross layer's one query position against its cached
image keys) goes through the ``flash_decode`` kernel (``kernels.ops``);
every other attention goes through :func:`attention_core`.
"""
from __future__ import annotations

import functools
import math
from typing import Callable, Mapping, Optional, Sequence

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.kernels.ref import NEG_INF

# ---------------------------------------------------------------------------
# Logical sharding rules (installed by the launch tooling)
# ---------------------------------------------------------------------------

_ACTIVE_RULES: Optional[dict] = None

# The reference's roofline switch: its scans fully unroll so XLA's
# cost_analysis counts every iteration. The port's loops run eagerly and a
# trace already counts every iteration, so nothing here reads it; it keeps
# its name for the launch tooling's callers.
FULL_UNROLL = False


def scan_unroll():
    """The reference's scan unroll factor. Eager loops count every
    iteration whatever it returns."""
    return True if FULL_UNROLL else 1


def set_logical_rules(rules: Optional[dict]) -> None:
    global _ACTIVE_RULES
    _ACTIVE_RULES = rules


def get_logical_rules() -> Optional[dict]:
    return _ACTIVE_RULES


def _dtensor_type():
    from torch.distributed.tensor import DTensor
    return DTensor


def is_dtensor(x) -> bool:
    return _ACTIVE_RULES is not None and isinstance(x, _dtensor_type())


# logical names whose dims shard unevenly (the reference lets vocab dims pad)
_UNEVEN_OK = ("vocab",)


def placements_for(mesh, names: Sequence[Optional[str]], base=None, shape=None) -> tuple:
    """DTensor placements over ``mesh`` for a tensor whose dims carry the
    logical ``names`` (``None`` for a dim with no name): a mesh axis that a
    named dim maps to under the active rules shards that dim; every other
    mesh dim keeps its placement in ``base`` (JAX's UNCONSTRAINED) or, with
    no ``base``, replicates. A mesh dim of ``base`` that shards a named dim
    the rules put elsewhere replicates. Given the tensor's ``shape``, a dim
    that its axes do not divide stays unsharded (DTensor cannot view an
    uneven shard), except a vocab dim."""
    from torch.distributed.tensor import Replicate, Shard
    rules = _ACTIVE_RULES or {}
    axes = mesh.mesh_dim_names
    out = list(base) if base is not None else [Replicate()] * len(axes)
    named = {}
    for d, name in enumerate(names):
        want = [a for a in ((rules.get(name) or ()) if name else ()) if a in axes]
        if want and shape is not None and name not in _UNEVEN_OK and \
                shape[d] % math.prod(mesh.size(axes.index(a)) for a in want):
            want = []
        named[d] = want
        for a in want:
            out[axes.index(a)] = Shard(d)
    for i, p in enumerate(out):
        if isinstance(p, Shard) and names[p.dim] and axes[i] not in named.get(p.dim, ()):
            if (rules.get(names[p.dim]) or ()) or named.get(p.dim) == []:
                out[i] = Replicate()
    return tuple(out)


def logical_constraint(x: torch.Tensor, *names: Optional[str]) -> torch.Tensor:
    """Constrain ``x``'s sharding by logical axis names (no-op without rules
    or on a plain tensor). Dims whose name is None or unmapped keep their
    current placement: the constraint pins only what it names."""
    if not is_dtensor(x) or not any(_ACTIVE_RULES.get(n) for n in names if n):
        return x
    want = placements_for(x.device_mesh, names, base=x.placements, shape=x.shape)
    return x if want == tuple(x.placements) else x.redistribute(x.device_mesh, want)


def logical_constraint_exact(x: torch.Tensor, *names: Optional[str]) -> torch.Tensor:
    """Hard constraint: unmapped/None dims are REPLICATED (not
    unconstrained), to force a single materialization point."""
    if not is_dtensor(x):
        return x
    want = placements_for(x.device_mesh, names, shape=x.shape)
    return x if want == tuple(x.placements) else x.redistribute(x.device_mesh, want)


def reduce_partial(x: torch.Tensor) -> torch.Tensor:
    """A DTensor's pending sums (``Partial`` placements, as an embedding
    lookup into a vocab-sharded table leaves) reduced now, once."""
    if not is_dtensor(x) or not any(p.is_partial() for p in x.placements):
        return x
    return x.redistribute(x.device_mesh, [_replicate() if p.is_partial() else p
                                          for p in x.placements])


class _CotangentConstraint(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, names):
        ctx.names = names
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return logical_constraint(g, *ctx.names), None


def cotangent_constraint(x: torch.Tensor, *names: Optional[str]) -> torch.Tensor:
    """Identity in forward; pins the gradient's sharding in backward."""
    if not is_dtensor(x) or not torch.is_grad_enabled():
        return x
    return _CotangentConstraint.apply(x, tuple(names))


def run_local(fn: Callable, args: Sequence, in_placements: Sequence, out_placements):
    """``local_map`` of ``fn`` over ``args`` (the first DTensor's mesh): each
    DTensor arg is first redistributed to its entry of ``in_placements``
    and a plain tensor among them counts as replicated; ``out_placements``
    holds one placements tuple per output."""
    from torch.distributed.tensor.experimental import local_map
    DTensor = _dtensor_type()
    mesh = next(a for a in args if isinstance(a, DTensor)).device_mesh
    wrapped = [_from_local(a, mesh, [_replicate()] * mesh.ndim, tuple(a.shape))
               if isinstance(a, torch.Tensor) and not isinstance(a, DTensor) else a
               for a in args]
    return local_map(fn, out_placements=tuple(out_placements), in_placements=tuple(in_placements),
                     device_mesh=mesh, redistribute_inputs=True)(*wrapped)


def local_call(fn: Callable, out_names, args: Sequence, in_names: Sequence):
    """``fn(*args)`` on plain tensors, or, under rules with a DTensor among
    ``args``, on each device's local shards (:func:`run_local`): every
    tensor arg is placed first as its logical names say, and each output
    comes back as a DTensor placed by its names. ``in_names`` holds one
    tuple of names per arg (``None`` for a non-tensor); ``out_names`` one
    per output (a tuple of tuples for several outputs)."""
    if not any(is_dtensor(a) for a in args):
        return fn(*args)
    mesh = next(a for a in args if is_dtensor(a)).device_mesh
    in_pl = [None if n is None else placements_for(mesh, n, shape=a.shape)
             for n, a in zip(in_names, args)]
    several = bool(out_names) and isinstance(out_names[0], tuple)
    outs = out_names if several else (out_names,)
    out = [placements_for(mesh, n, shape=_out_shape(n, in_names, args)) for n in outs]
    return run_local(fn, args, in_pl, out)


def _out_shape(names, in_names, args):
    """An output's dims, by name, sized as the first input dim of that name
    (what decides whether the output shards as its inputs do)."""
    sizes = {}
    for ns, a in zip(in_names, args):
        for n, size in zip(ns or (), getattr(a, "shape", ())):
            if n:
                sizes.setdefault(n, size)
    return [sizes.get(n, 0) for n in names]


def local_einsum(eq: str, x: torch.Tensor, w: torch.Tensor, x_names) -> torch.Tensor:
    """``torch.einsum(eq, x, w)`` of an activation x and a weight w. On
    DTensors each device multiplies its shards, placed as the reference's
    GSPMD places a sharded product rather than as DTensor's cost model
    would (it may flatten and split dims unevenly, or move activations in
    place of weights): x as its logical ``x_names`` say (exactly), w with
    its FSDP shards gathered and its model-axis shards kept; a mesh dim
    that splits a kept letter splits the output's, one that splits a
    contracted letter leaves a partial sum."""
    if not (is_dtensor(x) or is_dtensor(w)):
        return torch.einsum(eq, x, w)
    from torch.distributed.tensor import Partial, Replicate, Shard
    mesh = (w if is_dtensor(w) else x).device_mesh
    ins, out = eq.split("->")
    xl, wl = ins.split(",")
    x_pl = placements_for(mesh, x_names, shape=x.shape)
    w_pl = list(gathered(w)) if is_dtensor(w) else [Replicate()] * mesh.ndim
    out_pl = []
    for i in range(mesh.ndim):
        xs = xl[x_pl[i].dim] if isinstance(x_pl[i], Shard) else None
        ws = wl[w_pl[i].dim] if isinstance(w_pl[i], Shard) else None
        if xs and ws and xs != ws:
            w_pl[i], ws = Replicate(), None
        letter = xs or ws
        out_pl.append(Replicate() if letter is None else
                      Shard(out.index(letter)) if letter in out else Partial())
    return run_local(functools.partial(torch.einsum, eq), (x, w), (x_pl, tuple(w_pl)),
                     [tuple(out_pl)])


def project(x: torch.Tensor, w: torch.Tensor, heads: Optional[str],
            bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x [B, S, d] @ w [d, H, hd] (+ bias [H, hd]) -> [B, S, H, hd], each
    device projecting its batch shard (sequence gathered) onto its heads
    (:func:`local_einsum`); ``heads`` is the heads' logical name."""
    y = local_einsum("bsd,dhk->bshk", x, w, ("batch", None, None))
    y = logical_constraint(y, "batch", None, heads, None)
    return y if bias is None else y + bias


def batch_mesh_dims(mesh) -> set:
    """Mesh dims of the axes the rules give the batch (FSDP's axes too)."""
    axes = (_ACTIVE_RULES or {}).get("batch") or ()
    return {i for i, a in enumerate(mesh.mesh_dim_names) if a in axes}


def gathered(w) -> tuple:
    """A weight's placements with its FSDP shards (over the batch axes)
    gathered: what a local body needs of it."""
    bdims = batch_mesh_dims(w.device_mesh)
    return tuple(_replicate() if i in bdims else p for i, p in enumerate(w.placements))


def _along_last(fn: Callable, x: torch.Tensor, other: torch.Tensor, other_dims) -> torch.Tensor:
    """``fn(x, other)`` of a function that works along x's last dim, on
    each device's shard of DTensor x (no operator for DTensor to
    propagate), its last dim gathered first if it is split; ``other``
    follows x's dims ``other_dims`` (None: replicated)."""
    from torch.distributed.tensor import Shard
    x = reduce_partial(x)
    whole = [_replicate() if isinstance(p, Shard) and p.dim == x.ndim - 1 else p
             for p in x.placements]
    if whole != list(x.placements):
        x = x.redistribute(x.device_mesh, whole)
    o_pl = (tuple(_replicate() for _ in x.placements) if other_dims is None
            else _follow(x.placements, other_dims))
    return run_local(fn, (x, other), (x.placements, o_pl), [x.placements])


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """In f32 for f32 and bf16 input, as the reference; in f64 for f64."""
    if is_dtensor(x):
        return _along_last(functools.partial(rms_norm, eps=eps), x, weight, None)
    dtype = x.dtype
    acc = torch.promote_types(dtype, torch.float32)
    x = x.to(acc)
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * weight.to(acc)).to(dtype)


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
    if is_dtensor(x):
        return _along_last(lambda x, p: apply_rope(x, p, theta), x, positions, {0: 0, 1: 1})
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


def _gqa_repeat(x: torch.Tensor, H: int) -> torch.Tensor:
    """[B, S, K, hd] -> [B, S, H, hd], KV head k serving query heads
    k * G .. k * G + G - 1 (``repeat_interleave``'s order, by a view that
    DTensor shards)."""
    B, S, K, hd = x.shape
    if K == H:
        return x
    return x[:, :, :, None, :].expand(B, S, K, H // K, hd).reshape(B, S, H, hd)


def _core(q, k, v, q_positions, kv_positions, kv_valid, *, causal, sliding_window,
          q_chunk):
    """The attention core on whole (or local) tensors, K == H."""
    Sq, hd = q.shape[1], q.shape[3]
    kw = dict(causal=causal, sliding_window=sliding_window, kv_valid=kv_valid,
              scale=1.0 / math.sqrt(hd))
    if Sq <= q_chunk or Sq % q_chunk != 0:
        out = _attn_block_math(q, k, v, q_positions, kv_positions, **kw)
        return out.to(q.dtype)
    chunks = [_attn_block_math(q[:, i:i + q_chunk], k, v,
                               q_positions[:, i:i + q_chunk], kv_positions, **kw)
              for i in range(0, Sq, q_chunk)]
    return torch.cat(chunks, dim=1).to(q.dtype)


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
    exact. On DTensors it runs on each device's shard of batch and heads
    (the whole KV span, as the reference's rules place it)."""
    H = q.shape[2]
    fn = functools.partial(_core, causal=causal, sliding_window=sliding_window,
                           q_chunk=q_chunk)
    qn, kvn = ("batch", "q_seq", "heads", None), ("batch", None, "heads", None)
    return local_call(fn, qn, (q, _gqa_repeat(k, H), _gqa_repeat(v, H), q_positions,
                               kv_positions, kv_valid),
                      (qn, kvn, kvn, ("batch", "q_seq"), ("batch", None),
                       None if kv_valid is None else ("batch", None)))


def attention_qkv(params: Mapping[str, torch.Tensor], x: torch.Tensor,
                  kv_src: Optional[torch.Tensor] = None):
    """Project hidden states to q (from x) and k, v (from kv_src or x)."""
    src = x if kv_src is None else kv_src
    q = project(x, params["wq"], "heads", params.get("bq"))
    k = project(src, params["wk"], "kv_heads", params.get("bk"))
    v = project(src, params["wv"], "kv_heads", params.get("bv"))
    return q, k, v


def attention_out(params: Mapping[str, torch.Tensor], attn: torch.Tensor) -> torch.Tensor:
    return local_einsum("bshk,hkd->bsd", attn, params["wo"], ("batch", None, "heads", None))


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
    q = logical_constraint(q, "batch", "q_seq", "heads", None)
    k = logical_constraint(k, "batch", "kv_seq" if kv_cache is not None else None,
                           "kv_heads", None)
    if kv_cache is None:
        attn = attention_core(q, k, v, positions, positions, causal=cfg.causal,
                              sliding_window=cfg.sliding_window)
        return logical_constraint(attention_out(params, attn), "batch", None, None), None

    ck, cv = kv_cache["k"], kv_cache["v"]
    Sq = q.shape[1]
    S_max = ck.shape[1]
    ring = bool(cfg.sliding_window) and S_max <= cfg.sliding_window
    slot = cache_index % S_max if ring else cache_index
    if not 0 <= slot <= S_max - Sq:
        raise ValueError(f"cache index {cache_index} with {Sq} new positions "
                         f"does not fit a cache of {S_max}")
    write_cache(kv_cache, slot, k, v, positions)
    if Sq == 1 and cfg.causal and not cfg.sliding_window:
        attn = decode_attention(q[:, 0], ck, cv, cache_index + 1, use_kernel=use_kernel)
        attn = attn[:, None].to(q.dtype)
    else:
        attn = attention_core(q, ck, cv, positions, kv_cache["pos"],
                              causal=cfg.causal, sliding_window=cfg.sliding_window,
                              kv_valid=kv_cache["valid"].to(torch.bool))
    return logical_constraint(attention_out(params, attn), "batch", None, None), kv_cache


def _shard_offset(x, dim: int):
    """(first index, shard count) of this device's shard of DTensor ``x``'s
    dim ``dim`` (``torch.chunk``'s split, the mesh dims that shard it
    major to minor)."""
    from torch.distributed.tensor import Shard
    mesh, idx, n = x.device_mesh, 0, 1
    for i, p in enumerate(x.placements):
        if isinstance(p, Shard) and p.dim == dim:
            idx = idx * mesh.size(i) + mesh.get_local_rank(i)
            n *= mesh.size(i)
    return idx * -(-x.shape[dim] // n), n


def _follow(placements, dims: Mapping[int, int]) -> tuple:
    """Placements for a tensor that follows another's sharding: mesh dims
    sharding the other's dim d shard dim ``dims[d]``; others replicate."""
    from torch.distributed.tensor import Replicate, Shard
    return tuple(Shard(dims[p.dim]) if isinstance(p, Shard) and p.dim in dims
                 else Replicate() for p in placements)


def _from_local(t, mesh, placements, shape):
    DTensor = _dtensor_type()
    stride = torch.empty(shape, device="meta").stride()
    return DTensor.from_local(t, mesh, placements, run_check=False, shape=shape,
                              stride=stride)


@torch.no_grad()
def write_cache(kv_cache: dict, slot: int, k, v, positions) -> None:
    """Write k/v [B, Sq, K, hd] and their positions at ``slot`` of one
    layer's cache, in place. On DTensors each device writes into its own
    shard: the cache is not moved, the new entries follow its placements
    (a sequence-sharded cache takes the write in the shard that holds
    ``slot``)."""
    ck = kv_cache["k"]
    Sq = k.shape[1]
    if not is_dtensor(ck):
        ck[:, slot:slot + Sq] = k.to(ck.dtype)
        kv_cache["v"][:, slot:slot + Sq] = v.to(ck.dtype)
        kv_cache["pos"][:, slot:slot + Sq] = positions.to(kv_cache["pos"].dtype)
        kv_cache["valid"][:, slot:slot + Sq] = 1
        return
    mesh = ck.device_mesh
    new_pl = _follow(ck.placements, {0: 0, 2: 2})
    pos_pl = _follow(ck.placements, {0: 0})
    lo = slot - _shard_offset(ck, 1)[0]
    if not 0 <= lo <= ck.to_local().shape[1] - Sq:
        return
    for name, new, pl in (("k", k, new_pl), ("v", v, new_pl), ("pos", positions, pos_pl)):
        dst = kv_cache[name].to_local()
        if not isinstance(new, _dtensor_type()):
            new = _from_local(new, mesh, [_replicate()] * mesh.ndim, tuple(new.shape))
        dst[:, lo:lo + Sq] = new.redistribute(mesh, pl).to_local().to(dst.dtype)
    kv_cache["valid"].to_local()[:, lo:lo + Sq] = 1


def _replicate():
    from torch.distributed.tensor import Replicate
    return Replicate()


def merge_splits(out: torch.Tensor, lse: torch.Tensor) -> torch.Tensor:
    """Merge attention over n disjoint key ranges: out [n, B, H, hd] f32 and
    lse [n, B, H] (each range's log-sum-exp) -> [B, H, hd], the log-sum-exp
    merge ``flash_decode`` does across its splits. On DTensors sharded on
    dim 0 it is one all-reduce of the rescaled partials (after a small one
    of the maxima)."""
    m = lse.amax(dim=0)
    w = torch.exp(lse - m)
    packed = torch.cat([out * w[..., None], w[..., None]], dim=-1).sum(dim=0)
    packed = reduce_partial(packed)
    return packed[..., :-1] / packed[..., -1:]


@torch.no_grad()
def decode_attention(q: torch.Tensor, ck: torch.Tensor, cv: torch.Tensor, kv_len: int, *,
                     use_kernel: bool = True) -> torch.Tensor:
    """One query position q [B, H, hd] against a cache [B, S, K, hd] whose
    positions 0..kv_len-1 are written: the ``flash_decode`` kernel (or its
    plain version). Returns [B, H, hd] f32.

    On DTensors each device calls it on its own shard of the cache, the
    query placed to match (batch and KV heads as the cache's). A cache
    sharded on its sequence (KV heads that do not divide the model axis)
    is not gathered: each shard attends over its slice with its share of
    ``kv_len`` and returns its output and log-sum-exp, and the shards merge
    across the axis by :func:`merge_splits`."""
    B, H, hd = q.shape
    if not is_dtensor(ck):
        lens = torch.full((B,), kv_len, dtype=torch.int32, device=q.device)
        return ops.decode_attention(q, ck, cv, lens, use_kernel=use_kernel)
    from torch.distributed.tensor import Shard
    mesh = ck.device_mesh
    q_pl = _follow(ck.placements, {0: 0, 2: 1})
    if not isinstance(q, _dtensor_type()):
        q = _from_local(q, mesh, [_replicate()] * mesh.ndim, (B, H, hd))
    q_loc = q.redistribute(mesh, q_pl).to_local()
    k_loc, v_loc = ck.to_local(), cv.to_local()
    offset, n = _shard_offset(ck, 1)
    lens = torch.full((k_loc.shape[0],), max(0, min(kv_len - offset, k_loc.shape[1])),
                      dtype=torch.int32, device=k_loc.device)
    if n == 1:
        out = ops.decode_attention(q_loc, k_loc, v_loc, lens, use_kernel=use_kernel)
        return _from_local(out, mesh, q_pl, (B, H, hd))
    out, lse = ops.decode_attention(q_loc, k_loc, v_loc, lens, use_kernel=use_kernel,
                                    return_lse=True)
    part_pl = tuple(Shard(0) if isinstance(p, Shard) and p.dim == 1 else
                    (Shard(1) if isinstance(p, Shard) and p.dim == 0 else _replicate())
                    for p in ck.placements)
    return merge_splits(_from_local(out[None], mesh, part_pl, (n, B, H, hd)),
                        _from_local(lse[None], mesh, part_pl, (n, B, H)))


def cross_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    decode: bool = False, use_kernel: bool = True) -> torch.Tensor:
    """Non-causal attention of q [B, Sq, H, hd] onto image keys and values
    k/v [B, T, K, hd]: no positions and no mask, every key seen by every
    query. A decode call (one query position against the cached image K/V)
    goes through the ``flash_decode`` kernel with ``kv_len = T`` for every
    row, the kernel's prefix mask then masking nothing; other calls take
    :func:`attention_core`. Returns [B, Sq, H, hd] in q's dtype."""
    B, Sq = q.shape[:2]
    if decode and Sq == 1:
        attn = decode_attention(q[:, 0].contiguous(), k, v, k.shape[1], use_kernel=use_kernel)
        return attn[:, None].to(q.dtype)
    q = logical_constraint(q, "batch", "q_seq", "heads", None)
    k = logical_constraint(k, "batch", None, "kv_heads", None)
    v = logical_constraint(v, "batch", None, "kv_heads", None)
    qpos = torch.zeros((B, Sq), dtype=torch.int32, device=q.device)
    kpos = torch.zeros((B, k.shape[1]), dtype=torch.int32, device=q.device)
    return attention_core(q, k, v, qpos, kpos, causal=False)


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
    xn = ("batch", None, None)
    h = local_einsum("bsd,df->bsf", x, params["w1"], xn)
    if gated:
        h = F.silu(h) * local_einsum("bsd,df->bsf", x, params["w3"], xn)
    else:
        h = F.gelu(h, approximate="tanh")
    h = logical_constraint(h, "batch", None, "ff")
    return local_einsum("bsf,fd->bsd", h, params["w2"], ("batch", None, "ff"))
