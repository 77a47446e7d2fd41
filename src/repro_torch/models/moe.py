"""Mixture-of-Experts layer: top-k router and capacity-based GShard dispatch.

The port of ``src/repro/models/moe.py``. The routing is the reference's to
the token: groups of ``GROUP_TOKENS`` tokens when the sequence is longer than
that and a multiple of it, else one group of the whole sequence; a capacity
of ``max(k, int(cf * Sg * k / E))`` slots per expert and group; k rounds of
``argmax`` over the gates not yet taken (first index on ties), tokens
claiming each expert's slots in sequence order with the count carried
across rounds; a token whose slot is ``>= capacity`` is dropped for that
expert; the combine weight is the gate, not renormalised.

The reference builds one-hot ``[G, S, E, C]`` dispatch and combine tensors
and runs every expert over all of its C slots as dense einsums. Here the
kept (token, expert, gate) assignments are listed instead, sorted by expert,
and each expert's FFN runs only on its kept rows: one host read of the
per-expert counts a layer, then ``torch.matmul`` on each expert's rows. In a
decode step (one token a group, C = k) that is k rows a token where the
einsums compute E x k. The results go back through a ``[tokens, k]`` slot
buffer summed over the rounds, which is deterministic on the card (an
``index_add_`` there accumulates with atomics), and rows are gathered with
``F.embedding``, whose backward is a sorted segment sum.

``static_capacity=True`` (what the launch tooling's traced steps pass)
gives every expert its ``capacity`` slots of every group instead, the
shapes the reference compiles, with no host read: kept rows fill an
expert's slots in (round, token) order, the rest of its slots hold a zero
row, and each expert runs over all its slots. The kept set, the gates and
the sums are the dynamic path's (``tests/test_torch_dryrun.py`` holds the
two equal under forced drops). On DTensors the body runs on each device's
batch shard and experts (or expert hidden slice), its output a partial sum
over the model axis.
"""
from __future__ import annotations

import functools
import math
from typing import Mapping

import torch
import torch.nn.functional as F

GROUP_TOKENS = 256  # the reference's routing-group size


def moe_shapes(cfg) -> dict:
    """Parameter shapes of one MoE layer, in the reference's layouts."""
    d, E, f = cfg.d_model, cfg.num_experts, cfg.moe_d_ff
    p = {"router": (d, E), "w1": (E, d, f), "w2": (E, f, d)}
    if cfg.ffn_gated:
        p["w3"] = (E, d, f)
    if cfg.num_shared_experts:
        fs = f * cfg.num_shared_experts
        p["shared_w1"] = (d, fs)
        p["shared_w2"] = (fs, d)
        if cfg.ffn_gated:
            p["shared_w3"] = (d, fs)
    return p


def init_moe(cfg, generator: torch.Generator, leading=()) -> dict:
    """One MoE layer's weights (``leading`` dims in front of each, e.g. the
    layer count), drawn as the reference's ``init_moe``: N(0, 1/fan_in),
    the experts' fan-in their input dim."""
    out = {}
    for name, shape in moe_shapes(cfg).items():
        if name == "shared_w3":
            # The reference draws shared_w1 and shared_w3 from one key
            # (src/repro/models/moe.py:33-37), so the two are equal.
            out[name] = out["shared_w1"].clone()
            continue
        fan_in = shape[-2]
        out[name] = torch.randn(tuple(leading) + shape, generator=generator) \
            * (1.0 / max(1, fan_in) ** 0.5)
    return out


def _rounds(gates: torch.Tensor, top_k: int, capacity: int):
    """Per round r, (expert [G, S], slot [G, S], kept [G, S]) of the
    reference's ``_topk_dispatch``; and the kept count [G, E]."""
    G, S, E = gates.shape
    base = torch.zeros((G, E), dtype=torch.int64, device=gates.device)
    remaining = gates
    out = []
    for _ in range(top_k):
        idx = torch.argmax(remaining, dim=-1)                        # [G, S]
        onehot = F.one_hot(idx, E)                                   # [G, S, E]
        ahead = (torch.cumsum(onehot, dim=1) - onehot).gather(-1, idx[..., None])[..., 0]
        pos = ahead + base.gather(-1, idx)                           # [G, S]
        keep = pos < capacity
        base = base + (onehot * keep[..., None]).sum(dim=1)
        remaining = remaining * (1.0 - onehot.to(remaining.dtype))
        out.append((idx, pos, keep))
    return out, base


def topk_assign(gates: torch.Tensor, top_k: int, capacity: int):
    """The kept assignments of the reference's ``_topk_dispatch``.

    gates [G, S, E] (no gradient needed: only the choice is made here).
    Returns (token [n] flat index into G * S, expert [n], round [n], kept
    count [G, E]), the assignments in round order, then token order."""
    G, S, _ = gates.shape
    rounds, base = _rounds(gates, top_k, capacity)
    flat = torch.arange(G * S, device=gates.device)
    tokens, experts, rnds = [], [], []
    for r, (idx, _, keep) in enumerate(rounds):
        keep = keep.reshape(-1)
        tokens.append(flat[keep])
        experts.append(idx.reshape(-1)[keep])
        rnds.append(torch.full_like(flat[keep], r))
    return torch.cat(tokens), torch.cat(experts), torch.cat(rnds), base


def _expert_ffn(w1, w2, w3, x: torch.Tensor) -> torch.Tensor:
    h = torch.matmul(x, w1)
    if w3 is not None:
        h = F.silu(h) * torch.matmul(x, w3)
    else:
        h = F.gelu(h, approximate="tanh")
    return torch.matmul(h, w2)


def _group_len(S: int) -> int:
    """Tokens of a routing group in a sequence of S."""
    return GROUP_TOKENS if S > GROUP_TOKENS and S % GROUP_TOKENS == 0 else S


def _group(x: torch.Tensor):
    B, S, d = x.shape
    return x.reshape(B * S // _group_len(S), _group_len(S), d)


def capacity_of(cfg, x: torch.Tensor) -> int:
    """Slots per expert and routing group for input x [B, S, d]."""
    Sg = _group_len(x.shape[1])
    return max(cfg.top_k, int(cfg.moe_capacity_factor * Sg * cfg.top_k / cfg.num_experts))


def _aux(gates_sum, counts, n_tok, E):
    """Switch-style aux loss from the gates' and the kept counts' sums over
    the tokens; the kept fraction is built from one-hots in the reference,
    so its gradient flows through the gates only."""
    n = torch.full((), n_tok, dtype=torch.float32, device=gates_sum.device)
    return E * torch.sum((gates_sum / n) * (counts.to(torch.float32) / n))


def _shared(params, y, xf):
    return y + _expert_ffn(params["shared_w1"], params["shared_w2"],
                           params.get("shared_w3"), xf)


def moe_ffn(params: Mapping[str, torch.Tensor], x: torch.Tensor, cfg, *,
            static_capacity: bool = False):
    """x [B, S, d] -> (y [B, S, d], the load-balancing aux loss). With
    ``static_capacity`` every expert runs over its ``capacity`` slots of
    every group (no host read), as the reference compiles it."""
    if static_capacity:
        return _moe_static(params, x, cfg)
    B, S, d = x.shape
    E, k = cfg.num_experts, cfg.top_k
    xg = _group(x)
    G, Sg = xg.shape[:2]
    capacity = capacity_of(cfg, x)

    logits = torch.einsum("gsd,de->gse", xg, params["router"])
    gates = torch.softmax(logits.to(torch.float32), dim=-1)           # [G, Sg, E]
    token, expert, rnd, kept = topk_assign(gates.detach(), k, capacity)
    counts = kept.sum(dim=0)                                          # [E]
    order = torch.argsort(expert, stable=True)
    token, expert, rnd = token[order], expert[order], rnd[order]
    gate = gates.reshape(G * Sg, E)[token, expert].to(x.dtype)        # grads reach the gates

    xf = xg.reshape(G * Sg, d)
    rows = F.embedding(token, xf)                                     # [n, d]
    w3 = params.get("w3")
    outs, lo = [], 0
    for e, n in enumerate(counts.tolist()):                           # one host read a layer
        if n:
            outs.append(_expert_ffn(params["w1"][e], params["w2"][e],
                                    None if w3 is None else w3[e], rows[lo:lo + n]))
        lo += n
    slots = xf.new_zeros((G * Sg, k, d))
    if outs:
        slots = slots.index_put((token, rnd), torch.cat(outs) * gate[:, None])
    y = slots.sum(dim=1)

    if cfg.num_shared_experts:
        y = _shared(params, y, xf)
    aux = _aux(gates.sum(dim=(0, 1)), counts, G * Sg, E)
    return y.reshape(B, S, d), aux


def _static_body(x, router, w1, w2, w3, *, top_k, capacity, e_offset):
    """The capacity dispatch on whole (or local) tensors: x [B, S, d], the
    router over all E experts, w1/w2/w3 the E_loc experts from global index
    ``e_offset``. Returns (y [B, S, d] over these experts, the gates' sum
    [E], the kept counts [E])."""
    B, S, d = x.shape
    xg = _group(x)
    G, Sg = xg.shape[:2]
    E_loc, C = w1.shape[0], capacity
    gates = torch.softmax(torch.einsum("gsd,de->gse", xg, router).to(torch.float32), dim=-1)
    rounds, kept = _rounds(gates.detach(), top_k, capacity)
    # slot table [G, E_loc * C + 1]: the token of every slot, Sg (a zero row)
    # when empty; the last column takes what is dropped or foreign
    table = torch.full((G, E_loc * C + 1), Sg, dtype=torch.int64, device=x.device)
    tok = torch.arange(Sg, device=x.device).expand(G, Sg)
    where = []
    for idx, pos, keep in rounds:
        e = idx - e_offset
        mine = keep & (e >= 0) & (e < E_loc)
        at = torch.where(mine, e * C + pos, E_loc * C)
        table.scatter_(1, at, tok)
        where.append(at)
    table = table[:, :E_loc * C]
    xz = torch.cat([xg, xg.new_zeros((G, 1, d))], dim=1)                # [G, Sg + 1, d]
    xe = torch.gather(xz, 1, table[..., None].expand(G, E_loc * C, d))
    xe = xe.reshape(G, E_loc, C, d).transpose(0, 1).reshape(E_loc, G * C, d)
    h = torch.bmm(xe, w1)
    h = F.silu(h) * torch.bmm(xe, w3) if w3 is not None else F.gelu(h, approximate="tanh")
    ye = torch.bmm(h, w2).reshape(E_loc, G, C, d).transpose(0, 1).reshape(G, E_loc * C, d)
    yz = torch.cat([ye, ye.new_zeros((G, 1, d))], dim=1)                # [G, E_loc*C + 1, d]
    at = torch.stack(where, dim=2)                                      # [G, Sg, k]
    picked = torch.gather(yz, 1, at.reshape(G, Sg * top_k, 1).expand(G, Sg * top_k, d))
    gate = torch.stack([torch.gather(gates, -1, idx[..., None])[..., 0]
                        for idx, _, _ in rounds], dim=2).to(x.dtype)    # [G, Sg, k]
    y = (picked.reshape(G, Sg, top_k, d) * gate[..., None]).sum(dim=2)
    return y.reshape(B, S, d), gates.sum(dim=(0, 1)), kept.sum(dim=0)


def _moe_static(params, x, cfg):
    from repro_torch.models import layers as L
    E, k = cfg.num_experts, cfg.top_k
    capacity = capacity_of(cfg, x)
    w3 = params.get("w3")
    args = (x, params["router"], params["w1"], params["w2"], w3)
    fn = functools.partial(_static_body, top_k=k, capacity=capacity, e_offset=0)
    if not L.is_dtensor(x):
        y, gsum, counts = fn(*args)
    else:
        y, gsum, counts = _static_local(args, top_k=k, capacity=capacity)
        gsum, counts = L.reduce_partial(gsum), L.reduce_partial(counts)
    if cfg.num_shared_experts and L.is_dtensor(x):
        y = y + L.ffn({"w1": params["shared_w1"], "w2": params["shared_w2"],
                       "w3": params.get("shared_w3")}, x, cfg.ffn_gated)
    elif cfg.num_shared_experts:
        B, S, d = x.shape
        y = _shared(params, y.reshape(B * S, d), x.reshape(B * S, d)).reshape(B, S, d)
    return y, _aux(gsum, counts, x.shape[0] * x.shape[1], E)


def _static_local(args, *, top_k, capacity):
    """:func:`_static_body` on each device's shards: x by batch (its
    sequence gathered), the router whole, the experts as the plan places
    them over the model axis (expert-parallel or their hidden dim split),
    their FSDP shards gathered. y comes back a partial sum over the model
    axes that split the experts; the gates' sums and the kept counts partial
    sums over the batch axes."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    from repro_torch.models import layers as L
    x, router, w1, w2, w3 = args
    mesh = x.device_mesh
    bdims = L.batch_mesh_dims(mesh)
    w1_pl = L.gathered(w1)
    split = {i for i, p in enumerate(w1_pl) if isinstance(p, Shard)}
    e_dims = [i for i, p in enumerate(w1_pl) if isinstance(p, Shard) and p.dim == 0]
    e_offset = 0
    for i in e_dims:
        e_offset = e_offset * mesh.size(i) + mesh.get_local_rank(i)
    e_offset *= w1.shape[0] // max(1, math.prod(mesh.size(i) for i in e_dims))
    x_pl = L.placements_for(mesh, ("batch", None, None))
    y_pl = tuple(Shard(0) if i in bdims else Partial() if i in split else Replicate()
                 for i in range(mesh.ndim))
    s_pl = tuple(Partial() if i in bdims else Replicate() for i in range(mesh.ndim))
    fn = functools.partial(_static_body, top_k=top_k, capacity=capacity, e_offset=e_offset)
    return L.run_local(fn, args, (x_pl, (Replicate(),) * mesh.ndim, w1_pl, L.gathered(w2),
                                  None if w3 is None else L.gathered(w3)),
                       (y_pl, s_pl, s_pl))
