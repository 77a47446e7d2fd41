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
"""
from __future__ import annotations

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


def topk_assign(gates: torch.Tensor, top_k: int, capacity: int):
    """The kept assignments of the reference's ``_topk_dispatch``.

    gates [G, S, E] (no gradient needed: only the choice is made here).
    Returns (token [n] flat index into G * S, expert [n], round [n], kept
    count [G, E]), the assignments in round order, then token order."""
    G, S, E = gates.shape
    base = torch.zeros((G, E), dtype=torch.int64, device=gates.device)
    remaining = gates
    tokens, experts, rounds = [], [], []
    flat = torch.arange(G * S, device=gates.device)
    for r in range(top_k):
        idx = torch.argmax(remaining, dim=-1)                        # [G, S]
        onehot = F.one_hot(idx, E)                                   # [G, S, E]
        ahead = (torch.cumsum(onehot, dim=1) - onehot).gather(-1, idx[..., None])[..., 0]
        pos = ahead + base.gather(-1, idx)                           # [G, S]
        keep = (pos < capacity).reshape(-1)
        base = base + (onehot * keep.reshape(G, S, 1)).sum(dim=1)
        remaining = remaining * (1.0 - onehot.to(remaining.dtype))
        tokens.append(flat[keep])
        experts.append(idx.reshape(-1)[keep])
        rounds.append(torch.full_like(flat[keep], r))
    return torch.cat(tokens), torch.cat(experts), torch.cat(rounds), base


def _expert_ffn(w1, w2, w3, x: torch.Tensor) -> torch.Tensor:
    h = torch.matmul(x, w1)
    if w3 is not None:
        h = F.silu(h) * torch.matmul(x, w3)
    else:
        h = F.gelu(h, approximate="tanh")
    return torch.matmul(h, w2)


def moe_ffn(params: Mapping[str, torch.Tensor], x: torch.Tensor, cfg):
    """x [B, S, d] -> (y [B, S, d], the load-balancing aux loss)."""
    B, S, d = x.shape
    E, k = cfg.num_experts, cfg.top_k
    xg = x
    if S > GROUP_TOKENS and S % GROUP_TOKENS == 0:
        xg = x.reshape(B * (S // GROUP_TOKENS), GROUP_TOKENS, d)
    G, Sg = xg.shape[:2]
    capacity = max(k, int(cfg.moe_capacity_factor * Sg * k / E))

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
        y = y + _expert_ffn(params["shared_w1"], params["shared_w2"],
                            params.get("shared_w3"), xf)

    # Switch-style aux loss; the kept fraction is built from one-hots in the
    # reference, so its gradient flows through the gates only.
    n_tok = torch.tensor(G * Sg, dtype=torch.float32, device=x.device)
    me = gates.sum(dim=(0, 1)) / n_tok
    ce = counts.to(torch.float32) / n_tok
    aux = E * torch.sum(me * ce)
    return y.reshape(B, S, d), aux
