"""Step functions and abstract inputs for every (arch x shape) dry-run cell.

The port of ``src/repro/launch/steps.py``. ``input_specs(cfg, shape)``
gives fake tensors (``FakeTensorMode``: shapes and dtypes, nothing
allocated) for every model input; ``build_step`` returns the step function,
its arguments as DTensors over a mesh with the plan's placements, and the
placements of its inputs and outputs.

Trees are the reference's: params stacked ``[L, ...]`` (the step walks one
view per layer of them, the port's per-layer blocks, so a layer's spec is
the stacked leaf's with the leading ``None`` dropped), the train state
``{"params", "opt": {"m", "v"}, "step"}``, the decode cache in
``init_cache``'s layout (``transformer.cache_tree``). A decode cell's cache
holds ``seq_len - 1`` written positions and its step decodes position
``seq_len - 1``: the port's ``decode_step`` takes the host position that
equals the cache's length, so the batch's ``pos`` rides along unread.

Traced steps run the MoE layers at their static capacity
(``moe.moe_ffn(static_capacity=True)``): a fake tensor has no values for
the dynamic path's host read of the per-expert counts.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.launch import sharding as sh
from repro_torch.models import transformer as T
from repro_torch.optim import AdamW, make_train_step
from repro_torch.tree import flatten, tree_map, unflatten

ACT_DTYPE = torch.bfloat16


def _fake_mode(fake_mode):
    from torch._subclasses.fake_tensor import FakeTensorMode
    return fake_mode or FakeTensorMode()


def input_specs(cfg: ModelConfig, shape: ShapeConfig, *, device="cuda",
                fake_mode=None) -> dict:
    """Fake tensors for the data inputs of this cell."""
    B, S = shape.global_batch, shape.seq_len

    def sds(s, dtype):
        return torch.empty(s, dtype=dtype, device=device)
    with _fake_mode(fake_mode):
        if shape.kind == "decode":
            return {"tokens": sds((B, 1), torch.int32), "pos": sds((), torch.int32)}
        batch = {}
        if cfg.family == "encoder":
            batch["frames"] = sds((B, S, cfg.d_model), ACT_DTYPE)
        else:
            batch["tokens"] = sds((B, S), torch.int32)
        if shape.kind == "train":
            batch["labels"] = sds((B, S), torch.int32)
        if cfg.family == "vlm":
            batch["images"] = sds((B, cfg.num_image_tokens, cfg.d_model), ACT_DTYPE)
        return batch


def abstract_state(cfg: ModelConfig, optimizer, *, device="cuda", fake_mode=None) -> dict:
    mode = _fake_mode(fake_mode)
    params = T.abstract_params(cfg, dtype=ACT_DTYPE, device=device, fake_mode=mode)
    with mode:
        return {"params": params, "opt": optimizer.init(params),
                "step": torch.zeros((), dtype=torch.int32, device=device)}


def abstract_cache(cfg: ModelConfig, shape: ShapeConfig, *, device="cuda",
                   fake_mode=None) -> dict:
    """The decode cache of this cell in the reference's layout
    (``transformer.cache_tree``), as fake tensors."""
    meta = T.cache_tree(T.init_cache(cfg, shape.global_batch, shape.seq_len,
                                     dtype=ACT_DTYPE, device="meta"))
    with _fake_mode(fake_mode):
        return tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype, device=device), meta)


def quantize_params_abstract(params):
    """Int8 per-tensor-quantized serving weights: each matrix becomes
    {"q": int8 payload, "s": f32 scale}; norms and vectors stay as they
    are (tiny, precision-sensitive)."""
    def q(p):
        if p.dim() >= 2:
            return {"q": torch.empty_like(p, dtype=torch.int8),
                    "s": torch.empty((), dtype=torch.float32, device=p.device)}
        return p
    return tree_map(q, params)


def dequantize_params(qparams, dtype=ACT_DTYPE):
    def dq(p):
        if isinstance(p, dict) and set(p) == {"q", "s"}:
            return p["q"].to(dtype) * p["s"].to(dtype)
        if isinstance(p, dict):
            return {k: dq(v) for k, v in p.items()}
        return p
    return dq(qparams)


def place(tree, placements, mesh):
    """Each leaf of ``tree`` (plain or fake tensors, whole) as a DTensor
    over ``mesh`` with its placements (the matching leaf of ``placements``):
    the local shard of this rank, nothing communicated."""
    from torch.distributed.tensor import DTensor, Shard

    def one(t, pl):
        local = t
        for i, p in enumerate(pl):
            if isinstance(p, Shard):
                local = torch.chunk(local, mesh.size(i), dim=p.dim)[mesh.get_local_rank(i)]
        return DTensor.from_local(local.contiguous(), mesh, pl, run_check=False,
                                  shape=t.shape, stride=t.stride())
    return map_placed(one, tree, placements)


def map_placed(fn, tree, placements):
    """``fn(leaf, placements)`` over the leaves of ``tree`` and the matching
    placement tuples of ``placements`` (a tree of them shaped as ``tree``)."""
    def at(node, path):
        for k in path:
            node = node[k]
        return node
    paths, xs = flatten(tree)
    return unflatten(tree, [fn(x, at(placements, p)) for p, x in zip(paths, xs)])


def build_step(cfg: ModelConfig, shape: ShapeConfig, mesh, *,
               fsdp: bool = True, expert_parallel: bool = True, serve_int8: bool = False,
               seq_parallel=None, device: Optional[str] = None,
               fake_mode=None, values=None) -> Tuple:
    """Returns (step_fn, args, in_placements, out_placements, plan).

    ``args`` are DTensors over ``mesh`` with the plan's placements: fake
    tensors of ``fake_mode`` (a new ``FakeTensorMode`` if None) on the mesh's
    device type, or, given ``values`` (a function from the abstract args to
    whole plain tensors of the same shapes and dtypes), those values, each
    rank keeping its shard. ``in_placements`` / ``out_placements`` are trees
    of placement tuples; the caller redistributes the step's outputs to
    ``out_placements`` (the reference's jit ``out_shardings``). Training
    always recomputes each block in the backward, as the port's
    ``forward(mode="train")`` does (the reference's ``remat``)."""
    device = device or mesh.device_type
    mode = _fake_mode(fake_mode)
    sp = cfg.seq_parallel if seq_parallel is None else seq_parallel
    plan = sh.make_plan(cfg, mesh, mode="train" if shape.kind == "train" else "serve",
                        fsdp=fsdp, expert_parallel=expert_parallel, seq_parallel=sp)
    batch_sp = sh.batch_specs(cfg, plan, shape.kind, shape.global_batch)
    data = input_specs(cfg, shape, device=device, fake_mode=mode)

    def finish(step, args, in_sp, out_pl):
        in_pl = sh.to_shardings(mesh, in_sp, args)
        if values is None:
            return step, _place_fake(args, in_pl, mesh, mode), in_pl, out_pl, plan
        return step, place(values(args), in_pl, mesh), in_pl, out_pl, plan

    if shape.kind == "train":
        optimizer = AdamW(lr=1e-4, weight_decay=0.1)
        state = abstract_state(cfg, optimizer, device=device, fake_mode=mode)
        psp = sh.param_specs(cfg, plan, state["params"])
        ssp = sh.state_specs(psp)
        grad_pl = sh.to_shardings(mesh, psp, state["params"])

        def loss(p, b):
            return T.loss_fn(p, b, cfg, static_moe=True)

        # pin the grads to the params' placements (FSDP's reduce-scatter)
        def constrain_grads(grads):
            return map_placed(lambda g, pl: g.redistribute(mesh, pl), grads, grad_pl)
        step = make_train_step(loss, optimizer, grad_transform=constrain_grads,
                               microbatches=cfg.microbatches)
        out_pl = (sh.to_shardings(mesh, ssp, state),
                  {"loss": sh.to_placements(sh.Spec(), mesh),
                   "grad_norm": sh.to_placements(sh.Spec(), mesh)})
        return finish(step, (state, data), (ssp, batch_sp), out_pl)

    params = T.abstract_params(cfg, dtype=ACT_DTYPE, device=device, fake_mode=mode)
    psp = sh.param_specs(cfg, plan, params)
    vocab_out = plan.vocab if cfg.vocab_size % plan.model_size == 0 else None

    if shape.kind == "prefill":
        def step(p, b):
            return T.prefill_step(p, b, cfg, static_moe=True)
        out_pl = sh.to_placements(sh.Spec(plan.batch_axes, None, vocab_out), mesh)
        return finish(step, (params, data), (psp, batch_sp), out_pl)

    # decode
    cache = abstract_cache(cfg, shape, device=device, fake_mode=mode)
    csp = sh.cache_specs(cfg, plan, cache)
    length = shape.seq_len - 1

    def decode(p, c, b):
        logits, out = T.decode_step(T._TreeView(p, cfg), T.cache_from_tree(cfg, c, length),
                                    b["tokens"], length, static_moe=True)
        return logits, T.cache_tree(out)

    if serve_int8:
        # int8 weight serving: the memory-bound decode step reads half the
        # weight bytes
        with mode:
            qparams = quantize_params_abstract(params)
        qpsp = _quant_specs(qparams, sh._broadcast_specs(psp, params))

        def step(qp, c, b):
            return decode(dequantize_params(qp), c, b)
        args, in_sp = (qparams, cache, data), (qpsp, csp, batch_sp)
    else:
        step = decode
        args, in_sp = (params, cache, data), (psp, csp, batch_sp)
    out_pl = (sh.to_placements(sh.Spec(plan.batch_axes if shape.global_batch > 1 else None,
                                       None, vocab_out), mesh),
              sh.to_shardings(mesh, csp, cache))
    return finish(step, args, in_sp, out_pl)


def _quant_specs(qparams, specs):
    if isinstance(qparams, dict) and set(qparams) == {"q", "s"}:
        return {"q": specs, "s": sh.Spec()}
    if isinstance(qparams, dict):
        return {k: _quant_specs(v, specs[k]) for k, v in qparams.items()}
    return specs


def _place_fake(tree, placements, mesh, mode):
    """Fake DTensors: each leaf's local shard made directly as a fake tensor
    of the shard's shape (no whole tensor is sliced)."""
    from torch.distributed.tensor import DTensor, Shard

    def one(t, pl):
        shape = list(t.shape)
        for i, p in enumerate(pl):
            if isinstance(p, Shard):
                n, r = mesh.size(i), mesh.get_local_rank(i)
                chunk = -(-shape[p.dim] // n)
                shape[p.dim] = max(0, min(chunk, shape[p.dim] - r * chunk))
        with mode:
            local = torch.empty(shape, dtype=t.dtype, device=t.device)
        return DTensor.from_local(local, mesh, pl, run_check=False, shape=t.shape,
                                  stride=t.stride())
    return map_placed(one, tree, placements)
