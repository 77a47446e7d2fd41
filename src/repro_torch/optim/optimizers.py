"""Optimizers over trees of tensors: AdamW, SGD; schedules; train-step factory.

The port of ``repro.optim.optimizers``. A tree is nested dicts and lists of
tensors with the reference's key paths (``repro_torch.tree``), walked in the
reference's order, so ``global_norm`` adds its leaves in the same order.
Moments are f32 whatever the param dtype; ``step`` is an int32 0-d tensor.
Updates are functional, as the reference's: a step returns new tensors and
leaves its input state as it was.

Every division of a device tensor divides by a tensor on the same device
(``_full``): on CUDA, a division by a host scalar becomes a multiply by its
reciprocal, one ulp off the reference (ROADMAP section 3, rule 1).
"""
from __future__ import annotations

import ctypes
import ctypes.util
import dataclasses
import math
from typing import Any, Callable, Optional

import numpy as np
import torch

from repro_torch.tree import flatten, leaves, tree_map, unflatten


def _full(value: float, like: torch.Tensor) -> torch.Tensor:
    """``value`` as a 0-d f32 tensor on ``like``'s device (a fill, no copy)."""
    return torch.full((), value, dtype=torch.float32, device=like.device)


def elementwise(fn: Callable, *xs):
    """``fn(*xs)`` of same-shaped tensors (0-d ones broadcast). On DTensors
    placed alike (the launch tooling's traced train steps: grads pinned to
    their params' placements, moments sharded as the params) it runs on
    each device's shards, placed as the first: an elementwise function
    needs no collective, and DTensor need not propagate its every
    operator. Returns what ``fn`` returns, each tensor placed so."""
    from torch.distributed.tensor import DTensor
    first = xs[0]
    if not isinstance(first, DTensor):
        return fn(*xs)
    out = fn(*[x.to_local() if isinstance(x, DTensor) else x for x in xs])

    def wrap(t):
        return DTensor.from_local(t, first.device_mesh, first.placements, run_check=False,
                                  shape=first.shape, stride=first.stride())
    return tuple(map(wrap, out)) if isinstance(out, tuple) else wrap(out)


def _sum_squares(x: torch.Tensor) -> torch.Tensor:
    """sum(x ** 2) in f32; on a DTensor, each device's shard's sum, a
    partial sum over the mesh dims that shard it."""
    from torch.distributed.tensor import DTensor, Partial, Replicate
    if not isinstance(x, DTensor):
        return torch.sum(torch.square(x.to(torch.float32)))
    local = torch.sum(torch.square(x.to_local().to(torch.float32)))
    return DTensor.from_local(local, x.device_mesh,
                              [Replicate() if p.is_replicate() else Partial()
                               for p in x.placements], run_check=False, shape=(), stride=())


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(_sum_squares(x) for x in leaves(tree)))


def clip_by_global_norm(tree, max_norm: float):
    norm = global_norm(tree)
    scale = torch.clamp(torch.div(_full(max_norm, norm), norm + 1e-9), max=1.0)
    return tree_map(lambda x: elementwise(
        lambda x, s: (x.to(torch.float32) * s).to(x.dtype), x, scale), tree), norm


def _cosf():
    """The C library's single-precision ``cosf``: XLA's CPU backend calls
    it, while ``torch.cos`` (SLEEF) and a float64 cosine rounded to f32
    each differ from it by an ulp on some inputs."""
    libm = ctypes.CDLL(ctypes.util.find_library("m"))
    libm.cosf.restype = ctypes.c_float
    libm.cosf.argtypes = [ctypes.c_float]
    return libm.cosf


def cosine_schedule(base_lr: float, warmup: int, total: int) -> Callable:
    """Linear warmup to ``base_lr`` over ``warmup`` steps, then a cosine
    decay to 0 at ``total``; f32 as the reference computes it, bit for bit.

    The schedule is a table of its values up to ``last = max(total,
    warmup + 1)``, computed once on the host in the reference's f32
    operations (``cosf`` for the cosine); ``lr(step)`` gathers from it on
    ``step``'s device, so a step needs no device sync and the card and the
    CPU get the same rates. From ``last`` on the reference's value no
    longer changes (``frac`` is clipped to 1 and the warmup is over), so
    later steps take the table's last value."""
    f32 = np.float32
    last = max(total, warmup + 1)
    steps = np.arange(last + 1, dtype=f32)
    warm = f32(base_lr) * steps / f32(max(1, warmup))
    frac = np.clip((steps - f32(warmup)) / f32(max(1, total - warmup)), f32(0), f32(1))
    cosf = _cosf()
    cos = np.array([cosf(v) for v in (f32(math.pi) * frac).tolist()], dtype=f32)
    table = np.where(steps < f32(warmup), warm, f32(0.5 * base_lr) * (f32(1) + cos))
    on_device = {}

    def lr(step: torch.Tensor) -> torch.Tensor:
        if step.device not in on_device:
            on_device[step.device] = torch.from_numpy(table).to(step.device)
        return torch.take(on_device[step.device], torch.clamp(step.long(), 0, last))
    return lr


def _zeros_f32(p: torch.Tensor) -> torch.Tensor:
    return torch.zeros(p.shape, dtype=torch.float32, device=p.device)


@dataclasses.dataclass(frozen=True)
class AdamW:
    lr: Any = 1e-3  # float or schedule fn
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.0

    def init(self, params):
        return {"m": tree_map(_zeros_f32, params), "v": tree_map(_zeros_f32, params)}

    def update(self, grads, opt_state, params, step):
        if hasattr(step, "to_local"):      # a replicated DTensor: the updates run locally
            step = step.to_local()
        lr = self.lr(step) if callable(self.lr) else self.lr
        b1, b2 = self.b1, self.b2
        t = step.to(torch.float32) + 1.0
        corr1 = 1.0 - b1 ** t
        corr2 = 1.0 - b2 ** t

        def upd(g, m, v, p):
            g = g.to(torch.float32)
            m = b1 * m + (1 - b1) * g
            v = b2 * v + (1 - b2) * torch.square(g)
            mhat = m / corr1
            vhat = v / corr2
            u = mhat / (torch.sqrt(vhat) + self.eps)
            if self.weight_decay:
                u = u + self.weight_decay * p.to(torch.float32)
            return (-lr * u).to(p.dtype), m, v

        out = [elementwise(upd, *a) for a in zip(leaves(grads), leaves(opt_state["m"]),
                                                 leaves(opt_state["v"]), leaves(params))]
        return (unflatten(grads, [o[0] for o in out]),
                {"m": unflatten(grads, [o[1] for o in out]),
                 "v": unflatten(grads, [o[2] for o in out])})


@dataclasses.dataclass(frozen=True)
class SGD:
    lr: Any = 1e-2
    momentum: float = 0.9

    def init(self, params):
        return {"mom": tree_map(_zeros_f32, params)}

    def update(self, grads, opt_state, params, step):
        lr = self.lr(step) if callable(self.lr) else self.lr

        def upd(g, mom, p):
            mom = self.momentum * mom + g.to(torch.float32)
            return (-lr * mom).to(p.dtype), mom

        out = [upd(*a) for a in zip(leaves(grads), leaves(opt_state["mom"]),
                                    leaves(params))]
        return (unflatten(grads, [o[0] for o in out]),
                {"mom": unflatten(grads, [o[1] for o in out])})


def apply_updates(params, updates):
    return tree_map(lambda p, u: elementwise(lambda p, u: p + u.to(p.dtype), p, u),
                    params, updates)


def TrainState(params, optimizer) -> dict:
    """``{"params", "opt", "step"}``, ``step`` an int32 0-d tensor on the
    device of the first param."""
    dev = leaves(params)[0].device
    return {"params": params, "opt": optimizer.init(params),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def value_and_grad(loss_fn: Callable, params, batch):
    """(loss, grads) of ``loss_fn(params, batch)``: autograd over the leaves.
    A leaf the loss does not use (the encoder's embedding table) gets a zero
    grad, as ``jax.grad`` gives it."""
    _, xs = flatten(params)
    xs = [x.detach().requires_grad_(True) for x in xs]
    with torch.enable_grad():
        loss = loss_fn(unflatten(params, xs), batch)
        grads = torch.autograd.grad(loss, xs, materialize_grads=True)
    return loss.detach(), unflatten(params, list(grads))


def microbatch(x: torch.Tensor, M: int, i: int) -> torch.Tensor:
    """Microbatch i of M of a batch leaf, split on its leading dim: rows
    ``i * B/M .. (i+1) * B/M``. A DTensor whose batch is sharded splits
    each device's own rows instead (the data-parallel microbatch), so no
    row moves between devices."""
    from torch.distributed.tensor import DTensor, Shard
    if isinstance(x, DTensor) and any(isinstance(p, Shard) and p.dim == 0
                                      for p in x.placements):
        local = x.to_local()
        part = local.reshape((M, local.shape[0] // M) + tuple(local.shape[1:]))[i]
        shape = (x.shape[0] // M,) + tuple(x.shape[1:])
        return DTensor.from_local(part, x.device_mesh, x.placements, run_check=False,
                                  shape=shape, stride=torch.empty(shape, device="meta").stride())
    return x.reshape((M, x.shape[0] // M) + tuple(x.shape[1:]))[i]


def make_train_step(loss_fn: Callable, optimizer, *, clip_norm: Optional[float] = 1.0,
                    grad_transform: Optional[Callable] = None,
                    microbatches: int = 1):
    """loss_fn(params, batch) -> scalar. Returns train_step(state, batch).

    microbatches > 1 runs gradient accumulation: every batch leaf is split
    on its leading dim and fwd/bwd runs per microbatch in a loop (the
    reference's ``lax.scan``), with an f32 grad accumulator.
    """

    def grads_of(params, batch):
        if microbatches == 1:
            return value_and_grad(loss_fn, params, batch)
        M = microbatches
        acc = tree_map(_zeros_f32, params)
        loss = torch.zeros((), dtype=torch.float32, device=leaves(params)[0].device)
        for i in range(M):
            li, gi = value_and_grad(loss_fn, params,
                                    tree_map(lambda x: microbatch(x, M, i), batch))
            loss = loss + li
            acc = tree_map(lambda a, g: a + g.to(torch.float32), acc, gi)
        m = _full(M, loss)
        grads = tree_map(lambda g, p: (g / m).to(p.dtype), acc, params)
        return loss / m, grads

    def train_step(state, batch):
        loss, grads = grads_of(state["params"], batch)
        with torch.no_grad():
            if grad_transform is not None:
                grads = grad_transform(grads)
            gnorm = torch.zeros((), dtype=torch.float32, device=loss.device)
            if clip_norm is not None:
                grads, gnorm = clip_by_global_norm(grads, clip_norm)
            updates, new_opt = optimizer.update(grads, state["opt"], state["params"],
                                                state["step"])
            new_params = apply_updates(state["params"], updates)
        new_state = {"params": new_params, "opt": new_opt, "step": state["step"] + 1}
        return new_state, {"loss": loss, "grad_norm": gnorm}

    return train_step
