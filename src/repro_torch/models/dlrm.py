"""DLRM (paper Fig. 2): bottom MLP -> embeddings -> interaction -> top MLP.

The model's parameters are the reference's tree (``{"bottom": [{"w",
"b"}...], "top": [...], "tables": [...]}``, ``w`` as ``[in, out]``), so the
optimizer and the checkpoint see the reference's key paths and layouts:
:func:`init_params` draws it on the CPU from a ``torch.Generator`` and then
moves it, so one seed gives the same model on every device, and
:func:`forward` / :func:`loss_fn` are the reference's on it.

Serving holds the weights in the ``nn.Module`` ``DLRM`` (loaded from a tree
by :func:`params_from_jax`), whose ``serve_query`` batches as §2.2 does:
user embeddings are looked up once per query (B_U = 1) and broadcast across
the item batch for the top MLP (Eq. 2).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from repro_torch import resolve_device
from repro_torch.tree import flatten, tree_map


@dataclasses.dataclass(frozen=True)
class DLRMArch:
    """Concrete trainable geometry (the train/e2e-example form)."""
    num_dense: int = 13
    embed_dim: int = 64
    user_tables: Sequence[int] = (100_000,) * 8   # rows per user table
    item_tables: Sequence[int] = (100_000,) * 4   # rows per item table
    pooling: int = 8                               # indices per bag (fixed)
    bottom_mlp: Sequence[int] = (256, 128, 64)
    top_mlp: Sequence[int] = (256, 128, 1)

    @property
    def num_tables(self) -> int:
        return len(self.user_tables) + len(self.item_tables)

    @property
    def all_tables(self):
        return tuple(self.user_tables) + tuple(self.item_tables)

    @property
    def top_in(self) -> int:
        f = self.num_tables + 1
        return self.bottom_mlp[-1] + f * (f - 1) // 2

    def param_count(self) -> int:
        n = sum(r * self.embed_dim for r in self.all_tables)
        dims = [self.num_dense] + list(self.bottom_mlp)
        n += sum(a * b + b for a, b in zip(dims[:-1], dims[1:]))
        dims = [self.top_in] + list(self.top_mlp)
        n += sum(a * b + b for a, b in zip(dims[:-1], dims[1:]))
        return n


def _mlp(dims: Sequence[int]) -> nn.ModuleList:
    """Linear layers, left unset (``params_from_jax`` fills them)."""
    return nn.ModuleList(nn.utils.skip_init(nn.Linear, a, b)
                         for a, b in zip(dims[:-1], dims[1:]))


def _run_mlp(layers: nn.ModuleList, x: torch.Tensor, final_act: bool = False):
    for i, lin in enumerate(layers):
        x = lin(x)
        if i < len(layers) - 1 or final_act:
            x = torch.relu(x)
    return x


def embed_bags(tables: Sequence[torch.Tensor], indices: torch.Tensor) -> torch.Tensor:
    """indices: [T, B, P] -> pooled [B, T, E] (sum pooling, SparseLengthsSum).
    ``F.embedding``'s backward is a sorted segment sum, deterministic on the
    card (a plain gather's is an atomic ``index_put_``)."""
    pooled = [F.embedding(indices[t].long(), table).sum(dim=1)
              for t, table in enumerate(tables)]
    return torch.stack(pooled, dim=1)


def interact(z0: torch.Tensor, emb: torch.Tensor) -> torch.Tensor:
    """Dot-product interaction: z0 [B, E], emb [B, T, E] -> [B, E + T(T+1)/2].
    Pairs (i < j) in row-major order, as ``triu_indices(F, k=1)`` lists them."""
    feats = torch.cat([z0[:, None, :], emb], dim=1)          # [B, F, E]
    gram = torch.bmm(feats, feats.transpose(1, 2))            # [B, F, F]
    F = feats.shape[1]
    iu, ju = torch.triu_indices(F, F, offset=1, device=feats.device)
    return torch.cat([z0, gram[:, iu, ju]], dim=1)


class DLRM(nn.Module):
    """The serving DLRM on ``device`` (``cuda`` unless the caller asks for
    the CPU), holding :func:`init_params`'s draw from ``generator`` (seed 0
    if None)."""

    def __init__(self, arch: DLRMArch, *, device="cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = resolve_device(device)
        g = torch.Generator().manual_seed(0) if generator is None else generator
        self.arch = arch
        self.bottom = _mlp([arch.num_dense] + list(arch.bottom_mlp))
        self.top = _mlp([arch.top_in] + list(arch.top_mlp))
        self.tables = nn.ParameterList(nn.Parameter(torch.empty(rows, arch.embed_dim))
                                       for rows in arch.all_tables)
        params_from_jax(self, init_params(arch, device="cpu", generator=g))
        self.to(dev)

    def serve_query(self, user_idx: torch.Tensor, item_idx: torch.Tensor,
                    dense: torch.Tensor) -> torch.Tensor:
        """Inference per §2.2: user bags once (B_U=1), broadcast over the item
        batch. user_idx [Tu, P]; item_idx [Ti, Bi, P]; dense [Bi, num_dense].
        Returns CTR scores [Bi]."""
        n_user = len(self.arch.user_tables)
        tables = list(self.tables)
        user_emb = embed_bags(tables[:n_user], user_idx[:, None, :])  # [1, Tu, E]
        Bi = dense.shape[0]
        user_emb = user_emb.expand((Bi,) + tuple(user_emb.shape[1:]))
        item_emb = embed_bags(tables[n_user:], item_idx)               # [Bi, Ti, E]
        emb = torch.cat([user_emb, item_emb], dim=1)
        z0 = _run_mlp(self.bottom, dense, final_act=True)
        return torch.sigmoid(_run_mlp(self.top, interact(z0, emb))[:, 0])


def bce_with_logits(logit: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Numerically stable BCE with logits, as the reference writes it
    (``maximum``, whose gradient splits at a tie as ``jnp.maximum``'s)."""
    y = labels.to(torch.float32)
    return torch.mean(torch.maximum(logit, torch.zeros_like(logit)) - logit * y
                      + torch.log1p(torch.exp(-torch.abs(logit))))


# ---------------------------------------------------------------------------
# Training on the reference's parameter tree
# ---------------------------------------------------------------------------


def _tree_mlp(layers, x: torch.Tensor, final_act: bool = False) -> torch.Tensor:
    for i, lin in enumerate(layers):
        x = x @ lin["w"] + lin["b"]
        if i < len(layers) - 1 or final_act:
            x = torch.relu(x)
    return x


def forward(params: dict, batch: dict, arch: DLRMArch) -> torch.Tensor:
    """The reference's ``forward`` on its tree: batch ``dense`` [B, num_dense],
    ``indices`` [T, B, P] -> CTR logit [B]."""
    z0 = _tree_mlp(params["bottom"], batch["dense"], final_act=True)
    emb = embed_bags(params["tables"], batch["indices"])
    return _tree_mlp(params["top"], interact(z0, emb))[:, 0]


def loss_fn(params: dict, batch: dict, arch: DLRMArch) -> torch.Tensor:
    return bce_with_logits(forward(params, batch, arch), batch["labels"])


def init_params(arch: DLRMArch, *, device="cuda",
                generator: Optional[torch.Generator] = None) -> dict:
    """The reference's tree for ``arch``, drawn on the CPU from ``generator``
    (seed 0 if None) and moved to ``device``: weights N(0, 1/fan_in), biases
    zero, tables N(0, 1/embed_dim); bottom, top, then tables, each ``w``
    drawn ``[out, in]`` and stored contiguous ``[in, out]`` (as a restored
    checkpoint is: a GEMM's rounding may follow its operands' strides)."""
    dev = resolve_device(device)
    g = torch.Generator().manual_seed(0) if generator is None else generator

    def mlp(dims):
        return [{"w": (torch.randn(b, a, generator=g) / math.sqrt(a)).T.contiguous(),
                 "b": torch.zeros(b)} for a, b in zip(dims[:-1], dims[1:])]
    params = {"bottom": mlp([arch.num_dense] + list(arch.bottom_mlp)),
              "top": mlp([arch.top_in] + list(arch.top_mlp)),
              "tables": [torch.randn(rows, arch.embed_dim, generator=g)
                         / math.sqrt(arch.embed_dim) for rows in arch.all_tables]}
    return tree_map(lambda x: x.to(dev), params)


def _shapes(arch: DLRMArch) -> dict:
    """The reference tree of ``arch`` as storage-free (meta) tensors."""
    def leaf(*shape):
        return torch.empty(shape, device="meta")

    def mlp(dims):
        return [{"w": leaf(a, b), "b": leaf(b)} for a, b in zip(dims[:-1], dims[1:])]
    return {"bottom": mlp([arch.num_dense] + list(arch.bottom_mlp)),
            "top": mlp([arch.top_in] + list(arch.top_mlp)),
            "tables": [leaf(r, arch.embed_dim) for r in arch.all_tables]}


def state_from_jax(state: dict, arch: DLRMArch, *, device="cuda") -> dict:
    """A reference ``TrainState`` (``params``; ``opt``: ``m``/``v`` or
    ``mom``, each a tree like ``params``; ``step``), given as numpy arrays,
    as tensors on ``device``. Every params and moment leaf's shape is
    checked against ``arch``; ``step`` becomes an int32 0-d tensor."""
    dev = resolve_device(device)
    want_paths, want = flatten(_shapes(arch))
    trees = [("params", state["params"])] + [
        (f"opt.{k}", v) for k, v in sorted(state["opt"].items())]
    for where, tree in trees:
        paths, got = flatten(tree)
        shapes = [tuple(np.shape(x)) for x in got]
        if paths != want_paths or shapes != [tuple(w.shape) for w in want]:
            raise ValueError(f"{where}: leaves {list(zip(paths, shapes))} do not match "
                             f"the arch's {[(p, tuple(w.shape)) for p, w in zip(want_paths, want)]}")
    to = lambda x: torch.from_numpy(np.array(x)).to(dev)   # noqa: E731
    return {"params": tree_map(to, state["params"]),
            "opt": {k: tree_map(to, v) for k, v in state["opt"].items()},
            "step": torch.tensor(int(np.asarray(state["step"])), dtype=torch.int32,
                                 device=dev)}


def params_from_jax(model: DLRM, params: dict) -> DLRM:
    """Load a reference parameter tree (``{"bottom": [{"w", "b"}...], "top":
    [...], "tables": [...]}``: the reference's ``init_params`` as numpy
    arrays, or a tree the port trained, as tensors) into ``model``. The
    reference's ``w`` is ``[in, out]`` (used as ``x @ w``); ``nn.Linear``
    keeps ``[out, in]``, so each ``w`` is transposed once here."""
    def load(dst: torch.Tensor, src, transpose=False) -> None:
        if not isinstance(src, torch.Tensor):
            src = torch.from_numpy(np.array(src))
        src = src.detach().to(dst.dtype)
        if transpose:
            src = src.T
        if tuple(src.shape) != tuple(dst.shape):
            raise ValueError(f"shape {tuple(src.shape)} != {tuple(dst.shape)}")
        dst.copy_(src.to(dst.device))

    with torch.no_grad():
        for name in ("bottom", "top"):
            layers = getattr(model, name)
            if len(params[name]) != len(layers):
                raise ValueError(f"{name}: {len(params[name])} layers, "
                                 f"model has {len(layers)}")
            for lin, p in zip(layers, params[name]):
                load(lin.weight, p["w"], transpose=True)
                load(lin.bias, p["b"])
        if len(params["tables"]) != len(model.tables):
            raise ValueError("table count differs")
        for t, src in zip(model.tables, params["tables"]):
            load(t, src)
    return model
