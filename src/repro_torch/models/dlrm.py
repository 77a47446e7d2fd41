"""DLRM (paper Fig. 2): bottom MLP -> embeddings -> interaction -> top MLP.

An ``nn.Module`` port of the reference DLRM. Inference batching matches
§2.2: user embeddings are looked up once per query (B_U = 1) and broadcast
across the item batch for the top MLP (Eq. 2). Weights are drawn on the CPU
from a ``torch.Generator`` and then moved, so one seed gives the same model
on every device.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence

import numpy as np
import torch
from torch import nn

from repro_torch import resolve_device


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


def _mlp(dims: Sequence[int], g: torch.Generator) -> nn.ModuleList:
    """Linear layers with N(0, 1/fan_in) weights and zero biases."""
    layers = nn.ModuleList()
    for a, b in zip(dims[:-1], dims[1:]):
        lin = nn.utils.skip_init(nn.Linear, a, b)
        with torch.no_grad():
            lin.weight.copy_(torch.randn(b, a, generator=g) / math.sqrt(a))
            lin.bias.zero_()
        layers.append(lin)
    return layers


def _run_mlp(layers: nn.ModuleList, x: torch.Tensor, final_act: bool = False):
    for i, lin in enumerate(layers):
        x = lin(x)
        if i < len(layers) - 1 or final_act:
            x = torch.relu(x)
    return x


def embed_bags(tables: Sequence[torch.Tensor], indices: torch.Tensor) -> torch.Tensor:
    """indices: [T, B, P] -> pooled [B, T, E] (sum pooling, SparseLengthsSum)."""
    pooled = [table[indices[t].long()].sum(dim=1) for t, table in enumerate(tables)]
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
    """The DLRM on ``device`` (``cuda`` unless the caller asks for the CPU)."""

    def __init__(self, arch: DLRMArch, *, device="cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = resolve_device(device)
        g = torch.Generator().manual_seed(0) if generator is None else generator
        self.arch = arch
        self.bottom = _mlp([arch.num_dense] + list(arch.bottom_mlp), g)
        self.top = _mlp([arch.top_in] + list(arch.top_mlp), g)
        self.tables = nn.ParameterList(
            nn.Parameter(torch.randn(rows, arch.embed_dim, generator=g)
                         / math.sqrt(arch.embed_dim))
            for rows in arch.all_tables)
        self.to(dev)

    def forward(self, dense: torch.Tensor, indices: torch.Tensor) -> torch.Tensor:
        """dense [B, num_dense], indices [T, B, P] -> CTR logit [B]."""
        z0 = _run_mlp(self.bottom, dense, final_act=True)
        emb = embed_bags(list(self.tables), indices)
        return _run_mlp(self.top, interact(z0, emb))[:, 0]

    def loss_fn(self, dense: torch.Tensor, indices: torch.Tensor,
                labels: torch.Tensor) -> torch.Tensor:
        logit = self(dense, indices)
        y = labels.to(torch.float32)
        # numerically-stable BCE-with-logits
        return torch.mean(torch.clamp(logit, min=0) - logit * y
                          + torch.log1p(torch.exp(-logit.abs())))

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


def params_from_jax(model: DLRM, params: dict) -> DLRM:
    """Load the reference ``init_params`` pytree, given as numpy arrays
    (``{"bottom": [{"w", "b"}...], "top": [...], "tables": [...]}``), into
    ``model``. The reference's ``w`` is ``[in, out]`` (used as ``x @ w``);
    ``nn.Linear`` keeps ``[out, in]``, so each ``w`` is transposed once here."""
    def load(dst: torch.Tensor, src) -> None:
        src = torch.tensor(np.asarray(src), dtype=dst.dtype)
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
                load(lin.weight, np.asarray(p["w"]).T)
                load(lin.bias, p["b"])
        if len(params["tables"]) != len(model.tables):
            raise ValueError("table count differs")
        for t, src in zip(model.tables, params["tables"]):
            load(t, src)
    return model
