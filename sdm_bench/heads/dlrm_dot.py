"""Plain reference of DLRM's dot-interaction scoring head (arXiv:1906.00091,
Fig. 1): a bottom MLP over the dense features, the pairwise dots of its
output and the pooled bags, a top MLP to one logit a query.

``spec``: ``num_dense``, ``num_tables`` and ``embed_dim`` (the pooled block
``[B, num_tables, embed_dim]``), ``bottom_mlp`` (its last width is
``embed_dim``) and ``top_mlp`` (its last width is 1). Every layer is
``x @ w + b`` with ``w`` as ``[in, out]``; ReLU follows every bottom layer
and every top layer but the last. Products go through ``torch.matmul`` of
the namespace given, so a control can round their operands.
"""
from __future__ import annotations


def _layers(name, dims):
    out = []
    for k, (a, b) in enumerate(zip(dims[:-1], dims[1:])):
        out += [(f"{name}.{k}.w", (a, b), a), (f"{name}.{k}.b", (b,), a)]
    return out


def param_shapes(spec):
    """(name, shape, fan-in) of every parameter, bottom MLP then top."""
    f = spec["num_tables"] + 1
    if spec["bottom_mlp"][-1] != spec["embed_dim"] or spec["top_mlp"][-1] != 1:
        raise ValueError("the bottom MLP must end at embed_dim and the top MLP at 1")
    return (_layers("bottom", [spec["num_dense"], *spec["bottom_mlp"]])
            + _layers("top", [spec["embed_dim"] + f * (f - 1) // 2, *spec["top_mlp"]]))


def _mlp(torch, x, weights, name, n, relu_last):
    for k in range(n):
        x = torch.matmul(x, weights[f"{name}.{k}.w"]) + weights[f"{name}.{k}.b"]
        if k < n - 1 or relu_last:
            x = torch.relu(x)
    return x


def logits(torch, pooled, dense, weights, spec):
    """``pooled`` [B, T, D], ``dense`` [B, num_dense] -> logits [B]."""
    B, T, D = pooled.shape
    if (T, D) != (spec["num_tables"], spec["embed_dim"]):
        raise ValueError(f"pooled is [{B}, {T}, {D}], the head takes "
                         f"[B, {spec['num_tables']}, {spec['embed_dim']}]")
    x = _mlp(torch, dense, weights, "bottom", len(spec["bottom_mlp"]), True)
    z = torch.cat([x[:, None, :], pooled], dim=1)                # [B, T + 1, D]
    dots = torch.matmul(z, z.transpose(1, 2))
    i, j = torch.tril_indices(T + 1, T + 1, offset=-1, device=z.device)
    y = _mlp(torch, torch.cat([x, dots[:, i, j]], dim=1), weights, "top",
             len(spec["top_mlp"]), False)
    return y[:, 0]
