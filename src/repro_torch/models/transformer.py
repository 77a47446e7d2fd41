"""Dense-family LM: prefill logits, the decode step and training.

The port of the dense family of ``src/repro/models/transformer.py``: a
llama-style decoder (GQA, SwiGLU or GELU MLP, optional QKV bias, tied or
separate LM head). ``LM`` holds the parameters in the reference's layouts,
one ``Block`` per layer; :func:`params_from_jax` loads the reference's
``init_params`` pytree (blocks stacked ``[L, ...]``). The reference scans
the stacked blocks; here a Python loop walks them.

Training (``forward(..., mode="train")``, :func:`lm_loss`, :func:`loss_fn`)
runs with autograd on and recomputes each block (or each ``remat_span``
group) in the backward through ``torch.utils.checkpoint``, as the
reference's ``jax.checkpoint``. :func:`loss_fn` takes the reference's
pytree itself, so the optimizer and the checkpoint see its key paths and
its stacked ``[L, ...]`` leaves.

Every other family (MoE, SSM, hybrid, VLM, encoder) raises
``NotImplementedError``.
"""
from __future__ import annotations

import dataclasses
import math
from types import SimpleNamespace
from typing import Mapping

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import ffn, init_kv_cache, rms_norm, self_attention

PENDING_FAMILIES = {"moe": "MoE, models/moe.py", "ssm": "SSD, models/ssd.py",
                    "hybrid": "hybrid", "vlm": "VLM", "encoder": "encoder"}


def require_dense(cfg: ModelConfig) -> None:
    if cfg.family != "dense":
        what = PENDING_FAMILIES.get(cfg.family, cfg.family)
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family} family is not ported yet "
            f"(ROADMAP.md module queue, item 6 \"LM model zoo\": {what})")


def block_shapes(cfg: ModelConfig) -> dict:
    """Per-layer parameter shapes, in the reference's layouts."""
    d, H, K, hd, f = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                      cfg.head_dim, cfg.d_ff)
    attn = {"wq": (d, H, hd), "wk": (d, K, hd), "wv": (d, K, hd), "wo": (H, hd, d)}
    if cfg.qkv_bias:
        attn.update(bq=(H, hd), bk=(K, hd), bv=(K, hd))
    mlp = {"w1": (d, f), "w2": (f, d)}
    if cfg.ffn_gated:
        mlp["w3"] = (d, f)
    return {"ln1": (d,), "attn": attn, "ln2": (d,), "mlp": mlp}


def init_params(cfg: ModelConfig, generator: torch.Generator) -> dict:
    """The reference's ``init_params`` pytree in f32, drawn on the CPU from
    ``generator`` with the reference's distributions: weights N(0, 1/fan_in)
    (``wo``'s fan-in is H * hd), embedding and LM head N(0, 0.02^2), norms
    one, biases zero. Blocks are stacked ``[L, ...]``."""
    require_dense(cfg)
    L = cfg.num_layers

    def normal(shape, std):
        return torch.randn(shape, generator=generator) * std

    def leaf(name, shape):
        if name in ("ln1", "ln2"):
            return torch.ones((L,) + shape)
        if name in ("bq", "bk", "bv"):
            return torch.zeros((L,) + shape)
        fan_in = cfg.num_heads * cfg.head_dim if name == "wo" else shape[0]
        return normal((L,) + shape, 1.0 / math.sqrt(max(1, fan_in)))

    blocks = {name: ({n: leaf(n, sh) for n, sh in s.items()}
                     if isinstance(s, dict) else leaf(name, s))
              for name, s in block_shapes(cfg).items()}
    params = {"embed": normal((cfg.vocab_size, cfg.d_model), 0.02),
              "blocks": blocks,
              "final_norm": torch.ones(cfg.d_model)}
    if not cfg.tie_embeddings:
        params["lm_head"] = normal((cfg.d_model, cfg.vocab_size), 0.02)
    return params


class Block(nn.Module):
    """One decoder layer: ``ln1``, ``attn`` (a ParameterDict), ``ln2``,
    ``mlp`` (a ParameterDict)."""

    def __init__(self, shapes: dict, make):
        super().__init__()
        for name, s in shapes.items():
            if isinstance(s, dict):
                setattr(self, name, nn.ParameterDict({n: make(sh) for n, sh in s.items()}))
            else:
                setattr(self, name, make(s))


class LM(nn.Module):
    """A dense-family LM with f32 weights on ``device`` (``cuda`` unless the
    caller asks for the CPU), drawn on the CPU from ``generator`` (seed 0 if
    None) and then moved, so one seed gives the same model on every device.
    Setting ``use_kernels`` to False sends decode attention through the
    plain version on any device."""

    def __init__(self, cfg: ModelConfig, *, device="cuda",
                 generator: torch.Generator = None):
        super().__init__()
        require_dense(cfg)
        dev = resolve_device(device)
        self.cfg = cfg
        self.use_kernels = True

        def make(shape):
            return nn.Parameter(torch.empty(shape, device=dev))

        self.embed = make((cfg.vocab_size, cfg.d_model))
        self.blocks = nn.ModuleList(Block(block_shapes(cfg), make)
                                    for _ in range(cfg.num_layers))
        self.final_norm = make((cfg.d_model,))
        self.lm_head = None if cfg.tie_embeddings else make((cfg.d_model, cfg.vocab_size))
        g = torch.Generator().manual_seed(0) if generator is None else generator
        params_from_jax(self, init_params(cfg, g))


def _targets(model: LM) -> dict:
    """The model's parameters as the reference's pytree; a stacked leaf is
    the list of its per-layer tensors."""
    blocks = {}
    for name, s in block_shapes(model.cfg).items():
        if isinstance(s, dict):
            blocks[name] = {n: [getattr(b, name)[n] for b in model.blocks] for n in s}
        else:
            blocks[name] = [getattr(b, name) for b in model.blocks]
    tree = {"embed": model.embed, "blocks": blocks, "final_norm": model.final_norm}
    if model.lm_head is not None:
        tree["lm_head"] = model.lm_head
    return tree


def _load(dst, src, where: str) -> None:
    if isinstance(dst, dict):
        if not isinstance(src, Mapping) or set(src) != set(dst):
            got = sorted(src) if isinstance(src, Mapping) else type(src).__name__
            raise ValueError(f"{where or 'params'}: leaves {got}, expected {sorted(dst)}")
        for name in dst:
            _load(dst[name], src[name], f"{where}.{name}" if where else name)
        return
    if not isinstance(src, torch.Tensor):
        src = torch.from_numpy(np.array(src))
    want = (len(dst),) + tuple(dst[0].shape) if isinstance(dst, list) else tuple(dst.shape)
    if tuple(src.shape) != want:
        raise ValueError(f"{where}: shape {tuple(src.shape)} != {want}")
    for d, s in zip(dst, src) if isinstance(dst, list) else [(dst, src)]:
        d.copy_(s)


def params_from_jax(model: LM, params: Mapping) -> LM:
    """Load the reference ``init_params`` pytree (``embed``, ``blocks`` with
    every leaf stacked ``[L, ...]``, ``final_norm``, ``lm_head`` when untied;
    numpy arrays or CPU tensors) into ``model``. Every leaf's shape is
    checked, and a missing or extra leaf raises."""
    with torch.no_grad():
        _load(_targets(model), params, "")
    return model


# ---------------------------------------------------------------------------
# Forward (prefill) and decode
# ---------------------------------------------------------------------------


def _attn_block(blk: Block, x, positions, cfg, kv_cache=None, cache_index=None,
                use_kernel=True):
    h, new_kv = self_attention(blk.attn, rms_norm(x, blk.ln1, cfg.norm_eps),
                               positions, cfg, kv_cache=kv_cache,
                               cache_index=cache_index, use_kernel=use_kernel)
    x = x + h
    x = x + ffn(blk.mlp, rms_norm(x, blk.ln2, cfg.norm_eps), cfg.ffn_gated)
    return x, new_kv


def _logits(model: LM, x: torch.Tensor) -> torch.Tensor:
    x = rms_norm(x, model.final_norm, model.cfg.norm_eps)
    head = model.embed.T if model.lm_head is None else model.lm_head
    return torch.einsum("bsd,dv->bsv", x, head)


class _TreeView:
    """The reference's params pytree seen as an ``LM``: ``embed``,
    ``final_norm``, ``lm_head`` and one view per layer of the stacked
    ``[L, ...]`` block leaves (so gradients flow to the stacked leaves)."""

    def __init__(self, params: Mapping, cfg: ModelConfig):
        require_dense(cfg)
        self.cfg = cfg
        self.embed = params["embed"]
        self.final_norm = params["final_norm"]
        self.lm_head = None if cfg.tie_embeddings else params["lm_head"]
        # unbind: its backward stacks the layers' grads in one operation
        # (indexing each layer would zero-fill a whole [L, ...] grad per layer)
        blocks = {name: ({n: v.unbind(0) for n, v in s.items()}
                         if isinstance(s, Mapping) else s.unbind(0))
                  for name, s in params["blocks"].items()}
        self.blocks = [SimpleNamespace(**{
            name: ({n: v[i] for n, v in s.items()} if isinstance(s, Mapping) else s[i])
            for name, s in blocks.items()}) for i in range(cfg.num_layers)]


def _run_blocks(blocks, x, positions, cfg) -> torch.Tensor:
    for blk in blocks:
        x, _ = _attn_block(blk, x, positions, cfg)
    return x


def forward(model, tokens: torch.Tensor, *, mode: str = "prefill") -> torch.Tensor:
    """tokens [B, S] int -> logits [B, S, V], as the reference's ``forward``.

    ``mode="prefill"`` runs under ``no_grad``. ``mode="train"`` keeps
    autograd on and recomputes in the backward each group of
    ``cfg.remat_span`` blocks when it divides the depth, else each block
    (``torch.utils.checkpoint``, non-reentrant), as the reference remats. ``model`` is an ``LM`` or
    the view :func:`loss_fn` makes of a params pytree."""
    if mode not in ("prefill", "train"):
        raise ValueError(f"mode {mode!r}: expected 'prefill' or 'train'")
    cfg = model.cfg
    B, S = tokens.shape
    if mode == "prefill":
        with torch.no_grad():
            x = model.embed[tokens.long()]
            positions = torch.arange(S, dtype=torch.int32, device=x.device)[None].expand(B, S)
            return _logits(model, _run_blocks(model.blocks, x, positions, cfg))
    x = F.embedding(tokens.long(), model.embed)     # a deterministic backward on the card
    positions = torch.arange(S, dtype=torch.int32, device=x.device)[None].expand(B, S)
    L = cfg.num_layers
    span = cfg.remat_span if L % cfg.remat_span == 0 else 1
    for i in range(0, L, span):
        x = checkpoint(_run_blocks, model.blocks[i:i + span], x, positions, cfg,
                       use_reentrant=False)
    return _logits(model, x)


def lm_loss(logits: torch.Tensor, labels: torch.Tensor, aux: torch.Tensor,
            aux_weight: float = 0.01) -> torch.Tensor:
    """Cross entropy: logsumexp minus the label's logit, in f32, plus
    ``aux_weight * aux``."""
    x = logits.to(torch.float32)
    lse = torch.logsumexp(x, dim=-1)                                  # [B, S]
    label_logit = torch.gather(x, -1, labels.long()[..., None])[..., 0]
    return torch.mean(lse - label_logit) + aux_weight * aux


def loss_fn(params: Mapping, batch: Mapping, cfg: ModelConfig) -> torch.Tensor:
    """The reference's ``loss_fn`` on its params pytree: batch ``tokens``
    and ``labels`` [B, S]. The dense family has no auxiliary loss."""
    view = _TreeView(params, cfg)
    logits = forward(view, batch["tokens"], mode="train")
    aux = torch.zeros((), dtype=torch.float32, device=logits.device)
    return lm_loss(logits, batch["labels"], aux)


@dataclasses.dataclass
class KVCache:
    """The decode cache of every layer, as the reference's ``cache["kv"]``:
    ``k``/``v`` [L, B, S, K, hd], ``pos`` [L, B, S] int32, ``valid``
    [L, B, S] int8. ``length`` counts the positions written so far; it is
    kept on the host so a step knows ``kv_len`` without a device sync."""
    k: torch.Tensor
    v: torch.Tensor
    pos: torch.Tensor
    valid: torch.Tensor
    length: int = 0

    def layer(self, i: int) -> dict:
        return {"k": self.k[i], "v": self.v[i], "pos": self.pos[i],
                "valid": self.valid[i]}


def init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype=torch.bfloat16,
               device="cuda") -> KVCache:
    """Zeroed decode cache; bf16 by default, as the reference serves."""
    require_dense(cfg)
    one = init_kv_cache(cfg, batch, max_len, dtype=dtype, device=resolve_device(device))
    return KVCache(**{name: t.new_zeros((cfg.num_layers,) + tuple(t.shape))
                      for name, t in one.items()})


@torch.no_grad()
def decode_step(model: LM, cache: KVCache, tokens: torch.Tensor, pos: int):
    """One token for every sequence: tokens [B, 1] at host position ``pos``.
    Returns (logits [B, 1, V], cache), the cache updated in place.

    ``pos`` must equal ``cache.length``: decode attention takes
    ``kv_len = pos + 1``, which is the reference's mask only when positions
    0..pos were written in order, so any other ``pos`` raises."""
    if tokens.dim() != 2 or tokens.shape[1] != 1:
        raise ValueError(f"decode_step takes tokens [B, 1], got {tuple(tokens.shape)}")
    if pos != cache.length:
        raise ValueError(f"decode position {pos}, but the cache holds positions "
                         f"0..{cache.length - 1}: positions are written in order")
    cfg = model.cfg
    x = model.embed[tokens.long()]
    positions = torch.full((x.shape[0], 1), pos, dtype=torch.int32, device=x.device)
    for i, blk in enumerate(model.blocks):
        x, _ = _attn_block(blk, x, positions, cfg, kv_cache=cache.layer(i),
                           cache_index=pos, use_kernel=model.use_kernels)
    cache.length = pos + 1
    return _logits(model, x), cache
