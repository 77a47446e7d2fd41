"""The LM zoo's dense, MoE, SSM and hybrid families: prefill logits, the
decode step and training.

The port of ``src/repro/models/transformer.py``:
  dense  -- llama-style decoder (GQA, SwiGLU or GELU MLP, optional QKV bias,
            tied or separate LM head)
  moe    -- dense attention + the MoE FFN of ``models/moe.py`` (Mixtral,
            DeepSeekMoE), whose load-balancing loss joins the training loss
  ssm    -- Mamba2 / SSD (``models/ssd.py``), attention-free
  hybrid -- an SSD backbone with ONE shared attention + MLP block, its
            weights shared, after every ``shared_attn_every`` SSD layers and
            the trailing layers after (Zamba2)

``LM`` holds the parameters in the reference's layouts, one ``Block`` per
layer (and the hybrid's ``shared`` block); :func:`params_from_jax` loads the
reference's ``init_params`` pytree (blocks stacked ``[L, ...]``). The
reference scans the stacked blocks; here a Python loop walks them.

Training (``forward(..., mode="train")``, :func:`lm_loss`, :func:`loss_fn`)
runs with autograd on and recomputes each block (or each ``remat_span``
group of a dense or MoE stack) in the backward through
``torch.utils.checkpoint``, as the reference's ``jax.checkpoint``.
:func:`loss_fn` takes the reference's pytree itself, so the optimizer and
the checkpoint see its key paths and its stacked ``[L, ...]`` leaves.

The VLM and encoder families raise ``NotImplementedError``.
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
from repro_torch.models.moe import init_moe, moe_ffn, moe_shapes
from repro_torch.models.ssd import (init_ssd, init_ssd_cache, ssd_decode_step, ssd_forward,
                                    ssd_shapes)

FAMILIES = ("dense", "moe", "ssm", "hybrid")
PENDING_FAMILIES = {"vlm": "VLM", "encoder": "encoder"}


def require_ported(cfg: ModelConfig) -> None:
    if cfg.family in PENDING_FAMILIES:
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family} family is not ported yet (ROADMAP.md module "
            f"queue, item 6 \"LM model zoo\": {PENDING_FAMILIES[cfg.family]})")
    if cfg.family not in FAMILIES:
        raise ValueError(f"{cfg.name}: unknown family {cfg.family!r}")


def _attn_mlp_shapes(cfg: ModelConfig) -> dict:
    """An attention + MLP block: a dense layer, or the hybrid's shared block."""
    d, H, K, hd, f = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                      cfg.head_dim, cfg.d_ff)
    attn = {"wq": (d, H, hd), "wk": (d, K, hd), "wv": (d, K, hd), "wo": (H, hd, d)}
    if cfg.qkv_bias:
        attn.update(bq=(H, hd), bk=(K, hd), bv=(K, hd))
    mlp = {"w1": (d, f), "w2": (f, d)}
    if cfg.ffn_gated:
        mlp["w3"] = (d, f)
    return {"ln1": (d,), "attn": attn, "ln2": (d,), "mlp": mlp}


def block_shapes(cfg: ModelConfig) -> dict:
    """Per-layer parameter shapes, in the reference's layouts."""
    require_ported(cfg)
    if cfg.family in ("ssm", "hybrid"):
        return {"ln1": (cfg.d_model,), "ssd": ssd_shapes(cfg)}
    shapes = _attn_mlp_shapes(cfg)
    if cfg.family == "moe":
        del shapes["mlp"]
        shapes["moe"] = moe_shapes(cfg)
    return shapes


def shared_shapes(cfg: ModelConfig) -> dict:
    """The hybrid's shared block (attention + MLP); empty for other families."""
    return _attn_mlp_shapes(cfg) if cfg.family == "hybrid" else {}


def init_params(cfg: ModelConfig, generator: torch.Generator) -> dict:
    """The reference's ``init_params`` pytree in f32, drawn on the CPU from
    ``generator`` with the reference's distributions: weights N(0, 1/fan_in)
    (``wo``'s fan-in is H * hd, an expert's its input dim), embedding and LM
    head N(0, 0.02^2), norms and ``D`` one, biases, ``A_log`` and
    ``dt_bias`` zero. Blocks are stacked ``[L, ...]``; the hybrid's
    ``shared`` block is not."""
    require_ported(cfg)

    def normal(shape, std):
        return torch.randn(shape, generator=generator).mul_(std)

    def leaf(name, shape, lead):
        if name in ("ln1", "ln2"):
            return torch.ones(lead + shape)
        if name in ("bq", "bk", "bv"):
            return torch.zeros(lead + shape)
        fan_in = cfg.num_heads * cfg.head_dim if name == "wo" else shape[0]
        return normal(lead + shape, 1.0 / math.sqrt(max(1, fan_in)))

    def draw(shapes, lead):
        out = {}
        for name, s in shapes.items():
            if name == "moe":
                out[name] = init_moe(cfg, generator, lead)
            elif name == "ssd":
                out[name] = init_ssd(cfg, generator, lead)
            elif isinstance(s, dict):
                out[name] = {n: leaf(n, sh, lead) for n, sh in s.items()}
            else:
                out[name] = leaf(name, s, lead)
        return out

    params = {"blocks": draw(block_shapes(cfg), (cfg.num_layers,)),
              "embed": normal((cfg.vocab_size, cfg.d_model), 0.02),
              "final_norm": torch.ones(cfg.d_model)}
    if not cfg.tie_embeddings:
        params["lm_head"] = normal((cfg.d_model, cfg.vocab_size), 0.02)
    if cfg.family == "hybrid":
        params["shared"] = draw(shared_shapes(cfg), ())
    return params


class Block(nn.Module):
    """One layer's parameters: a tensor or a ParameterDict per name of
    :func:`block_shapes` (``ln1``, ``attn``, ``ln2``, ``mlp`` / ``moe``; or
    ``ln1``, ``ssd``)."""

    def __init__(self, shapes: dict, make):
        super().__init__()
        for name, s in shapes.items():
            if isinstance(s, dict):
                setattr(self, name, nn.ParameterDict({n: make(sh) for n, sh in s.items()}))
            else:
                setattr(self, name, make(s))


class LM(nn.Module):
    """A dense, MoE, SSM or hybrid LM with f32 weights on ``device``
    (``cuda`` unless the caller asks for the CPU), drawn on the CPU from
    ``generator`` (seed 0 if None) and then moved, so one seed gives the same
    model on every device; or, given ``params`` (a pytree as
    :func:`init_params` returns), those weights. Setting ``use_kernels`` to
    False sends decode attention through the plain version on any device."""

    def __init__(self, cfg: ModelConfig, *, device="cuda",
                 generator: torch.Generator = None, params: Mapping = None):
        super().__init__()
        require_ported(cfg)
        dev = resolve_device(device)
        self.cfg = cfg
        self.use_kernels = True

        def make(shape):
            return nn.Parameter(torch.empty(shape, device=dev))

        self.embed = make((cfg.vocab_size, cfg.d_model))
        self.blocks = nn.ModuleList(Block(block_shapes(cfg), make)
                                    for _ in range(cfg.num_layers))
        self.shared = Block(shared_shapes(cfg), make) if cfg.family == "hybrid" else None
        self.final_norm = make((cfg.d_model,))
        self.lm_head = None if cfg.tie_embeddings else make((cfg.d_model, cfg.vocab_size))
        if params is None:
            g = torch.Generator().manual_seed(0) if generator is None else generator
            params = init_params(cfg, g)
        params_from_jax(self, params)


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
    if model.shared is not None:
        tree["shared"] = {name: (dict(getattr(model.shared, name)) if isinstance(s, dict)
                                 else getattr(model.shared, name))
                          for name, s in shared_shapes(model.cfg).items()}
    return tree


def tree_of(model: LM) -> dict:
    """The model's parameters as the reference's pytree on the model's
    device, detached, blocks stacked ``[L, ...]``: what
    :func:`params_from_jax` loads, so another ``LM`` can be given the same
    weights."""
    def stack(t):
        if isinstance(t, dict):
            return {k: stack(v) for k, v in t.items()}
        return torch.stack([x.detach() for x in t]) if isinstance(t, list) else t.detach()
    return stack(_targets(model))


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
    every leaf stacked ``[L, ...]``, ``final_norm``, ``lm_head`` when untied,
    the hybrid's ``shared`` block; numpy arrays or tensors) into ``model``.
    Every leaf's shape is checked, and a missing or extra leaf raises."""
    with torch.no_grad():
        _load(_targets(model), params, "")
    return model


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------


def _attn_block(blk, x, positions, cfg, kv_cache=None, cache_index=None,
                use_kernel=True):
    """Attention, then the MLP or (MoE family) the MoE FFN. Returns (x, the
    cache or None, the MoE aux loss or None)."""
    h, new_kv = self_attention(blk.attn, rms_norm(x, blk.ln1, cfg.norm_eps),
                               positions, cfg, kv_cache=kv_cache,
                               cache_index=cache_index, use_kernel=use_kernel)
    x = x + h
    x2 = rms_norm(x, blk.ln2, cfg.norm_eps)
    aux = None
    if cfg.family == "moe":
        h2, aux = moe_ffn(blk.moe, x2, cfg)
    else:
        h2 = ffn(blk.mlp, x2, cfg.ffn_gated)
    return x + h2, new_kv, aux


def _ssm_block(blk, x, cfg, ssd_cache=None):
    """The SSD layer on the normed input, added to the residual: chunked over
    the sequence, or one recurrent step updating ``ssd_cache`` in place."""
    u = rms_norm(x, blk.ln1, cfg.norm_eps)
    if ssd_cache is None:
        return x + ssd_forward(blk.ssd, u, cfg)[0]
    return x + ssd_decode_step(blk.ssd, u, ssd_cache, cfg)


def _units(model) -> list:
    """The model's layers in order, as ("attn" | "ssm", block): the hybrid's
    shared block follows every ``shared_attn_every``-th SSD layer."""
    cfg = model.cfg
    if cfg.family == "ssm":
        return [("ssm", blk) for blk in model.blocks]
    if cfg.family == "hybrid":
        units = []
        for i, blk in enumerate(model.blocks):
            units.append(("ssm", blk))
            if (i + 1) % cfg.shared_attn_every == 0:
                units.append(("attn", model.shared))
        return units
    return [("attn", blk) for blk in model.blocks]


def _add(total, aux):
    return aux if total is None else total if aux is None else total + aux


def _run_units(units, x, positions, cfg):
    """Prefill or train through ``units``. Returns (x, summed aux or None)."""
    aux = None
    for kind, blk in units:
        if kind == "ssm":
            x = _ssm_block(blk, x, cfg)
        else:
            x, _, a = _attn_block(blk, x, positions, cfg)
            aux = _add(aux, a)
    return x, aux


def _logits(model, x: torch.Tensor) -> torch.Tensor:
    x = rms_norm(x, model.final_norm, model.cfg.norm_eps)
    head = model.embed.T if model.lm_head is None else model.lm_head
    return torch.einsum("bsd,dv->bsv", x, head)


class _TreeView:
    """The reference's params pytree seen as an ``LM``: ``embed``,
    ``final_norm``, ``lm_head``, the hybrid's ``shared`` block, and one view
    per layer of the stacked ``[L, ...]`` block leaves (so gradients flow to
    the stacked leaves)."""

    def __init__(self, params: Mapping, cfg: ModelConfig):
        require_ported(cfg)
        self.cfg = cfg
        self.embed = params["embed"]
        self.final_norm = params["final_norm"]
        self.lm_head = None if cfg.tie_embeddings else params["lm_head"]
        self.shared = SimpleNamespace(**params["shared"]) if cfg.family == "hybrid" else None
        # unbind: its backward stacks the layers' grads in one operation
        # (indexing each layer would zero-fill a whole [L, ...] grad per layer)
        blocks = {name: ({n: v.unbind(0) for n, v in s.items()}
                         if isinstance(s, Mapping) else s.unbind(0))
                  for name, s in params["blocks"].items()}
        self.blocks = [SimpleNamespace(**{
            name: ({n: v[i] for n, v in s.items()} if isinstance(s, Mapping) else s[i])
            for name, s in blocks.items()}) for i in range(cfg.num_layers)]


def forward(model, tokens: torch.Tensor, *, mode: str = "prefill",
            return_aux: bool = False):
    """tokens [B, S] int -> logits [B, S, V], as the reference's ``forward``;
    with ``return_aux`` (logits, the MoE layers' summed aux loss, zero for
    the other families).

    ``mode="prefill"`` runs under ``no_grad``. ``mode="train"`` keeps
    autograd on and recomputes in the backward each block (each group of
    ``cfg.remat_span`` blocks of a dense or MoE stack when it divides the
    depth; each SSD layer and each call of the hybrid's shared block), with
    ``torch.utils.checkpoint`` (non-reentrant), as the reference remats.
    ``model`` is an ``LM`` or the view :func:`loss_fn` makes of a params
    pytree."""
    if mode not in ("prefill", "train"):
        raise ValueError(f"mode {mode!r}: expected 'prefill' or 'train'")
    cfg = model.cfg
    B, S = tokens.shape
    units = _units(model)
    if mode == "prefill":
        with torch.no_grad():
            x = model.embed[tokens.long()]
            positions = torch.arange(S, dtype=torch.int32, device=x.device)[None].expand(B, S)
            x, aux = _run_units(units, x, positions, cfg)
            logits = _logits(model, x)
    else:
        x = F.embedding(tokens.long(), model.embed)  # a deterministic backward on the card
        positions = torch.arange(S, dtype=torch.int32, device=x.device)[None].expand(B, S)
        span = cfg.remat_span if (cfg.family in ("dense", "moe")
                                  and cfg.num_layers % cfg.remat_span == 0) else 1
        aux = None
        for i in range(0, len(units), span):
            x, a = checkpoint(_run_units, units[i:i + span], x, positions, cfg,
                              use_reentrant=False)
            aux = _add(aux, a)
        logits = _logits(model, x)
    if not return_aux:
        return logits
    if aux is None:
        aux = torch.zeros((), dtype=torch.float32, device=logits.device)
    return logits, aux


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
    and ``labels`` [B, S]; the MoE family adds 0.01 x its aux loss."""
    logits, aux = forward(_TreeView(params, cfg), batch["tokens"], mode="train",
                          return_aux=True)
    return lm_loss(logits, batch["labels"], aux)


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class KVCache:
    """The KV cache of every attention layer (or shared-block call), as the
    reference's ``cache["kv"]``: ``k``/``v`` [n, B, S, K, hd], ``pos``
    [n, B, S] int32, ``valid`` [n, B, S] int8. ``length`` counts the
    positions written so far; it is kept on the host so a step knows
    ``kv_len`` without a device sync."""
    k: torch.Tensor
    v: torch.Tensor
    pos: torch.Tensor
    valid: torch.Tensor
    length: int = 0

    def layer(self, i: int) -> dict:
        return {"k": self.k[i], "v": self.v[i], "pos": self.pos[i],
                "valid": self.valid[i]}


@dataclasses.dataclass
class SSDCache:
    """The SSD decode cache of every layer, as the reference's
    ``cache["ssd"]``: ``state`` [L, B, H, hd, N] and the convolutions' last
    W - 1 inputs ``conv_x`` [L, B, W-1, d_inner], ``conv_b`` / ``conv_c``
    [L, B, W-1, N]; ``length`` as ``KVCache``'s."""
    state: torch.Tensor
    conv_x: torch.Tensor
    conv_b: torch.Tensor
    conv_c: torch.Tensor
    length: int = 0

    def layer(self, i: int) -> dict:
        return {"state": self.state[i], "conv_x": self.conv_x[i],
                "conv_b": self.conv_b[i], "conv_c": self.conv_c[i]}


@dataclasses.dataclass
class HybridCache:
    """The hybrid's cache: an ``SSDCache`` of every layer and a ``KVCache``
    of every shared-block call (the reference's ``ssd`` and ``kv``)."""
    ssd: SSDCache
    kv: KVCache

    @property
    def length(self) -> int:
        return self.kv.length

    @length.setter
    def length(self, n: int) -> None:
        self.ssd.length = self.kv.length = n


def init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype=torch.bfloat16,
               device="cuda"):
    """Zeroed decode cache; bf16 by default, as the reference serves: a
    ``KVCache`` (dense, MoE), an ``SSDCache`` (SSM) or a ``HybridCache``."""
    require_ported(cfg)
    dev = resolve_device(device)
    L = cfg.num_layers
    if cfg.family in ("dense", "moe"):
        return KVCache(**init_kv_cache(cfg, batch, max_len, L, dtype=dtype, device=dev,
                                       keep_leading=True))
    ssd = SSDCache(**init_ssd_cache(cfg, batch, n=L, dtype=dtype, device=dev))
    if cfg.family == "ssm":
        return ssd
    n_calls = L // cfg.shared_attn_every
    return HybridCache(ssd, KVCache(**init_kv_cache(cfg, batch, max_len, n_calls, dtype=dtype,
                                                    device=dev, keep_leading=True)))


@torch.no_grad()
def decode_step(model: LM, cache, tokens: torch.Tensor, pos: int):
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
    kv = cache.kv if isinstance(cache, HybridCache) else cache
    ssd = cache.ssd if isinstance(cache, HybridCache) else cache
    x = model.embed[tokens.long()]
    positions = torch.full((x.shape[0], 1), pos, dtype=torch.int32, device=x.device)
    n_kv = n_ssd = 0
    for kind, blk in _units(model):
        if kind == "ssm":
            x = _ssm_block(blk, x, cfg, ssd_cache=ssd.layer(n_ssd))
            n_ssd += 1
        else:
            x, _, _ = _attn_block(blk, x, positions, cfg, kv_cache=kv.layer(n_kv),
                                  cache_index=pos, use_kernel=model.use_kernels)
            n_kv += 1
    cache.length = pos + 1
    return _logits(model, x), cache
