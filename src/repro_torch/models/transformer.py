"""The LM zoo: prefill logits, the decode step and training of every family.

The port of ``src/repro/models/transformer.py``:
  dense   -- llama-style decoder (GQA, SwiGLU or GELU MLP, optional QKV bias,
             tied or separate LM head)
  moe     -- dense attention + the MoE FFN of ``models/moe.py`` (Mixtral,
             DeepSeekMoE), whose load-balancing loss joins the training loss
  ssm     -- Mamba2 / SSD (``models/ssd.py``), attention-free
  hybrid  -- an SSD backbone with ONE shared attention + MLP block, its
             weights shared, after every ``shared_attn_every`` SSD layers and
             the trailing layers after (Zamba2)
  encoder -- a bidirectional encoder on precomputed frame embeddings
             ``frames [B, S, d]`` (HuBERT): no RoPE, no causal mask, no
             decode step
  vlm     -- a dense decoder in sections of one gated cross-attention layer
             onto image embeddings ``images [B, T_img, d]`` followed by
             ``cross_attn_every`` self layers (Llama-Vision)

``LM`` holds the parameters in the reference's layouts, one ``Block`` per
layer (the hybrid's ``shared`` block, the VLM's ``cross`` layers);
:func:`params_from_jax` loads the reference's ``init_params`` pytree
(blocks stacked ``[L, ...]``, cross layers ``[n_cross, ...]``). The
reference scans the stacked blocks; here a Python loop walks them.

Training (``forward(..., mode="train")``, :func:`lm_loss`, :func:`loss_fn`)
runs with autograd on and recomputes in the backward each block (each
``remat_span`` group of a dense, MoE or encoder stack; each VLM section)
through ``torch.utils.checkpoint``, as the reference's ``jax.checkpoint``.
:func:`loss_fn` takes the reference's pytree itself, so the optimizer and
the checkpoint see its key paths and its stacked leaves.

The VLM decode cache's image keys and values come from
``forward(..., images=..., return_cache=True)``, as the reference's
``cache["cross_kv"]`` does; neither package prefills the self-attention
cache.
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
from repro_torch.models.layers import (attention_out, cotangent_constraint, cross_attention,
                                      ffn, init_kv_cache, is_dtensor, local_einsum,
                                      logical_constraint, project, reduce_partial, rms_norm,
                                      self_attention)
from repro_torch.models.moe import init_moe, moe_ffn, moe_shapes
from repro_torch.models.ssd import (init_ssd, init_ssd_cache, ssd_decode_step, ssd_forward,
                                    ssd_shapes)

FAMILIES = ("dense", "moe", "ssm", "hybrid", "encoder", "vlm")


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family not in FAMILIES:
        raise ValueError(f"{cfg.name}: unknown family {cfg.family!r}")


def n_cross(cfg: ModelConfig) -> int:
    """The VLM's cross-attention layers (one a section); 0 for the others."""
    return cfg.num_layers // cfg.cross_attn_every if cfg.family == "vlm" else 0


def _attn_shapes(cfg: ModelConfig, bias: bool) -> dict:
    d, H, K, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    attn = {"wq": (d, H, hd), "wk": (d, K, hd), "wv": (d, K, hd), "wo": (H, hd, d)}
    if bias:
        attn.update(bq=(H, hd), bk=(K, hd), bv=(K, hd))
    return attn


def _attn_mlp_shapes(cfg: ModelConfig) -> dict:
    """An attention + MLP block: a dense layer, or the hybrid's shared block."""
    d, f = cfg.d_model, cfg.d_ff
    mlp = {"w1": (d, f), "w2": (f, d)}
    if cfg.ffn_gated:
        mlp["w3"] = (d, f)
    return {"ln1": (d,), "attn": _attn_shapes(cfg, cfg.qkv_bias), "ln2": (d,), "mlp": mlp}


def block_shapes(cfg: ModelConfig) -> dict:
    """Per-layer parameter shapes, in the reference's layouts."""
    _check_family(cfg)
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


def cross_shapes(cfg: ModelConfig) -> dict:
    """A VLM cross layer: its norm, an attention with no bias (even under
    ``qkv_bias``) and a scalar gate; empty for other families."""
    if cfg.family != "vlm":
        return {}
    return {"ln": (cfg.d_model,), "attn": _attn_shapes(cfg, bias=False), "gate": ()}


def init_params(cfg: ModelConfig, generator: torch.Generator) -> dict:
    """The reference's ``init_params`` pytree in f32, drawn on the CPU from
    ``generator`` with the reference's distributions: weights N(0, 1/fan_in)
    (``wo``'s fan-in is H * hd, an expert's its input dim), embedding and LM
    head N(0, 0.02^2), norms and ``D`` one, biases, ``A_log``,
    ``dt_bias`` and the cross layers' gates zero. Blocks are stacked
    ``[L, ...]`` and cross layers ``[n_cross, ...]``; the hybrid's
    ``shared`` block is not."""
    _check_family(cfg)

    def normal(shape, std):
        return torch.randn(shape, generator=generator).mul_(std)

    def leaf(name, shape, lead):
        if name in ("ln1", "ln2", "ln"):
            return torch.ones(lead + shape)
        if name in ("bq", "bk", "bv", "gate"):
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
    if cfg.family == "vlm":
        params["cross"] = draw(cross_shapes(cfg), (n_cross(cfg),))
    return params


def param_shapes(cfg: ModelConfig) -> dict:
    """The shape of every leaf of :func:`init_params`'s pytree."""
    _check_family(cfg)

    def lead(shapes, n):
        return {k: lead(v, n) if isinstance(v, dict) else n + tuple(v)
                for k, v in shapes.items()}

    tree = {"blocks": lead(block_shapes(cfg), (cfg.num_layers,)),
            "embed": (cfg.vocab_size, cfg.d_model), "final_norm": (cfg.d_model,)}
    if not cfg.tie_embeddings:
        tree["lm_head"] = (cfg.d_model, cfg.vocab_size)
    if cfg.family == "hybrid":
        tree["shared"] = lead(shared_shapes(cfg), ())
    if cfg.family == "vlm":
        tree["cross"] = lead(cross_shapes(cfg), (n_cross(cfg),))
    return tree


def abstract_params(cfg: ModelConfig, dtype=torch.bfloat16, *, device="cuda",
                    fake_mode=None) -> dict:
    """:func:`init_params`'s pytree as fake tensors of ``dtype`` on
    ``device`` (``FakeTensorMode``, ``fake_mode`` or a new one): shapes and
    dtypes only, nothing drawn or allocated; no card is needed."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    mode = fake_mode or FakeTensorMode()

    def make(t):
        if isinstance(t, dict):
            return {k: make(v) for k, v in t.items()}
        return torch.empty(t, dtype=dtype, device=device)
    with mode:
        return make(param_shapes(cfg))


class Block(nn.Module):
    """One layer's parameters: a tensor or a ParameterDict per name of
    :func:`block_shapes` (``ln1``, ``attn``, ``ln2``, ``mlp`` / ``moe``; or
    ``ln1``, ``ssd``) or of :func:`cross_shapes` (``ln``, ``attn``,
    ``gate``)."""

    def __init__(self, shapes: dict, make):
        super().__init__()
        for name, s in shapes.items():
            if isinstance(s, dict):
                setattr(self, name, nn.ParameterDict({n: make(sh) for n, sh in s.items()}))
            else:
                setattr(self, name, make(s))


class LM(nn.Module):
    """An LM of any family with f32 weights on ``device``
    (``cuda`` unless the caller asks for the CPU), drawn on the CPU from
    ``generator`` (seed 0 if None) and then moved, so one seed gives the same
    model on every device; or, given ``params`` (a pytree as
    :func:`init_params` returns), those weights. Setting ``use_kernels`` to
    False sends decode attention through the plain version on any device."""

    def __init__(self, cfg: ModelConfig, *, device="cuda",
                 generator: torch.Generator = None, params: Mapping = None):
        super().__init__()
        _check_family(cfg)
        dev = resolve_device(device)
        self.cfg = cfg
        self.use_kernels = True

        def make(shape):
            return nn.Parameter(torch.empty(shape, device=dev))

        self.embed = make((cfg.vocab_size, cfg.d_model))
        self.blocks = nn.ModuleList(Block(block_shapes(cfg), make)
                                    for _ in range(cfg.num_layers))
        self.shared = Block(shared_shapes(cfg), make) if cfg.family == "hybrid" else None
        self.cross = (nn.ModuleList(Block(cross_shapes(cfg), make) for _ in range(n_cross(cfg)))
                      if cfg.family == "vlm" else None)
        self.final_norm = make((cfg.d_model,))
        self.lm_head = None if cfg.tie_embeddings else make((cfg.d_model, cfg.vocab_size))
        if params is None:
            g = torch.Generator().manual_seed(0) if generator is None else generator
            params = init_params(cfg, g)
        params_from_jax(self, params)


def _stacked(shapes: dict, mods) -> dict:
    """Each leaf of ``shapes`` as the list of its tensor in every module."""
    return {name: ({n: [getattr(m, name)[n] for m in mods] for n in s}
                   if isinstance(s, dict) else [getattr(m, name) for m in mods])
            for name, s in shapes.items()}


def _targets(model: LM) -> dict:
    """The model's parameters as the reference's pytree; a stacked leaf is
    the list of its per-layer tensors."""
    tree = {"embed": model.embed, "blocks": _stacked(block_shapes(model.cfg), model.blocks),
            "final_norm": model.final_norm}
    if model.lm_head is not None:
        tree["lm_head"] = model.lm_head
    if model.shared is not None:
        tree["shared"] = {name: (dict(getattr(model.shared, name)) if isinstance(s, dict)
                                 else getattr(model.shared, name))
                          for name, s in shared_shapes(model.cfg).items()}
    if model.cross is not None:
        tree["cross"] = _stacked(cross_shapes(model.cfg), model.cross)
    return tree


def tree_of(model: LM) -> dict:
    """The model's parameters as the reference's pytree on the model's
    device, detached, blocks stacked ``[L, ...]`` (cross layers
    ``[n_cross, ...]``): what
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
    the hybrid's ``shared`` block, the VLM's ``cross`` layers stacked
    ``[n_cross, ...]``; numpy arrays or tensors) into ``model``.
    Every leaf's shape is checked, and a missing or extra leaf raises."""
    with torch.no_grad():
        _load(_targets(model), params, "")
    return model


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------


_ACT = ("batch", "act_seq", None)   # the residual stream's logical dims


def _attn_block(blk, x, positions, cfg, kv_cache=None, cache_index=None,
                use_kernel=True, static_moe=False):
    """Attention, then the MLP or (MoE family) the MoE FFN. Returns (x, the
    cache or None, the MoE aux loss or None). The sharding constraints are
    the reference's (no-ops on plain tensors)."""
    x = logical_constraint(x, *_ACT)
    xin = cotangent_constraint(rms_norm(x, blk.ln1, cfg.norm_eps), *_ACT)
    h, new_kv = self_attention(blk.attn, xin, positions, cfg, kv_cache=kv_cache,
                               cache_index=cache_index, use_kernel=use_kernel)
    x = x + logical_constraint(h, *_ACT)
    x2 = cotangent_constraint(rms_norm(x, blk.ln2, cfg.norm_eps), *_ACT)
    aux = None
    if cfg.family == "moe":
        h2, aux = moe_ffn(blk.moe, x2, cfg, static_capacity=static_moe)
    else:
        h2 = ffn(blk.mlp, x2, cfg.ffn_gated)
    return logical_constraint(x + logical_constraint(h2, *_ACT), *_ACT), new_kv, aux


def _ssm_block(blk, x, cfg, ssd_cache=None):
    """The SSD layer on the normed input, added to the residual: chunked over
    the sequence, or one recurrent step updating ``ssd_cache`` in place."""
    u = rms_norm(x, blk.ln1, cfg.norm_eps)
    if ssd_cache is None:
        h = logical_constraint(ssd_forward(blk.ssd, u, cfg)[0], *_ACT)
        return logical_constraint(x + h, *_ACT)
    return x + ssd_decode_step(blk.ssd, u, ssd_cache, cfg)


def _cross_block(blk, x, images, cfg):
    """The gated cross-attention onto ``images`` [B, T_img, d] (no RoPE):
    q from the normed x, k and v from the raw images, added to the
    residual as ``x + tanh(gate) * out``. Returns (x, k, v), k and v the
    images' keys and values [B, T_img, K, hd]."""
    q = project(rms_norm(x, blk.ln, cfg.norm_eps), blk.attn["wq"], "heads")
    k = project(images, blk.attn["wk"], "kv_heads")
    v = project(images, blk.attn["wv"], "kv_heads")
    out = attention_out(blk.attn, cross_attention(q, k, v))
    return x + torch.tanh(blk.gate) * out, k, v


def _cross_block_cached(blk, x, kv, cfg, use_kernel=True):
    """The cross layer of a decode step, onto the cached image keys and
    values (``kv``: one section's ``k``, ``v`` [B, T_img, K, hd]); one query
    position goes through the ``flash_decode`` kernel."""
    q = project(rms_norm(x, blk.ln, cfg.norm_eps), blk.attn["wq"], "heads")
    attn = cross_attention(q, kv["k"], kv["v"], decode=True, use_kernel=use_kernel)
    return x + torch.tanh(blk.gate) * attention_out(blk.attn, attn)


def _units(model) -> list:
    """The model's layers in order, as ("attn" | "ssm" | "cross", block):
    the hybrid's shared block follows every ``shared_attn_every``-th SSD
    layer; each VLM section's cross layer comes before its
    ``cross_attn_every`` self layers."""
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
    if cfg.family == "vlm":
        every = cfg.cross_attn_every
        units = []
        for i, cross in enumerate(model.cross):
            units.append(("cross", cross))
            units.extend(("attn", blk) for blk in model.blocks[i * every:(i + 1) * every])
        return units
    return [("attn", blk) for blk in model.blocks]


def _remat_span(cfg: ModelConfig) -> int:
    """Units a training checkpoint spans: ``remat_span`` blocks of a dense,
    MoE or encoder stack when it divides the depth, a whole VLM section
    (its cross layer and self layers), else one unit."""
    if cfg.family == "vlm":
        return cfg.cross_attn_every + 1
    if cfg.family in ("dense", "moe", "encoder") and cfg.num_layers % cfg.remat_span == 0:
        return cfg.remat_span
    return 1


def _add(total, aux):
    return aux if total is None else total if aux is None else total + aux


def _run_units(units, x, positions, cfg, images=None, cross_kv=None, static_moe=False):
    """Prefill or train through ``units``. Returns (x, summed aux or None).
    A list ``cross_kv`` collects each cross layer's image (k, v)."""
    aux = None
    for kind, blk in units:
        if kind == "ssm":
            x = _ssm_block(blk, x, cfg)
        elif kind == "cross":
            x, k, v = _cross_block(blk, x, images, cfg)
            if cross_kv is not None:
                cross_kv.append((k, v))
        else:
            x, _, a = _attn_block(blk, x, positions, cfg, static_moe=static_moe)
            aux = _add(aux, a)
    return x, aux


def _logits(model, x: torch.Tensor) -> torch.Tensor:
    x = rms_norm(x, model.final_norm, model.cfg.norm_eps)
    head = model.embed.T if model.lm_head is None else model.lm_head
    return logical_constraint(local_einsum("bsd,dv->bsv", x, head, ("batch", None, None)),
                              "batch", None, "vocab")


def _layer_views(stacked: Mapping, n: int) -> list:
    """One namespace per layer of stacked ``[n, ...]`` leaves. ``unbind``:
    its backward stacks the layers' grads in one operation (indexing each
    layer would zero-fill a whole [n, ...] grad per layer)."""
    parts = {name: ({k: v.unbind(0) for k, v in s.items()} if isinstance(s, Mapping)
                    else s.unbind(0))
             for name, s in stacked.items()}
    return [SimpleNamespace(**{
        name: ({k: v[i] for k, v in s.items()} if isinstance(s, Mapping) else s[i])
        for name, s in parts.items()}) for i in range(n)]


class _TreeView:
    """The reference's params pytree seen as an ``LM``: ``embed``,
    ``final_norm``, ``lm_head``, the hybrid's ``shared`` block, and one view
    per layer of the stacked ``[L, ...]`` block leaves and of the VLM's
    ``[n_cross, ...]`` cross leaves (so gradients flow to the stacked
    leaves)."""

    use_kernels = True

    def __init__(self, params: Mapping, cfg: ModelConfig):
        _check_family(cfg)
        self.cfg = cfg
        self.embed = params["embed"]
        self.final_norm = params["final_norm"]
        self.lm_head = None if cfg.tie_embeddings else params["lm_head"]
        self.shared = SimpleNamespace(**params["shared"]) if cfg.family == "hybrid" else None
        self.blocks = _layer_views(params["blocks"], cfg.num_layers)
        self.cross = (_layer_views(params["cross"], n_cross(cfg)) if cfg.family == "vlm"
                      else None)


def _inputs(cfg, tokens, frames, images) -> None:
    """Check that the inputs are the family's: ``frames`` for the encoder,
    ``tokens`` for the others, and ``images`` for the VLM alone."""
    if cfg.family == "encoder":
        if frames is None or tokens is not None:
            raise ValueError(f"{cfg.name}: the encoder takes frames [B, S, d], not tokens")
    elif tokens is None or frames is not None:
        raise ValueError(f"{cfg.name}: the {cfg.family} family takes tokens, not frames")
    if (images is None) == (cfg.family == "vlm"):
        raise ValueError(f"{cfg.name}: images [B, T_img, d] are "
                         f"{'the VLM input' if images is None else 'for the VLM alone'}")


def forward(model, tokens: torch.Tensor = None, *, frames: torch.Tensor = None,
            images: torch.Tensor = None, mode: str = "prefill", return_aux: bool = False,
            return_cache: bool = False, static_moe: bool = False):
    """tokens [B, S] int (``frames`` [B, S, d] for the encoder; the VLM's
    ``images`` [B, T_img, d] beside its tokens) -> logits [B, S, V], as the
    reference's ``forward``; with ``return_aux`` also the MoE layers' summed
    aux loss (zero for the other families); with ``return_cache`` (VLM
    prefill only) also the decode cache's image keys and values, ``{"k",
    "v"}`` [n_cross, B, T_img, K, hd] in the images' dtype, the reference's
    ``cache["cross_kv"]``, for :meth:`VLMCache.load_cross`.

    ``mode="prefill"`` runs under ``no_grad``. ``mode="train"`` keeps
    autograd on and recomputes in the backward each block (each group of
    ``cfg.remat_span`` blocks of a dense, MoE or encoder stack when it
    divides the depth; each SSD layer and each call of the hybrid's shared
    block; each VLM section, the images an input of its checkpoint), with
    ``torch.utils.checkpoint`` (non-reentrant), as the reference remats.
    ``model`` is an ``LM`` or the view :func:`loss_fn` makes of a params
    pytree. ``static_moe`` runs the MoE layers at their static capacity
    (``moe.moe_ffn``), as the launch tooling's traced steps do."""
    if mode not in ("prefill", "train"):
        raise ValueError(f"mode {mode!r}: expected 'prefill' or 'train'")
    cfg = model.cfg
    _inputs(cfg, tokens, frames, images)
    if return_cache and (cfg.family != "vlm" or mode != "prefill"):
        raise ValueError("return_cache: only a VLM prefill emits a cache (its image K/V)")
    units = _units(model)
    cross_kv = [] if return_cache else None
    if mode == "prefill":
        with torch.no_grad():
            x = frames if tokens is None else F.embedding(tokens.long(), model.embed)
            x = logical_constraint(reduce_partial(x), *_ACT)
            B, S = x.shape[:2]
            positions = torch.arange(S, dtype=torch.int32, device=x.device)[None].expand(B, S)
            x, aux = _run_units(units, x, positions, cfg, images, cross_kv, static_moe)
            logits = _logits(model, x)
    else:
        # F.embedding: a deterministic backward on the card
        x = frames if tokens is None else F.embedding(tokens.long(), model.embed)
        x = logical_constraint(reduce_partial(x), *_ACT)
        B, S = x.shape[:2]
        positions = torch.arange(S, dtype=torch.int32, device=x.device)[None].expand(B, S)
        span = _remat_span(cfg)
        aux = None
        for i in range(0, len(units), span):
            x, a = checkpoint(_run_units, units[i:i + span], x, positions, cfg, images,
                              None, static_moe, use_reentrant=False)
            aux = _add(aux, a)
        logits = _logits(model, x)
    out = [logits]
    if return_aux:
        out.append(torch.zeros((), dtype=torch.float32, device=logits.device)
                   if aux is None else aux)
    if return_cache:
        out.append({"k": torch.stack([k for k, _ in cross_kv]),
                    "v": torch.stack([v for _, v in cross_kv])})
    return out[0] if len(out) == 1 else tuple(out)


def lm_loss(logits: torch.Tensor, labels: torch.Tensor, aux: torch.Tensor,
            aux_weight: float = 0.01) -> torch.Tensor:
    """Cross entropy: logsumexp minus the label's logit, in f32, plus
    ``aux_weight * aux``."""
    x = logits.to(torch.float32)
    if is_dtensor(x):
        lse, label_logit = _vocab_parallel_terms(x, labels)
        return reduce_partial(torch.mean(lse - label_logit)) + aux_weight * aux
    lse = torch.logsumexp(x, dim=-1)                                  # [B, S]
    label_logit = torch.gather(x, -1, labels.long()[..., None])[..., 0]
    return torch.mean(lse - label_logit) + aux_weight * aux


def _vocab_parallel_terms(x, labels):
    """The loss's logsumexp and label logit of vocab-sharded DTensor logits
    [B, S, V], as the reference computes them: vocab-dim reductions that
    finish with small all-reduces, the logits never gathered. The label
    logit is picked from each device's vocab slice (zero where the label
    lies elsewhere), a partial sum over the vocab's mesh axes."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    from repro_torch.models.layers import _from_local, _shard_offset
    x = logical_constraint(x, "batch", None, "vocab")
    m = x.detach().amax(dim=-1, keepdim=True)
    lse = logical_constraint((m + torch.log(torch.exp(x - m).sum(-1, keepdim=True)))[..., 0],
                             "batch", None)
    mesh, pl = x.device_mesh, x.placements
    lab_pl = tuple(p if isinstance(p, Shard) and p.dim < 2 else Replicate() for p in pl)
    lab = labels if is_dtensor(labels) else _from_local(
        labels, mesh, [Replicate()] * mesh.ndim, tuple(labels.shape))
    lab = lab.redistribute(mesh, lab_pl).to_local().long()
    x_loc = x.to_local()
    idx = lab - _shard_offset(x, 2)[0]
    ok = (idx >= 0) & (idx < x_loc.shape[-1])
    val = torch.gather(x_loc, -1, idx.clamp(0, x_loc.shape[-1] - 1)[..., None])[..., 0] * ok
    out_pl = tuple(Partial() if isinstance(p, Shard) and p.dim == 2 else q
                   for p, q in zip(pl, lab_pl))
    return lse, _from_local(val, mesh, out_pl, tuple(x.shape[:2]))


def loss_fn(params: Mapping, batch: Mapping, cfg: ModelConfig, *,
            static_moe: bool = False) -> torch.Tensor:
    """The reference's ``loss_fn`` on its params pytree: batch ``tokens``
    (the encoder's ``frames`` [B, S, d] instead; the VLM's ``images``
    [B, T_img, d] beside) and ``labels`` [B, S]; the MoE family adds 0.01 x
    its aux loss."""
    logits, aux = forward(_TreeView(params, cfg), batch.get("tokens"),
                          frames=batch.get("frames"), images=batch.get("images"),
                          mode="train", return_aux=True, static_moe=static_moe)
    return lm_loss(logits, batch["labels"], aux)


def prefill_step(params: Mapping, batch: Mapping, cfg: ModelConfig, *,
                 static_moe: bool = False) -> torch.Tensor:
    """The reference's ``prefill_step``: prefill logits [B, S, V] of the
    params pytree on ``batch`` (``tokens``, or the encoder's ``frames``;
    the VLM's ``images`` beside)."""
    return forward(_TreeView(params, cfg), batch.get("tokens"), frames=batch.get("frames"),
                   images=batch.get("images"), static_moe=static_moe)


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


@dataclasses.dataclass
class VLMCache:
    """The VLM's cache: a ``KVCache`` of every self layer and each cross
    layer's image keys and values, ``cross_k`` / ``cross_v`` [n_cross, B,
    T_img, K, hd] (the reference's ``kv`` and ``cross_kv``), zero until
    :meth:`load_cross` fills them."""
    kv: KVCache
    cross_k: torch.Tensor
    cross_v: torch.Tensor

    @property
    def length(self) -> int:
        return self.kv.length

    @length.setter
    def length(self, n: int) -> None:
        self.kv.length = n

    def cross_layer(self, i: int) -> dict:
        return {"k": self.cross_k[i], "v": self.cross_v[i]}

    def load_cross(self, cross_kv: Mapping) -> "VLMCache":
        """Copy ``forward(..., return_cache=True)``'s image keys and values
        in, in the cache's dtype."""
        with torch.no_grad():
            for dst, name in ((self.cross_k, "k"), (self.cross_v, "v")):
                if tuple(cross_kv[name].shape) != tuple(dst.shape):
                    raise ValueError(f"cross {name}: shape {tuple(cross_kv[name].shape)} "
                                     f"!= {tuple(dst.shape)}")
                dst.copy_(cross_kv[name])
        return self


def cache_tree(cache) -> dict:
    """A decode cache in the reference's ``init_cache`` layout: ``kv``
    (``k``, ``v``, ``pos``, ``valid``), ``ssd`` (``state``, ``conv_x``,
    ``conv_b``, ``conv_c``), and the VLM's ``cross_kv`` (``k``, ``v``)."""
    def kv(c):
        return {"k": c.k, "v": c.v, "pos": c.pos, "valid": c.valid}

    def ssd(c):
        return {"state": c.state, "conv_x": c.conv_x, "conv_b": c.conv_b, "conv_c": c.conv_c}
    if isinstance(cache, KVCache):
        return {"kv": kv(cache)}
    if isinstance(cache, SSDCache):
        return {"ssd": ssd(cache)}
    if isinstance(cache, HybridCache):
        return {"ssd": ssd(cache.ssd), "kv": kv(cache.kv)}
    return {"kv": kv(cache.kv), "cross_kv": {"k": cache.cross_k, "v": cache.cross_v}}


def cache_from_tree(cfg: ModelConfig, tree: Mapping, length: int = 0):
    """The port's cache object of ``cfg``'s family holding the tensors of a
    :func:`cache_tree` layout, ``length`` positions written."""
    if "kv" in tree:
        kv = KVCache(**tree["kv"], length=length)
    if cfg.family == "ssm":
        return SSDCache(**tree["ssd"], length=length)
    if cfg.family == "hybrid":
        return HybridCache(SSDCache(**tree["ssd"], length=length), kv)
    if cfg.family == "vlm":
        return VLMCache(kv, tree["cross_kv"]["k"], tree["cross_kv"]["v"])
    return kv


def init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype=torch.bfloat16,
               device="cuda"):
    """Zeroed decode cache; bf16 by default, as the reference serves: a
    ``KVCache`` (dense, MoE; the encoder's, as the reference makes one,
    though it has no decode step), an ``SSDCache`` (SSM), a ``HybridCache``
    or a ``VLMCache``."""
    _check_family(cfg)
    dev = resolve_device(device)
    L = cfg.num_layers
    if cfg.family in ("dense", "moe", "encoder", "vlm"):
        kv = KVCache(**init_kv_cache(cfg, batch, max_len, L, dtype=dtype, device=dev,
                                     keep_leading=True))
        if cfg.family != "vlm":
            return kv
        shape = (n_cross(cfg), batch, cfg.num_image_tokens, cfg.num_kv_heads, cfg.head_dim)
        return VLMCache(kv, torch.zeros(shape, dtype=dtype, device=dev),
                        torch.zeros(shape, dtype=dtype, device=dev))
    ssd = SSDCache(**init_ssd_cache(cfg, batch, n=L, dtype=dtype, device=dev))
    if cfg.family == "ssm":
        return ssd
    n_calls = L // cfg.shared_attn_every
    return HybridCache(ssd, KVCache(**init_kv_cache(cfg, batch, max_len, n_calls, dtype=dtype,
                                                    device=dev, keep_leading=True)))


@torch.no_grad()
def decode_step(model: LM, cache, tokens: torch.Tensor, pos: int, *,
                static_moe: bool = False):
    """One token for every sequence: tokens [B, 1] at host position ``pos``.
    Returns (logits [B, 1, V], cache), the cache updated in place. The
    encoder has no decode step and raises.

    ``pos`` must equal ``cache.length``: decode attention takes
    ``kv_len = pos + 1``, which is the reference's mask only when positions
    0..pos were written in order, so any other ``pos`` raises. A VLM's
    cross layers attend over all its cached image keys."""
    cfg = model.cfg
    if cfg.family == "encoder":
        raise ValueError("encoder-only model has no decode step")
    if tokens.dim() != 2 or tokens.shape[1] != 1:
        raise ValueError(f"decode_step takes tokens [B, 1], got {tuple(tokens.shape)}")
    if pos != cache.length:
        raise ValueError(f"decode position {pos}, but the cache holds positions "
                         f"0..{cache.length - 1}: positions are written in order")
    kv = cache.kv if isinstance(cache, (HybridCache, VLMCache)) else cache
    ssd = cache.ssd if isinstance(cache, HybridCache) else cache
    x = logical_constraint(reduce_partial(F.embedding(tokens.long(), model.embed)),
                           "batch", None, None)
    positions = torch.full((x.shape[0], 1), pos, dtype=torch.int32, device=x.device)
    n_kv = n_ssd = n_x = 0
    for kind, blk in _units(model):
        if kind == "ssm":
            x = _ssm_block(blk, x, cfg, ssd_cache=ssd.layer(n_ssd))
            n_ssd += 1
        elif kind == "cross":
            x = _cross_block_cached(blk, x, cache.cross_layer(n_x), cfg,
                                    use_kernel=model.use_kernels)
            n_x += 1
        else:
            x, _, _ = _attn_block(blk, x, positions, cfg, kv_cache=kv.layer(n_kv),
                                  cache_index=pos, use_kernel=model.use_kernels,
                                  static_moe=static_moe)
            n_kv += 1
    cache.length = pos + 1
    return _logits(model, x), cache
