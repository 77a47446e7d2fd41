"""Sharding plans of the LM zoo and the layouts of the sharded embedding store.

The port of ``src/repro/launch/sharding.py``. A spec (:class:`Spec`) is a
small tuple, one entry per tensor dim: ``None`` (not sharded), a mesh axis
name, or a tuple of names (one dim over several axes, as the batch over
(``pod``, ``data``)); it compares equal to ``tuple()`` of the reference's
``PartitionSpec``. Plans and specs are plain data; :func:`to_placements`
turns a spec into DTensor placements over a ``DeviceMesh``.

LM strategy (baseline, MaxText-style rules, as the reference):

* train: batch over ('pod','data'); FSDP over 'data' (weights' d_model dim);
  tensor-parallel over 'model' (heads / d_ff / experts / vocab). Optimizer
  moments shard like their weights (ZeRO-3).
* serve: batch over data axes, TP over 'model'; decode KV cache shards batch
  over 'data' and heads (or sequence, when heads don't divide) over 'model'.
* MoE: expert-parallel over 'model' when num_experts divides it, else
  tensor-parallel inside each expert (expert_ff).

All decisions check divisibility and degrade to replication, except vocab
dims of activations, where uneven shards are allowed.

The embedding store's layouts (``runtime.sharded_engine``):

* ``row``   -- every shard owns a row slice of every table; the shards'
               partial pools are summed.
* ``table`` -- every shard owns whole tables; each table's pool is taken
               from its owner.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping, Optional, Tuple

from repro_torch.configs.base import ModelConfig


class Spec(tuple):
    """A partition spec: one entry per tensor dim (``None``, an axis name, or
    a tuple of names). ``Spec()`` is a scalar's (replicated). Entries are
    normalized as ``PartitionSpec`` normalizes them: a tuple of one name is
    that name, an empty tuple ``None``."""

    def __new__(cls, *entries):
        def norm(e):
            if isinstance(e, (tuple, list)):
                return None if not e else e[0] if len(e) == 1 else tuple(e)
            return e
        return super().__new__(cls, (norm(e) for e in entries))

    def __repr__(self) -> str:
        return f"Spec{tuple.__repr__(self)}"


def mesh_axes(mesh) -> dict:
    """``{axis name: size}`` of a ``DeviceMesh`` (its ``mesh_dim_names``
    and ``shape``) or of a mapping of axis sizes."""
    if isinstance(mesh, Mapping):
        return dict(mesh)
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


@dataclasses.dataclass(frozen=True)
class ShardingPlan:
    """Resolved mesh-axis assignments for one (cfg, mesh) pair."""
    batch_axes: Tuple[str, ...]
    fsdp_axes: Optional[Tuple[str, ...]]     # None = no FSDP (serving)
    model_size: int
    heads: Optional[str]
    kv_heads: Optional[str]
    q_seq: Optional[str]                     # sequence-parallel attention when
                                             # heads don't divide the model axis
    act_seq: Optional[str]                   # sequence parallelism for the
                                             # residual stream at layer edges
    ff: Optional[str]
    expert: Optional[str]
    expert_ff: Optional[str]
    vocab: Optional[str]
    kv_seq: Optional[str]                    # decode cache sequence sharding
    ssd_heads: Optional[str]

    def rules(self) -> dict:
        """Activation logical-constraint rules (see ``models.layers``)."""
        def t(a):
            return (a,) if isinstance(a, str) else a
        return {
            "batch": t(self.batch_axes),
            "heads": t(self.heads),
            "kv_heads": t(self.kv_heads),
            "q_seq": t(self.q_seq),
            "act_seq": t(self.act_seq),
            "ff": t(self.ff),
            "expert": t(self.expert),
            "expert_ff": t(self.expert_ff),
            "vocab": t(self.vocab),
            "kv_seq": t(self.kv_seq),
        }


def make_plan(cfg: ModelConfig, mesh, *, mode: str = "train",
              fsdp: bool = True, expert_parallel: bool = True,
              vocab_tp: bool = True, seq_parallel: bool = True) -> ShardingPlan:
    axes = mesh_axes(mesh)
    msize = axes["model"]
    multi = "pod" in axes
    batch_axes = ("pod", "data") if multi else ("data",)
    div = lambda n: n and n % msize == 0  # noqa: E731

    heads = "model" if div(cfg.num_heads) else None
    # Unshardable head counts (smollm: 9H): replicate attention internals
    # over 'model', as the reference chose.
    q_seq = None
    kv_heads = "model" if div(cfg.num_kv_heads) else None
    expert = "model" if (expert_parallel and div(cfg.num_experts)) else None
    expert_ff = None if expert else ("model" if div(cfg.moe_d_ff) else None)
    # Sequence parallelism (Megatron-SP) of the residual stream at layer
    # boundaries; train only (decode has S = 1).
    act_seq = "model" if (seq_parallel and mode == "train") else None
    return ShardingPlan(
        batch_axes=batch_axes,
        # weights shard over both axes in serve too (ZeRO-inference)
        fsdp_axes=("data",) if fsdp else None,
        model_size=msize,
        heads=heads,
        kv_heads=kv_heads,
        q_seq=q_seq,
        act_seq=act_seq,
        ff="model" if div(cfg.d_ff) else None,
        expert=expert,
        expert_ff=expert_ff,
        vocab="model" if vocab_tp else None,   # uneven vocabs allowed
        # decode KV cache: shard heads when they divide, else the sequence dim
        kv_seq=None if kv_heads else "model",
        ssd_heads="model" if div(cfg.ssm_heads) else None,
    )


# ---------------------------------------------------------------------------
# Parameter specs
# ---------------------------------------------------------------------------


def _attn_specs(plan: ShardingPlan, prefix: Tuple[Optional[str], ...]) -> dict:
    f = plan.fsdp_axes[0] if plan.fsdp_axes else None
    h, k = plan.heads, plan.kv_heads
    return {
        "wq": Spec(*prefix, f, h, None),
        "wk": Spec(*prefix, f, k, None),
        "wv": Spec(*prefix, f, k, None),
        "wo": Spec(*prefix, h, None, f),
        "bq": Spec(*prefix, h, None),
        "bk": Spec(*prefix, k, None),
        "bv": Spec(*prefix, k, None),
    }


def _ffn_specs(plan: ShardingPlan, prefix) -> dict:
    f = plan.fsdp_axes[0] if plan.fsdp_axes else None
    return {
        "w1": Spec(*prefix, f, plan.ff),
        "w3": Spec(*prefix, f, plan.ff),
        "w2": Spec(*prefix, plan.ff, f),
    }


def _moe_specs(plan: ShardingPlan, prefix) -> dict:
    f = plan.fsdp_axes[0] if plan.fsdp_axes else None
    e, eff = plan.expert, plan.expert_ff
    return {
        "router": Spec(*prefix, f, None),
        "w1": Spec(*prefix, e, f, eff),
        "w3": Spec(*prefix, e, f, eff),
        "w2": Spec(*prefix, e, eff, f),
        "shared_w1": Spec(*prefix, f, plan.ff),
        "shared_w3": Spec(*prefix, f, plan.ff),
        "shared_w2": Spec(*prefix, plan.ff, f),
    }


def _ssd_specs(plan: ShardingPlan, prefix) -> dict:
    f = plan.fsdp_axes[0] if plan.fsdp_axes else None
    sh = plan.ssd_heads  # shards d_inner-derived dims (heads * head_dim)
    return {
        "z_proj": Spec(*prefix, f, sh),
        "x_proj": Spec(*prefix, f, sh),
        "b_proj": Spec(*prefix, f, None),
        "c_proj": Spec(*prefix, f, None),
        "dt_proj": Spec(*prefix, f, sh),
        "conv_x": Spec(*prefix, None, sh),
        "conv_x_b": Spec(*prefix, sh),
        "conv_b": Spec(*prefix, None, None),
        "conv_b_b": Spec(*prefix, None),
        "conv_c": Spec(*prefix, None, None),
        "conv_c_b": Spec(*prefix, None),
        "A_log": Spec(*prefix, sh),
        "D": Spec(*prefix, sh),
        "dt_bias": Spec(*prefix, sh),
        "out_proj": Spec(*prefix, sh, f),
    }


def _block_specs(cfg: ModelConfig, plan: ShardingPlan, stacked: bool) -> dict:
    prefix: Tuple[Optional[str], ...] = (None,) if stacked else ()
    specs: dict = {"ln1": Spec(*prefix, None)}
    if cfg.family in ("ssm", "hybrid"):
        specs["ssd"] = _ssd_specs(plan, prefix)
        return specs
    specs["attn"] = _attn_specs(plan, prefix)
    specs["ln2"] = Spec(*prefix, None)
    if cfg.family == "moe":
        specs["moe"] = _moe_specs(plan, prefix)
    else:
        specs["mlp"] = _ffn_specs(plan, prefix)
    return specs


def param_specs(cfg: ModelConfig, plan: ShardingPlan, abstract) -> dict:
    """Spec tree matching ``abstract_params(cfg)``; pruned to the keys that
    actually exist (qkv bias, gated w3, tied head...)."""
    f = plan.fsdp_axes[0] if plan.fsdp_axes else None
    # argument shardings divide evenly: uneven vocabs (49155, 50280, 504)
    # fall back to FSDP on d
    vocab_ok = cfg.vocab_size % plan.model_size == 0
    v = plan.vocab if vocab_ok else None
    full = {
        "embed": Spec(v, "data" if (not vocab_ok and f) else None),
        "blocks": _block_specs(cfg, plan, stacked=True),
        "final_norm": Spec(None),
        "lm_head": Spec(f, v),
    }
    if cfg.family == "hybrid":
        full["shared"] = {"ln1": Spec(None), "ln2": Spec(None),
                          "attn": _attn_specs(plan, ()),
                          "mlp": _ffn_specs(plan, ())}
    if cfg.family == "vlm":
        full["cross"] = {"ln": Spec(None, None),
                         "attn": _attn_specs(plan, (None,)),
                         "gate": Spec(None)}
    return _prune_to(abstract, full)


def _prune_to(abstract, specs):
    """Keep only spec entries whose path exists in the abstract tree."""
    if isinstance(abstract, Mapping):
        return {k: _prune_to(v, specs[k]) for k, v in abstract.items()}
    if isinstance(abstract, (list, tuple)):
        return type(abstract)(_prune_to(v, specs) for v in abstract)
    return specs  # leaf: specs is the Spec for this leaf (or subtree broadcast)


# ---------------------------------------------------------------------------
# Batch / cache / state specs
# ---------------------------------------------------------------------------


def batch_specs(cfg: ModelConfig, plan: ShardingPlan, kind: str,
                global_batch: int = 0) -> dict:
    b = plan.batch_axes
    if global_batch and global_batch % _axes_size(plan, b) != 0:
        b = None  # e.g. long_500k batch=1: replicate batch dim
    if kind == "decode":
        return {"tokens": Spec(b, None), "pos": Spec()}
    specs = {}
    if cfg.family == "encoder":
        specs["frames"] = Spec(b, None, None)
    else:
        specs["tokens"] = Spec(b, None)
    if kind == "train":
        specs["labels"] = Spec(b, None)
    if cfg.family == "vlm":
        specs["images"] = Spec(b, None, None)
    return specs


def cache_specs(cfg: ModelConfig, plan: ShardingPlan, abstract_cache: Mapping) -> dict:
    """Specs of the decode cache in the reference's layout (``kv``, ``ssd``,
    ``cross_kv``; ``models.transformer.cache_tree`` gives it for the
    port's cache objects)."""
    kv_b = plan.batch_axes
    specs: dict = {}
    if "kv" in abstract_cache:
        bdim = abstract_cache["kv"]["k"].shape[1]
        kv_batch = kv_b if bdim % _axes_size(plan, kv_b) == 0 else None
        khead = plan.kv_heads
        kseq = None if khead else plan.kv_seq
        specs["kv"] = {
            "k": Spec(None, kv_batch, kseq, khead, None),
            "v": Spec(None, kv_batch, kseq, khead, None),
            "pos": Spec(None, kv_batch, kseq),
            "valid": Spec(None, kv_batch, kseq),
        }
    if "ssd" in abstract_cache:
        sb = abstract_cache["ssd"]["state"].shape[1]
        sbatch = kv_b if sb % _axes_size(plan, kv_b) == 0 else None
        sh = plan.ssd_heads
        specs["ssd"] = {
            "state": Spec(None, sbatch, sh, None, None),
            "conv_x": Spec(None, sbatch, None, sh),
            "conv_b": Spec(None, sbatch, None, None),
            "conv_c": Spec(None, sbatch, None, None),
        }
    if "cross_kv" in abstract_cache:
        cb = abstract_cache["cross_kv"]["k"].shape[1]
        cbatch = kv_b if cb % _axes_size(plan, kv_b) == 0 else None
        specs["cross_kv"] = {
            "k": Spec(None, cbatch, None, plan.kv_heads, None),
            "v": Spec(None, cbatch, None, plan.kv_heads, None),
        }
    return specs


def _axes_size(plan: ShardingPlan, axes) -> int:
    # The reference's quirk, copied so the specs stay equal: data=16 and
    # pod=2 whatever the mesh (ROADMAP.md section 3).
    size = 1
    for a in axes or ():
        size *= {"pod": 2, "data": 16, "model": plan.model_size}[a]
    return size


def state_specs(param_sp: dict) -> dict:
    """Train-state specs: optimizer moments shard like params (ZeRO-3)."""
    return {"params": param_sp,
            "opt": {"m": param_sp, "v": param_sp},
            "step": Spec()}


# ---------------------------------------------------------------------------
# Specs to DTensor placements
# ---------------------------------------------------------------------------


def to_placements(spec, mesh) -> tuple:
    """DTensor placements over ``mesh`` (a ``DeviceMesh``) of a spec: mesh
    dim i is ``Shard(d)`` where tensor dim d's entry names mesh axis i,
    else ``Replicate()``. One tensor dim may take several mesh axes, as the
    batch takes (``pod``, ``data``): each of them shards it, in mesh
    order."""
    from torch.distributed.tensor import Replicate, Shard

    owner = {}
    for d, entry in enumerate(spec):
        for name in ((entry,) if isinstance(entry, str) else entry or ()):
            if name in owner:
                raise ValueError(f"spec {spec}: mesh axis {name!r} shards two dims")
            owner[name] = d
    names = mesh.mesh_dim_names
    unknown = set(owner) - set(names)
    if unknown:
        raise ValueError(f"spec {spec}: axes {sorted(unknown)} not in mesh {names}")
    return tuple(Shard(owner[n]) if n in owner else Replicate() for n in names)


def _broadcast_specs(specs, abstract):
    """Broadcast a spec subtree (single Spec for a dict of leaves) to tree shape."""
    if isinstance(specs, Spec):
        if isinstance(abstract, Mapping):
            return {k: _broadcast_specs(specs, v) for k, v in abstract.items()}
        if isinstance(abstract, (list, tuple)):
            return type(abstract)(_broadcast_specs(specs, a) for a in abstract)
        return specs
    if isinstance(abstract, Mapping):
        return {k: _broadcast_specs(specs[k], abstract[k]) for k in abstract}
    if isinstance(abstract, (list, tuple)):
        if isinstance(specs, (list, tuple)):
            return type(abstract)(_broadcast_specs(s, a) for s, a in zip(specs, abstract))
        return type(abstract)(_broadcast_specs(specs, a) for a in abstract)
    return specs


def to_shardings(mesh, spec_tree, abstract):
    """Spec tree -> a tree of placement tuples shaped like ``abstract``."""
    def build(s, a):
        if isinstance(a, Mapping):
            return {k: build(s[k], a[k]) for k in a}
        if isinstance(a, (list, tuple)):
            return type(a)(build(x, y) for x, y in zip(s, a))
        return to_placements(s, mesh)
    return build(_broadcast_specs(spec_tree, abstract), abstract)


# ---------------------------------------------------------------------------
# Sharded embedding store (runtime.sharded_engine)
# ---------------------------------------------------------------------------

EMBED_LAYOUTS = ("row", "table")


def check_layout(layout: str) -> None:
    if layout not in EMBED_LAYOUTS:
        raise ValueError(f"layout must be one of {EMBED_LAYOUTS}, got {layout!r}")


def embed_store_specs(layout: str) -> dict:
    """Spec per leaf of the packed backing store, leading axis 'shard'
    everywhere (row and table packings differ on the host; the device
    placement rule is the same stacked split)."""
    check_layout(layout)
    return {
        "payload": Spec("shard", None, None),   # [n, local_rows+1, dim] int8
        "scale": Spec("shard", None),           # [n, local_rows+1] f32
        "bias": Spec("shard", None),            # [n, local_rows+1] f32
    }


def embed_cache_specs() -> dict:
    """Spec per leaf of the stacked per-shard row-cache state (every row
    cache leaf gains a leading 'shard' axis)."""
    return {
        "tag_table": Spec("shard", None, None),
        "tag_row": Spec("shard", None, None),
        "data": Spec("shard", None, None, None),
        "stamp": Spec("shard", None, None),
        "clock": Spec("shard"),
        "hits": Spec("shard"),
        "misses": Spec("shard"),
    }


def embed_batch_specs() -> dict:
    """The sharded serve step's data flow: the index block and its valid
    mask replicated, the pooled output replicated (already combined), the
    per-shard miss counts sharded so each shard's IO queue is charged."""
    return {"idx": Spec(), "valid": Spec(), "pooled": Spec(),
            "miss": Spec("shard", None, None)}


def embed_store_shardings(mesh, layout: str) -> dict:
    """Placements of the packed backing store's leaves over a 1-D
    ``('shard',)`` ``DeviceMesh``."""
    return {k: to_placements(s, mesh) for k, s in embed_store_specs(layout).items()}


def embed_cache_shardings(mesh) -> dict:
    return {k: to_placements(s, mesh) for k, s in embed_cache_specs().items()}
