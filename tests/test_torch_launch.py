"""Port vs reference: the launch tooling's plans and abstract shapes
(``repro_torch.launch.sharding``, ``steps``, ``hlo``, ``mesh``, the
dry-run's analytic terms) against ``repro.launch``, for every arch in
``ASSIGNED_ARCHS`` x every shape x the 16x16, 2x16x16 and 4x2 meshes.

The reference side gets ``jax.sharding.AbstractMesh`` and ``jax.eval_shape``,
so it needs no devices and no compile; the port side gets a mapping of axis
sizes (its plans read nothing else of a mesh) and fake tensors. Specs are
compared as tuples: the port's ``Spec`` against ``tuple()`` of the
reference's ``PartitionSpec``, leaf by leaf. Nothing here starts a process
group (``test_torch_dryrun.py`` runs the fake-mesh traces in a subprocess).
"""
import functools
import json
import os
import subprocess
import sys

import jax.numpy as jnp
import pytest
import torch
from jax.sharding import AbstractMesh
from jax.sharding import PartitionSpec as P

from repro.configs import ASSIGNED_ARCHS, SHAPE_ORDER, SHAPES, get_config
from repro.launch import dryrun as jdry
from repro.launch import hlo as jhlo
from repro.launch import sharding as jsh
from repro.launch import steps as jsteps
from repro.models import transformer as JT
from repro_torch.configs import SHAPES as TSHAPES
from repro_torch.configs import get_config as tget_config
from repro_torch.launch import dryrun as tdry
from repro_torch.launch import hlo as thlo
from repro_torch.launch import sharding as tsh
from repro_torch.launch import steps as tsteps
from repro_torch.models import transformer as TT

SRC = os.path.join(os.path.dirname(__file__), "..", "src")

MESHES = {
    "16x16": ((16, 16), ("data", "model")),
    "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
    "4x2": ((4, 2), ("data", "model")),
}
CELLS = [(a, s, m) for a in ASSIGNED_ARCHS for s in SHAPE_ORDER for m in MESHES]
MODE_OF = {"train": "train", "prefill": "serve", "decode": "serve"}


def _meshes(name):
    sizes, names = MESHES[name]
    return AbstractMesh(sizes, names), dict(zip(names, sizes))


def _plans(arch, shape, mesh):
    cfg, tcfg = get_config(arch), tget_config(arch)
    jm, tm = _meshes(mesh)
    kind = SHAPES[shape].kind
    sp = cfg.seq_parallel
    return (cfg, tcfg, jsh.make_plan(cfg, jm, mode=MODE_OF[kind], seq_parallel=sp),
            tsh.make_plan(tcfg, tm, mode=MODE_OF[kind], seq_parallel=sp))


@functools.lru_cache(maxsize=None)
def _jparams(arch):
    return JT.abstract_params(get_config(arch), dtype=jnp.bfloat16)


@functools.lru_cache(maxsize=None)
def _tparams(arch):
    return TT.abstract_params(tget_config(arch), dtype=torch.bfloat16, device="cpu")


def _spec_leaves(tree, prefix=()):
    """(path, tuple) of every spec leaf, either package's."""
    if isinstance(tree, (P, tsh.Spec)):
        return [(prefix, tuple(tree))]
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _spec_leaves(tree[k], prefix + (k,))]
    raise TypeError(f"{prefix}: {type(tree)}")


def _shape_leaves(tree, prefix=()):
    """(path, shape, dtype name) of every array leaf, either package's."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _shape_leaves(tree[k], prefix + (k,))]
    return [(prefix, tuple(tree.shape), str(tree.dtype).split(".")[-1])]


@pytest.mark.parametrize("arch,shape,mesh", CELLS)
def test_plans_and_specs_equal_the_reference(arch, shape, mesh):
    cfg, tcfg, jplan, tplan = _plans(arch, shape, mesh)
    assert tplan.rules() == jplan.rules()
    assert dataclasses_equal(tplan, jplan)
    sh = SHAPES[shape]
    jp = jsh.param_specs(cfg, jplan, _jparams(arch))
    tp = tsh.param_specs(tcfg, tplan, _tparams(arch))
    assert _spec_leaves(tp) == _spec_leaves(jp)
    assert _spec_leaves(tsh.state_specs(tp)) == _spec_leaves(jsh.state_specs(jp))
    for g in (0, sh.global_batch):
        assert _spec_leaves(tsh.batch_specs(tcfg, tplan, sh.kind, g)) == \
            _spec_leaves(jsh.batch_specs(cfg, jplan, sh.kind, g))
    if sh.kind == "decode" and not cfg.is_encoder_only:
        jc = jsteps.abstract_cache(cfg, sh)
        tc = tsteps.abstract_cache(tcfg, TSHAPES[shape], device="cpu")
        assert _spec_leaves(tsh.cache_specs(tcfg, tplan, tc)) == \
            _spec_leaves(jsh.cache_specs(cfg, jplan, jc))


def dataclasses_equal(a, b) -> bool:
    import dataclasses
    return [(f.name, getattr(a, f.name)) for f in dataclasses.fields(a)] == \
        [(f.name, getattr(b, f.name)) for f in dataclasses.fields(b)]


@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_abstract_params_equal_the_reference(arch):
    assert _shape_leaves(_tparams(arch)) == _shape_leaves(_jparams(arch))


@pytest.mark.parametrize("arch,shape", [(a, s) for a in ASSIGNED_ARCHS for s in SHAPE_ORDER])
def test_input_specs_and_abstract_cache_equal_the_reference(arch, shape):
    cfg, tcfg, sh = get_config(arch), tget_config(arch), SHAPES[shape]
    assert _shape_leaves(tsteps.input_specs(tcfg, TSHAPES[shape], device="cpu")) == \
        _shape_leaves(jsteps.input_specs(cfg, sh))
    if sh.kind == "decode" and not cfg.is_encoder_only:
        assert _shape_leaves(tsteps.abstract_cache(tcfg, TSHAPES[shape], device="cpu")) == \
            _shape_leaves(jsteps.abstract_cache(cfg, sh))


@pytest.mark.parametrize("arch,shape,mesh", [c for c in CELLS if c[2] != "4x2"])
def test_analytic_terms_equal_the_reference(arch, shape, mesh):
    jm, tm = _meshes(mesh)
    cfg, tcfg = get_config(arch), tget_config(arch)
    assert tdry._analytic_temp(tcfg, TSHAPES[shape], tm) == jdry._analytic_temp(cfg, SHAPES[shape], jm)
    assert tdry._model_flops(tcfg, TSHAPES[shape]) == jdry._model_flops(cfg, SHAPES[shape])


def test_abstract_params_allocate_nothing():
    from torch._subclasses.fake_tensor import FakeTensor
    leaves = [t for _, t in _flat(_tparams("llama-3.2-vision-90b"))]
    assert leaves and all(isinstance(t, FakeTensor) for t in leaves)
    assert sum(t.numel() for t in leaves) > 9e10          # 90B parameters, none made


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _flat(tree[k], prefix + (k,))]
    return [(prefix, tree)]


# --------------------------------------------------------------------------
# HLO collective parser and CommDebugMode records
# --------------------------------------------------------------------------

HLO = """
  %ag = bf16[16,512]{1,0} all-gather(%x), replica_groups=[16,16]<=[256], dimensions={0}
  %ar = f32[128]{0} all-reduce(%y), replica_groups={{0,1,2,3}}, to_apply=%sum
  %cp = bf16[4,4]{1,0} collective-permute(%z), source_target_pairs={{0,1}}
  %t = (f32[8,4]{1,0}, bf16[2,2]{1,0}) all-reduce(%a, %b), replica_groups=[32,8]<=[256]
  %s = f32[64]{0} reduce-scatter-start(%c), replica_groups={{0,1}}, dimensions={0}
  %g = s32[3,5]{1,0} all-gather-start(%d), replica_groups=[2,128]<=[256], dimensions={1}
  %aa = u8[1024]{0} all-to-all(%e), replica_groups=[64,4]<=[256]
  %n = f32[7]{0} add(%p, %q)
"""


@pytest.mark.parametrize("default_group", [1, 2, 16])
def test_collective_stats_bit_equal_to_the_reference(default_group):
    assert thlo.collective_stats(HLO, default_group) == jhlo.collective_stats(HLO, default_group)
    for op in ("all-gather", "all-reduce", "reduce-scatter", "add", "collective-permute"):
        assert thlo.count_ops(HLO, op) == jhlo.count_ops(HLO, op)


def test_comm_stats_layout_and_ring_bytes():
    recs = [{"op": "_c10d_functional.all_gather_into_tensor.default", "result_bytes": 1600,
             "group": 16},
            {"op": "all_reduce", "result_bytes": 512, "group": 4},
            {"op": "all-reduce", "result_bytes": 100},
            {"op": "reduce_scatter_tensor", "result_bytes": 64, "group": 2},
            {"op": "wait_tensor", "result_bytes": 9, "group": 2}]
    stats = thlo.comm_stats(recs, default_group=8)
    assert stats["all-gather"] == {"count": 1, "result_bytes": 1600, "wire_bytes": 1500}
    assert stats["all-reduce"] == {"count": 2, "result_bytes": 612,
                                   "wire_bytes": int(2 * 512 * 3 / 4) + int(2 * 100 * 7 / 8)}
    assert stats["reduce-scatter"]["wire_bytes"] == 64
    assert stats["total_count"] == 4 and "wait_tensor" not in stats
    assert stats["total_wire_bytes"] == 1500 + 768 + 175 + 64
    # the same collective through both parsers prices the same
    assert thlo.comm_stats([{"op": "all-gather", "result_bytes": 16 * 512 * 2}], 16) == \
        jhlo.collective_stats(HLO.splitlines()[1], 16)


# --------------------------------------------------------------------------
# meshes and placements
# --------------------------------------------------------------------------

MESH_SCRIPT = r"""
import json, torch.distributed as dist
import repro_torch.launch.mesh as M
import repro_torch.launch.dryrun, repro_torch.launch.steps  # noqa: F401
before = dist.is_initialized()
m = M.make_host_mesh(device="cpu")
print(json.dumps({"import_initialized": before, "names": list(m.mesh_dim_names),
                  "shape": list(m.shape), "backend": dist.get_backend()}))
"""


def test_mesh_constructors():
    """Importing the launch modules starts no process group; the host mesh
    (a one-rank gloo group here) has ``data`` and ``model``."""
    out = subprocess.run([sys.executable, "-c", MESH_SCRIPT], capture_output=True, text=True,
                         env=dict(os.environ, PYTHONPATH=SRC), timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got == {"import_initialized": False, "names": ["data", "model"], "shape": [1, 1],
                   "backend": "gloo"}


def test_production_mesh_constants_are_the_h100s():
    from repro_torch.launch import mesh as M
    assert (M.PEAK_FLOPS_BF16, M.HBM_BW, M.LINK_BW) == (989e12, 3.35e12, 50e9)
    assert 80e9 < M.HBM_PER_CHIP < 86e9


class _Mesh:
    """What ``to_placements`` reads of a ``DeviceMesh``."""
    def __init__(self, names):
        self.mesh_dim_names = names


def test_to_placements():
    from torch.distributed.tensor import Replicate, Shard
    m3 = _Mesh(("pod", "data", "model"))
    assert tsh.to_placements(tsh.Spec(("pod", "data"), None, "model"), m3) == \
        (Shard(0), Shard(0), Shard(2))
    assert tsh.to_placements(tsh.Spec(None, "data"), m3) == (Replicate(), Shard(1), Replicate())
    assert tsh.to_placements(tsh.Spec(), m3) == (Replicate(),) * 3
    with pytest.raises(ValueError):
        tsh.to_placements(tsh.Spec("model", "model"), m3)
    with pytest.raises(ValueError):
        tsh.to_placements(tsh.Spec("pod"), _Mesh(("data", "model")))
    shard = _Mesh(("shard",))
    assert tsh.embed_store_shardings(shard, "row") == {
        "payload": (Shard(0),), "scale": (Shard(0),), "bias": (Shard(0),)}
    assert set(tsh.embed_cache_shardings(shard)) == set(jsh.embed_cache_specs())


def test_embed_specs_equal_the_reference():
    for layout in tsh.EMBED_LAYOUTS:
        assert _spec_leaves(tsh.embed_store_specs(layout)) == \
            _spec_leaves(jsh.embed_store_specs(layout))
    assert _spec_leaves(tsh.embed_cache_specs()) == _spec_leaves(jsh.embed_cache_specs())
    assert _spec_leaves(tsh.embed_batch_specs()) == _spec_leaves(jsh.embed_batch_specs())
    with pytest.raises(ValueError):
        tsh.embed_store_specs("column")


def test_axes_size_keeps_the_references_quirk():
    """``_axes_size`` takes data = 16 and pod = 2 whatever the mesh: on the
    4x2 mesh a batch of 8 does not 'divide' data, in both packages."""
    _, _, jplan, tplan = _plans("smollm-135m", "train_4k", "4x2")
    assert tsh._axes_size(tplan, ("data",)) == jsh._axes_size(jplan, ("data",)) == 16
    assert tsh.batch_specs(tget_config("smollm-135m"), tplan, "train", 8)["tokens"] == (None, None)
