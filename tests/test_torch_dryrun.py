"""The port's dry-run (``repro_torch.launch.dryrun``): steps traced as DTensor
code over a fake process group under ``FakeTensorMode``.

The traces run in ONE subprocess (``_WORKER``), so the fake process group
never leaks into another test's worker; each test reads its part of the
JSON the subprocess prints. Meshes are 4x2 (``data``, ``model``) of fake CPU
tensors, cells cut to 8 sequences of 64 tokens on the reduced configs.
The plain-tensor pieces (the MoE's static capacity, the kernels' log-sum-
exp and the split merge) run here, in process.
"""
import dataclasses
import functools
import json
import math
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.kernels import ref
from repro_torch.models import layers as L
from repro_torch.models import moe as tmoe

SRC = os.path.join(os.path.dirname(__file__), "..", "src")

FAMILY_ARCHS = {"dense": "smollm-135m", "moe": "deepseek-moe-16b", "ssm": "mamba2-1.3b",
                "hybrid": "zamba2-1.2b", "encoder": "hubert-xlarge",
                "vlm": "llama-3.2-vision-90b"}
KINDS = {"train": "train_4k", "prefill": "prefill_32k", "decode": "decode_32k"}
FAMILY_CELLS = [(f, k) for f in FAMILY_ARCHS for k in KINDS
                if not (f == "encoder" and k == "decode")]

_WORKER = r"""
import dataclasses, json, math, sys
import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.utils.flop_counter import FlopCounterMode
from repro_torch.configs import SHAPES, get_config
from repro_torch.launch import dryrun, steps
from repro_torch.launch.mesh import make_mesh_compat
from repro_torch.tree import leaves

mesh = make_mesh_compat((4, 2), ("data", "model"), device="cpu")
out = {}

def small(arch):
    cfg = get_config(arch).reduced()
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}

def cell(arch, shape):
    c = dryrun.run_cell(arch, shape, False, cfg_override=small(arch), device="cpu",
                        shape_override=dict(seq_len=64, global_batch=8), mesh=mesh, cut=False)
    return {k: c.get(k) for k in ("status", "error", "traceback", "hlo_flops_per_device",
                                  "memory", "collectives", "trace_s")}

# the reference's mini cell: smollm-135m reduced, 4x2, train 8 x 64
out["mini"] = cell("smollm-135m", "train_4k")
for key, (arch, shape) in json.loads(sys.argv[1]).items():
    out[key] = cell(arch, shape)

# argument bytes: an independent sum of each leaf's local shard
cfg = get_config("smollm-135m").reduced()
shape = dataclasses.replace(SHAPES["train_4k"], seq_len=64, global_batch=8)
args = steps.build_step(cfg, shape, mesh)[1]
def local_numel(t):
    dims = list(t.shape)
    for i, p in enumerate(t.placements):
        if isinstance(p, Shard):
            n, r = mesh.size(i), mesh.get_local_rank(i)
            chunk = -(-dims[p.dim] // n)
            dims[p.dim] = max(0, min(chunk, dims[p.dim] - r * chunk))
    return math.prod(dims)
out["arg_bytes_independent"] = sum(local_numel(t) * t.dtype.itemsize for t in leaves(args))

# per-device FLOPs of sharded products against the local product's
from torch._subclasses.fake_tensor import FakeTensorMode
mode = FakeTensorMode()
with mode:
    x = torch.empty(8, 64); w = torch.empty(64, 32)
flops = {}
for name, xp, wp in (("row_col", [Shard(0), Replicate()], [Replicate(), Shard(1)]),
                     ("contracted", [Replicate(), Shard(1)], [Replicate(), Shard(0)])):
    xd = steps._place_fake(x, xp, mesh, mode)
    wd = steps._place_fake(w, wp, mesh, mode)
    c = dryrun.step_counter()
    with mode, c:
        y = torch.mm(xd, wd)
    with mode, FlopCounterMode(display=False) as f:
        torch.mm(xd.to_local(), wd.to_local())
    flops[name] = [c.flops, f.get_total_flops(),
                   ["P" if p.is_partial() else "S" if p.is_shard() else "R" for p in y.placements]]
    if name == "contracted":
        c = dryrun.step_counter()
        with mode, c:
            y.redistribute(mesh, [Replicate(), Replicate()])
        flops["reduce_records"] = [[r["op"], r["result_bytes"], r["group"]] for r in c.records]
out["flops"] = flops

# the two reports, on the mini cell's config and mesh
import contextlib, io
from repro_torch.launch import collectives_report, inspect_hlo
with contextlib.redirect_stdout(io.StringIO()):
    sites = collectives_report.report("smollm-135m", "train_4k", 2, mesh=mesh, device="cpu",
                                      cfg_override={k: v for k, v in small("smollm-135m").items()
                                                    if k not in ("num_layers", "name")})
    top = inspect_hlo.inspect(get_config("smollm-135m").reduced(), shape, mesh)
out["report"] = {"sites": sites, "top": top}
print(json.dumps(out, default=str))
"""


@functools.lru_cache(maxsize=None)
def _run() -> dict:
    cells = {f"{f}:{k}": (FAMILY_ARCHS[f], KINDS[k]) for f, k in FAMILY_CELLS}
    res = subprocess.run([sys.executable, "-c", _WORKER, json.dumps(cells)],
                         capture_output=True, text=True, timeout=600,
                         env=dict(os.environ, PYTHONPATH=SRC))
    assert res.returncode == 0, res.stderr[-3000:]
    return json.loads(res.stdout.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def traced():
    return _run()


def test_mini_cell_traces_with_flops(traced):
    """The reference's mini cell (``tests/test_dryrun_mini.py``): smollm-135m
    reduced on a 4x2 mesh, a train step of 8 x 64 tokens."""
    c = traced["mini"]
    assert c["status"] == "ok", c.get("traceback")
    assert c["hlo_flops_per_device"] > 0
    mem = c["memory"]
    assert mem["argument"] > 0 and mem["temp"] > 0 and mem["fits"]
    assert c["collectives"]["total_count"] > 0


@pytest.mark.parametrize("family,kind", FAMILY_CELLS)
def test_every_family_traces(traced, family, kind):
    c = traced[f"{family}:{kind}"]
    assert c["status"] == "ok", c.get("traceback")
    assert c["hlo_flops_per_device"] > 0 and c["memory"]["peak_per_device"] > 0


def test_argument_bytes_are_the_local_shards(traced):
    assert traced["mini"]["memory"]["argument"] == traced["arg_bytes_independent"]


@pytest.mark.parametrize("case,split", [("row_col", 8), ("contracted", 2)])
def test_per_device_flops_of_a_sharded_product(traced, case, split):
    """A DTensor product counts its global FLOPs over the devices its output
    is split over (rows over 4 x columns over 2; or a contraction split
    over the 2 of ``model``, a partial sum): the local product's count."""
    counted, local, _ = traced["flops"][case]
    assert counted == local == 2 * 8 * 64 * 32 / split


def test_partial_sum_reduces_with_one_all_reduce(traced):
    _, _, placements = traced["flops"]["contracted"]
    assert placements == ["R", "P"]
    assert traced["flops"]["reduce_records"] == [["all-reduce", 8 * 32 * 4, 2]]


def test_collectives_report_groups_by_site(traced):
    """``collectives_report`` groups the cut cell's collectives by op and by
    the model code that issued them: the FSDP weight gathers of the
    attention projections among them."""
    sites = traced["report"]["sites"]
    assert sites and all(n > 0 and b > 0 for n, b in sites.values())
    assert any(k.startswith("all-gather | layers.py:") for k in sites)


def test_inspect_hlo_lists_the_tensors_live_at_the_peak(traced):
    top = traced["report"]["top"]
    assert top and all(b > 0 and n >= 1 for _, b, n in top)
    assert [b for _, b, _ in top] == sorted((b for _, b, _ in top), reverse=True)


# --------------------------------------------------------------------------
# plain tensors: the MoE's static capacity, the log-sum-exp and its merge
# --------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "mixtral-8x22b"])
@pytest.mark.parametrize("S", [24, 512])
def test_moe_static_capacity_equals_the_dynamic_path_under_drops(arch, S):
    """``static_capacity=True`` (every expert over its capacity slots, the
    traced steps' body) against the dynamic path's host read of the counts,
    with drops forced (capacity factor 0.25): bit for bit."""
    cfg = dataclasses.replace(get_config(arch).reduced(), moe_capacity_factor=0.25)
    g = torch.Generator().manual_seed(S)
    params = tmoe.init_moe(cfg, g)
    x = torch.randn(3, S, cfg.d_model, generator=g)
    kept = tmoe.topk_assign(torch.softmax(torch.einsum(
        "bsd,de->bse", tmoe._group(x), params["router"]), -1), cfg.top_k,
        tmoe.capacity_of(cfg, x))[0]
    assert len(kept) < x.shape[0] * S * cfg.top_k              # tokens were dropped
    y, aux = tmoe.moe_ffn(params, x, cfg)
    ys, auxs = tmoe.moe_ffn(params, x, cfg, static_capacity=True)
    assert torch.equal(ys, y) and torch.equal(auxs, aux)


def test_moe_static_capacity_in_a_decode_step():
    """One token a group (capacity k): within float32 rounding, the GEMMs
    taking 1 row in one path and k in the other (measured 1.2e-7)."""
    cfg = get_config("deepseek-moe-16b").reduced()
    g = torch.Generator().manual_seed(5)
    params = tmoe.init_moe(cfg, g)
    x = torch.randn(4, 1, cfg.d_model, generator=g)
    y, aux = tmoe.moe_ffn(params, x, cfg)
    ys, auxs = tmoe.moe_ffn(params, x, cfg, static_capacity=True)
    torch.testing.assert_close(ys, y, rtol=1e-6, atol=1e-6)
    assert torch.equal(auxs, aux)


@pytest.mark.parametrize("kv_len", [0, 1, 37, 64, 90])
def test_flash_decode_ref_lse_against_float64(kv_len):
    """The plain version's log-sum-exp [B, H] against a float64 logsumexp of
    the same scaled, masked scores (within 1e-5: f32 rounding of scores
    near 10)."""
    rng = np.random.default_rng(kv_len)
    B, S, H, K, hd = 3, 64, 6, 2, 16
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in ((B, H, hd), (B, S, K, hd), (B, S, K, hd)))
    lens = np.array([kv_len, min(kv_len, 5), S], dtype=np.int32)
    out, lse = ref.flash_decode_ref(*map(torch.from_numpy, (q, k, v, lens)), return_lse=True)
    assert torch.equal(out, ref.flash_decode_ref(*map(torch.from_numpy, (q, k, v, lens))))
    kr = np.repeat(k.astype(np.float64), H // K, axis=2)
    scores = np.einsum("bhd,bshd->bhs", q.astype(np.float64), kr) / math.sqrt(hd)
    scores = np.where(np.arange(S)[None, None, :] < lens[:, None, None], scores, -1e30)
    m = scores.max(-1, keepdims=True)
    want = (m + np.log(np.exp(scores - m).sum(-1, keepdims=True)))[..., 0]
    valid = lens > 0                 # a row with no valid key scores -1e30 throughout
    np.testing.assert_allclose(lse.numpy()[valid], want[valid], rtol=0, atol=1e-5)
    assert (lse.numpy()[~valid] == np.float32(-1e30)).all()


@pytest.mark.parametrize("n", [2, 4])
def test_merge_splits_equals_attention_over_the_whole_cache(n):
    """A sequence-sharded cache's decode: each slice attended with its share
    of kv_len, merged by log-sum-exp, against one call over the whole
    cache (within 1e-6); a slice past kv_len adds nothing."""
    rng = np.random.default_rng(n)
    B, S, H, K, hd = 2, 64, 6, 3, 16
    q = torch.from_numpy(rng.standard_normal((B, H, hd)).astype(np.float32))
    k, v = (torch.from_numpy(rng.standard_normal((B, S, K, hd)).astype(np.float32))
            for _ in range(2))
    kv_len = 40
    want = ref.flash_decode_ref(q, k, v, torch.full((B,), kv_len, dtype=torch.int32))
    parts = [ref.flash_decode_ref(q, k[:, i * S // n:(i + 1) * S // n],
                                  v[:, i * S // n:(i + 1) * S // n],
                                  torch.full((B,), max(0, min(kv_len - i * S // n, S // n)),
                                             dtype=torch.int32), return_lse=True)
             for i in range(n)]
    got = L.merge_splits(torch.stack([o for o, _ in parts]), torch.stack([s for _, s in parts]))
    torch.testing.assert_close(got, want, rtol=0, atol=1e-6)


# --------------------------------------------------------------------------
# against the reference's compiled mini cell
# --------------------------------------------------------------------------

_REFERENCE = r"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import dataclasses, json
import jax
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.configs import SHAPES, get_config
from repro.launch import hlo, steps
from repro.launch.mesh import make_mesh_compat
from repro.models.layers import set_logical_rules
mesh = make_mesh_compat((4, 2), ("data", "model"))
cfg = get_config("smollm-135m").reduced()
shape = dataclasses.replace(SHAPES["train_4k"], seq_len=64, global_batch=8)
step, args, in_sp, out_sp, plan = steps.build_step(cfg, shape, mesh)
set_logical_rules(plan.rules())
sh = lambda sp: NamedSharding(mesh, P() if sp is None else sp)
is_spec = lambda x: x is None or isinstance(x, P)
with jax.set_mesh(mesh):
    compiled = jax.jit(step, in_shardings=jax.tree.map(sh, in_sp, is_leaf=is_spec),
                       out_shardings=jax.tree.map(sh, out_sp, is_leaf=is_spec)
                       ).lower(*args).compile()
stats = hlo.collective_stats(compiled.as_text(), default_group=2)
print(json.dumps({"argument": compiled.memory_analysis().argument_size_in_bytes,
                  "kinds": sorted(k for k in stats if not k.startswith("total"))}))
"""


@pytest.mark.slow
def test_mini_cell_against_the_reference_compile(traced):
    """Argument bytes equal the reference's compiled mini cell's exactly
    (both place the same specs: the local shards of the same state and
    batch). The collective kinds agree up to two rewrites, which is the
    tolerance: a reduce-scatter counts as an all-reduce (XLA's CPU
    partitioner writes one as an all-reduce whose result it slices), and
    an all-to-all may appear in the port alone (DTensor moves a tensor
    between two shardings of one mesh axis with it, where XLA gathers).
    Counts and bytes are not compared: the two partitioners choose
    differently."""
    res = subprocess.run([sys.executable, "-c", _REFERENCE], capture_output=True, text=True,
                         timeout=600, env=dict(os.environ, PYTHONPATH=SRC,
                                               JAX_PLATFORMS="cpu"))
    assert res.returncode == 0, res.stderr[-3000:]
    want = json.loads(res.stdout.strip().splitlines()[-1])
    mini = traced["mini"]
    assert mini["memory"]["argument"] == want["argument"]
    as_xla = {"reduce-scatter": "all-reduce"}
    kinds = {as_xla.get(k, k) for k in mini["collectives"] if not k.startswith("total")}
    assert kinds - {"all-to-all"} <= set(want["kinds"])
    assert "all-gather" in kinds and "all-reduce" in kinds
