"""Multi-pod dry-run: trace every (arch x shape x mesh) cell on fake tensors.

The port of ``src/repro/launch/dryrun.py``. PyTorch has no GSPMD; its
counterpart of "compile a sharded step without the hardware" is the step
run as DTensor code over a fake process group (``launch.mesh``) under
``FakeTensorMode``: nothing is allocated and no collective moves a byte,
but every operator runs on its device's local shapes and DTensor issues
every collective its placements need. Per cell, into
``artifacts/dryrun/<arch>__<shape>__<mesh>.json``:

* ``hlo_flops_per_device`` -- FLOPs of the step on one device (each
  operator's ``torch.utils.flop_counter`` formula on its global shapes,
  divided by the devices its output is split over, ``Shard`` or
  ``Partial``; bodies run on local shards count their local shapes);
  ``hlo_bytes_per_device`` -- the bytes each operator reads and writes on
  one device (unfused, so far above XLA's fused count);
* ``memory`` -- ``argument`` and ``output`` (summed local bytes), ``temp``
  (the peak of live local storages above the arguments and outputs),
  ``alias`` (outputs that are arguments, updated in place), their peak,
  the analytic temp (a copy of the reference's) and whether each fits
  ``HBM_PER_CHIP``;
* ``collectives`` -- ``hlo.comm_stats`` of the collectives recorded;
* ``roofline`` -- compute, memory and collective seconds against the H100
  constants of ``launch.mesh``, and the largest as the bottleneck.

All of it is counted by one ``CommDebugMode`` (:func:`step_counter`). A
cell is traced at two cut depths and extrapolated linearly to its full
depth (:func:`cut_depths`, :func:`extrapolate`); ``depths_traced`` says
which.

The reference's ``lower_s`` and ``compile_s`` become ``trace_s``. A cell
that raises is ``FAILED`` with its traceback, and ``main`` exits 1 if any
cell failed.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun [--arch A] [--shape S]
        [--mesh single|multi|both] [--no-fsdp] [--no-ep] [--out DIR]
        [--device cuda|cpu] [--workers N]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import sys
import time
import traceback
import weakref
from pathlib import Path

import torch

from repro_torch.configs import ASSIGNED_ARCHS, SHAPE_ORDER, SHAPES, get_config
from repro_torch.launch import hlo as hlo_mod
from repro_torch.launch import steps as steps_mod
from repro_torch.launch.mesh import (HBM_BW, HBM_PER_CHIP, LINK_BW, PEAK_FLOPS_BF16,
                                     make_production_mesh)
from repro_torch.models import layers as layers_mod
from repro_torch.tree import leaves


def _tensors(x):
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (list, tuple)):
        return [t for y in x for t in _tensors(y)]
    if isinstance(x, dict):
        return [t for y in x.values() for t in _tensors(y)]
    return []


def _local(t: torch.Tensor) -> torch.Tensor:
    return t._local_tensor if hasattr(t, "_local_tensor") else t


def _split(t: torch.Tensor) -> int:
    """Devices a DTensor's value is split over (1 for a plain tensor)."""
    pl = getattr(t, "placements", None)
    if pl is None:
        return 1
    mesh = t.device_mesh
    return math.prod(mesh.size(i) for i, p in enumerate(pl) if not p.is_replicate())


def _local_bytes(t: torch.Tensor) -> int:
    t = _local(t)
    return t.numel() * t.element_size()


def _site() -> str:
    """The innermost two frames of the port's model code on the stack:
    where a collective was issued."""
    frames, f = [], sys._getframe(2)
    while f is not None and len(frames) < 2:
        path = f.f_code.co_filename
        if "repro_torch" in path and "launch" not in path:
            frames.append(f"{os.path.basename(path)}:{f.f_code.co_name}")
        f = f.f_back
    return " < ".join(frames) or "?"


def _group(args, kwargs) -> int:
    """The size of a functional collective's process group."""
    from torch.distributed.distributed_c10d import _resolve_process_group
    for a in list(args) + list((kwargs or {}).values()):
        if isinstance(a, str):
            try:
                return _resolve_process_group(a).size()
            except (ValueError, RuntimeError):
                continue
    return 0


def _in_propagation() -> bool:
    """Whether DTensor's sharding propagation is on the stack."""
    f = sys._getframe(2)
    for _ in range(16):
        if f is None:
            return False
        if f.f_code.co_filename.endswith("_sharding_prop.py"):
            return True
        f = f.f_back
    return False


def step_counter(keep_peak: bool = False):
    """A ``CommDebugMode`` that also counts, per device, what a step costs:

    * ``flops`` and ``bytes`` -- a DTensor operator is seen once, with
      global shapes: its ``torch.utils.flop_counter`` formula's count is
      divided by :func:`_split` of its output; bytes are the local bytes of
      its inputs and outputs (view operators move none). An operator on
      plain (local) tensors counts as it is;
    * ``live`` / ``peak`` -- the live bytes of local storages: each storage
      an operator outputs counts from its first appearance until it is
      freed (a weak reference's callback), so autograd's saved tensors
      count while the graph holds them; ``track`` registers tensors made
      before (the arguments); with ``keep_peak``, ``at_peak`` lists the
      storages live at the peak (bytes, ``dtype[shape]``);
    * ``records`` -- every collective: its op, local result bytes, group
      size and where the model issued it (:func:`_site`; the port's model
      runs no module's ``forward``, so the mode's own module path reads
      "Global" for all of them).

    Operators run by DTensor's sharding propagation are not the step's:
    it runs each new operator once on global fake shapes to learn its
    output's (:func:`_in_propagation`).
    """
    from torch.distributed.tensor.debug import CommDebugMode
    from torch.utils.flop_counter import flop_registry

    from torch.distributed.tensor import DTensor

    class StepCounter(CommDebugMode):
        def __init__(self):
            super().__init__()
            self.keep_peak = keep_peak
            self.at_peak = []         # (bytes, dtype[shape]) live at the peak
            self._what = {}
            self.flops = 0.0
            self.bytes = 0.0
            self.live = 0
            self.peak = 0
            self.records = []
            self._seen = {}

        def track(self, tensors) -> None:
            for t in tensors:
                st = _local(t).untyped_storage()
                key = id(st)
                if key in self._seen:
                    continue
                n = st.nbytes()
                self.live += n

                def gone(_, key=key, n=n):
                    self.live -= n
                    self._seen.pop(key, None)
                    self._what.pop(key, None)
                self._seen[key] = weakref.ref(st, gone)
                if self.keep_peak:
                    lt = _local(t)
                    self._what[key] = (n, f"{str(lt.dtype).split('.')[-1]}"
                                          f"{list(lt.shape)}")
                if self.live > self.peak:
                    self.peak = self.live
                    if self.keep_peak:
                        self.at_peak = list(self._what.values())

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            out = super().__torch_dispatch__(func, types, args, kwargs)
            outs = _tensors(out)
            if not any(isinstance(t, DTensor) for t in outs) and _in_propagation():
                return out
            formula = flop_registry.get(func._overloadpacket)
            if formula is not None and outs:
                self.flops += formula(*args, **kwargs, out_val=out) / _split(outs[0])
            if not func.is_view:
                self.bytes += sum(_local_bytes(t) for t in _tensors(args) + outs)
            self.track(outs)
            op = hlo_mod.hlo_name(func)
            if op:
                self.records.append({"op": op, "result_bytes": sum(map(_local_bytes, outs)),
                                     "group": _group(args, kwargs), "site": _site()})
            return out
    return StepCounter()


@dataclasses.dataclass
class Trace:
    """What one traced run of a step measured."""
    flops: float
    bytes: float
    records: list
    arg_bytes: int
    out_bytes: int
    alias_bytes: int
    temp_bytes: int
    trace_s: float
    outputs: object
    collectives: dict = None
    at_peak: list = None


def trace_step(step, args, out_placements, fake_mode=None, keep_peak: bool = False) -> Trace:
    """Run ``step(*args)`` once under :func:`step_counter` and redistribute
    its outputs to ``out_placements``; ``fake_mode`` (the args' mode) is
    entered around it, so tensors made inside are fake too."""
    from contextlib import nullcontext

    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.launch.steps import map_placed
    arg_ts = [t for t in leaves(args) if isinstance(t, torch.Tensor)]
    arg_b = sum(_local_bytes(t) for t in arg_ts)
    counter = step_counter(keep_peak)
    counter.track(arg_ts)
    base = counter.live
    t0 = time.perf_counter()
    with fake_mode or nullcontext(), implicit_replication(), counter:
        out = step(*args)
        out = map_placed(lambda t, pl: t.redistribute(t.device_mesh, pl)
                         if hasattr(t, "placements") else t, out, out_placements)
    trace_s = time.perf_counter() - t0
    out_ts = [t for t in leaves(out) if isinstance(t, torch.Tensor)]
    arg_st = {id(_local(t).untyped_storage()) for t in arg_ts}
    alias = sum(_local_bytes(t) for t in out_ts if id(_local(t).untyped_storage()) in arg_st)
    out_b = sum(_local_bytes(t) for t in out_ts)
    temp = max(0, counter.peak - base - (out_b - alias))
    return Trace(counter.flops, counter.bytes, counter.records, arg_b, out_b, alias, temp,
                 trace_s, out, at_peak=counter.at_peak)


def run_cell(arch: str, shape_name: str, multi_pod: bool, *, fsdp: bool = True,
             expert_parallel: bool = True, tag: str = "", cfg_override: dict = None,
             shape_override: dict = None, serve_int8: bool = False, seq_parallel=None,
             device: str = "cuda", mesh=None, cut: bool = True) -> dict:
    """Trace one cell at two cut depths (:func:`cut_depths`) and extrapolate
    to the full depth (:func:`extrapolate`), or at the full depth when
    ``cut`` is False. ``mesh`` overrides the production mesh (a smaller fake
    mesh, as the reference's mini cell)."""
    cfg = get_config(arch)
    if cfg_override:
        cfg = dataclasses.replace(cfg, **cfg_override)
    shape = SHAPES[shape_name]
    if shape_override:
        shape = dataclasses.replace(shape, **shape_override)
    mesh_name = "multi" if multi_pod else "single"
    cell = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
            "fsdp": fsdp, "expert_parallel": expert_parallel, "tag": tag}

    reason = cfg.skipped(shape_name)
    if shape_name == "long_500k" and not cfg.subquadratic:
        reason = reason or "full attention (quadratic); 500k decode context infeasible"
    if shape.kind == "decode" and cfg.is_encoder_only:
        reason = reason or "encoder-only: no decode step"
    if reason:
        cell["status"] = "skipped"
        cell["reason"] = reason
        return cell

    mesh = mesh if mesh is not None else make_production_mesh(multi_pod=multi_pod,
                                                             device=device)
    depths = cut_depths(cfg, shape) if cut else (cfg.num_layers,)
    try:
        t0 = time.perf_counter()
        traces = [trace_cell(dataclasses.replace(cfg, num_layers=L), shape, mesh,
                             fsdp=fsdp, expert_parallel=expert_parallel,
                             serve_int8=serve_int8, seq_parallel=seq_parallel)
                  for L in depths]
        tr = extrapolate(traces, depths, cfg.num_layers)
        # the arguments at full depth, placed but not run
        args = steps_mod.build_step(cfg, shape, mesh, fsdp=fsdp,
                                    expert_parallel=expert_parallel,
                                    serve_int8=serve_int8, seq_parallel=seq_parallel)[1]
        tr.arg_bytes = sum(_local_bytes(t) for t in leaves(args) if isinstance(t, torch.Tensor))
        wall_s = time.perf_counter() - t0
    except Exception as e:  # noqa: BLE001 -- a failed cell is a bug to report
        cell["status"] = "FAILED"
        cell["error"] = f"{type(e).__name__}: {e}"[:2000]
        cell["traceback"] = traceback.format_exc()[-2000:]
        return cell

    cell.update(cell_report(cfg, shape, mesh, tr, tr.collectives))
    cell["depths_traced"] = list(depths)
    cell["cell_s"] = round(wall_s, 3)
    cell["chips"] = mesh.size()
    return cell


def cut_depths(cfg, shape) -> tuple:
    """The two depths a cell is traced at: one and two repeating units (a
    VLM section, a hybrid's SSD run and its shared block, a training remat
    span, else a layer), or the full depth when that is no deeper."""
    unit = 1
    if cfg.family == "vlm":
        unit = cfg.cross_attn_every
    elif cfg.family == "hybrid":
        unit = cfg.shared_attn_every
    elif (shape.kind == "train" and cfg.family in ("dense", "moe", "encoder")
          and cfg.num_layers % cfg.remat_span == 0):
        unit = cfg.remat_span
    return (cfg.num_layers,) if cfg.num_layers <= 2 * unit else (unit, 2 * unit)


def trace_cell(cfg, shape, mesh, keep_peak: bool = False, **kw) -> "Trace":
    """Build the cell's step on fake tensors and trace it once."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    mode = FakeTensorMode()
    step, args, _, out_pl, plan = steps_mod.build_step(cfg, shape, mesh, fake_mode=mode, **kw)
    layers_mod.set_logical_rules(plan.rules())
    try:
        tr = trace_step(step, args, out_pl, mode, keep_peak)
    finally:
        layers_mod.set_logical_rules(None)
    tr.collectives = hlo_mod.comm_stats(tr.records, default_group=dict(
        zip(mesh.mesh_dim_names, mesh.shape))["model"])
    return tr


def _lerp(a, b, k):
    """a + k (b - a) over numbers or nested dicts of them (a key missing on
    one side counts as 0); integers stay integers."""
    if isinstance(a, dict) or isinstance(b, dict):
        a, b = a or {}, b or {}
        return {key: _lerp(a.get(key), b.get(key), k) for key in set(a) | set(b)}
    a, b = a or 0, b or 0
    v = a + k * (b - a)
    return int(round(v)) if isinstance(a, int) and isinstance(b, int) else v


def extrapolate(traces, depths, depth: int) -> "Trace":
    """The trace at ``depth`` layers from traces at ``depths``: linear in
    depth (every repeating unit costs the same), exact for FLOPs, bytes and
    collectives of identical layers, a model for the live-memory peak."""
    if len(traces) == 1:
        return traces[0]
    (t1, t2), (l1, l2) = traces, depths
    k = (depth - l1) / (l2 - l1)
    fields = ("flops", "bytes", "arg_bytes", "out_bytes", "alias_bytes", "temp_bytes")
    tr = dataclasses.replace(t2, **{f: _lerp(getattr(t1, f), getattr(t2, f), k)
                                    for f in fields})
    tr.collectives = _lerp(t1.collectives, t2.collectives, k)
    tr.trace_s = t1.trace_s + t2.trace_s
    return tr


def cell_report(cfg, shape, mesh, tr: Trace, coll: dict) -> dict:
    """The cell's numbers from one trace: the reference's fields."""
    t_compute = tr.flops / PEAK_FLOPS_BF16
    t_memory = tr.bytes / HBM_BW
    t_collective = coll["total_wire_bytes"] / LINK_BW
    peak = tr.arg_bytes + tr.out_bytes + tr.temp_bytes - tr.alias_bytes
    tmp_analytic = _analytic_temp(cfg, shape, mesh)
    peak_analytic = tr.arg_bytes + tr.out_bytes + tmp_analytic
    model_flops = _model_flops(cfg, shape)
    n_chips = mesh.size()
    return {
        "status": "ok",
        "trace_s": round(tr.trace_s, 3),
        "hlo_flops_per_device": tr.flops,
        "hlo_bytes_per_device": tr.bytes,
        "collectives": coll,
        "memory": {"argument": tr.arg_bytes, "output": tr.out_bytes, "temp": tr.temp_bytes,
                   "alias": tr.alias_bytes, "peak_per_device": peak,
                   "temp_analytic": tmp_analytic,
                   "peak_analytic": peak_analytic,
                   "hbm_per_chip": HBM_PER_CHIP,
                   "fits": bool(peak <= HBM_PER_CHIP),
                   "fits_analytic": bool(peak_analytic <= HBM_PER_CHIP)},
        "roofline": {
            "compute_s": t_compute,
            "memory_s": t_memory,
            "collective_s": t_collective,
            "bottleneck": max(
                (("compute", t_compute), ("memory", t_memory),
                 ("collective", t_collective)), key=lambda kv: kv[1])[0],
        },
        "model_flops_global": model_flops,
        "useful_flops_ratio": (model_flops / (tr.flops * n_chips) if tr.flops else 0.0),
    }


def _mesh_sizes(mesh) -> dict:
    return dict(zip(mesh.mesh_dim_names, mesh.shape)) if hasattr(mesh, "mesh_dim_names") \
        else dict(mesh)


def _analytic_temp(cfg, shape, mesh) -> int:
    """The reference's analytic temp estimate: remat stash + CE buffers +
    ~4 per-layer transients, at bf16 (f32 for softmax/CE), under the
    baseline sharding. ``mesh``: a ``DeviceMesh`` or ``{axis: size}``."""
    sizes = _mesh_sizes(mesh)
    msize = sizes["model"]
    dsize = math.prod(sizes.values()) // msize
    B = max(1, shape.global_batch // dsize)
    if shape.kind == "train":
        B = max(1, B // max(1, cfg.microbatches))
    if shape.kind == "decode":
        # decode temps are tiny next to weights/cache (both in args)
        return 64 << 20
    S = shape.seq_len
    d = cfg.d_model
    S_loc = max(1, S // msize) if shape.kind == "train" else S
    # remat stash
    if cfg.family == "vlm":
        n_entries = cfg.num_layers // cfg.cross_attn_every
    else:
        n_entries = max(1, cfg.num_layers // max(1, cfg.remat_span))
    stash = n_entries * B * S_loc * d * 2 * (2 if shape.kind == "train" else 0)
    # CE / logits (train) or logits (prefill)
    v_loc = max(1, cfg.vocab_size // msize)
    ce = B * S * v_loc * (8 if shape.kind == "train" else 2)
    # per-layer transients (~4 largest intermediates co-resident)
    ff_loc = max(cfg.d_ff, cfg.moe_d_ff * (cfg.num_experts or 1) // 4,
                 cfg.d_inner * (2 if cfg.ssm_state else 0)) // msize
    trans = 4 * B * S * max(ff_loc, d) * 2
    if shape.kind == "train":
        trans *= 2  # fwd + bwd cotangent
    return int(stash + ce + trans)


def _model_flops(cfg, shape) -> float:
    """Analytic MODEL_FLOPS: 6*N*D for train, 2*N*D for inference forward
    (N = active params, D = tokens processed this step)."""
    n = cfg.param_count()
    if cfg.num_experts:
        # active experts only: replace full expert count by top_k (+ shared)
        full = cfg.num_experts
        active = cfg.top_k
        expert_p = (3 if cfg.ffn_gated else 2) * cfg.d_model * cfg.moe_d_ff
        n = n - cfg.num_layers * (full - active) * expert_p
    tokens = shape.global_batch * (1 if shape.kind == "decode" else shape.seq_len)
    mult = 6 if shape.kind == "train" else 2
    return float(mult * n * tokens)


def _line(name: str, cell: dict) -> str:
    st = cell["status"]
    if st == "ok":
        r = cell["roofline"]
        mem_gb = cell["memory"]["peak_per_device"] / 2**30
        mem_a = cell["memory"]["peak_analytic"] / 2**30
        return (f"{name:64s} OK  trace={cell['trace_s']:6.2f}s "
                f"mem/dev={mem_gb:6.2f}GiB (analytic {mem_a:6.2f}) "
                f"fits={cell['memory']['fits']} "
                f"bottleneck={r['bottleneck']:10s} "
                f"[{r['compute_s']:.2e}/{r['memory_s']:.2e}/{r['collective_s']:.2e}]s")
    if st == "skipped":
        return f"{name:64s} SKIP ({cell['reason']})"
    return f"{name:64s} FAIL {cell['error']}"


def _worker(job) -> dict:
    """One cell, in a worker process (its own fake process group)."""
    (arch, shape, multi), kw = job
    return run_cell(arch, shape, multi, **kw)


def _cost(cell) -> int:
    """A rough order of the cells' tracing time, largest first."""
    arch, shape, multi = cell
    cfg, kind = get_config(arch), SHAPES[shape].kind
    depth = sum(cut_depths(cfg, SHAPES[shape]))
    weight = {"train": 8 * cfg.microbatches, "prefill": 3, "decode": 1}[kind]
    return -(weight * depth * (2 if multi else 1))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="both", choices=["single", "multi", "both"])
    ap.add_argument("--no-fsdp", dest="fsdp", action="store_false")
    ap.add_argument("--no-ep", dest="ep", action="store_false")
    ap.add_argument("--tag", default="")
    ap.add_argument("--out", default="artifacts/dryrun")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="device type of the fake tensors (no card is used)")
    ap.add_argument("--workers", type=int, default=1,
                    help="processes tracing cells in parallel, each with its own "
                         "fake process group")
    args = ap.parse_args(argv)

    archs = list(ASSIGNED_ARCHS) if args.arch == "all" else [args.arch]
    shapes = list(SHAPE_ORDER) if args.shape == "all" else [args.shape]
    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]
    todo = [(a, s, m) for a in archs for s in shapes for m in meshes]
    kw = dict(fsdp=args.fsdp, expert_parallel=args.ep, tag=args.tag, device=args.device)

    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    n = max(1, min(args.workers, len(todo)))
    jobs = [(c, kw) for c in sorted(todo, key=_cost)]
    if n == 1:
        results = [_worker(j) for j in jobs]
    else:
        import multiprocessing
        with multiprocessing.get_context("spawn").Pool(n) as pool:
            results = list(pool.imap_unordered(_worker, jobs))
    order = {c: i for i, c in enumerate(todo)}
    results.sort(key=lambda c: order[(c["arch"], c["shape"], c["mesh"] == "multi")])
    counts = {"ok": 0, "skipped": 0, "FAILED": 0}
    for cell in results:
        name = f"{cell['arch']}__{cell['shape']}__{cell['mesh']}{args.tag}"
        (out_dir / f"{name}.json").write_text(json.dumps(cell, indent=1, default=str))
        counts[cell["status"]] += 1
        print(_line(name, cell), flush=True)
    print(f"\ndry-run: {counts['ok']} ok, {counts['skipped']} skipped, "
          f"{counts['FAILED']} FAILED in {time.perf_counter() - t0:.1f}s")
    if counts["FAILED"]:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
