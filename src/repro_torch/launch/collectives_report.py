"""Collective profiler for one cell: wire bytes grouped by where the model
issued each collective.

The port of ``src/repro/launch/collectives_report.py``. The reference
groups the collectives of a cell's HLO by their ``op_name`` site; here each
collective ``CommDebugMode`` saw while the cell's step ran on fake tensors
(``launch.dryrun.trace_cell``) is grouped by its op and the innermost two
frames of the port's model code that issued it. The cell is cut to
``--layers`` layers (one microbatch, remat span 1), as the reference's.

PYTHONPATH=src python -m repro_torch.launch.collectives_report --arch X --shape Y
    [--layers 2] [--multi] [--no-fsdp] [--no-ep] [--device cuda|cpu]
"""
from __future__ import annotations

import argparse
import dataclasses
from collections import defaultdict

from repro_torch.configs import SHAPES, get_config
from repro_torch.launch.dryrun import trace_cell
from repro_torch.launch.mesh import make_production_mesh


def report(arch: str, shape: str, layers: int, *, multi_pod: bool = False,
           device: str = "cuda", cfg_override: dict = None, top: int = 14,
           mesh=None, **kw) -> dict:
    """Trace the cut cell (on ``mesh``, else the production mesh); print and
    return ``{"op | site": [count, result bytes]}`` (per device), largest
    first."""
    override = {"num_layers": layers, "microbatches": 1, "remat_span": 1,
                **(cfg_override or {})}
    cfg = dataclasses.replace(get_config(arch), **override)
    mesh = mesh or make_production_mesh(multi_pod=multi_pod, device=device)
    tr = trace_cell(cfg, SHAPES[shape], mesh, **kw)
    sites = defaultdict(lambda: [0, 0])
    for rec in tr.records:
        key = f"{rec['op']} | {rec['site']}"
        sites[key][0] += 1
        sites[key][1] += rec["result_bytes"]
    total = tr.collectives["total_wire_bytes"]
    print(f"{arch} {shape} L={layers}: wire={total / 1e9:.2f} GB/device "
          f"(flops={tr.flops:.2e})")
    ranked = dict(sorted(sites.items(), key=lambda kv: -kv[1][1]))
    for k, (n, b) in list(ranked.items())[:top]:
        print(f"  {b / 2**20:9.1f} MiB x{n:3d}  {k}")
    return ranked


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--multi", action="store_true")
    ap.add_argument("--no-fsdp", dest="fsdp", action="store_false")
    ap.add_argument("--no-ep", dest="ep", action="store_false")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="device type of the fake tensors (no card is used)")
    args = ap.parse_args(argv)
    report(args.arch, args.shape, args.layers, multi_pod=args.multi, device=args.device,
           fsdp=args.fsdp, expert_parallel=args.ep)


if __name__ == "__main__":
    main()
