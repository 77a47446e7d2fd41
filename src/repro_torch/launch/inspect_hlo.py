"""The largest per-device tensors live at the peak of a cell's step.

The port of ``src/repro/launch/inspect_hlo.py`` (the name kept, so a reader
finds its counterpart). The reference lists the largest shapes in a
compiled cell's HLO; here the step runs on fake tensors under the dry-run's
memory tracker (``launch.dryrun.step_counter``), which lists the local
storages live at the step's peak.

PYTHONPATH=src python -m repro_torch.launch.inspect_hlo --arch X --shape Y
    [--multi] [--no-fsdp] [--layers N] [--device cuda|cpu]
"""
from __future__ import annotations

import argparse
import dataclasses
from collections import Counter

from repro_torch.configs import SHAPES, get_config
from repro_torch.launch.dryrun import trace_cell
from repro_torch.launch.mesh import make_production_mesh


def top_tensors(at_peak, n: int = 14):
    """The ``n`` largest (bytes, ``dtype[shape]``) of the storages live at
    the peak, each shape once with its count."""
    counts = Counter(desc for _, desc in at_peak)
    sizes = {desc: b for b, desc in at_peak}
    return sorted(((desc, sizes[desc], counts[desc]) for desc in sizes),
                  key=lambda kv: -kv[1])[:n]


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--multi", action="store_true")
    ap.add_argument("--no-fsdp", dest="fsdp", action="store_false")
    ap.add_argument("--layers", type=int, default=0, help="cut depth (0: the full depth)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="device type of the fake tensors (no card is used)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.layers:
        cfg = dataclasses.replace(cfg, num_layers=args.layers)
    mesh = make_production_mesh(multi_pod=args.multi, device=args.device)
    inspect(cfg, SHAPES[args.shape], mesh, fsdp=args.fsdp)


def inspect(cfg, shape, mesh, **kw):
    """Trace the cell on ``mesh``; print its memory terms and largest live
    tensors, and return ``top_tensors``'s list."""
    tr = trace_cell(cfg, shape, mesh, keep_peak=True, **kw)
    print(f"temp={tr.temp_bytes / 2**30:.2f}GiB args={tr.arg_bytes / 2**30:.2f}GiB "
          f"out={tr.out_bytes / 2**30:.2f}GiB")
    top = top_tensors(tr.at_peak)
    for desc, b, count in top:
        print(f"{b / 2**30:8.2f} GiB  {desc}  x{count}")
    return top


if __name__ == "__main__":
    main()
