"""The SDM serving benchmark of ``repro_torch`` (the PyTorch/CUDA port).

Run from the root of a checkout:

    python3 sdm_bench/run.py --workload m1-zipf --seed 7 --seconds 10 --trace 0

It runs one cell of ``BENCHMARK.json`` on the card it is started on and
prints the result as one JSON object, the last line of standard output;
the numbers compared with the plain reference, each beside its limit, are
the last lines of standard error. Exit codes: 0 a result was printed
(``correct`` may still be false), 1 the run failed, 3 no usable card, 4 a
JAX module was loaded.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    # build and kernel caches stay inside the checkout, at fixed paths
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(ROOT / "build" / "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "triton"))
    sys.path[:0] = [str(ROOT / "src"), str(HERE)]
    import sdmb_harness as harness

    cell = harness.load_cell(ROOT, args.workload)
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"sdm_bench: {args.workload} needs {cell.chips} CUDA device(s); "
              f"available: {torch.cuda.is_available()}, count: "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    out = harness.run(ROOT, args.workload, args.seed, args.seconds, bool(args.trace),
                      t_start=T_START)
    bad = harness.forbidden_modules()      # modules stay loaded: this covers the window
    if bad:
        print(f"sdm_bench: loaded in the run: {', '.join(bad)}", file=sys.stderr)
        return 4
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stdout.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
