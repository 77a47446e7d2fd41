"""The readings that the limit of ``pooled_gap`` is set from, at a cell's own
size: for each seed, one run of the program (its gap from the reference)
and the reference's controls put in its place in the precision below the
configuration's -- rows held in bfloat16 (``bf16_rows``) and a 4-bit store
(``int4_store``) -- on the same sampled chunks, each judged by the run's own
checks: a control has to come out not correct. The benchmark's own runs do
not run it.

    python3 sdm_bench/control.py --workload m1-zipf --seeds 11,12,13 --seconds 3

Prints one JSON line a seed.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT / "src"), str(HERE)]
    import sdmb_harness as harness
    for seed in (int(s) for s in args.seeds.split(",")):
        out = harness.run(ROOT, args.workload, seed, args.seconds, False, device=args.device,
                          controls=("bf16_rows", "int4_store"))
        print(json.dumps({"workload": args.workload, "seed": seed, "correct": out["correct"],
                          "pooled_gap": out["checks"]["pooled_gap"]["value"],
                          "limit": out["checks"]["pooled_gap"]["limit"],
                          "controls": {k: {"correct": c["correct"],
                                           "pooled_gap": c["checks"]["pooled_gap"]["value"]}
                                       for k, c in out["controls"].items()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
