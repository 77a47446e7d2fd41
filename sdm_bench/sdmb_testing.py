"""A tiny checkout for the benchmark's CPU tests: ``BENCHMARK.json`` and the
data files of one small configuration, laid out as in the repository."""
from __future__ import annotations

import json
import pathlib
import shutil
import sys

BENCH_DIR = pathlib.Path(__file__).resolve().parent
REPO = BENCH_DIR.parent
for p in (str(REPO / "src"), str(BENCH_DIR)):
    if p not in sys.path:
        sys.path.insert(0, p)

# [rows, pooling, alpha, row bytes]: 16, 12, 8 and 16 values a row
TINY_TABLES = [[3000, 5, 1.1, 24], [500, 3, 1.3, 20], [2000, 8, 1.05, 16], [800, 1, 1.5, 24]]
TINY_CACHE = {"hbm_bytes": 8192, "ways": 4, "sets": 64}      # 32 B a row of 16


def tiny_config(**over) -> dict:
    cfg = json.loads((BENCH_DIR / "configs" / "dlrm-m1.json").read_text())
    cfg.update(name="tiny", dim=16, cache=dict(TINY_CACHE), tables=TINY_TABLES)
    cfg.update(over)
    return cfg


def tiny_traffic(law: str, **over) -> dict:
    t = {"law": law, "chunk": 8, "block_queries": 64, "warmup_fills": 2.0,
         "warmup_min_chunks": 4}
    t.update(over)
    return t


def make_root(tmp: pathlib.Path, cells=("tiny-zipf", "tiny-uniform")) -> pathlib.Path:
    """A checkout under ``tmp`` whose ``BENCHMARK.json`` holds the repository's
    metrics and the tiny cells (``tiny-<law>``) over the ``tiny``
    configuration."""
    root = tmp / "checkout"
    (root / "sdm_bench" / "configs").mkdir(parents=True)
    for d in ("traffic", "metrics", "end_to_end"):
        shutil.copytree(BENCH_DIR / d, root / "sdm_bench" / d)
    write(root, "configs/tiny.json", tiny_config())
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    bench["configs"] = [dict(bench["configs"][0], name="tiny",
                             file="sdm_bench/configs/tiny.json")]
    bench["workloads"] = []
    for cell in cells:
        law = cell.split("-", 1)[1]
        write(root, f"traffic/{cell}.json", tiny_traffic(law))
        bench["workloads"].append({"name": cell, "config": "tiny", "traffic": cell,
                                   "chips": 1, "why": "a CPU test"})
    for m in bench["per_layer"]:
        m["workloads"] = list(cells)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


def write(root: pathlib.Path, rel: str, obj) -> None:
    path = root / "sdm_bench" / rel
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(obj if isinstance(obj, str) else json.dumps(obj))
