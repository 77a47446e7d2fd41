"""A tiny checkout for the benchmark's CPU tests: ``BENCHMARK.json`` and the
data files of one small configuration, laid out as in the repository; and a
tiny scoring head (a program entry over the engine, in plain f32 torch, and
the ``dlrm_dot`` reference under ``heads/``) for configurations with a
``scoring`` block."""
from __future__ import annotations

import json
import pathlib
import shutil
import sys

import numpy as np
import torch

BENCH_DIR = pathlib.Path(__file__).resolve().parent
REPO = BENCH_DIR.parent
for p in (str(REPO / "src"), str(BENCH_DIR)):
    if p not in sys.path:
        sys.path.insert(0, p)

# [rows, pooling, alpha, row bytes]: 16, 12, 8 and 16 values a row
TINY_TABLES = [[3000, 5, 1.1, 24], [500, 3, 1.3, 20], [2000, 8, 1.05, 16], [800, 1, 1.5, 24]]
TINY_CACHE = {"hbm_bytes": 8192, "ways": 4, "sets": 64}      # 32 B a row of 16
# a dot-interaction head over the 4 tiny tables: 5 features of 16, 10 dots
TINY_SCORING = {"program": "sdmb_testing:tiny_server", "reference": "dlrm_dot",
                "num_dense": 5, "dense_law": "log1p_exponential",
                "spec": {"num_tables": 4, "embed_dim": 16, "bottom_mlp": [8, 16],
                         "top_mlp": [16, 16, 1]},
                "limits": {"score_gap": 5e-9}}


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
    for m in bench["end_to_end"]:
        if "workloads" in m:
            m["workloads"] = list(cells)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


def write(root: pathlib.Path, rel: str, obj) -> None:
    path = root / "sdm_bench" / rel
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(obj if isinstance(obj, str) else json.dumps(obj))


def make_scored_root(tmp: pathlib.Path, program: str = "sdmb_testing:tiny_server",
                     laws=("zipf", "uniform")) -> pathlib.Path:
    """A checkout whose scored cells (``tiny-scored-<law>``, configuration
    ``tiny-scored``: the tiny tables and ``TINY_SCORING`` with ``program``)
    come as new files and entries only: a configuration, traffic mixes, the
    head's reference under ``heads/``, a per-layer reader of the head
    (``head_macs_a_query``), with no edit to any file or entry that
    :func:`make_root` lays out."""
    root = make_root(tmp, cells=("tiny-zipf",))
    write(root, "configs/tiny-scored.json",
          tiny_config(name="tiny-scored", scoring=dict(TINY_SCORING, program=program)))
    write(root, "heads/dlrm_dot.py", (BENCH_DIR / "heads" / "dlrm_dot.py").read_text())
    write(root, "metrics/head_macs_a_query.py", HEAD_MACS_READER)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append(dict(bench["configs"][0], name="tiny-scored",
                                 file="sdm_bench/configs/tiny-scored.json"))
    cells = [f"tiny-scored-{law}" for law in laws]
    for cell, law in zip(cells, laws):
        write(root, f"traffic/scored-{law}.json", tiny_traffic(law))
        bench["workloads"].append({"name": cell, "config": "tiny-scored",
                                   "traffic": f"scored-{law}", "chips": 1,
                                   "why": "a CPU test"})
    bench["per_layer"].append({"name": "head_macs_a_query", "unit": "MAC/query",
                               "better": "lower", "source": "program_counter",
                               "layer": "scoring head", "moves": "qps", "workloads": cells})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


HEAD_MACS_READER = """\
def read(ctx):
    if ctx.scoring is None:
        return None
    s = ctx.scoring.spec
    f = s["num_tables"] + 1
    dims = [s["num_dense"], *s["bottom_mlp"]]
    top = [s["embed_dim"] + f * (f - 1) // 2, *s["top_mlp"]]
    return float(sum(a * b for a, b in zip(dims[:-1], dims[1:]))
                 + f * f * s["embed_dim"] + sum(a * b for a, b in zip(top[:-1], top[1:])))
"""


class TinyServer:
    """The tiny head's program: the engine pools the query's bags, then a
    bottom MLP, the dot interaction and a top MLP score them in plain torch
    on the engine's device (f32 unless ``dtype``); one logit a query comes
    back to the host. ``fault`` breaks it: ``skip`` leaves out the top
    MLP's middle layer, ``transpose`` takes that layer's weight transposed."""

    def __init__(self, engine, weights, spec, dtype=torch.float32, fault=None):
        self.engine, self.spec, self.dtype, self.fault = engine, spec, dtype, fault
        self.device = engine.devices[0]
        self.w = {k: v.to(self.device, dtype) for k, v in weights.items()}
        f = spec["num_tables"] + 1
        self.pairs = torch.tril_indices(f, f, offset=-1, device=self.device)

    def _mlp(self, x, name, n, relu_last):
        for k in range(n):
            if name == "top" and k == 1 and self.fault == "skip":
                continue
            w = self.w[f"{name}.{k}.w"]
            if name == "top" and k == 1 and self.fault == "transpose":
                w = w.t()
            x = torch.addmm(self.w[f"{name}.{k}.b"], x, w)
            if k < n - 1 or relu_last:
                x = torch.relu(x)
        return x

    def serve_columnar(self, chunk, bg_iops, dense):
        pooled, sm_time, sm_ios = self.engine.serve_columnar(chunk, bg_iops)
        p = torch.from_numpy(pooled).to(self.device, self.dtype)
        d = torch.from_numpy(np.ascontiguousarray(dense)).to(self.device, self.dtype)
        x = self._mlp(d, "bottom", len(self.spec["bottom_mlp"]), True)
        z = torch.cat([x.unsqueeze(1), p], 1)
        dots = torch.bmm(z, z.transpose(1, 2))[:, self.pairs[0], self.pairs[1]]
        y = self._mlp(torch.cat([x, dots], 1), "top", len(self.spec["top_mlp"]), False)
        return y[:, 0].float().cpu().numpy(), sm_time, sm_ios


def tiny_server(engine, weights, spec):
    return TinyServer(engine, weights, spec)


def tiny_server_skipped_layer(engine, weights, spec):
    return TinyServer(engine, weights, spec, fault="skip")


def tiny_server_transposed(engine, weights, spec):
    return TinyServer(engine, weights, spec, fault="transpose")


def tiny_server_bf16(engine, weights, spec):
    return TinyServer(engine, weights, spec, dtype=torch.bfloat16)
