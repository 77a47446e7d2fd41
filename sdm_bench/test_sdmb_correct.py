"""CPU tests of how the benchmark decides ``correct``: its controls (the
reference in the precision below the configuration's) come out not
correct, and so does a run whose timed path is broken underneath, once for
each fault a one-card serving cell can have. The chip readings of the same
controls, at the cells' own sizes, come from ``sdm_bench/control.py``."""
from __future__ import annotations

import numpy as np
import pytest

import sdmb_testing as tt  # noqa: F401  (puts src/ and sdm_bench/ on sys.path)
import sdmb_harness as harness


def _run(tmp_path, cell, **kw):
    return harness.run(tt.make_root(tmp_path), cell, 3141592653, 0.3, False,
                       device="cpu", **kw)


@pytest.mark.parametrize("cell", ["tiny-zipf", "tiny-uniform"])
def test_controls_fail_where_the_program_passes(tmp_path, cell):
    """Each control, put in the program's place, comes out not correct by the
    run's own verdict, far above the limit; the program passes."""
    out = _run(tmp_path, cell, controls=("bf16_rows", "int4_store"))
    gap = out["checks"]["pooled_gap"]
    assert out["correct"] and gap["value"] < gap["limit"]
    assert set(out["controls"]) == {"bf16_rows", "int4_store"}
    for kind, c in out["controls"].items():
        assert c["correct"] is False, kind
        assert c["checks"]["pooled_gap"]["value"] > 10 * gap["limit"], (kind, c["checks"])
        assert {k: v for k, v in c["checks"].items() if k != "pooled_gap"} == \
            {k: v for k, v in out["checks"].items() if k != "pooled_gap"}


def _no_fill(monkeypatch):
    from repro_torch.core.cache import TorchRowCache
    monkeypatch.setattr(TorchRowCache, "insert", lambda self, state, *a, **k: state)


def _wrap_served(monkeypatch, change):
    from repro_torch.runtime.engine import DeviceServingEngine
    served = DeviceServingEngine.serve_columnar

    def serve(self, chunk, bg_iops=0.0):
        return change(*served(self, chunk, bg_iops))
    monkeypatch.setattr(DeviceServingEngine, "serve_columnar", serve)


def _half_batch(monkeypatch):
    def change(pooled, smt, ios):
        pooled = pooled.copy()
        half = len(pooled) // 2
        pooled[half:] = pooled[:half].mean(axis=0)
        return pooled, smt, ios
    _wrap_served(monkeypatch, change)


def _altered_answer(monkeypatch):
    from repro_torch.kernels import ops
    pool = ops.embedding_gather_pool

    def altered(*a, **k):
        out = pool(*a, **k)
        out[0, 0] += 1e-3 * (1.0 + abs(float(out[0, 0])))
        return out
    monkeypatch.setattr(ops, "embedding_gather_pool", altered)


def _altered_reads(monkeypatch):
    def change(pooled, smt, ios):
        ios = ios.copy()
        ios[-1] += 1
        return pooled, smt, ios
    _wrap_served(monkeypatch, change)


@pytest.mark.parametrize("fault,caught_by", [
    (_no_fill, "sm_ios_diff"),             # a step that returns its state unchanged
    (_half_batch, "pooled_gap"),           # half the batch left out, the rest's mean
    (_altered_answer, "pooled_gap"),       # an answer altered where it is produced
    (_altered_reads, "sm_ios_diff"),       # an SM read count altered
])
def test_a_broken_timed_path_is_not_correct(tmp_path, monkeypatch, fault, caught_by):
    fault(monkeypatch)
    out = _run(tmp_path, "tiny-zipf")
    assert out["correct"] is False
    c = out["checks"][caught_by]
    assert not c["value"] <= c["limit"], out["checks"]
    assert np.isfinite(c["value"])
