"""CPU tests of the benchmark at M2's shape (``dlrm-m2``): a tiny
configuration with M2's features -- row widths that are not a multiple of
4 and a widest row above 255 B, so the program's store and cache run at a
pitch wider than ``dim`` and the cache takes the CPU-optimized branch (40 B
of metadata a row) -- run through the real harness against the plain
reference; and the inventory ``dlrm-m2.json`` holds."""
from __future__ import annotations

import pytest

import sdmb_testing as tt  # noqa: F401  (puts src/ and sdm_bench/ on sys.path)
import sdmb_harness as harness
import sdmb_reference as reference
import test_sdmb_bench as bench_tests

# [rows, pooling, alpha, row bytes]: 279, 37, 122 and 255 values a row
TINY_M2_TABLES = [[3000, 5, 1.1, 287], [500, 3, 1.3, 45], [2000, 8, 1.05, 130],
                  [800, 2, 1.5, 263]]
TINY_M2_DIM = 279
TINY_M2_CACHE = {"hbm_bytes": 83712, "ways": 4, "sets": 64}   # 327 B a row of 287
M2_ROWS = 43_390_069


def _root(tmp_path):
    root = tt.make_root(tmp_path)
    tt.write(root, "configs/tiny.json",
             tt.tiny_config(dim=TINY_M2_DIM, cache=dict(TINY_M2_CACHE),
                            tables=TINY_M2_TABLES))
    return root


def test_tiny_m2_geometry():
    """The tiny configuration's cache is the CPU-optimized branch's, and the
    program builds that cache at the pitch above ``dim``."""
    assert reference.cache_geometry(TINY_M2_CACHE["hbm_bytes"], TINY_M2_DIM, 4) == (64, 4)
    assert reference.cache_geometry(TINY_M2_CACHE["hbm_bytes"], 247, 4) != (64, 4)
    from repro_torch.runtime.engine import row_pitch
    assert row_pitch(TINY_M2_DIM) == 280 and any(
        (t[3] - 8) % 4 for t in TINY_M2_TABLES)


@pytest.mark.parametrize("cell", ["tiny-zipf", "tiny-uniform"])
def test_m2_shaped_cells_correct_and_controls_not(tmp_path, cell):
    """At M2's shape the program passes every check of the reference, and
    each control, put in its place, comes out not correct."""
    out = harness.run(_root(tmp_path), cell, 2718281828, 0.3, False, device="cpu",
                      controls=("bf16_rows", "int4_store"))
    assert out["correct"], out["checks"]
    gap = out["checks"]["pooled_gap"]
    assert gap["value"] < gap["limit"]
    assert {k: c["value"] for k, c in out["checks"].items() if k != "pooled_gap"} == \
        {"sm_ios_diff": 0, "sm_time_diff": 0, "hits_diff": 0, "tags_diff": 0}
    assert set(out["controls"]) == {"bf16_rows", "int4_store"}
    for kind, c in out["controls"].items():
        assert c["correct"] is False, kind
        assert c["checks"]["pooled_gap"]["value"] > 10 * gap["limit"], (kind, c["checks"])


def test_m2_shaped_traced_run(tmp_path):
    """A traced run at M2's shape reads the per-layer metrics a CPU run can
    read, and stays correct."""
    out = harness.run(_root(tmp_path), "tiny-zipf", 161803398, 0.2, True, device="cpu")
    assert out["correct"], out["checks"]
    assert 0 < out["metrics"]["cache_hit_rate"]["value"] < 100
    assert out["metrics"]["dense_from_chunk_ms"]["value"] > 0


def test_m2_inventory_is_the_samplers():
    """``dlrm-m2.json`` holds what its sampler parameters give: 450 user
    tables, its rows, widths within M2's, ``dim`` the widest and the cache
    the budget's."""
    bench_tests.test_inventory_is_the_samplers("dlrm-m2", 450, M2_ROWS)
