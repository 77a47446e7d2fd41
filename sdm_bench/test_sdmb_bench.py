"""CPU tests of the SDM serving benchmark: what it imports, how it finds its
cells, its traffic generator, its yardstick and its reference. Tests that
need the card are not here: a card-only run is the benchmark itself."""
from __future__ import annotations

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import sdmb_testing as tt  # noqa: F401  (puts src/ and sdm_bench/ on sys.path)
import sdmb_harness as harness
import sdmb_inputs as inputs
import sdmb_reference as reference
import sdmb_yardstick as yardstick

FORBIDDEN = {"jax", "jaxlib", "flax", "repro", "benchmarks"}


def _run(root, cell, seed=4242424242, seconds=0.3, trace=False, **kw):
    return harness.run(root, cell, seed, seconds, trace, device="cpu", **kw)


# -- imports --------------------------------------------------------------------------


def test_a_run_loads_no_jax_module(tmp_path):
    """In a fresh interpreter, a whole CPU run (traced too) and ``run.py``
    leave no ``jax``, ``jaxlib``, ``flax``, ``repro`` or ``benchmarks``
    module behind, top-level names compared whole."""
    root = tt.make_root(tmp_path)
    code = (
        "import sys, json, importlib.util\n"
        f"sys.path[:0] = [{str(tt.REPO / 'src')!r}, {str(tt.BENCH_DIR)!r}]\n"
        "import sdmb_harness as h\n"
        "spec = importlib.util.spec_from_file_location('sdmb_run', "
        f"{str(tt.BENCH_DIR / 'run.py')!r})\n"
        "mod = importlib.util.module_from_spec(spec); spec.loader.exec_module(mod)\n"
        f"h.run({str(root)!r}, 'tiny-zipf', 5, 0.2, False, device='cpu')\n"
        f"h.run({str(root)!r}, 'tiny-uniform', 5, 0.2, True, device='cpu')\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, timeout=240)
    assert out.returncode == 0, out.stderr[-3000:]
    loaded = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "repro_torch" in loaded and "torch" in loaded
    assert not loaded & FORBIDDEN


def test_forbidden_modules_compares_whole_names():
    assert harness.forbidden_modules(["repro_torch.core.cache", "reprox", "torch",
                                      "benchmarks_x", "jaxtyping"]) == []
    assert harness.forbidden_modules(["repro.core.sdm", "jaxlib.xla_client", "flax",
                                      "benchmarks.kernels", "jax"]) == [
        "benchmarks", "flax", "jax", "jaxlib", "repro"]


def test_no_card_no_result(tmp_path):
    """Without a usable card ``run.py`` exits with a code other than 0 and
    prints no result; so it does too in a directory that holds only
    ``BENCHMARK.json`` and the benchmark's folder."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the exit without one is not reachable")
    bare = tmp_path / "bare"
    bare.mkdir()
    (bare / "BENCHMARK.json").write_text((tt.REPO / "BENCHMARK.json").read_text())
    subprocess.run(["cp", "-r", str(tt.BENCH_DIR), str(bare / "sdm_bench")], check=True)
    for cwd in (tt.REPO, bare):
        out = subprocess.run([sys.executable, "sdm_bench/run.py", "--workload", "m1-zipf",
                              "--seed", "3", "--seconds", "1", "--trace", "0"],
                             capture_output=True, text=True, cwd=cwd, timeout=120)
        assert out.returncode != 0
        assert out.stdout.strip() == ""


# -- finding cells, configurations, traffic and metrics by name ---------------------------


def test_an_added_cell_is_found_by_name(tmp_path):
    """A configuration, a traffic mix, a per-layer metric and an end-to-end
    metric added as files and entries, with no code edited, are run."""
    root = tt.make_root(tmp_path, cells=("tiny-zipf",))
    tt.write(root, "configs/tiny2.json", tt.tiny_config(name="tiny2", tables=tt.TINY_TABLES[:2]))
    tt.write(root, "traffic/mixed.json", tt.tiny_traffic("zipf", pool_sigma=0.25,
                                                         drift_period_queries=40,
                                                         drift_blend=0.3))
    tt.write(root, "metrics/keys_a_query.py",
             "def read(ctx):\n    return sum(c.valid for c in ctx.counts) / ctx.queries\n")
    tt.write(root, "end_to_end/queries_served.py",
             "def read(ctx):\n    return float(ctx.queries)\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append(dict(bench["configs"][0], name="tiny2",
                                 file="sdm_bench/configs/tiny2.json"))
    bench["workloads"].append({"name": "tiny2-mixed", "config": "tiny2",
                               "traffic": "mixed", "chips": 1, "why": "added"})
    bench["per_layer"].append({"name": "keys_a_query", "unit": "keys", "better": "higher",
                               "source": "program_counter", "layer": "row cache",
                               "moves": "qps", "workloads": ["tiny2-mixed"]})
    bench["end_to_end"].append({"name": "queries_served", "unit": "queries",
                                "better": "higher", "bound": 0.25, "source": "host_clock",
                                "workloads": ["tiny2-mixed"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    e2e = _run(root, "tiny2-mixed")
    assert e2e["correct"], e2e["checks"]
    assert {"qps", "batch_p95_ms", "sm_reads_per_query", "setup_s",
            "queries_served"} <= set(e2e["metrics"])
    traced = _run(root, "tiny2-mixed", trace=True)
    assert traced["correct"], traced["checks"]
    assert traced["metrics"]["keys_a_query"]["value"] > 0
    # device metrics are never written from a CPU run
    assert not {"device_idle_share", "device_busy_ms", "step_mfu", "gather_pool_roofline",
                "cache_probe_roofline"} & set(traced["metrics"])
    assert "keys_a_query" not in _run(root, "tiny-zipf", trace=True)["metrics"]


def test_benchmark_json_names_files_that_exist():
    bench = json.loads((tt.REPO / "BENCHMARK.json").read_text())
    for c in bench["configs"]:
        assert (tt.REPO / c["file"]).is_file()
    for w in bench["workloads"]:
        cell = harness.load_cell(tt.REPO, w["name"])
        assert cell.chips == 1 and cell.per_layer and cell.end_to_end
    for m in bench["end_to_end"]:
        assert (tt.BENCH_DIR / "end_to_end" / f"{m['name']}.py").is_file()
    for m in bench["per_layer"]:
        assert (tt.BENCH_DIR / "metrics" / f"{m['name']}.py").is_file()


# -- the configurations -------------------------------------------------------------------


@pytest.mark.parametrize("name,tables,rows", [("dlrm-m1", 61, 65_190_715)])
def test_inventory_is_the_samplers(name, tables, rows):
    """The inventory a configuration holds is what its sampler parameters
    give, through the frozen copy and through the program's own sampler."""
    from repro_torch.core.locality import sample_table_metas
    cfg = json.loads((tt.BENCH_DIR / "configs" / f"{name}.json").read_text())
    params = cfg["inventory"]["params"]
    assert inputs.inventory_from_sampler(params) == cfg["tables"]
    p = dict(params)
    rng = np.random.default_rng(np.random.SeedSequence(p.pop("seed_sequence")))
    prog = [[m.num_rows, m.pooling_factor, m.zipf_alpha, m.dim_bytes]
            for m in sample_table_metas(rng, **p) if m.kind == "user"]
    assert prog == cfg["tables"]
    assert len(cfg["tables"]) == tables and sum(t[0] for t in cfg["tables"]) == rows
    lo, hi = cfg["user_dim_bytes"]
    assert all(lo <= t[3] <= hi for t in cfg["tables"])
    assert cfg["dim"] == max(t[3] for t in cfg["tables"]) - 8
    assert reference.cache_geometry(cfg["cache"]["hbm_bytes"], cfg["dim"],
                                    cfg["cache"]["ways"]) == (cfg["cache"]["sets"],
                                                              cfg["cache"]["ways"])


# -- the traffic generator ----------------------------------------------------------------


@pytest.mark.parametrize("traffic", [
    tt.tiny_traffic("zipf"), tt.tiny_traffic("uniform"),
    tt.tiny_traffic("zipf", pool_sigma=0.25, drift_period_queries=50, drift_blend=0.3)])
def test_block_prefix_does_not_depend_on_length(traffic):
    """Block ``i`` is the same whether the run makes 2 blocks or 4, and in
    whatever order the chunks are asked for."""
    inv = inputs.Inventory.from_config(tt.tiny_config())
    a = inputs.ChunkSource(inputs.TrafficGen(torch, inv, traffic, 77, "cpu"))
    b = inputs.ChunkSource(inputs.TrafficGen(torch, inv, traffic, 77, "cpu"))
    per = a.per_block
    long_run = [a.raw(i) for i in range(4 * per)]
    short_run = [b.raw(i) for i in reversed(range(2 * per))][::-1]
    for x, y in zip(long_run, short_run):
        for u, v in zip(x, y):
            np.testing.assert_array_equal(u, v)
    other = inputs.ChunkSource(inputs.TrafficGen(torch, inv, traffic, 78, "cpu")).raw(0)
    assert not np.array_equal(other[0], long_run[0][0])
    values, seg_offsets, seg_table, query_seg = long_run[per + 1]
    assert values.dtype == np.int64 and seg_offsets[0] == 0 and query_seg[0] == 0
    lens = np.diff(seg_offsets)
    assert len(lens) == traffic["chunk"] * inv.num_tables and (lens >= 1).all()
    rows = inv.rows[seg_table]
    assert (values >= 0).all() and (values < np.repeat(rows, lens)).all()
    if not traffic.get("pool_sigma"):
        np.testing.assert_array_equal(lens, np.tile(inv.pooling, traffic["chunk"]))


def test_permutation_is_the_programs():
    rng = np.random.default_rng(0)
    r = rng.integers(0, 1 << 26, 4096)
    e = rng.integers(0, 40, 4096)
    n = rng.integers(64, 1 << 23, 4096)
    got = inputs.permute_ranks(torch, torch.as_tensor(r), torch.as_tensor(e),
                               torch.as_tensor(n)).numpy()
    np.testing.assert_array_equal(got, inputs.permute_ranks_numpy(r, e, n))
    # epoch 0 is the program's zipf_indices_drift at epoch 0
    from repro_torch.workloads.trace import zipf_indices_drift

    class Ranks:                      # feeds fixed Zipf draws (rank + 1)
        def zipf(self, a, size):
            return r[:size] + 1
    want = zipf_indices_drift(Ranks(), 1 << 27, 1.2, 4096)
    got0 = inputs.permute_ranks(torch, torch.as_tensor(r), None, 1 << 27).numpy()
    np.testing.assert_array_equal(got0, want)


def test_zipf_law_truncated_to_the_table():
    """Rank frequencies follow ``k**-alpha`` normalized over the table's own
    ``n`` ranks: no rank past the table is clamped into its last row."""
    n, a = 500, 1.2
    cfg = tt.tiny_config(tables=[[n, 64, a, 24]])
    inv = inputs.Inventory.from_config(cfg)
    gen = inputs.TrafficGen(torch, inv, tt.tiny_traffic("zipf", block_queries=4096), 9, "cpu")
    vals = np.concatenate([gen.block(b).values for b in range(2)]).astype(np.int64)
    k = np.arange(1, n + 1, dtype=np.float64)
    pmf = k ** -a / (k ** -a).sum()
    # the hash permutation may put several ranks on one row
    rows = inputs.permute_ranks_numpy(np.arange(n), np.zeros(n, np.int64), np.full(n, n))
    want = np.bincount(rows, weights=pmf, minlength=n)
    got = np.bincount(vals, minlength=n) / len(vals)
    for row in np.argsort(want)[::-1][:20]:
        assert abs(got[row] - want[row]) < 0.002 + 0.05 * want[row], (row, want[row])
    # the last rank's row takes its ranks' share, not the clamped tail's ~26% too
    last = rows[n - 1]
    assert abs(got[last] - want[last]) < 0.002 + 0.05 * want[last]


def test_tables_are_made_block_by_block():
    inv = inputs.Inventory.from_config(tt.tiny_config(tables=[[700_000, 4, 1.1, 24],
                                                                [600_000, 4, 1.2, 18]]))
    tabs = inputs.make_tables(torch, inv, 3, "cpu")
    whole = torch.cat([tabs[0], tabs[1]])
    for b in range(2):
        blk = inputs.table_block(torch, inv, 3, b, "cpu")
        lo = b * inputs.TABLE_BLOCK_ROWS
        assert torch.equal(whole[lo:lo + blk.shape[0]], blk)
    # each table keeps its own width: 16 and 10 values, the rest zero
    assert (tabs[0] == 0).float().mean() < 1e-6 and (tabs[1][:, :10] == 0).float().mean() < 1e-6
    assert (tabs[1][:, 10:] == 0).all()


# -- the yardstick --------------------------------------------------------------------------


def test_byte_and_flop_counts_by_hand():
    """One call of 2 queries x 3 tables of 16, 8 and 16 values a row, bags
    padded to 4: 10 keys, 6 hits (on rows of 16, 16, 8, 8, 16, 16 values) on
    4 cached rows (16, 8, 16, 16), 4 misses (16, 16, 8, 16) on 3 distinct rows
    (16, 8, 16), 7 sets probed by the keys and 8 with the padded slots' set."""
    c = yardstick.ChunkCounts(queries=2, tables=3, width=4, dim=16, valid=10, hits=6,
                              hit_rows=4, unique_misses=3, sets_probed=8, sets_valid=7,
                              bag_values=2 * 40, hit_values=80, miss_values=56,
                              hit_row_values=56, miss_row_values=40)
    assert (c.positions, c.bags, c.misses) == (24, 6, 4)
    # 24 indices x 4 B; 3 rows of 40 values and 3 x 8 B; the sentinel 16 + 8 B;
    # 80 pooled values x 4 B
    assert yardstick.gather_pool_bytes(c) == 96 + 40 + 24 + 24 + 320
    # 24 probes x 12 B; 8 sets x 2 tag lines x 4 ways x 4 B; 56 values x 4 B;
    # 4 slots x 80 values x 4 B out; 24 hit flags x 4 B
    assert yardstick.cache_probe_bytes(c, 4) == 288 + 256 + 224 + 1280 + 96
    # 10 keys x 4 B; 7 sets x 32 B; 56 values x 4 B; 3 stored rows (40 + 24 B),
    # their fill (40 x 4 + 3 x 12 B); 80 values x 4 B out
    assert yardstick.step_bytes(c, 4) == 40 + 224 + 224 + 64 + 196 + 320
    assert yardstick.step_flops(c) == 80 + 3 * 56 + 2 * 40
    assert yardstick.least_seconds(3.35e12, 0) == pytest.approx(1.0)
    assert yardstick.least_seconds(0, 67e12) == pytest.approx(1.0)


def test_traced_counts_match_the_program(tmp_path):
    """The per-call counts the traced run keeps add up to the program's own
    hit and miss counters over the window."""
    root = tt.make_root(tmp_path)
    out = _run(root, "tiny-zipf", trace=True, seconds=0.2)
    assert out["correct"], out["checks"]
    assert out["metrics"]["cache_hit_rate"]["value"] > 0
    assert out["metrics"]["dense_from_chunk_ms"]["value"] > 0


# -- the reference ----------------------------------------------------------------------


@pytest.mark.parametrize("law", ["zipf", "uniform"])
def test_reference_follows_the_plain_path(law):
    """The program's plain path (``use_kernels=False``) on the CPU, served
    chunk by chunk, agrees with the reference replay: every query's SM reads
    and SM time exactly, the hit count and the cache's tags exactly, the
    pooled bags within float32 rounding."""
    from repro_torch.core.columnar import ColumnarQueries
    from repro_torch.core.io_sim import DEVICES
    from repro_torch.runtime.engine import DeviceServingEngine, EngineConfig
    cfg = tt.tiny_config()
    inv = inputs.Inventory.from_config(cfg)
    sets, ways = cfg["cache"]["sets"], cfg["cache"]["ways"]
    eng = DeviceServingEngine(inputs.make_tables(torch, inv, 11, "cpu"), DEVICES["nand_flash"],
                              EngineConfig(hbm_cache_bytes=cfg["cache"]["hbm_bytes"],
                                           ways=ways, use_kernels=False),
                              torch_device="cpu")
    src = inputs.ChunkSource(inputs.TrafficGen(torch, inv, tt.tiny_traffic(law), 11, "cpu"))
    store = reference.RefStore(torch, inv, 11, "cpu")
    replay = reference.CacheReplay(torch, sets, ways, inv.offsets, "cpu")
    offsets = torch.as_tensor(inv.offsets)
    T, bg, worst, hits = inv.num_tables, cfg["sm"]["bg_iops"], 0.0, 0
    for i in range(40):
        raw = src.raw(i)
        pooled, smt, ios = eng.serve_columnar(ColumnarQueries(*raw).whole(), bg)
        q, t, r, _ = inputs.chunk_positions(raw, T)
        tq, rq = torch.as_tensor(t), torch.as_tensor(r)
        hit, io, _ = replay.step(tq, rq)
        hits += int(hit.sum())
        bag = torch.as_tensor(q) * T + tq
        io_bt = torch.zeros(len(ios) * T, dtype=torch.int64).index_add_(
            0, bag, io.long()).view(-1, T).numpy()
        np.testing.assert_array_equal(ios, io_bt.sum(1))
        np.testing.assert_array_equal(smt, reference.sm_latency_us(io_bt, cfg["sm"], bg))
        grow = offsets[tq] + rq
        ref = reference.pool(torch, store.rows(grow, torch.float64), bag, len(ios) * T)
        l1 = reference.pool(torch, store.magnitudes(grow), bag, len(ios) * T)
        worst = max(worst, reference.pooled_gap(torch, pooled.reshape(-1, inv.dim), ref, l1))
    assert int(eng.state["hits"]) == hits
    assert torch.equal(eng.state["tag_table"], replay.tag_t)
    assert torch.equal(eng.state["tag_row"], replay.tag_r)
    assert worst < 1e-6
    assert int(eng.state["misses"]) > 0 and hits > 0


def test_store_width_is_the_widest_table():
    """The store's ``dim`` is the widest table's values; another is refused."""
    inv = inputs.Inventory.from_config(tt.tiny_config())
    assert inv.dim == 16 and list(inv.values) == [16, 12, 8, 16]
    with pytest.raises(ValueError):
        inputs.Inventory.from_config(tt.tiny_config(dim=20))
