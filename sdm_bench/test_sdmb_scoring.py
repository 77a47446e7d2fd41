"""Tests of a configuration's ``scoring`` block: the harness serves pool then
score through the program entry the block names, and the head's plain
reference (``heads/``) decides ``correct`` on the logits; its controls and
faulty program heads come out not correct. Also the dense features and head
weights drawn from the seed, and the engine's span metrics of a traced run.
The ``cuda``-marked test runs the tiny scored cells on the card."""
from __future__ import annotations

import json
import os
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

import sdmb_testing as tt  # noqa: F401  (puts src/ and sdm_bench/ on sys.path)
import sdmb_harness as harness
import sdmb_inputs as inputs
import sdmb_reference as reference
import sdmb_spans as spans_mod
import test_sdmb_spans as spans_tests

CONTROLS = ("bf16_rows", "int4_store", "tf32_head")
SPAN_METRICS = ("densify_span_ms", "account_span_ms", "step_host_ms", "slot_use_share")
IDLE_METRICS = ("idle_outside_engine_share", "idle_engine_host_share", "idle_step_share")


def _run(root, cell, seed=2718281828, seconds=0.3, trace=False, device="cpu", **kw):
    return harness.run(root, cell, seed, seconds, trace, device=device, **kw)


def _assert_scored(out):
    """Correct, judged on the logits, every exact check 0, each control not
    correct by a wide margin."""
    assert out["correct"], out["checks"]
    assert "score_gap" in out["checks"] and "pooled_gap" not in out["checks"]
    gap = out["checks"]["score_gap"]
    assert gap["value"] < gap["limit"]
    assert {k: c["value"] for k, c in out["checks"].items() if k != "score_gap"} == \
        {"sm_ios_diff": 0, "sm_time_diff": 0, "hits_diff": 0, "tags_diff": 0}
    assert set(out["controls"]) == set(CONTROLS)
    for kind, c in out["controls"].items():
        assert c["correct"] is False, (kind, c["checks"]["score_gap"])
        assert c["checks"]["score_gap"]["value"] > 10 * gap["limit"], (kind, c["checks"])


# -- (a), (b): scored cells from new files only, and their controls -------------------------


@pytest.mark.parametrize("law", ["zipf", "uniform"])
def test_scored_cells_correct_and_controls_not(tmp_path, law):
    """A checkout built from new files and entries only (a configuration
    with a ``scoring`` block, its traffic, the head's reference under
    ``heads/``, a per-layer reader of the head) runs through the harness:
    the program's logits pass, and ``bf16_rows``, ``int4_store`` and
    ``tf32_head`` in its place do not."""
    root = tt.make_scored_root(tmp_path)
    _assert_scored(_run(root, f"tiny-scored-{law}", controls=CONTROLS))
    traced = _run(root, f"tiny-scored-{law}", seed=99, trace=True)
    assert traced["correct"], traced["checks"]
    assert traced["metrics"]["head_macs_a_query"]["value"] == 1256.0


def test_scored_run_through_run_py_needs_a_card(tmp_path):
    """``run.py`` in the scored checkout (the benchmark's modules as they
    are, beside the new files) finds the cell and, without a card, exits
    with no result."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the exit without one is not reachable")
    root = tt.make_scored_root(tmp_path)
    for path in [tt.BENCH_DIR / "run.py", *tt.BENCH_DIR.glob("sdmb_*.py")]:
        (root / "sdm_bench" / path.name).write_text(path.read_text())
    out = subprocess.run([sys.executable, "sdm_bench/run.py", "--workload",
                          "tiny-scored-zipf", "--seed", "5", "--seconds", "1"],
                         capture_output=True, text=True, cwd=root, timeout=120)
    assert out.returncode == 3 and out.stdout.strip() == "", out.stderr[-2000:]


def test_a_scored_run_loads_no_jax_module(tmp_path):
    """In a fresh interpreter, a scored CPU run (traced too) leaves no
    ``jax``, ``jaxlib``, ``flax``, ``repro`` or ``benchmarks`` module
    behind."""
    root = tt.make_scored_root(tmp_path)
    code = (
        "import sys, json\n"
        f"sys.path[:0] = [{str(tt.REPO / 'src')!r}, {str(tt.BENCH_DIR)!r}]\n"
        "import sdmb_harness as h\n"
        f"h.run({str(root)!r}, 'tiny-scored-zipf', 5, 0.2, False, device='cpu',\n"
        f"      controls={CONTROLS!r})\n"
        f"h.run({str(root)!r}, 'tiny-scored-uniform', 5, 0.2, True, device='cpu')\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, timeout=240)
    assert out.returncode == 0, out.stderr[-3000:]
    loaded = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "repro_torch" in loaded and "sdmb_testing" in loaded
    assert not harness.forbidden_modules(sorted(loaded))


# -- (c): faulty program heads ----------------------------------------------------------------


@pytest.mark.parametrize("program", ["sdmb_testing:tiny_server_skipped_layer",
                                     "sdmb_testing:tiny_server_transposed",
                                     "sdmb_testing:tiny_server_bf16"])
def test_a_faulty_head_is_not_correct(tmp_path, program):
    """A program head that skips a layer, takes a weight transposed, or
    scores in bfloat16 comes out not correct, by ``score_gap`` alone."""
    out = _run(tt.make_scored_root(tmp_path, program=program), "tiny-scored-zipf")
    assert out["correct"] is False
    gap = out["checks"]["score_gap"]
    assert gap["value"] > 10 * gap["limit"] and np.isfinite(gap["value"]), gap
    assert all(c["value"] == 0 for k, c in out["checks"].items() if k != "score_gap")


def test_a_head_outside_matmul_fails_the_tf32_control():
    """The ``tf32_head`` control refuses a head that multiplies outside
    ``torch.matmul``: it could round no operand."""
    mod = types.SimpleNamespace(logits=lambda torch, p, d, w, s: (p.sum((1, 2)) * 2.0))
    head = reference.Head(mod, dict(tt.TINY_SCORING))
    with pytest.raises(ValueError, match="matmul"):
        head.tf32_logits(torch, torch.ones(2, 4, 16), torch.ones(2, 5), {})


def test_tf32_rounding_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0, 1 + 2 ** -11, 1 + 3 * 2 ** -11, -(1 + 2 ** -11),
                      1 + 2 ** -10 + 2 ** -12, 3.0e-30], dtype=torch.float64)
    got = reference.round_tf32(torch, x)
    assert got.tolist()[:5] == [1.0, 1.0, 1 + 2 ** -9, -1.0, 1 + 2 ** -10]
    bits = got.to(torch.float32).view(torch.int32)
    assert (torch.bitwise_and(bits, 0x1FFF) == 0).all()


# -- (d): a configuration without the block -------------------------------------------------


def test_an_unscored_configuration_keeps_pooled_gap(tmp_path):
    root = tt.make_scored_root(tmp_path)
    out = _run(root, "tiny-zipf", controls=("bf16_rows", "int4_store"))
    assert out["correct"] and "pooled_gap" in out["checks"]
    assert "score_gap" not in out["checks"]
    assert all("score_gap" not in c["checks"] for c in out["controls"].values())
    with pytest.raises(ValueError, match="tf32_head"):
        _run(root, "tiny-zipf", controls=("tf32_head",))


# -- (e): dense features and weights from the seed ------------------------------------------


def test_dense_features_and_weights_do_not_depend_on_what_follows():
    """Block ``i``'s dense rows are the same whether the run makes 2 blocks
    or 4; each weight is the same whatever parameters follow it, on every
    draw; another seed draws others."""
    inv = inputs.Inventory.from_config(tt.tiny_config())
    traffic = tt.tiny_traffic("zipf")

    def source(seed):
        return inputs.ChunkSource(inputs.TrafficGen(torch, inv, traffic, seed, "cpu"),
                                  dense=(5, "log1p_exponential"))
    a, b = source(77), source(77)
    per = a.per_block
    long_run = [a.dense(i).copy() for i in range(4 * per)]
    short_run = [b.dense(i).copy() for i in reversed(range(2 * per))][::-1]
    for x, y in zip(long_run, short_run):
        np.testing.assert_array_equal(x, y)
    assert long_run[0].shape == (traffic["chunk"], 5) and long_run[0].dtype == np.float32
    assert (np.concatenate(long_run) >= 0).all()
    assert not np.array_equal(source(78).dense(0), long_run[0])
    with pytest.raises(ValueError):
        inputs.dense_block(1, 0, 4, 2, "gaussian")

    shapes = harness.head_of(tt.REPO, tt.tiny_config(scoring=tt.TINY_SCORING)).param_shapes()
    w = inputs.head_weights(torch, shapes, 9, "cpu")
    again = inputs.head_weights(torch, shapes, 9, "cpu")
    prefix = inputs.head_weights(torch, shapes[:3], 9, "cpu")
    for name, shape, fan_in in shapes:
        assert tuple(w[name].shape) == tuple(shape) and w[name].dtype == torch.float32
        assert w[name].abs().max() <= fan_in ** -0.5
        assert torch.equal(w[name], again[name])
    for name in prefix:
        assert torch.equal(w[name], prefix[name])
    other = inputs.head_weights(torch, shapes, 10, "cpu")
    assert not torch.equal(w["top.0.w"], other["top.0.w"])


# -- (f): the engine's spans in a traced run ------------------------------------------------


def test_a_traced_run_reads_the_engines_spans(tmp_path):
    """A traced CPU run reports the span and counter metrics and no
    ``dense_from_chunk_ms``; the idle shares, which need device records,
    are read on the card only, and their readers take them from
    ``sdmb_spans`` where it gives them."""
    root = tt.make_root(tmp_path, cells=("tiny-uniform",))
    out = _run(root, "tiny-uniform", trace=True)
    assert out["correct"], out["checks"]
    m = out["metrics"]
    assert all(m[k]["value"] > 0 for k in SPAN_METRICS), m
    assert 0 < m["slot_use_share"]["value"] < 100
    assert "dense_from_chunk_ms" not in m and not set(IDLE_METRICS) & set(m)
    assert not (tt.BENCH_DIR / "metrics" / "dense_from_chunk_ms.py").exists()
    untraced = _run(root, "tiny-uniform")
    assert not set(SPAN_METRICS) & set(untraced["metrics"])
    recorded, calls, events = spans_tests._engine_calls(3)
    counters = {"engine.slots": 400, "engine.valid_keys": 100}
    read, idle = spans_mod.read_window(recorded, calls, counters, 0, events)
    ctx = types.SimpleNamespace(span_metrics=read)
    for name in SPAN_METRICS + IDLE_METRICS:
        assert harness.reader(tt.REPO, "metrics", name)(ctx) == read[name]
    assert sum(idle.values()) * 1e2 / sum((e - s) * 1e-9 for s, e in calls) == \
        pytest.approx(sum(read[k] for k in IDLE_METRICS))
    empty = types.SimpleNamespace(span_metrics={})
    assert all(harness.reader(tt.REPO, "metrics", n)(empty) is None
               for n in SPAN_METRICS + IDLE_METRICS)


# -- the card --------------------------------------------------------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return "cuda"


@pytest.mark.cuda
@pytest.mark.parametrize("law", ["zipf", "uniform"])
def test_card_scored_cells_correct_and_controls_not(tmp_path, card, law):
    """The tiny scored cells on the card: the program's logits pass and each
    control fails. No traced run here: ``test_sdmb_spans.py``'s card test
    found no call alignment when it ran after a traced run in one process
    (it passes alone), and the cells' own traced runs read the span metrics
    on the card."""
    root = tt.make_scored_root(tmp_path)
    for seed in (11, 2 ** 31 + 5, 4242424242):
        out = _run(root, f"tiny-scored-{law}", seed=seed, device=card, controls=CONTROLS)
        print(f"{law} seed {seed}: score_gap {out['checks']['score_gap']['value']!r}, "
              + ", ".join(f"{k} {c['checks']['score_gap']['value']!r}"
                          for k, c in out["controls"].items()))
        _assert_scored(out)
