import os
import sys

import pytest

# Tests run on the single real CPU device (the dry-run sets its own flags in
# a separate process). Keep JAX quiet and deterministic.
os.environ.setdefault("JAX_PLATFORMS", "cpu")

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))
sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def pytest_addoption(parser):
    parser.addoption(
        "--runslow", action="store_true", default=False,
        help="run tests marked slow (skipped by default so the tier-1 "
             "`pytest -x -q` stays fast; `make test` passes this)")


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "slow: long-running test (heavyweight arch smoke, deep property "
        "sweeps, traffic-driven benchmark goldens, the XLA dry-run); "
        "skipped by default — run with `--runslow` / `make test`")
    config.addinivalue_line(
        "markers",
        "cuda: needs an NVIDIA GPU (the port's CUDA kernels); skips without one")


def pytest_collection_modifyitems(config, items):
    if config.getoption("--runslow"):
        return
    if "slow" in (config.option.markexpr or ""):
        return  # an explicit -m expression controls slow selection itself
    skip = pytest.mark.skip(
        reason="slow test: pass --runslow (or `make test`) to run")
    for item in items:
        if "slow" in item.keywords:
            item.add_marker(skip)
