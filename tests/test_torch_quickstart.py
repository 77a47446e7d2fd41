"""Port vs reference: ``python -m repro_torch.quickstart`` against the
reference's ``examples/quickstart.py`` run as a subprocess (the same lines,
byte for byte), and ``repro_torch.core.make_key`` against
``repro.core.make_key``."""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro.core import make_key as jmake_key
from repro_torch import quickstart
from repro_torch.core import make_key

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def test_quickstart_prints_the_reference_lines(capsys):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), JAX_PLATFORMS="cpu")
    ref = subprocess.run([sys.executable, os.path.join(ROOT, "examples", "quickstart.py")],
                         env=env, cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert ref.returncode == 0, ref.stderr[-3000:]
    quickstart.main()
    got = capsys.readouterr().out
    assert got == ref.stdout
    assert "steady state: row-cache hit rate" in got and got.count("  q") == 4


@pytest.mark.parametrize("table,row", [
    (3, 7),                                                   # scalars
    (np.arange(4), np.arange(10, 14)),                        # arrays
    (2, np.arange(5)),                                        # a scalar table broadcast
    (np.arange(3)[:, None], np.arange(4)[None, :]),           # [3, 1] x [1, 4]
    (np.array([2**31 - 1, -1]), np.array([0, 2**31 - 1])),    # int32's ends
])
def test_make_key_matches_reference(table, row):
    want = np.asarray(jmake_key(table, row))
    got = make_key(table, row)
    assert got.dtype == torch.int32 and tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.numpy(), want)
    t = make_key(torch.as_tensor(table), torch.as_tensor(row))
    np.testing.assert_array_equal(t.numpy(), want)
