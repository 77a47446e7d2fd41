"""``device_idle_share`` in the cells whose ``qps`` and ``batch_p95_ms`` are
per layer (``traced_qps``, ``traced_batch_p95_ms``): the same reader,
set against ``sm_reads_per_query``, the end-to-end metric they report."""
import pathlib
import runpy

read = runpy.run_path(str(pathlib.Path(__file__).with_name("device_idle_share.py")))["read"]
