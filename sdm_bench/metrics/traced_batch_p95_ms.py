"""``batch_p95_ms`` of the traced window, in the cells where the host's speed spreads
it too widely for a bound end to end (``m1-zipf``): the end-to-end
reader over the traced window's calls, which the profiler slows."""
import pathlib
import runpy

read = runpy.run_path(str(pathlib.Path(__file__).parent.parent / "end_to_end"
                          / "batch_p95_ms.py"))["read"]
