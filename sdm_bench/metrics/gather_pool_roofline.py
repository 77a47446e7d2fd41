"""Percent of the ``gather_pool`` kernel's device time that its bytes need
at the card's memory rate (``csrc/gather_pool.cu``; bytes per call from each
batch's block, hits and misses, over the device seconds per call recorded
in the trace)."""
import sdmb_profile as prof
import sdmb_yardstick as y

KERNEL = "gather_pool"


def read(ctx):
    if ctx.summary is None or not ctx.counts:
        return None
    n, sec = prof.named(ctx.summary, KERNEL)
    if not n or sec <= 0:
        return None
    per_call = sum(y.least_seconds(y.gather_pool_bytes(c), 0)
                   for c in ctx.counts) / len(ctx.counts)
    return 100.0 * per_call / (sec / n)
