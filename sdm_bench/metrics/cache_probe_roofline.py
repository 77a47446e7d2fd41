"""Percent of the ``cache_probe`` kernel's device time that its bytes need
at the card's memory rate (``csrc/cache_probe.cu``; bytes per call from each
batch's probes, sets and hits, over the device seconds per call recorded in
the trace)."""
import sdmb_profile as prof
import sdmb_yardstick as y

KERNEL = "cache_probe"


def read(ctx):
    if ctx.summary is None or not ctx.counts:
        return None
    n, sec = prof.named(ctx.summary, KERNEL)
    if not n or sec <= 0:
        return None
    per_call = sum(y.least_seconds(y.cache_probe_bytes(c, ctx.ways), 0)
                   for c in ctx.counts) / len(ctx.counts)
    return 100.0 * per_call / (sec / n)
