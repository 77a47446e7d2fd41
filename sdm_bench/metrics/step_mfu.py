"""Percent of its wall that the whole ``serve_columnar`` call would take on
the card at its peaks: the larger of the bytes the batch needs at the
memory rate and its dequant-and-pool FLOPs at the float32 rate, summed over
the traced window's calls, over their summed host-clock walls."""
import sdmb_yardstick as y


def read(ctx):
    if ctx.summary is None or not ctx.counts or ctx.serving_s <= 0:
        return None
    least = sum(y.least_seconds(y.step_bytes(c, ctx.ways), y.step_flops(c))
                for c in ctx.counts)
    return 100.0 * least / ctx.serving_s
