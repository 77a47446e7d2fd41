"""Percent of the traced window's serving seconds in which no operation ran
on the device (1 - busy / wall, from the device trace)."""


def read(ctx):
    if ctx.summary is None or not ctx.summary["ops"] or ctx.serving_s <= 0:
        return None
    return 100.0 * (1.0 - ctx.summary["busy_s"] / ctx.serving_s)
