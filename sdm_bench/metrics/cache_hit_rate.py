"""Percent of the window's valid probes that hit the row cache: the change
of the program's own ``hits`` counter over that of ``hits + misses``."""


def read(ctx):
    n = ctx.hits + ctx.misses
    return 100.0 * ctx.hits / n if n > 0 else None
