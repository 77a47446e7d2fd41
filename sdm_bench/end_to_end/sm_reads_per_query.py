"""SM reads the window's calls returned (``sm_ios``, the deduped misses the
cache leaves to the slow tier), over the window's queries."""


def read(ctx):
    return ctx.sm_ios / ctx.queries if ctx.queries else None
