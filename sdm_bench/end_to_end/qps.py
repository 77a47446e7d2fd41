"""Queries served in the window over the window's serving seconds."""


def read(ctx):
    return ctx.queries / ctx.serving_s if ctx.serving_s > 0 else None
