"""Device-busy ms a call: the seconds in which an operation of the traced
window ran on the device, over its calls. Steadier than the walls, which
follow the host's speed."""


def read(ctx):
    if ctx.summary is None or not ctx.summary["ops"] or not ctx.walls:
        return None
    return 1e3 * ctx.summary["busy_s"] / len(ctx.walls)
