"""95th percentile over every ``serve_columnar`` call of the window of the
call's host-clock wall (a query's latency on the card is its batch's)."""
import numpy as np


def read(ctx):
    return float(np.percentile(ctx.walls, 95)) * 1e3 if ctx.walls else None
