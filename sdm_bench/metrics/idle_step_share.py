"""Percent of the traced calls' seconds in which the card was idle while the
host was in ``engine.step`` or a ``step.*`` span: launches and syncs of the
device step (``sdmb_spans``). Card runs only."""


def read(ctx):
    return ctx.span_metrics.get("idle_step_share")
