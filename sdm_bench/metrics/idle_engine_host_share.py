"""Percent of the traced calls' seconds in which the card was idle while the
host was in an engine span outside the step (``engine.serve`` itself,
``densify``, ``validate``, ``h2d``, ``d2h``, ``account``; ``sdmb_spans``).
Card runs only."""


def read(ctx):
    return ctx.span_metrics.get("idle_engine_host_share")
