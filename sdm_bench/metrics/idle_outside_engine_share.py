"""Percent of the traced calls' seconds in which the card was idle while the
host was inside a call but in no engine span (the harness's
``ColumnarQueries(...).whole()``, a scoring head's host work); device
records aligned to the engine's spans (``sdmb_spans``). Card runs only."""


def read(ctx):
    return ctx.span_metrics.get("idle_outside_engine_share")
