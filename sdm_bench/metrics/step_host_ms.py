"""Mean ms a call of the engine's ``engine.step`` wall span: the host's
time in the device step (probe, hit pool, miss pool, dedupe, fill), its
launches and syncs (the traced window's spans, ``sdmb_spans``)."""


def read(ctx):
    return ctx.span_metrics.get("step_host_ms")
