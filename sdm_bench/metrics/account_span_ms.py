"""Mean ms a call of the engine's ``engine.account`` wall span: the IO
submission and Eq. 3 accounting of the call's misses on the host (the
traced window's spans, ``sdmb_spans``)."""


def read(ctx):
    return ctx.span_metrics.get("account_span_ms")
