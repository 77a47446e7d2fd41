"""Mean ms a call of the engine's ``engine.densify`` wall span: the host's
O(segments) work over the chunk's CSR arrays ahead of the copy in (the
traced window's spans, ``sdmb_spans``)."""


def read(ctx):
    return ctx.span_metrics.get("densify_span_ms")
