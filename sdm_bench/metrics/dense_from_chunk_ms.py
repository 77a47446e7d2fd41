"""Mean ms a batch of the program's ``dense_from_chunk`` (the engine's host
side: CSR chunk to the padded [B, T, P] block), timed by the benchmark on
each chunk of the traced window, beside the served calls."""


def read(ctx):
    return sum(ctx.dense_ms) / len(ctx.dense_ms) if ctx.dense_ms else None
