"""Percent of the padded [B, T, P] block's slots that hold a key: the
engine's ``engine.valid_keys`` counter over ``engine.slots`` across the traced
window."""


def read(ctx):
    return ctx.span_metrics.get("slot_use_share")
