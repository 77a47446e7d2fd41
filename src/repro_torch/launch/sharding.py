"""Layouts of the sharded embedding store (``runtime.sharded_engine``).

* ``row``   -- every shard owns a row slice of every table; the shards'
               partial pools are summed.
* ``table`` -- every shard owns whole tables; each table's pool is taken
               from its owner.
"""
from __future__ import annotations

EMBED_LAYOUTS = ("row", "table")


def check_layout(layout: str) -> None:
    if layout not in EMBED_LAYOUTS:
        raise ValueError(f"layout must be one of {EMBED_LAYOUTS}, got {layout!r}")
