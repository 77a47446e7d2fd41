"""Collective inventories and wire-byte estimates, per device.

Two sources give the same dict layout, ``{op: {count, result_bytes,
wire_bytes}}`` plus ``total_wire_bytes`` and ``total_count``, under HLO's op
names (``all-reduce``, ``all-gather``, ``reduce-scatter``, ``all-to-all``,
``collective-permute``):

* :func:`collective_stats` parses post-SPMD HLO text (the per-device
  program the reference's ``repro.launch.dryrun --save-hlo`` writes), a
  copy of ``src/repro/launch/hlo.py``;
* :func:`comm_stats` reads the collectives ``CommDebugMode`` recorded while
  a DTensor step ran (the port's dry-run).

Both price a collective of result bytes R over a group of N devices with
one ring formula, :func:`ring_wire_bytes`:

    all-reduce(S):        2 * S * (N-1)/N
    all-gather(result R): R * (N-1)/N           (each device receives R-R/N)
    reduce-scatter(S_in): S_in * (N-1)/N        (S_in = R * N)
    all-to-all(S):        S * (N-1)/N
    collective-permute(S): S
"""
from __future__ import annotations

import re
from collections import defaultdict
from typing import Dict, Iterable, Mapping

_DTYPE_BYTES = {
    "f64": 8, "f32": 4, "f16": 2, "bf16": 2, "f8e4m3fn": 1, "f8e5m2": 1,
    "s64": 8, "u64": 8, "s32": 4, "u32": 4, "s16": 2, "u16": 2,
    "s8": 1, "u8": 1, "pred": 1, "c64": 8, "c128": 16, "s4": 1, "u4": 1,
}

COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute")

# e.g.:  %all-gather.3 = bf16[16,512]{1,0} all-gather(...), replica_groups=...
_OP_RE = re.compile(
    r"=\s*(?:\(([^)]*)\)|(\w+)\[([\d,]*)\](?:\{[^}]*\})?)\s+"
    r"(all-reduce|all-gather|reduce-scatter|all-to-all|collective-permute)"
    r"(?:-start)?\(")

_TUPLE_ELEM_RE = re.compile(r"(\w+)\[([\d,]*)\]")
_GROUPS_LIST_RE = re.compile(r"replica_groups=\{\{([^}]*)\}")
_GROUPS_IOTA_RE = re.compile(r"replica_groups=\[(\d+),(\d+)\]")

# the functional collectives DTensor issues, by their HLO names
_FUNCOL_OPS = {
    "all_reduce": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "permute_tensor": "collective-permute",
}


def _shape_bytes(dtype: str, dims: str) -> int:
    n = 1
    if dims:
        for d in dims.split(","):
            n *= int(d)
    return n * _DTYPE_BYTES.get(dtype, 4)


def _group_size(line: str, default: int) -> int:
    m = _GROUPS_IOTA_RE.search(line)
    if m:
        return int(m.group(2))
    m = _GROUPS_LIST_RE.search(line)
    if m:
        return len(m.group(1).split(","))
    return default


def ring_wire_bytes(op: str, result_bytes: int, group: int) -> int:
    """Bytes one device sends for collective ``op`` whose result is
    ``result_bytes`` on each device, over a ring of ``group`` devices
    (at least 2, as the reference counts a group it cannot read)."""
    n = max(2, group)
    frac = (n - 1) / n
    if op == "all-reduce":
        return int(2 * result_bytes * frac)
    if op in ("all-gather", "all-to-all"):
        return int(result_bytes * frac)
    if op == "reduce-scatter":
        return int(result_bytes * n * frac)  # operand = result * N
    if op == "collective-permute":
        return result_bytes
    raise ValueError(f"unknown collective {op!r}")


def _totals(stats) -> Dict:
    out = dict(stats)
    out["total_wire_bytes"] = sum(s["wire_bytes"] for s in stats.values())
    out["total_count"] = sum(s["count"] for s in stats.values())
    return out


def _new_stats():
    return defaultdict(lambda: {"count": 0, "result_bytes": 0, "wire_bytes": 0})


def _add(stats, op: str, result_bytes: int, group: int) -> None:
    s = stats[op]
    s["count"] += 1
    s["result_bytes"] += result_bytes
    s["wire_bytes"] += ring_wire_bytes(op, result_bytes, group)


def collective_stats(hlo_text: str, default_group: int = 1) -> Dict:
    """Returns {op: {count, result_bytes, wire_bytes}} + totals (per device)."""
    stats = _new_stats()
    for line in hlo_text.splitlines():
        m = _OP_RE.search(line)
        if not m:
            continue
        tuple_body, dtype, dims, op = m.groups()
        if tuple_body is not None:
            rb = sum(_shape_bytes(d, s) for d, s in _TUPLE_ELEM_RE.findall(tuple_body))
        else:
            rb = _shape_bytes(dtype, dims)
        _add(stats, op, rb, _group_size(line, default_group))
    return _totals(stats)


def count_ops(hlo_text: str, opname: str) -> int:
    return len(re.findall(rf"\b{re.escape(opname)}\(", hlo_text))


def hlo_name(op) -> str:
    """HLO's name of a functional-collective op (an ``OpOverload``, its
    packet or its name, e.g. ``c10d_functional.all_gather_into_tensor``,
    or an HLO name already), or the empty string when it is not a
    collective."""
    text = str(getattr(op, "_qualified_op_name", op))
    if text in COLLECTIVES:
        return text
    for part in text.split("::")[-1].split("."):
        if part in _FUNCOL_OPS:
            return _FUNCOL_OPS[part]
    return ""


def comm_stats(records: Iterable[Mapping], default_group: int = 1) -> Dict:
    """The layout of :func:`collective_stats` from collectives recorded
    while a DTensor step ran: each record a mapping with ``op`` (anything
    :func:`hlo_name` reads), ``result_bytes`` (the local result on one
    device) and optionally ``group`` (the devices taking part; else
    ``default_group``). Records that are not collectives are skipped."""
    stats = _new_stats()
    for rec in records:
        op = hlo_name(rec["op"])
        if op:
            _add(stats, op, int(rec["result_bytes"]), int(rec.get("group") or default_group))
    return _totals(stats)
