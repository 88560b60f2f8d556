"""Changelog (retract) stream model.

A copy of `flink_tpu/table/changelog.py` (jax-free there; the port keeps
its own), read by the port's continuous aggregate.

Reference: `RowKind` (flink-core .../apache/flink/types/RowKind.java:28) and
the planner's changelog-mode inference (ChangelogMode, retract vs upsert).
The reference attaches a RowKind byte to every row; continuous (non-windowed)
aggregates and regular joins consume and produce such changelogs.

TPU-first shape: rows stay plain dicts so the columnar batch machinery is
unchanged; the kind rides in a reserved field (`ROW_KIND_FIELD`). Insert-only
streams simply omit the field — `row_kind` defaults to INSERT — so every
existing source/operator is a valid changelog producer, and changelog-aware
operators (GroupAggRunner, StreamingJoinRunner) compose: a continuous
aggregate's output can be registered as a table and aggregated again, the
reference's cascading-retraction topology.
"""

from __future__ import annotations

from collections import Counter
from typing import Dict, Iterable, List, Tuple

# RowKind.java:28 — shortString() byte codes
INSERT = "+I"
UPDATE_BEFORE = "-U"
UPDATE_AFTER = "+U"
DELETE = "-D"

ROW_KIND_FIELD = "__rowkind__"

# kinds that ADD a row to downstream state vs RETRACT one
_ADDITIVE = frozenset((INSERT, UPDATE_AFTER))
_RETRACTIVE = frozenset((UPDATE_BEFORE, DELETE))


def row_kind(row: dict) -> str:
    """The row's changelog kind; absent field means INSERT (insert-only
    streams are changelog streams with only +I, ChangelogMode.insertOnly)."""
    return row.get(ROW_KIND_FIELD, INSERT)


def is_additive(kind: str) -> bool:
    return kind in _ADDITIVE


def is_retractive(kind: str) -> bool:
    return kind in _RETRACTIVE


def with_kind(row: dict, kind: str) -> dict:
    out = dict(row)
    out[ROW_KIND_FIELD] = kind
    return out


def carry_kind(out: dict, src: dict) -> dict:
    """Copy `src`'s changelog kind onto `out` (in place) when present — THE
    way for projections/maps to forward a changelog row's kind; dropping it
    silently turns retractions into inserts downstream."""
    if ROW_KIND_FIELD in src:
        out[ROW_KIND_FIELD] = src[ROW_KIND_FIELD]
    return out


def strip_kind(row: dict) -> dict:
    if ROW_KIND_FIELD not in row:
        return row
    out = dict(row)
    out.pop(ROW_KIND_FIELD)
    return out


def _freeze(row: dict) -> Tuple:
    return tuple(sorted((k, v) for k, v in row.items() if k != ROW_KIND_FIELD))


def materialize(rows: Iterable[dict]) -> List[dict]:
    """Apply a changelog to an empty multiset and return the surviving rows
    (the reference's retract-sink materialization: +I/+U add a row, -U/-D
    remove an equal one). Works without upsert-key knowledge because -U/-D
    carry the FULL retracted row, which is the retract-changelog contract.
    Output order is first-insertion order; surviving duplicates are
    returned with their multiplicity (SQL multiset semantics)."""
    counts: Counter = Counter()
    sample: Dict[Tuple, dict] = {}
    order: List[Tuple] = []
    for row in rows:
        f = _freeze(row)
        kind = row_kind(row)
        if kind in _ADDITIVE:
            if counts[f] == 0 and f not in sample:
                order.append(f)
            counts[f] += 1
            sample[f] = strip_kind(row)
        elif kind in _RETRACTIVE:
            if counts[f] <= 0:
                raise ValueError(
                    f"changelog retracts a row that is not present: {row!r}")
            counts[f] -= 1
        else:
            raise ValueError(f"unknown row kind {kind!r} on {row!r}")
    out: List[dict] = []
    for f in order:
        out.extend(dict(sample[f]) for _ in range(counts[f]))
    return out
