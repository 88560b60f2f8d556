"""Rewrite rules over the logical plan.

A copy of `flink_tpu/planner/rules.py` (jax-free there; the port keeps its
own copy under the same name).

Each rule either annotates the tree (the lowering reads the annotations)
or raises `Unsupported` with a catalogued reason — the table layer keeps
such statements on the interpreted path with the reason attributed.

The sequence mirrors the reference planner's group-window rewrite set at
the scale this dialect needs:

  normalize_window          TUMBLE/HOP -> the sliceable assigner form
                            (slice granule = gcd(size, slide); session is
                            not sliceable and was rejected at build)
  map_aggregates            agg call -> builtin DeviceAggregator name
                            (COUNT->count, SUM->sum, MIN->min, MAX->max,
                            AVG->mean — mean's two add-scatter fields pass
                            the fused classifier's add/min/max bar)
  push_predicate_below_window
                            WHERE mask proven columnar-traceable over the
                            scanned numeric fields -> marked for the
                            traced device prologue (below the window
                            ingest, above nothing: the filter IS part of
                            the compiled superscan)
  prune_projection          the scan's required field set = group col +
                            agg arg + predicate columns; row-mode tables
                            columnarize exactly these (physical pruning),
                            columnar sources keep their layout and the
                            traced extractors simply never touch pruned
                            columns

Join plans (JoinLogicalPlan — windowed INNER equi-joins) take their own
single rewrite, `rewrite_join_window`: the shared window normalizes onto
the sliceable form whose gcd granule seeds the device join ring's bucket
geometry, which is what turns `SELECT ... FROM a JOIN b ... WINDOW ...`
into a fused-runner selection instead of the old blanket 'join' fallback.
"""

from __future__ import annotations

from flink_tpu_torch.planner.logical import (
    JoinLogicalPlan,
    LogicalPlan,
    Unsupported,
    predicate_is_columnar,
    window_slice_ms,
)
#: single-sourced with the interpreted translation (table_env) — the two
#: front doors must never disagree about which aggregates have a device
#: form; the runtime and the fusion classifier resolve these strings via
#: ops.aggregators.resolve
from flink_tpu_torch.table.sql import DEVICE_AGG_OF, predicate_columns


def optimize(plan):
    """Run the full rule sequence in order; mutates and returns `plan`."""
    if isinstance(plan, JoinLogicalPlan):
        rewrite_join_window(plan)
        return plan
    normalize_window(plan)
    map_aggregates(plan)
    push_predicate_below_window(plan)
    prune_projection(plan)
    return plan


def rewrite_join_window(plan: JoinLogicalPlan) -> None:
    """The join lowering rewrite: normalize the shared window onto the
    sliceable form the device join ring consumes. The ring's bucket
    granule is gcd(size, slide) — the same slice decomposition the
    windowed-aggregate path uses — so a SQL TUMBLE/HOP join lands on the
    fused `DeviceJoinRunner` with NO host re-bucketing: the logical
    window spec IS the ring geometry's seed (joins/spec.py
    plan_join_geometry starts from exactly these numbers)."""
    w = plan.window
    if w.size_ms <= 0 or w.slide_ms <= 0:
        raise Unsupported("bad-window-geometry",
                          f"size={w.size_ms} slide={w.slide_ms}")
    w.slice_ms = window_slice_ms(w.size_ms, w.slide_ms)


def normalize_window(plan: LogicalPlan) -> None:
    w = plan.window_agg.window
    table = plan.scan.table
    if w.size_ms <= 0 or w.slide_ms <= 0:
        raise Unsupported(
            "bad-window-geometry",
            f"size={w.size_ms} slide={w.slide_ms}")
    if table.rowtime is None or w.time_col != table.rowtime:
        raise Unsupported(
            "window-not-on-rowtime",
            f"window over {w.time_col!r}, table rowtime is "
            f"{table.rowtime!r}")
    w.slice_ms = window_slice_ms(w.size_ms, w.slide_ms)


def map_aggregates(plan: LogicalPlan) -> None:
    agg = plan.window_agg.agg
    table = plan.scan.table
    agg.device_agg = DEVICE_AGG_OF.get(agg.func)
    if agg.device_agg is None:   # parser only emits the five; belt+braces
        raise Unsupported("multi-aggregate",
                          f"unmapped aggregate {agg.func}")
    if agg.arg is not None:
        if agg.arg == table.rowtime:
            raise Unsupported("rowtime-in-expression",
                              f"{agg.func}({agg.arg})")
        if agg.arg not in table.fields:
            raise Unsupported("unknown-column",
                              f"{agg.func} over unknown column "
                              f"{agg.arg!r}")
        if table.field_types is None and not table.columnar:
            raise Unsupported("untyped-schema",
                              f"{agg.func}({agg.arg}) over an untyped "
                              f"row-mode table")
        if not table.is_numeric(agg.arg):
            raise Unsupported("non-numeric-field",
                              f"{agg.func}({agg.arg})")


def push_predicate_below_window(plan: LogicalPlan) -> None:
    if plan.filter is None:
        return
    table = plan.scan.table
    if table.field_types is None and not table.columnar:
        raise Unsupported("untyped-schema",
                          "WHERE over an untyped row-mode table")
    code, why = predicate_is_columnar(plan.filter.pred, table)
    if code is not None:
        raise Unsupported(code, why)
    plan.filter.below_window = True


def prune_projection(plan: LogicalPlan) -> None:
    table = plan.scan.table
    wa = plan.window_agg
    key = wa.group_col
    if key == table.rowtime:
        raise Unsupported("rowtime-in-expression", f"GROUP BY {key}")
    if key not in table.fields:
        raise Unsupported("unknown-column",
                          f"unknown GROUP BY column {key!r}")
    if table.field_types is None and not table.columnar:
        raise Unsupported("untyped-schema", f"GROUP BY {key} over an "
                                            "untyped row-mode table")
    if table.type_of(key) != "int":
        if table.field_types is None:
            # columnar registration without declared types: nothing was
            # "declared 'float'" — the user just needs to declare the key
            raise Unsupported(
                "untyped-schema",
                f"GROUP BY {key!r} on a columnar table without "
                "field_types (the group key must be a declared int — "
                "dense device keys, and the row view must emit the same "
                "Python ints the fused path does)")
        raise Unsupported(
            "non-integer-group-key",
            f"GROUP BY {key!r} is declared {table.type_of(key)!r}")
    required = [key]
    if wa.agg.arg is not None and wa.agg.arg not in required:
        required.append(wa.agg.arg)
    if plan.filter is not None:
        for c in predicate_columns(plan.filter.pred):
            if c not in required:
                required.append(c)
    plan.scan.required = required
