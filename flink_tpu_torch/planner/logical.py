"""Logical relational plan IR for the SQL front door.

A copy of `flink_tpu/planner/logical.py` (jax-free there; the port keeps
its own copy under the same name).

A parsed `Query` (table/sql.py) is first translated into a small
relational tree — Scan → [Filter] → WindowAggregate → Output — before any
physical decision is made. The tree is the planner's working surface: the
rewrite rules (planner/rules.py) annotate it (predicate pushdown below the
window, projection pruning, window-spec normalization, agg-call → device
aggregator field mapping) and the lowering (planner/lowering.py) reads the
annotations to emit transformations for the fused device path.

"On the Semantic Overlap of Operators in Stream Processing Engines"
(PAPERS.md) grounds the move: relational SELECT/WHERE/GROUP BY windows
reduce to the same operator core the DataStream API records, so one
classifier (graph/fusion.py) serves both front doors. Shapes outside that
core raise `Unsupported` with a catalogued reason, and the table layer
keeps them on the interpreted path — a fallback is attributed, never a
failure.

Layering: this package sits beside `graph` — it may import `table` (the
parsed Query shapes), `graph` (Transformation), `core`, and `config`;
never `runtime`, `api`, or `scheduler` (ARCH001). Assigner construction
happens through the sanctioned function-scoped lazy import in lowering.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional, Tuple

from flink_tpu_torch.table.sql import BoolExpr, Operand, Query, SelectItem

#: fallback catalog: reason code -> what keeps the statement on the
#: interpreted path (docs/sql.md renders this table; the gateway reports
#: the code per statement)
FALLBACK_CATALOG: Dict[str, str] = {
    "disabled": "table.device-fusion is off; every statement interprets",
    "unknown-table": "the statement references an unregistered table",
    "join": "join shapes outside the fused core (aggregates or GROUP BY "
            "over a join) stay on the host join translation",
    "join-unwindowed": "regular (non-windowed) joins keep unbounded "
                       "two-sided state with retraction output; the device "
                       "join ring is windowed, so they run on the host "
                       "StreamingJoinRunner",
    "join-outer-windowed": "windowed LEFT/RIGHT OUTER joins need "
                           "end-of-window padding the device emission does "
                           "not produce; only windowed INNER joins fuse",
    "join-full-outer": "FULL OUTER JOIN is not supported on any path: "
                       "neither the host join operators nor the device "
                       "join ring implements two-sided padding retraction",
    "join-session-window": "SESSION windows are not sliceable, so a "
                           "session-windowed join has no bucket-ring form "
                           "(and the host windowed join refuses it too)",
    "union": "UNION ALL branches plan independently on the host",
    "no-window": "continuous (non-windowed) aggregates emit a retract "
                 "changelog; the device path is append-only windows",
    "no-aggregate": "pure projection / ML_PREDICT statements have no "
                    "windowed aggregate to fuse",
    "no-group-by": "a windowed aggregate without GROUP BY columns has no "
                   "key column for dense device keying",
    "composite-group-key": "multi-column GROUP BY keys need host tuple "
                           "keying; dense device keys are single ints",
    "multi-aggregate": "more than one aggregate call per SELECT keeps the "
                       "host composite accumulator",
    "session-window": "SESSION windows are not sliceable; the fused "
                      "superscan requires a sliceable assigner",
    "bad-window-geometry": "window size/slide must be positive; the "
                           "interpreted path raises the assigner's own "
                           "error for the statement",
    "window-not-on-rowtime": "the window's time column must be the "
                             "table's declared rowtime (the batch "
                             "timestamp column)",
    "untyped-schema": "row-mode tables without declared field_types "
                      "cannot prove numeric columns at plan time",
    "non-integer-group-key": "the GROUP BY column must be a declared "
                             "int field (dense device keys)",
    "non-numeric-field": "an aggregate or predicate references a "
                         "non-numeric field",
    "non-traceable-predicate": "the WHERE predicate compares against a "
                               "string literal or otherwise has no "
                               "columnar device form",
    "unknown-column": "the statement references a column the table's "
                      "schema does not declare; the interpreted path "
                      "raises its own error for the statement",
    "rowtime-in-expression": "the rowtime column rides the batch "
                             "timestamps; predicates/aggregates over it "
                             "have no value-column device form",
}


class Unsupported(Exception):
    """A statement shape outside the fused front door. Carries the
    catalogued reason code; the table layer turns this into an attributed
    interpreted-path fallback, never an error."""

    def __init__(self, reason: str, detail: str = ""):
        assert reason in FALLBACK_CATALOG, f"uncatalogued reason {reason!r}"
        self.reason = reason
        self.detail = detail or FALLBACK_CATALOG[reason]
        super().__init__(f"{reason}: {self.detail}")


@dataclasses.dataclass(frozen=True)
class TableInfo:
    """Catalog entry the planner sees per registered table."""

    name: str
    fields: Tuple[str, ...]
    rowtime: Optional[str] = None
    field_types: Optional[Tuple[str, ...]] = None   # 'int'|'float'|'str'
    columnar: bool = False

    def type_of(self, field: str) -> Optional[str]:
        """Declared type; columnar tables default to 'float' (their batch
        columns are numeric by construction), row tables to None."""
        if self.field_types is not None:
            try:
                return self.field_types[self.fields.index(field)]
            except ValueError:
                return None
        return "float" if self.columnar else None

    def is_numeric(self, field: str) -> bool:
        return self.type_of(field) in ("int", "float")


@dataclasses.dataclass
class AggCall:
    """One aggregate select item, mapped by rules.map_aggregates onto the
    builtin DeviceAggregator the runtime resolves by name."""

    func: str                     # COUNT/SUM/MIN/MAX/AVG
    arg: Optional[str]            # None for COUNT(*)
    output: str
    device_agg: Optional[str] = None   # 'count'/'sum'/'min'/'max'/'mean'

    def describe(self) -> str:
        call = f"{self.func.lower()}({self.arg or '*'})"
        dev = f" -> {self.device_agg}" if self.device_agg else ""
        return f"{call} AS {self.output}{dev}"


@dataclasses.dataclass
class NormalizedWindow:
    """A TUMBLE/HOP spec normalized onto the sliceable assigner form the
    device operators consume (rules.normalize_window fills slice_ms)."""

    kind: str                     # 'tumble' | 'hop'
    time_col: str
    size_ms: int
    slide_ms: int                 # == size_ms for tumble
    slice_ms: Optional[int] = None

    def describe(self) -> str:
        parts = [f"size={self.size_ms}ms"]
        if self.kind == "hop":
            parts.append(f"slide={self.slide_ms}ms")
        if self.slice_ms is not None:
            parts.append(f"slice={self.slice_ms}ms")
        return f"{self.kind}({' '.join(parts)})"


@dataclasses.dataclass
class Scan:
    table: TableInfo
    required: Optional[List[str]] = None   # rules.prune_projection fills

    def describe(self) -> str:
        read = (",".join(self.required)
                if self.required is not None else "*")
        return (f"Scan[{self.table.name}, "
                f"fields={','.join(self.table.fields)}, read={read}]")


@dataclasses.dataclass
class Filter:
    pred: Any                     # Comparison | BoolExpr
    text: str
    below_window: bool = False    # rules.push_predicate_below_window

    def describe(self) -> str:
        note = ", device-pushdown" if self.below_window else ""
        return f"Filter[{render_predicate(self.pred)}{note}]"


@dataclasses.dataclass
class WindowAggregate:
    group_col: str
    window: NormalizedWindow
    agg: AggCall

    def describe(self) -> str:
        return (f"WindowAggregate[key={self.group_col}, "
                f"{self.window.describe()}, {self.agg.describe()}]")


@dataclasses.dataclass
class Output:
    """The host-side output stage: row assembly + HAVING + per-window
    top-N. Downstream of the fused program, shared verbatim with the
    interpreted path (table_env's windowed output stage)."""

    columns: List[str]
    having_text: Optional[str] = None
    order_by: List[Tuple[str, bool]] = dataclasses.field(default_factory=list)
    limit: Optional[int] = None

    def describe(self) -> str:
        extra = []
        if self.having_text:
            extra.append(f"having={self.having_text}")
        if self.order_by:
            ob = ",".join(f"{c}{' DESC' if d else ''}"
                          for c, d in self.order_by)
            extra.append(f"order_by={ob}")
        if self.limit is not None:
            extra.append(f"limit={self.limit}")
        tail = f", {' '.join(extra)}" if extra else ""
        return f"Output[{','.join(self.columns)}{tail}]"


@dataclasses.dataclass
class LogicalPlan:
    scan: Scan
    filter: Optional[Filter]
    window_agg: WindowAggregate
    output: Output
    query: Query

    def describe(self) -> str:
        """Top-down indented tree — the golden-test surface."""
        nodes = [self.output.describe(), self.window_agg.describe()]
        if self.filter is not None:
            nodes.append(self.filter.describe())
        nodes.append(self.scan.describe())
        return "\n".join("  " * i + n for i, n in enumerate(nodes))


@dataclasses.dataclass
class JoinScan:
    """One input side of a fused windowed join."""

    table: TableInfo
    alias: str
    key_col: str                  # unqualified column on this side

    def describe(self) -> str:
        return (f"Scan[{self.table.name} AS {self.alias}, "
                f"key={self.key_col}]")


@dataclasses.dataclass
class JoinLogicalPlan:
    """A fused windowed equi-join: two scans under one shared window,
    matched on the device join ring (runtime's DeviceJoinRunner). The
    WHERE/projection stages run on the host DOWNSTREAM of the fused
    emission — the join itself (both sides' buffering and the per-window
    cross-match) is the device part."""

    left: JoinScan
    right: JoinScan
    window: NormalizedWindow
    output: Output
    query: Query
    filter_text: Optional[str] = None

    def describe(self) -> str:
        q = self.query
        j = q.join
        flt = f", where={self.filter_text}" if self.filter_text else ""
        nodes = [
            self.output.describe(),
            (f"WindowJoin[{j.left_col} = {j.right_col}, "
             f"{self.window.describe()}, device=join-ring{flt}]"),
        ]
        lines = ["  " * i + n for i, n in enumerate(nodes)]
        indent = "  " * len(nodes)
        lines.append(indent + self.left.describe())
        lines.append(indent + self.right.describe())
        return "\n".join(lines)


def render_predicate(node) -> str:
    """Stable text form of a predicate AST (parenthesized OR under AND)."""
    if isinstance(node, BoolExpr):
        left, right = render_predicate(node.left), render_predicate(node.right)
        if node.op == "and":
            if isinstance(node.left, BoolExpr) and node.left.op == "or":
                left = f"({left})"
            if isinstance(node.right, BoolExpr) and node.right.op == "or":
                right = f"({right})"
        return f"{left} {node.op.upper()} {right}"
    return (f"{_render_operand(node.left)} {node.op} "
            f"{_render_operand(node.right)}")


def _render_operand(op: Operand) -> str:
    if op.kind == "string":
        return f"'{op.value}'"
    return str(op.value)


def build_logical_plan(
    q: Query, catalog: Dict[str, TableInfo],
) -> "LogicalPlan | JoinLogicalPlan":
    """Translate a parsed Query into the relational tree, rejecting (with
    catalogued reasons) every shape outside the fused front door. The
    rewrite rules then annotate the tree; see planner/rules.py."""
    if q.union_all is not None:
        raise Unsupported("union")
    if q.join is not None:
        return _build_join_plan(q, catalog)
    table = catalog.get(q.table)
    if table is None:
        raise Unsupported("unknown-table", f"table {q.table!r}")

    aggs = [i for i in q.select if i.kind == "agg"]
    if any(i.kind == "ml_predict" for i in q.select):
        raise Unsupported("no-aggregate", "ML_PREDICT projection")
    if not aggs:
        raise Unsupported("no-aggregate")
    if q.window is None:
        raise Unsupported("no-window")
    if q.window.kind == "session":
        raise Unsupported("session-window")
    if not q.group_by:
        raise Unsupported("no-group-by")
    if len(q.group_by) > 1:
        raise Unsupported("composite-group-key",
                          f"GROUP BY {', '.join(q.group_by)}")
    if len(aggs) > 1:
        raise Unsupported("multi-aggregate",
                          f"{len(aggs)} aggregate calls")
    for item in q.select:
        if item.kind == "column" and item.name not in q.group_by:
            # invalid SQL, not a fallback shape: both paths refuse it with
            # the same error (the shared output stage raises identically),
            # so the planner must not classify it as fused either
            raise ValueError(
                f"SELECT column {item.name!r} must appear in GROUP BY "
                "(non-grouped columns are not defined for aggregates)")

    window = NormalizedWindow(
        kind=q.window.kind,
        time_col=q.window.time_col,
        size_ms=q.window.size_ms,
        slide_ms=(q.window.slide_ms if q.window.kind == "hop"
                  else q.window.size_ms),
    )
    agg_item: SelectItem = aggs[0]
    agg = AggCall(
        func=agg_item.func,
        arg=None if agg_item.name == "*" else agg_item.name,
        output=agg_item.output_name,
    )
    flt = (Filter(q.where_ast, q.where_text or "")
           if q.where_ast is not None else None)
    out = Output(
        columns=[i.output_name for i in q.select],
        having_text=q.having_text,
        order_by=list(q.order_by),
        limit=q.limit,
    )
    return LogicalPlan(
        scan=Scan(table=table),
        filter=flt,
        window_agg=WindowAggregate(
            group_col=q.group_by[0], window=window, agg=agg),
        output=out,
        query=q,
    )


def _build_join_plan(q: Query, catalog: Dict[str, TableInfo]
                     ) -> JoinLogicalPlan:
    """The join front door: windowed INNER equi-joins plan fused (the
    device join ring); every other join shape falls back with its OWN
    catalogued reason — single-sourced with the JAX package's runtime join
    fallback catalog (`joins/spec.py`), so the SQL explain and the
    runner's fallback_reason attribute the same way."""
    j = q.join
    if j.join_type == "full":
        raise Unsupported("join-full-outer",
                          f"{q.table} FULL OUTER JOIN {j.table2}")
    if j.window is None:
        raise Unsupported("join-unwindowed",
                          f"regular join on {j.left_col} = {j.right_col}")
    if j.join_type != "inner":
        raise Unsupported("join-outer-windowed",
                          f"windowed {j.join_type.upper()} OUTER join")
    if j.window.kind == "session":
        raise Unsupported("join-session-window",
                          f"session window on {j.left_col} = {j.right_col}")
    left = catalog.get(q.table)
    if left is None:
        raise Unsupported("unknown-table", f"table {q.table!r}")
    right = catalog.get(j.table2)
    if right is None:
        raise Unsupported("unknown-table", f"table {j.table2!r}")
    if q.group_by or any(i.kind in ("agg", "ml_predict") for i in q.select):
        raise Unsupported("join", "aggregate/GROUP BY over a join")
    window = NormalizedWindow(
        kind=j.window.kind,
        time_col=j.window.time_col or "<batch timestamps>",
        size_ms=j.window.size_ms,
        slide_ms=(j.window.slide_ms if j.window.kind == "hop"
                  else j.window.size_ms),
    )
    out = Output(columns=[i.output_name for i in q.select])
    return JoinLogicalPlan(
        left=JoinScan(table=left, alias=j.alias1,
                      key_col=j.left_col.split(".", 1)[1]),
        right=JoinScan(table=right, alias=j.alias2,
                       key_col=j.right_col.split(".", 1)[1]),
        window=window,
        output=out,
        query=q,
        filter_text=q.where_text,
    )


def predicate_is_columnar(
    node, table: TableInfo,
) -> Tuple[Optional[str], str]:
    """Can this predicate run as a traceable column mask? Returns
    (fallback_reason_code or None, detail) — a STRUCTURED code, never
    prose the caller has to grep. Requires every operand to be a numeric
    field of `table` or a numeric literal; string literals and rowtime
    references have no value-column form."""
    if isinstance(node, BoolExpr):
        for side in (node.left, node.right):
            code, why = predicate_is_columnar(side, table)
            if code is not None:
                return code, why
        return None, ""
    for side in (node.left, node.right):
        if side.kind == "string":
            return "non-traceable-predicate", f"string literal '{side.value}'"
        if side.kind == "column":
            name = side.value
            if name == table.rowtime:
                return "rowtime-in-expression", f"rowtime column {name!r}"
            if name not in table.fields:
                return "unknown-column", f"unknown column {name!r}"
            if not table.is_numeric(name):
                return ("non-traceable-predicate",
                        f"non-numeric column {name!r}")
    return None, ""


def window_slice_ms(size_ms: int, slide_ms: int) -> int:
    """Slice granule of a sliceable window: gcd(size, slide) — the same
    decomposition SlidingEventTimeWindows declares (tumbling is the
    slide == size special case)."""
    return math.gcd(int(size_ms), int(slide_ms))
