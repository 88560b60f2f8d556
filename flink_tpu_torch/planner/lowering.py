"""Lower an optimized logical plan onto the fused step-graph path.

Counterpart of `flink_tpu/planner/lowering.py`. The output is the SAME
transformation chain a hand-fused DataStream program records —

    source -> [columnarize] -> filter(traceable) -> key_by(traceable)
           -> window_aggregate(builtin device agg, traceable value_fn)

— so `graph.transformation.plan()` + `graph.fusion.plan_device_chains()`
classify the SQL windowed aggregate exactly like a DataStream one, and the
executor picks `DeviceChainRunner` (kernel K1) with no SQL-specific
runtime code at all.

Two source shapes:

- **columnar tables** (numeric Batch columns; field i of the non-rowtime
  schema order = column i, rowtime rides the batch timestamps): the WHERE
  mask, key extraction and value extraction are all emitted as traceable
  column functions — the whole prologue runs on the device inside each
  fused dispatch (the filter chain step is absorbed).
- **typed row-mode tables** (dict rows with declared numeric
  field_types): the planner emits a host vectorized columnarizer over
  exactly the pruned field set (physical projection pushdown), and the
  window still fuses with traced key/value extraction over the pruned
  layout — device window, host prologue.

The port's traceable UDFs take torch tensor columns on both routes (on
the device in the fused prologue, as CPU tensor views on the host route),
so the generated callables are torch forms: `col[:, i].to(torch.int32)`
where the JAX package emits `.astype("int32")`, and masks built from the
comparison table (`table/sql.py::CMP_OPS`), `&`/`|` on bool tensors and
the null-aware `a == a` NaN test. The columnarizer stays numpy.

The window terminal carries `sql_origin: True`; the runners carry it, and
the job's `job.sqlFusedSelected` gauge reads it.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from flink_tpu_torch.graph.transformation import Transformation
from flink_tpu_torch.planner.logical import LogicalPlan, render_predicate
from flink_tpu_torch.table.sql import CMP_OPS, BoolExpr, Operand


@dataclasses.dataclass
class LoweredQuery:
    """What the table layer wires up: the window terminal transformation
    (ready for DataStream wrapping + the shared windowed output stage)
    plus the plan facts the output stage needs."""

    terminal: Transformation
    group_col: str
    size_ms: int
    host_prologue: bool           # row-mode columnarizer in front
    device_agg: str

    @property
    def name(self) -> str:
        return self.terminal.name


def _column_layout(plan: LogicalPlan) -> List[str]:
    """Field -> column-index layout the traced extractors index into.

    Columnar tables keep their registration layout (every non-rowtime
    schema field, in order — the source's physical columns). Row-mode
    tables get the PRUNED layout: the columnarizer materializes only the
    fields the query reads (projection pushdown made physical)."""
    table = plan.scan.table
    if table.columnar:
        return [f for f in table.fields if f != table.rowtime]
    return [f for f in (plan.scan.required or [])
            if f != table.rowtime]


# Generated callables are memoized on their STRUCTURE (column index,
# predicate AST — frozen dataclasses, hashable): two plans of the same
# statement get the IDENTICAL function objects, which is what the fused
# pipeline's caches key on, so re-planning a statement (every job build,
# every bench sweep) hands back the same prologue.

@functools.lru_cache(maxsize=None)
def _key_extractor(i: int) -> Callable:
    return lambda col, _i=i: col[:, _i].to(torch.int32)


@functools.lru_cache(maxsize=None)
def _value_extractor(i: int) -> Callable:
    return lambda col, _i=i: col[:, _i]


def _operand_fn(op: Operand, index: Dict[str, int]) -> Callable:
    if op.kind == "column":
        i = index[op.value]
        return lambda col, _i=i: col[:, _i]
    v = op.value
    return lambda col, _v=v: _v


@functools.lru_cache(maxsize=256)
def _mask_fn_for(node, layout: Tuple[str, ...],
                 null_aware: bool) -> Callable:
    index = {f: i for i, f in enumerate(layout)}
    return _mask_fn(node, index, null_aware)


def _mask_fn(node, index: Dict[str, int], null_aware: bool) -> Callable:
    """Predicate AST -> columnar mask function ([n, F] tensor -> bool[n]).
    Elementwise `&`/`|` on bool tensors replace the row closure's and/or —
    identical semantics for pure comparisons over numeric columns.

    `null_aware` (row-mode tables, where the columnarizer encodes SQL
    NULL as NaN): every comparison is additionally masked by operand
    validity (`x == x` is False iff NaN), giving the interpreted path's
    three-valued semantics — NULL cmp anything is not-TRUE, including
    `!=`. Columnar sources have no NULL representation, so their masks
    stay plain (a genuine NaN float then compares exactly like the
    interpreted row view's NaN)."""
    if isinstance(node, BoolExpr):
        l = _mask_fn(node.left, index, null_aware)
        r = _mask_fn(node.right, index, null_aware)
        if node.op == "and":
            return lambda col, _l=l, _r=r: _l(col) & _r(col)
        return lambda col, _l=l, _r=r: _l(col) | _r(col)
    lhs = _operand_fn(node.left, index)
    rhs = _operand_fn(node.right, index)
    cmp = CMP_OPS[node.op]   # the dialect's one operator table, shared
    if not null_aware:
        return lambda col, _l=lhs, _r=rhs, _c=cmp: _c(_l(col), _r(col))

    def null_aware_cmp(col, _l=lhs, _r=rhs, _c=cmp):
        a, b = _l(col), _r(col)
        return _c(a, b) & (a == a) & (b == b)

    return null_aware_cmp


@functools.lru_cache(maxsize=256)
def _columnarizer(fields: Tuple[str, ...],
                  int_cols: Tuple[int, ...],
                  strict_cols: Tuple[int, ...]) -> Callable:
    """Dict rows -> [n, len(fields)] float32 (the record-mode bridge onto
    the device path; a loud KeyError/ValueError for malformed rows).

    NULL handling: predicate-only columns encode SQL NULL (None) as NaN
    — the null-aware masks then drop such rows exactly like the
    interpreted closures. `strict_cols` (the group key and the aggregate
    argument) REFUSE None loudly: a NULL group key has no dense device
    representation, and a NULL aggregate input is refused by the
    interpreted extraction too.

    Declared-int columns (`int_cols`) are round-trip checked: a value the
    float32 column cannot represent exactly (|v| >= 2**24) would silently
    alias another key/value on the device — the same never-silently-alias
    contract the traced key range check enforces, so it raises instead."""

    def columnarize(rows, _cols=fields, _ints=int_cols,
                    _strict=strict_cols):
        for i in _strict:
            f = _cols[i]
            if any(r[f] is None for r in rows):
                raise TypeError(
                    f"NULL in column {f!r}: the fused path's dense device "
                    "keying/aggregation has no NULL representation for "
                    "GROUP BY keys or aggregate arguments — clean the "
                    "column or set table.device-fusion false")
        arr = np.asarray(
            [[(np.nan if r[f] is None else float(r[f])) for f in _cols]
             for r in rows],
            dtype=np.float64,
        )
        out = arr.astype(np.float32)
        if _ints and len(out) and not np.array_equal(
                np.nan_to_num(out[:, _ints]).astype(np.int64),
                np.nan_to_num(arr[:, _ints]).astype(np.int64)):
            bad = [_cols[i] for i in _ints
                   if len(out) and not np.array_equal(
                       np.nan_to_num(out[:, i]).astype(np.int64),
                       np.nan_to_num(arr[:, i]).astype(np.int64))]
            raise TypeError(
                f"int column(s) {bad} hold values float32 cannot represent "
                "exactly (|v| >= 2**24): columnarizing would silently alias "
                "distinct keys/values on the device path — keep such "
                "columns out of fused statements or set "
                "table.device-fusion false")
        return out

    return columnarize


def lower(plan: LogicalPlan, source: Transformation) -> LoweredQuery:
    """Emit the fused-path transformation chain for an OPTIMIZED plan on
    top of the table's source transformation. Requires rules.optimize to
    have run (slice/aggregate/pushdown annotations present)."""
    table = plan.scan.table
    wa = plan.window_agg
    assert wa.agg.device_agg is not None and wa.window.slice_ms is not None, \
        "lower() needs an optimized plan (run planner.rules.optimize first)"

    layout = tuple(_column_layout(plan))
    index = {f: i for i, f in enumerate(layout)}
    prev = source
    host_prologue = not table.columnar
    if host_prologue:
        int_cols = tuple(i for i, f in enumerate(layout)
                         if table.type_of(f) == "int")
        strict = {wa.group_col}
        if wa.agg.arg is not None:
            strict.add(wa.agg.arg)
        strict_cols = tuple(i for i, f in enumerate(layout) if f in strict)
        prev = Transformation(
            "map", f"sql_columnarize[{','.join(layout)}]", [prev],
            {"fn": _columnarizer(layout, int_cols, strict_cols),
             "vectorized": True, "traceable": False, "sql_origin": True},
        )
    if plan.filter is not None:
        mask = _mask_fn_for(plan.filter.pred, layout,
                            null_aware=host_prologue)
        prev = Transformation(
            "filter", f"sql_where[{render_predicate(plan.filter.pred)}]",
            [prev],
            {"fn": mask, "vectorized": True, "traceable": True,
             "sql_origin": True},
        )

    key_fn = _key_extractor(index[wa.group_col])
    keyed = Transformation(
        "key_by", f"sql_key[{wa.group_col}]", [prev],
        {"key_selector": key_fn, "vectorized": True, "traceable": True,
         "sql_origin": True},
    )

    value_fn: Optional[Callable] = None
    if wa.agg.arg is not None:
        value_fn = _value_extractor(index[wa.agg.arg])

    terminal = Transformation(
        "window_aggregate", f"sql_{wa.agg.func.lower()}", [keyed],
        {
            "assigner": _assigner(wa.window),
            "aggregate": wa.agg.device_agg,
            "value_fn": value_fn,
            "value_vectorized": value_fn is not None,
            "value_traceable": value_fn is not None,
            "window_fn": None,
            "trigger": None,
            "evictor": None,
            "allowed_lateness": 0,
            "side_output_late": False,
            "key_selector": key_fn,
            "key_vectorized": True,
            "key_traceable": True,
            "sql_origin": True,
        },
    )
    return LoweredQuery(
        terminal=terminal,
        group_col=wa.group_col,
        size_ms=wa.window.size_ms,
        host_prologue=host_prologue,
        device_agg=wa.agg.device_agg,
    )


def _assigner(window) -> Any:
    """Normalized window -> the port's sliceable assigner. The api import
    is function-scoped, so importing the planner never drags the
    api/runtime stack in."""
    from flink_tpu_torch.api.windowing.assigners import (
        SlidingEventTimeWindows,
        TumblingEventTimeWindows,
    )

    if window.kind == "tumble":
        return TumblingEventTimeWindows.of(window.size_ms)
    return SlidingEventTimeWindows.of(window.size_ms, window.slide_ms)
