"""TableEnvironment: SQL over registered streaming tables.

Counterpart of `flink_tpu/table/table_env.py`. Reference: TableEnvironment
+ the planner's translation of windowed GROUP BY queries into DataStream
transformations (flink-table-planner; group windows lower onto the same
WindowOperator machinery — here onto the port's device window operators
via its DataStream API).

Rows are dicts keyed by schema field names. `sql_query` parses, plans
(`planner/`) and translates a statement:

- a windowed single-aggregate GROUP BY over a typed table lowers onto the
  fused step graph (`DeviceChainRunner`, kernel K1);
- every other statement takes the interpreted translation, with the
  planner's catalogued reason in `last_plan_report`: a single device
  aggregate over TUMBLE/HOP on the fused or per-batch window operator,
  SESSION on the session operator (kernels K3/K4), several aggregates on
  a composite accumulator (`_MultiAgg`) over the per-record oracle window
  operator, a non-windowed GROUP BY on the continuous aggregate
  (`GroupAggRunner`), a projection on a map.

What the port does not carry yet raises, naming its ROADMAP.md item, and
never falls back to another route: UNION ALL (item 19), joins (item 12)
and ML_PREDICT (item 14). The planner still reports those statements'
paths and reasons exactly as the JAX package does; only execution raises.

A TableEnvironment takes its device from its StreamExecutionEnvironment
(CUDA unless it was made with device="cpu").
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

from flink_tpu_torch.api.datastream import DataStream, StreamExecutionEnvironment
from flink_tpu_torch.api.functions import AggregateFunction
from flink_tpu_torch.api.windowing.assigners import (
    EventTimeSessionWindows,
    SlidingEventTimeWindows,
    TumblingEventTimeWindows,
)
from flink_tpu_torch.core.watermarks import WatermarkStrategy
# the aggregate map is single-sourced with planner/rules
from flink_tpu_torch.table.sql import DEVICE_AGG_OF as _DEVICE_AGG
from flink_tpu_torch.table.sql import Query, SelectItem, parse_query
from flink_tpu_torch.utils import deferred


@dataclasses.dataclass
class TableSchema:
    fields: List[str]
    rowtime: Optional[str] = None          # event-time column (ms)
    watermark_delay_ms: int = 0            # bounded out-of-orderness
    # optional declared field types ('int' | 'float' | 'str', one per
    # field): what lets the SQL planner prove numeric columns at plan time
    # and lower the statement onto the fused device path. Untyped row-mode
    # tables always take the interpreted path.
    field_types: Optional[List[str]] = None

    def __post_init__(self):
        if self.field_types is not None and \
                len(self.field_types) != len(self.fields):
            raise ValueError(
                f"field_types ({len(self.field_types)}) must match fields "
                f"({len(self.fields)})")

    def py_cast(self, field: str):
        """Python-type cast for a field's values (identity when untyped)."""
        if self.field_types is None:
            return lambda v: v
        t = self.field_types[self.fields.index(field)]
        return {"int": int, "float": float, "str": str}.get(t, lambda v: v)


@dataclasses.dataclass
class _Table:
    stream: DataStream
    schema: TableSchema
    # columnar: the stream carries numeric [n, F] batches where column i is
    # the i-th non-rowtime schema field and the rowtime rides the batch
    # timestamps — the device-ready registration the fused SQL path stages
    # straight into the dispatch. Row-mode (dict) tables interpret, or
    # fuse window-only when field_types declare numeric columns.
    columnar: bool = False


class _MultiAgg(AggregateFunction):
    """Composite accumulator for multi-aggregate SELECTs, run on the
    per-record oracle window operator (JAX `table_env._MultiAgg`)."""

    def __init__(self, items: List[SelectItem]):
        self.items = items

    def create_accumulator(self):
        return [
            {"count": 0, "sum": 0.0, "min": float("inf"), "max": float("-inf")}
            for _ in self.items
        ]

    def add(self, row, accs):
        out = []
        for item, acc in zip(self.items, accs):
            v = 1.0 if item.name == "*" else float(row[item.name])
            out.append({
                "count": acc["count"] + 1,
                "sum": acc["sum"] + (0 if item.name == "*" else v),
                "min": min(acc["min"], v),
                "max": max(acc["max"], v),
            })
        return out

    def get_result(self, accs):
        vals = []
        for item, acc in zip(self.items, accs):
            if item.func == "COUNT":
                vals.append(acc["count"])
            elif item.func == "SUM":
                vals.append(acc["sum"])
            elif item.func == "MIN":
                vals.append(acc["min"])
            elif item.func == "MAX":
                vals.append(acc["max"])
            elif item.func == "AVG":
                vals.append(acc["sum"] / max(acc["count"], 1))
        return tuple(vals)

    def merge(self, a, b):
        return [
            {
                "count": x["count"] + y["count"],
                "sum": x["sum"] + y["sum"],
                "min": min(x["min"], y["min"]),
                "max": max(x["max"], y["max"]),
            }
            for x, y in zip(a, b)
        ]


class TableEnvironment:
    def __init__(self, env: Optional[StreamExecutionEnvironment] = None):
        self.env = env or StreamExecutionEnvironment.get_execution_environment()
        self._tables: Dict[str, _Table] = {}
        # planning outcome of the last sql_query()/execute_sql* call — the
        # gateway reports it per statement (executionPath + fallbackReason)
        self.last_plan_report = None

    # -- registration -----------------------------------------------------
    def register_model(self, name: str, provider) -> None:
        """Register a model for SQL ML_PREDICT: not ported yet."""
        raise deferred.not_ported("TableEnvironment.register_model (ML_PREDICT)", deferred.ML)

    def register_table(self, name: str, stream: DataStream,
                       schema: TableSchema, columnar: bool = False) -> None:
        """Register a stream as a table. `columnar=True` declares the
        device-ready contract: the stream's batches are numeric [n, F]
        columns, column i = the i-th non-rowtime schema field, event time
        rides the batch timestamps. Columnar tables are what the SQL
        planner fuses whole; the interpreted path reads them through a
        per-record row view."""
        self._tables[name] = _Table(stream, schema, columnar=columnar)

    def from_rows(self, name: str, rows: Sequence[dict], schema: TableSchema) -> None:
        """Register an in-memory table (fromValues analogue)."""
        strategy = None
        ts_fn = None
        if schema.rowtime:
            rt = schema.rowtime
            ts_fn = lambda row: int(row[rt])  # noqa: E731
            strategy = WatermarkStrategy.for_bounded_out_of_orderness(
                schema.watermark_delay_ms
            )
        stream = self.env.from_collection(list(rows), timestamp_fn=ts_fn,
                                          watermark_strategy=strategy)
        self.register_table(name, stream, schema)

    def table(self, name: str):
        """Fluent Table API handle (table/api.py)."""
        from flink_tpu_torch.table.api import Table

        return Table(self, name)

    # -- queries ----------------------------------------------------------
    def sql_query(self, sql: str) -> DataStream:
        # cleared BEFORE parsing: a statement that fails to parse or
        # translate must not inherit the previous statement's report (the
        # gateway stamps this onto the operation as executionPath)
        self.last_plan_report = None
        q = parse_query(sql)
        return self._plan_and_translate(q)

    def explain_sql(self, sql: str):
        """Plan-only view of a statement: the SqlPlanReport the planner
        produces (fused logical tree, or the attributed fallback reason)."""
        from flink_tpu_torch.config import TableOptions
        from flink_tpu_torch.planner import SqlPlanReport, plan_query

        q = parse_query(sql)
        if not self.env.config.get(TableOptions.DEVICE_FUSION):
            return SqlPlanReport(path="interpreted", reason="disabled",
                                 detail="table.device-fusion is false")
        return plan_query(q, self._catalog())

    def _catalog(self):
        from flink_tpu_torch.planner import TableInfo

        return {
            name: TableInfo(
                name=name,
                fields=tuple(t.schema.fields),
                rowtime=t.schema.rowtime,
                field_types=(tuple(t.schema.field_types)
                             if t.schema.field_types is not None else None),
                columnar=t.columnar,
            )
            for name, t in self._tables.items()
        }

    def _plan_and_translate(self, q: Query) -> DataStream:
        """Route through the SQL planner behind table.device-fusion:
        fused-lowerable statements go onto the fused device path; everything
        else keeps the interpreted translation below, with the reason
        recorded in `last_plan_report`."""
        from flink_tpu_torch.config import TableOptions
        from flink_tpu_torch.planner import SqlPlanReport, plan_query

        if not self.env.config.get(TableOptions.DEVICE_FUSION):
            self.last_plan_report = SqlPlanReport(
                path="interpreted", reason="disabled",
                detail="table.device-fusion is false")
            return self._translate(q)
        report = plan_query(
            q, self._catalog(),
            sources={n: t.stream.transform
                     for n, t in self._tables.items()},
        )
        self.last_plan_report = report
        if report.fused and q.join is not None:
            # a fused windowed join (the JAX package's DeviceJoinRunner)
            return self._join_query(q)
        if report.lowered is None:
            return self._translate(q)
        low = report.lowered
        result = DataStream(self.env, low.terminal)
        return self._windowed_output_stage(
            result, q, [low.group_col], extract=None)

    def _translate(self, q: Query) -> DataStream:
        if q.union_all is not None:
            # branch schemas must agree, as in standard SQL (the JAX
            # package's check, before anything runs)
            left_cols = [i.output_name for i in q.select]
            right_cols = [i.output_name for i in q.union_all.select]
            if left_cols != right_cols:
                raise ValueError(
                    f"UNION ALL branches must produce the same columns: "
                    f"{left_cols} vs {right_cols} (use AS aliases)"
                )
            raise deferred.not_ported("SQL UNION ALL (DataStream.union)", deferred.API)
        if q.table not in self._tables:
            raise KeyError(f"unknown table {q.table!r}; registered: {list(self._tables)}")
        table = self._tables[q.table]
        stream = self._row_stream(table)

        if q.join is not None:
            return self._join_query(q)

        if q.where is not None:
            pred = q.where
            stream = stream.filter(pred, name=f"where[{q.where_text}]")

        aggs = [i for i in q.select if i.kind == "agg"]
        preds = [i for i in q.select if i.kind == "ml_predict"]
        if not aggs and (q.order_by or q.limit is not None):
            raise NotImplementedError(
                "ORDER BY / LIMIT are defined per window (streaming top-N); "
                "use them on a windowed GROUP BY aggregate query"
            )
        if not aggs and (q.having is not None or q.group_by):
            raise NotImplementedError(
                "GROUP BY / HAVING require aggregate select items with a "
                "TUMBLE/HOP/SESSION window"
            )
        if not aggs:
            if preds:
                raise deferred.not_ported("SQL ML_PREDICT", deferred.ML)
            # projection query
            from flink_tpu_torch.table.changelog import carry_kind

            cols = [i for i in q.select if i.kind == "column"]

            def project(row, _cols=cols):
                return carry_kind(
                    {c.output_name: row[c.name] for c in _cols}, row)

            return stream.map(project, name="project")
        if preds:
            raise NotImplementedError(
                "ML_PREDICT inside windowed aggregate queries is not supported; "
                "apply it in a follow-up projection query"
            )
        if q.window is None:
            # continuous (non-windowed) aggregation: emits a retract
            # changelog (GroupAggFunction analogue; table/changelog.py)
            return self._continuous_agg_query(q, stream)
        if not q.group_by:
            raise NotImplementedError(
                "windowed aggregate queries require GROUP BY columns "
                "alongside the TUMBLE/HOP/SESSION window"
            )
        # unknown columns fail at translation with a diagnostic, not as a
        # per-record KeyError from inside the key/value selectors
        known = set(table.schema.fields)
        missing = [c for c in q.group_by if c not in known] + [
            i.name for i in aggs if i.name != "*" and i.name not in known
        ]
        if missing:
            raise ValueError(
                f"unknown column(s) {sorted(set(missing))} in GROUP "
                f"BY/aggregates; table {q.table!r} declares "
                f"{table.schema.fields}")
        return self._grouped_window_query(q, stream)

    def _row_stream(self, table: _Table) -> DataStream:
        """Dict-row view of a table for the interpreted path. Row-mode
        tables pass through; columnar tables get a per-record adapter
        (vector row + batch timestamp -> schema dict, cast through the
        declared field types so both paths emit the same Python values)."""
        if not table.columnar:
            return table.stream
        schema = table.schema
        rowtime = schema.rowtime
        value_fields = [f for f in schema.fields if f != rowtime]
        casts = [schema.py_cast(f) for f in value_fields]

        def to_row(v, ts, _fs=tuple(value_fields), _casts=tuple(casts),
                   _rt=rowtime):
            row = {f: c(v[i]) for i, (f, c) in enumerate(zip(_fs, _casts))}
            if _rt is not None:
                row[_rt] = int(ts)
            return row

        return table.stream.map_with_timestamp(to_row, name="sql_row_view")

    def _continuous_agg_query(self, q: Query, stream: DataStream) -> DataStream:
        """Non-windowed GROUP BY: continuous aggregation over the unbounded
        stream, emitting updates/retractions as the groups evolve
        (StreamExecGroupAggregate -> GroupAggFunction.java:33) on the
        port's GroupAggRunner. The result is a changelog stream;
        registering it as a table and aggregating again composes (cascading
        retraction)."""
        aggs = [i for i in q.select if i.kind == "agg"]
        if q.having is not None or q.order_by or q.limit is not None:
            raise NotImplementedError(
                "HAVING/ORDER BY/LIMIT on continuous (non-windowed) "
                "aggregates are not supported; window the query or apply "
                "them downstream"
            )
        if any(i.kind in ("window_start", "window_end") for i in q.select):
            raise ValueError(
                "WINDOW_START/WINDOW_END require a TUMBLE/HOP/SESSION window")
        for i in q.select:
            if i.kind == "column" and i.name not in q.group_by:
                raise ValueError(
                    f"SELECT column {i.name!r} must appear in GROUP BY "
                    "(non-grouped columns are not defined for aggregates)")
        group_cols = list(q.group_by)
        if group_cols:
            key_fn = (
                (lambda row, c=group_cols[0]: row[c])
                if len(group_cols) == 1
                else (lambda row, cs=tuple(group_cols): tuple(row[c] for c in cs))
            )
        else:
            key_fn = lambda row: 0    # noqa: E731 — global aggregate
        specs = [(i.func, None if i.name == "*" else i.name) for i in aggs]
        key_fields = []
        for c in group_cols:
            item = next((i for i in q.select
                         if i.kind == "column" and i.name == c), None)
            key_fields.append(item.output_name if item is not None else c)
        out_names = [i.output_name for i in aggs]
        keyed = stream.key_by(
            key_fn, name=f"group_by[{','.join(group_cols) or 'GLOBAL'}]")
        result = keyed.continuous_aggregate(
            specs, key_fields, out_names, name="sql_group_agg")
        # SQL projection: GROUP BY columns not in the SELECT list must not
        # appear in output rows (the operator needs the full key to name
        # its fields; trim here, keeping the changelog kind — retraction
        # stays sound because -U/-D carry the full PROJECTED row and
        # materialization is multiset-based)
        selected = [i.output_name for i in q.select]
        if any(kf not in selected for kf in key_fields):
            from flink_tpu_torch.table.changelog import carry_kind

            def trim(row, _sel=tuple(selected)):
                return carry_kind({c: row[c] for c in _sel}, row)

            result = result.map(trim, name="sql_group_agg_project")
        return result

    def _grouped_window_query(self, q: Query, stream: DataStream) -> DataStream:
        """Windowed GROUP BY translation shared by SQL and the fluent Table
        API (both lower onto the same DataStream window machinery, like the
        reference's two APIs lowering onto one planner)."""
        aggs = [i for i in q.select if i.kind == "agg"]
        group_cols = list(q.group_by)
        key_fn = (
            (lambda row, c=group_cols[0]: row[c])
            if len(group_cols) == 1
            else (lambda row, cs=tuple(group_cols): tuple(row[c] for c in cs))
        )
        assigner = self._assigner(q)
        keyed = stream.key_by(key_fn, name=f"group_by[{','.join(group_cols)}]")
        windowed = keyed.window(assigner)

        if len(aggs) == 1 and aggs[0].func in _DEVICE_AGG:
            item = aggs[0]
            value_fn = None if item.name == "*" else (
                lambda row, c=item.name: float(row[c])
            )
            result = windowed.aggregate(
                _DEVICE_AGG[item.func], value_fn, name=f"sql_{item.func.lower()}"
            )
            extract = None                # single device agg: result IS rec[1]
        else:
            result = windowed.aggregate(_MultiAgg(aggs), name="sql_multi_agg")
            extract = tuple               # composite accumulator result
        # mark the SQL origin on the interpreted path's window terminal too
        result.transform.config["sql_origin"] = True
        return self._windowed_output_stage(result, q, group_cols, extract)

    def _windowed_output_stage(self, result: DataStream, q: Query,
                               group_cols: List[str], extract) -> DataStream:
        """Post-window host stage shared VERBATIM by the interpreted path
        and the planner's fused lowering: output-row assembly + HAVING +
        per-window top-N. One implementation is what makes the two paths'
        rows identical by construction (the three-way parity bar)."""
        # assemble output rows: group cols + aggregates + window bounds
        # (emission timestamp = window.maxTimestamp ⇒ end = ts+1,
        # start = end - size; session windows get end-only fidelity).
        # The assembler is CODE-GENERATED as one dict-literal lambda over
        # (rec, ts): it runs once per emitted window on the hot fused path,
        # where a generic kind-dispatch loop would cost more than the
        # dispatch saves.
        size_ms = q.window.size_ms
        topn = bool(q.order_by) or q.limit is not None
        single = extract is None          # single device aggregate: rec[1]
        parts = []
        ai = 0
        for item in q.select:
            if item.kind == "column":
                if item.name not in group_cols:
                    # non-grouped columns are undefined for aggregates; a
                    # silent key-value stand-in would be plausibly-shaped
                    # wrong data (the continuous-agg path already refuses)
                    raise ValueError(
                        f"SELECT column {item.name!r} must appear in "
                        "GROUP BY (non-grouped columns are not defined "
                        "for aggregates)")
                expr = ("rec[0]" if len(group_cols) == 1
                        else f"rec[0][{group_cols.index(item.name)}]")
            elif item.kind == "agg":
                expr = "rec[1]" if single else f"_ex(rec[1])[{ai}]"
                ai += 1
            elif item.kind == "window_end":
                expr = "ts + 1"
            elif item.kind == "window_start":
                expr = f"ts + 1 - {size_ms}"
            else:
                continue
            parts.append(f"{item.output_name!r}: {expr}")
        if topn:
            parts.append("'__wend': ts + 1")  # per-window key (internal)
        src = f"lambda rec, ts: {{{', '.join(parts)}}}"
        to_row = eval(src, {"__builtins__": {}, "_ex": extract})  # noqa: S307
        to_row.__sql_codegen__ = src       # introspection/debugging handle

        out = result.map_with_timestamp(to_row, name="sql_output")
        if q.having is not None:
            out = out.filter(q.having, name=f"having[{q.having_text}]")
        if topn:
            # streaming top-N (the reference expresses this as ROW_NUMBER()
            # OVER per window; here ORDER BY/LIMIT rank WITHIN each window).
            # A window's rows all emit in the step its trigger fires, so
            # ranking groups by window inside the step batch — no
            # cross-batch state needed. Vectorized flat_map: N rows in,
            # ranked/cut rows out, timestamps follow the source index.
            known = {i.output_name for i in q.select}
            for col, _desc in q.order_by:
                if col not in known:
                    raise ValueError(
                        f"ORDER BY column {col!r} is not produced by the "
                        f"SELECT list (available: {sorted(known)})"
                    )
            order_by, limit = list(q.order_by), q.limit

            def rank_vec(vals):
                from itertools import groupby

                import numpy as _np

                from flink_tpu_torch.utils.arrays import obj_array

                rows = list(vals)
                by_w = sorted(range(len(rows)),
                              key=lambda i: rows[i]["__wend"])
                out_vals, out_idx = [], []
                for _w, grp in groupby(by_w, key=lambda i: rows[i]["__wend"]):
                    grp = list(grp)
                    for col, desc in reversed(order_by):
                        grp.sort(key=lambda i, c=col: rows[i][c],
                                 reverse=desc)
                    if limit is not None:
                        grp = grp[:limit]
                    for i in grp:
                        r = dict(rows[i])
                        r.pop("__wend", None)
                        out_vals.append(r)
                        out_idx.append(i)
                return obj_array(out_vals), _np.asarray(out_idx,
                                                        dtype=_np.int64)

            # ranking is global per window: pin the rank step to ONE
            # parallel instance (GlobalPartitioner hint)
            out = out.global_().flat_map(rank_vec, name="sql_topn",
                                         vectorized=True)
        return out

    def _join_query(self, q: Query) -> DataStream:
        """SQL joins (windowed, regular and outer): not ported yet."""
        j = q.join
        kind = "windowed" if j.window is not None else "regular"
        raise deferred.not_ported(
            f"SQL {kind} {j.join_type.upper()} JOIN {q.table} / {j.table2}", deferred.JOINS)

    def execute_sql_to_list(self, sql: str) -> List[dict]:
        """Convenience: run the query to completion, return rows. A
        changelog result (continuous aggregate) is MATERIALIZED: the
        retractions are applied and the surviving rows returned (the
        reference's retract-sink view of the stream)."""
        from flink_tpu_torch.table.changelog import ROW_KIND_FIELD, materialize

        rows = self.execute_sql_to_changelog(sql)
        if any(isinstance(r, dict) and ROW_KIND_FIELD in r for r in rows):
            return materialize(rows)
        return rows

    def execute_sql_to_changelog(self, sql: str) -> List[dict]:
        """Run the query to completion and return the RAW emitted rows —
        for changelog queries these carry their row kinds
        (table/changelog.py) in emission order."""
        sink = self.sql_query(sql).collect()
        self.env.execute("sql-query")
        return sink.results

    def _assigner(self, q: Query):
        return self._assigner_for(q.window)

    def _assigner_for(self, w):
        if w.kind == "tumble":
            return TumblingEventTimeWindows.of(w.size_ms)
        if w.kind == "hop":
            return SlidingEventTimeWindows.of(w.size_ms, w.slide_ms)
        if w.kind == "session":
            return EventTimeSessionWindows.with_gap(w.size_ms)
        raise ValueError(w.kind)
