"""Fluent Table API over registered streaming tables.

Counterpart of `flink_tpu/table/api.py`. The reference's Table API
(flink-table-api-java: Table.select/filter/groupBy/window with
Tumble/Slide/Session group windows) is the programmatic
sibling of SQL; both lower onto the same planner. Here a `Table` is a thin
builder over the dict-row DataStream machinery `TableEnvironment` already
uses for SQL — windowed aggregations take the device window operator
exactly like their SQL equivalents.

    t = tenv.table("clicks")
    result = (
        t.where(lambda r: r["price"] > 10)
         .window(Tumble.of_ms(10_000))
         .group_by("campaign")
         .aggregate(total=("sum", "price"))
    )
    rows = result.to_list()

One aggregate a call: several (a composite accumulator on the per-record
oracle operator) raise until the port carries that operator (ROADMAP.md
Queue A, item 18).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Tuple

from flink_tpu_torch.table.sql import SelectItem, WindowSpec

_AGGS = {"count", "sum", "min", "max", "avg"}


@dataclasses.dataclass(frozen=True)
class _GroupWindow:
    spec: WindowSpec


class Tumble:
    @staticmethod
    def of_ms(size_ms: int) -> _GroupWindow:
        return _GroupWindow(WindowSpec("tumble", "", size_ms=size_ms))


class Slide:
    @staticmethod
    def of_ms(size_ms: int, slide_ms: int) -> _GroupWindow:
        return _GroupWindow(WindowSpec("hop", "", size_ms=size_ms,
                                       slide_ms=slide_ms))


class Session:
    @staticmethod
    def with_gap_ms(gap_ms: int) -> _GroupWindow:
        return _GroupWindow(WindowSpec("session", "", size_ms=gap_ms))


class Table:
    """Immutable fluent builder; terminal ops hand off to the planner."""

    def __init__(self, tenv, name: str):
        self._tenv = tenv
        self._name = name
        self._filters: List[Tuple[Callable[[dict], bool], str]] = []
        self._projection: Optional[List[str]] = None
        self._window: Optional[_GroupWindow] = None
        self._keys: List[str] = []
        self._having: Optional[Tuple[Callable[[dict], bool], str]] = None
        self._order: List[Tuple[str, bool]] = []
        self._limit: Optional[int] = None

    def _copy(self) -> "Table":
        t = Table(self._tenv, self._name)
        t._filters = list(self._filters)
        t._projection = list(self._projection) if self._projection else None
        t._window = self._window
        t._keys = list(self._keys)
        t._having = self._having
        t._order = list(self._order)
        t._limit = self._limit
        return t

    # -- relational ops ---------------------------------------------------
    def where(self, pred: Callable[[dict], bool],
              label: str = "<callable>") -> "Table":
        t = self._copy()
        t._filters.append((pred, label))
        return t

    filter = where

    def select(self, *columns: str) -> "Table":
        t = self._copy()
        t._projection = list(columns)
        return t

    def window(self, w: _GroupWindow) -> "Table":
        t = self._copy()
        t._window = w
        return t

    def group_by(self, *keys: str) -> "Table":
        t = self._copy()
        t._keys = list(keys)
        return t

    def having(self, pred: Callable[[dict], bool],
               label: str = "<callable>") -> "Table":
        """Post-aggregation filter over OUTPUT rows (SQL HAVING)."""
        t = self._copy()
        t._having = (pred, label)
        return t

    def order_by(self, *cols: str) -> "Table":
        """Per-window ordering of the aggregate output (streaming top-N
        when combined with limit); prefix a column with '-' for DESC."""
        t = self._copy()
        t._order = [(c.lstrip("-"), c.startswith("-")) for c in cols]
        return t

    def limit(self, n: int) -> "Table":
        t = self._copy()
        t._limit = n
        return t

    # -- terminals --------------------------------------------------------
    def _base_stream(self):
        tab = self._tenv._tables.get(self._name)
        if tab is None:
            raise KeyError(
                f"unknown table {self._name!r}; registered: "
                f"{list(self._tenv._tables)}")
        # columnar tables read through the dict-row view here: the fluent
        # API's predicates/projections are row closures (the SQL planner's
        # fused lowering is the columnar consumer)
        stream = self._tenv._row_stream(tab)
        for pred, label in self._filters:
            stream = stream.filter(pred, name=f"where[{label}]")
        return stream

    def aggregate(self, **aggs: Tuple[str, ...]):
        """Windowed grouped aggregation: kwargs name the outputs,
        values are ('count',) / ('count', '*') / ('sum'|'min'|'max'|'avg',
        column). Returns a dict-row DataStream (device operator for a
        single device-resolvable aggregate, same as SQL)."""
        if self._window is None:
            raise ValueError("aggregate() requires .window(Tumble/Slide/Session)")
        if not self._keys:
            raise ValueError("aggregate() requires .group_by(keys)")
        items: List[SelectItem] = [
            SelectItem("column", k) for k in self._keys
        ]
        if self._projection is not None:
            raise ValueError(
                "select() composes with projection terminals; name aggregate "
                "outputs via the aggregate(...) kwargs instead")
        for out_name, spec in aggs.items():
            func = spec[0].lower()
            if func not in _AGGS:
                raise ValueError(f"unknown aggregate {spec[0]!r}")
            if func != "count" and (len(spec) < 2 or spec[1] == "*"):
                raise ValueError(
                    f"{func}() needs a column, e.g. ('{func}', 'price')")
            arg = spec[1] if len(spec) > 1 else "*"
            items.append(SelectItem("agg", arg, func=func.upper(),
                                    alias=out_name))
        from flink_tpu_torch.table.sql import Query

        having = self._having[0] if self._having else None
        q = Query(items, self._name, None, None, list(self._keys),
                  self._window.spec, having=having,
                  having_text=self._having[1] if self._having else None,
                  order_by=list(self._order), limit=self._limit)
        stream = self._base_stream()
        return TableResult(self._tenv,
                           self._tenv._grouped_window_query(q, stream))

    def to_stream(self):
        """Projection terminal: the filtered (+selected) dict-row stream."""
        if self._window is not None or self._keys:
            raise ValueError(
                "window()/group_by() require the aggregate(...) terminal; "
                "to_stream()/to_list() are projection terminals")
        if self._having is not None or self._order or self._limit is not None:
            raise ValueError(
                "having()/order_by()/limit() apply to windowed aggregates; "
                "use them with the aggregate(...) terminal")
        stream = self._base_stream()
        if self._projection:
            cols = list(self._projection)
            stream = stream.map(
                lambda row, _c=tuple(cols): {k: row[k] for k in _c},
                name=f"select[{','.join(cols)}]")
        return stream

    def to_list(self) -> List[dict]:
        return TableResult(self._tenv, self.to_stream()).to_list()


class TableResult:
    """Materialization handle for a terminal table operation."""

    def __init__(self, tenv, stream):
        self._tenv = tenv
        self._stream = stream

    def to_stream(self):
        return self._stream

    def to_list(self) -> List[dict]:
        sink = self._stream.collect()
        self._tenv.env.execute("table-query")
        return sink.results
