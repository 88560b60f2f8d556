"""SQL planner: table plans → step graph, onto the fused device path.

Counterpart of `flink_tpu/planner/`. The SQL front door translates parsed
`Query` objects (table/sql.py) into logical relational plans
(planner/logical.py), optimizes them (planner/rules.py: predicate pushdown
below the window, projection pruning, window-spec normalization onto the
sliceable assigners, agg-call → DeviceAggregator mapping), and lowers them
(planner/lowering.py) into the same transformation chain the DataStream
API records — so `graph.transformation.plan()` + `graph/fusion.py`
classify SQL windowed aggregates as device-fusable and `DeviceChainRunner`
runs them on kernel K1.

Statements outside the fused core take the interpreted TableEnvironment
path with a catalogued reason (`FALLBACK_CATALOG`). The reasons are the
JAX package's, statement for statement, including those of statements the
port cannot execute yet (joins, UNION ALL, ML_PREDICT: planning reports
them, execution raises naming their ROADMAP item).
`TableEnvironment.sql_query` routes through here behind
`table.device-fusion` (default on); `explain_sql` returns the report this
module produces.

Layering: may import table/graph/core/config — never runtime or api;
assigner construction is a function-scoped lazy import.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

from flink_tpu_torch.planner.logical import (  # noqa: F401 — public surface
    FALLBACK_CATALOG,
    JoinLogicalPlan,
    LogicalPlan,
    TableInfo,
    Unsupported,
    build_logical_plan,
)
from flink_tpu_torch.planner.lowering import LoweredQuery, lower
from flink_tpu_torch.planner.rules import optimize
from flink_tpu_torch.table.sql import Query


@dataclasses.dataclass
class SqlPlanReport:
    """Per-statement planning outcome: which path was selected and why.

    `path` is 'fused' or 'interpreted'; on fallback, `reason` is a
    FALLBACK_CATALOG code and `detail` the specific trigger. `plan` holds
    the optimized logical tree for fused statements (golden-test /
    EXPLAIN surface); `lowered` the emitted chain when a source
    transformation was provided."""

    path: str
    reason: Optional[str] = None
    detail: Optional[str] = None
    plan: Optional[LogicalPlan] = None
    lowered: Optional[LoweredQuery] = None

    @property
    def fused(self) -> bool:
        return self.path == "fused"

    def describe(self) -> str:
        if self.fused and self.plan is not None:
            return self.plan.describe()
        return f"interpreted[{self.reason}]: {self.detail}"


def plan_query(
    q: Query,
    catalog: Dict[str, TableInfo],
    sources: Optional[Dict[str, object]] = None,
) -> SqlPlanReport:
    """Plan one parsed statement against the catalog.

    `sources` maps table name -> source Transformation; when provided and
    the statement is fused-lowerable, the report carries the emitted
    LoweredQuery ready for execution. Without sources the report is
    plan-only (EXPLAIN / golden tests)."""
    try:
        plan = optimize(build_logical_plan(q, catalog))
    except Unsupported as u:
        return SqlPlanReport(path="interpreted", reason=u.reason,
                             detail=u.detail)
    lowered = None
    if sources is not None:
        if isinstance(plan, JoinLogicalPlan):
            # fused windowed join: the planner validated the shape; the
            # two-input stream is built by the table layer, which raises
            # until the port carries joins (ROADMAP item 12). The report
            # stays `lowered=None` by design, as in the JAX package.
            for name in (q.table, q.join.table2):
                if sources.get(name) is None:
                    return SqlPlanReport(
                        path="interpreted", reason="unknown-table",
                        detail=f"no source for {name!r}")
        else:
            src = sources.get(q.table)
            if src is None:
                return SqlPlanReport(
                    path="interpreted", reason="unknown-table",
                    detail=f"no source for {q.table!r}")
            lowered = lower(plan, src)
    return SqlPlanReport(path="fused", plan=plan, lowered=lowered)
