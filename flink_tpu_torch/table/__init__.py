"""Table/SQL layer, counterpart of `flink_tpu/table` (reference:
flink-table — parser, planner, runtime). A compact dialect covering the
streaming-aggregation core: windowed GROUP BY over TUMBLE/HOP/SESSION,
WHERE filters, HAVING, per-window ORDER BY/LIMIT, continuous GROUP BY and
the standard aggregate functions, translated onto the port's DataStream
plan (and therefore onto its device window operators; `planner/` lowers
windowed single aggregates onto the fused device chain and kernel K1)."""

from flink_tpu_torch.table.changelog import (  # noqa: F401
    DELETE,
    INSERT,
    ROW_KIND_FIELD,
    UPDATE_AFTER,
    UPDATE_BEFORE,
    materialize,
    row_kind,
    with_kind,
)
from flink_tpu_torch.table.sql import SqlParseError, parse_query  # noqa: F401
from flink_tpu_torch.table.table_env import TableEnvironment, TableSchema  # noqa: F401
