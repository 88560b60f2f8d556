"""SQL parser for the streaming-aggregation dialect.

A copy of `flink_tpu/table/sql.py` (jax-free there; the port keeps its own
copy under the same name). Reference: the Calcite-based parser
(flink-sql-parser) + planner rewrite of group windows. Supported grammar
(case-insensitive keywords):

  SELECT <item> [, <item>]*
  FROM <table>
  [[LEFT|RIGHT|FULL [OUTER]|INNER] JOIN <table> ON a.col = b.col [WINDOW <window>]]
                                      -- with WINDOW: windowed join;
                                      -- without: regular streaming join
                                      -- emitting a retract changelog
  [WHERE <expr>]
  [GROUP BY <col> [, <col>]* [, <window>]]
                                      -- without a window: CONTINUOUS
                                      -- aggregation (retract changelog)
  [HAVING <expr>]                      -- over output rows (aliases visible)
  [ORDER BY <col> [ASC|DESC] [, ...]] -- per window (streaming top-N)
  [LIMIT <n>]
  [UNION ALL <query>]                 -- concatenate result streams

  <item>   := <col> | <agg>( <col> | * ) [AS <alias>]
            | WINDOW_START [AS alias] | WINDOW_END [AS alias]
  <agg>    := COUNT | SUM | MIN | MAX | AVG
  <window> := TUMBLE(<time_col>, INTERVAL '<n>' <unit>)
            | HOP(<time_col>, INTERVAL '<n>' <unit>, INTERVAL '<n>' <unit>)
            | SESSION(<time_col>, INTERVAL '<n>' <unit>)
  <expr>   := comparisons of columns and literals combined with AND / OR,
              operators = != <> < <= > >=

The whole grammar parses; joins, UNION ALL and ML_PREDICT execute only once
the port carries them (`table/table_env.py`). Hand-rolled recursive
descent: statements compile to closures over rows (the interpreted path)
and, through `planner/`, to torch column functions (the fused path).
"""

from __future__ import annotations

import dataclasses
import re
from typing import Any, Callable, List, Optional, Tuple

_TOKEN_RE = re.compile(
    r"\s*(?:(?P<num>-?\d+\.\d+|-?\d+)|(?P<str>'[^']*')|(?P<op><=|>=|!=|<>|=|<|>|\(|\)|,|\*)"
    r"|(?P<word>[A-Za-z_][A-Za-z_0-9.]*))"
)

AGG_FUNCS = {"COUNT", "SUM", "MIN", "MAX", "AVG"}

#: SQL aggregate function -> builtin DeviceAggregator name. THE single
#: source for both front doors: the interpreted translation (table_env)
#: and the planner's agg-call mapping (planner/rules) read this one dict,
#: so they can never disagree about which aggregates have a device form.
DEVICE_AGG_OF = {
    "COUNT": "count", "SUM": "sum", "MIN": "min", "MAX": "max",
    "AVG": "mean",
}
_UNIT_MS = {
    "MILLISECOND": 1, "SECOND": 1000, "MINUTE": 60_000, "HOUR": 3_600_000,
    "DAY": 86_400_000,
}


class SqlParseError(ValueError):
    """A parse failure with position + snippet context. Subclasses
    ValueError so callers catching the parser's historical error type keep
    working; the gain is a *diagnostic* (where in the statement, with a
    caret) instead of a bare crash message — the reference throws
    SqlParseException with line/column for the same reason."""

    def __init__(self, message: str, sql: str, pos: int):
        self.reason = message
        self.sql = sql
        self.pos = max(0, min(pos, len(sql)))
        super().__init__(f"{message}\n{self.snippet()}")

    def snippet(self, width: int = 40) -> str:
        """The statement text around the failure with a caret under it."""
        start = max(0, self.pos - width)
        end = min(len(self.sql), self.pos + width)
        prefix = "..." if start > 0 else ""
        suffix = "..." if end < len(self.sql) else ""
        line = prefix + self.sql[start:end] + suffix
        caret = " " * (len(prefix) + self.pos - start) + "^"
        return f"  {line}\n  {caret} (at position {self.pos})"


def _tokenize(sql: str) -> Tuple[List[str], List[int]]:
    """Tokens plus their start offsets (for SqlParseError diagnostics)."""
    tokens: List[str] = []
    positions: List[int] = []
    pos = 0
    while pos < len(sql):
        m = _TOKEN_RE.match(sql, pos)
        if not m:
            rest = sql[pos:]
            if rest.strip():
                bad = pos + (len(rest) - len(rest.lstrip()))
                raise SqlParseError(
                    f"cannot tokenize at: {sql[bad:bad + 20]!r}", sql, bad)
            break
        tokens.append(m.group(0).strip())
        positions.append(m.end() - len(tokens[-1]))
        pos = m.end()
    return tokens, positions


@dataclasses.dataclass
class SelectItem:
    kind: str                 # 'column' | 'agg' | 'window_start' | 'window_end' | 'ml_predict'
    name: str                 # column name or agg arg ('*' for COUNT(*)); model name for ml_predict
    func: Optional[str] = None
    alias: Optional[str] = None
    args: Optional[List[str]] = None   # ml_predict feature columns

    @property
    def output_name(self) -> str:
        if self.alias:
            return self.alias
        if self.kind == "agg":
            return f"{self.func.lower()}_{self.name if self.name != '*' else 'all'}"
        if self.kind == "column":
            return self.name.split(".")[-1] if "." in self.name else self.name
        return self.kind


@dataclasses.dataclass
class WindowSpec:
    kind: str                 # 'tumble' | 'hop' | 'session'
    time_col: str
    size_ms: int
    slide_ms: Optional[int] = None  # hop only; for hop arg order: slide, size


@dataclasses.dataclass(frozen=True)
class Operand:
    """One side of a comparison: a column reference or a literal."""

    kind: str                 # 'column' | 'number' | 'string'
    value: Any


@dataclasses.dataclass(frozen=True)
class Comparison:
    """`lhs op rhs` with op in = != <> < <= > >=."""

    left: Operand
    op: str
    right: Operand


@dataclasses.dataclass(frozen=True)
class BoolExpr:
    """AND/OR combination of comparisons (parenthesization is structural)."""

    op: str                   # 'and' | 'or'
    left: Any                 # Comparison | BoolExpr
    right: Any


#: comparison op -> callable. Pure operator closures that work both
#: per-row (scalars; compile_predicate) and columnar (elementwise on numpy
#: arrays and torch tensors; planner/lowering's mask builder) — one table
#: for every consumer of the dialect's operators.
CMP_OPS = {
    "=": lambda a, b: a == b,
    "!=": lambda a, b: a != b,
    "<>": lambda a, b: a != b,
    "<": lambda a, b: a < b,
    "<=": lambda a, b: a <= b,
    ">": lambda a, b: a > b,
    ">=": lambda a, b: a >= b,
}
_CMP_OPS = CMP_OPS   # historical internal alias


def compile_predicate(node) -> Callable[[dict], bool]:
    """Row-closure view of a predicate AST (the interpreted path's form).
    Semantics: NULL comparisons are not-TRUE (SQL three-valued logic),
    AND/OR short-circuit like Python's."""
    if isinstance(node, BoolExpr):
        l, r = compile_predicate(node.left), compile_predicate(node.right)
        if node.op == "and":
            return lambda row: l(row) and r(row)
        return lambda row: l(row) or r(row)
    fn = _CMP_OPS[node.op]
    lhs, rhs = _compile_operand(node.left), _compile_operand(node.right)

    def compare(row):
        a, b = lhs(row), rhs(row)
        if a is None or b is None:
            return False        # SQL three-valued logic: NULL cmp -> not TRUE
        return fn(a, b)

    return compare


def _compile_operand(op: Operand):
    if op.kind == "column":
        name = op.value
        return lambda row: row[name]
    lit = op.value
    return lambda row: lit


def predicate_columns(node) -> List[str]:
    """Column names a predicate AST references, in first-use order."""
    out: List[str] = []

    def walk(n):
        if isinstance(n, BoolExpr):
            walk(n.left)
            walk(n.right)
            return
        for side in (n.left, n.right):
            if side.kind == "column" and side.value not in out:
                out.append(side.value)

    walk(node)
    return out


@dataclasses.dataclass
class JoinSpec:
    """Equi-join. With a trailing WINDOW clause: windowed join (the
    reference implements stream joins as coGroup over a shared window;
    JoinedStreams.java:101). Without one: a REGULAR streaming join with
    retraction semantics (StreamingJoinOperator.java:40) — both sides'
    rows buffer indefinitely and the output is a changelog."""

    table2: str
    alias1: str
    alias2: str
    left_col: str           # qualified 'alias.col'
    right_col: str
    window: Optional[WindowSpec] = None
    join_type: str = "inner"   # 'inner' | 'left' | 'right' (regular only)
                               # | 'full' (parses; refused with the typed
                               # catalogued reason 'join-full-outer')


@dataclasses.dataclass
class Query:
    select: List[SelectItem]
    table: str
    where: Optional[Callable[[dict], bool]]
    where_text: Optional[str]
    group_by: List[str]
    window: Optional[WindowSpec]
    join: Optional[JoinSpec] = None
    having: Optional[Callable[[dict], bool]] = None   # over OUTPUT rows
    having_text: Optional[str] = None
    order_by: List[Tuple[str, bool]] = dataclasses.field(
        default_factory=list)                          # (col, descending)
    limit: Optional[int] = None
    union_all: Optional["Query"] = None               # concatenated branch
    # structural predicate ASTs (Comparison/BoolExpr): what the planner
    # (planner/) reads — the closures above are the interpreted
    # path's compiled view of the same trees
    where_ast: Any = None
    having_ast: Any = None


class _Parser:
    def __init__(self, tokens: List[str], positions: List[int], sql: str):
        self.tokens = tokens
        self.positions = positions
        self.sql = sql
        self.i = 0

    def pos(self) -> int:
        """Character offset of the current token (end of input when past)."""
        if self.i < len(self.positions):
            return self.positions[self.i]
        return len(self.sql)

    def error(self, message: str, at: Optional[int] = None) -> SqlParseError:
        return SqlParseError(message, self.sql,
                             self.pos() if at is None else at)

    def peek(self) -> Optional[str]:
        return self.tokens[self.i] if self.i < len(self.tokens) else None

    def peek_upper(self) -> Optional[str]:
        t = self.peek()
        return t.upper() if t is not None else None

    def next(self) -> str:
        t = self.peek()
        if t is None:
            raise self.error("unexpected end of query")
        self.i += 1
        return t

    def expect(self, word: str) -> None:
        at = self.pos()
        t = self.next()
        if t.upper() != word.upper():
            raise self.error(f"expected {word}, got {t!r}", at=at)

    # -- grammar ----------------------------------------------------------
    def query(self) -> Query:
        self.expect("SELECT")
        select = [self.select_item()]
        while self.peek() == ",":
            self.next()
            select.append(self.select_item())
        self.expect("FROM")
        table = self.next()
        join = None
        alias1 = table
        if self.peek_upper() == "AS":
            self.next()
            alias1 = self.next()
        join_type = "inner"
        has_join = self.peek_upper() == "JOIN"
        if self.peek_upper() in ("LEFT", "RIGHT", "FULL", "INNER"):
            join_type = self.next().lower()
            if join_type != "inner" and self.peek_upper() == "OUTER":
                self.next()
            self.expect("JOIN")
            has_join = True
        elif has_join:
            self.next()
        if has_join:
            table2 = self.next()
            alias2 = table2
            if self.peek_upper() == "AS":
                self.next()
                alias2 = self.next()
            if alias2 == alias1:
                raise ValueError(
                    f"join sides must have distinct aliases, both are "
                    f"{alias1!r} (use FROM t AS a JOIN t AS b ...)"
                )
            self.expect("ON")
            left = self.next()
            self.expect("=")
            right = self.next()
            # normalize side order to (alias1 col, alias2 col)
            if right.split(".")[0] == alias1 and left.split(".")[0] == alias2:
                left, right = right, left
            if left.split(".")[0] != alias1 or right.split(".")[0] != alias2:
                raise ValueError(
                    f"join condition must equate {alias1}.<col> with "
                    f"{alias2}.<col>, got {left} = {right}"
                )
            join = (table2, alias1, alias2, left, right)
        where = where_text = where_ast = None
        if self.peek_upper() == "WHERE":
            self.next()
            where, where_text, where_ast = self.where_expr()
        group_by: List[str] = []
        window = None
        if self.peek_upper() == "GROUP":
            self.next()
            self.expect("BY")
            while True:
                if self.peek_upper() in ("TUMBLE", "HOP", "SESSION"):
                    window = self.window_spec()
                else:
                    group_by.append(self.next())
                if self.peek() == ",":
                    self.next()
                    continue
                break
        having = having_text = having_ast = None
        if self.peek_upper() == "HAVING":
            if not group_by and window is None:
                raise self.error("HAVING requires GROUP BY")
            self.next()
            having, having_text, having_ast = self.where_expr()
        order_by: List[Tuple[str, bool]] = []
        if self.peek_upper() == "ORDER":
            self.next()
            self.expect("BY")
            while True:
                col = self.next()
                desc = False
                if self.peek_upper() in ("ASC", "DESC"):
                    desc = self.next().upper() == "DESC"
                order_by.append((col, desc))
                if self.peek() == ",":
                    self.next()
                    continue
                break
        limit = None
        if self.peek_upper() == "LIMIT":
            self.next()
            at = self.pos()
            lit = self.next()
            try:
                limit = int(lit)
            except ValueError:
                raise self.error(
                    f"LIMIT expects an integer literal, got {lit!r}", at=at
                ) from None
            if limit < 0:
                raise self.error(
                    f"LIMIT must be non-negative, got {limit}", at=at)
        if join is None and alias1 != table:
            raise ValueError(
                "table aliases are only meaningful on join queries; "
                f"drop 'AS {alias1}' or add a JOIN"
            )
        if join is not None:
            # an optional trailing WINDOW <spec> clause bounds the join
            # (windowed join); without it the join is a REGULAR streaming
            # join over unbounded state, emitting a changelog
            jwindow = None
            if self.peek_upper() == "WINDOW":
                self.next()
                jwindow = self.window_spec(time_col_optional=True)
            if jwindow is not None and join_type in ("left", "right"):
                # FULL parses through here on purpose: it gets the typed
                # catalogued refusal ('join-full-outer') downstream, not a
                # parse error
                raise ValueError(
                    "LEFT/RIGHT OUTER are only supported on regular "
                    "(non-windowed) joins")
            if self.peek_upper() == "UNION":
                raise ValueError(
                    "UNION ALL with a join as the LEFT branch is not "
                    "supported; put the join on the right branch"
                )
            if self.peek() is not None:
                raise ValueError(f"trailing tokens: {self.tokens[self.i:]}")
            if having is not None or order_by or limit is not None:
                raise ValueError(
                    "HAVING/ORDER BY/LIMIT are not supported on join queries"
                )
            return Query(select, table, where, where_text, group_by, None,
                         JoinSpec(join[0], join[1], join[2], join[3],
                                  join[4], jwindow, join_type),
                         where_ast=where_ast)
        union_all = None
        if self.peek_upper() == "UNION":
            self.next()
            self.expect("ALL")
            union_all = self.query()       # right-recursive: a UNION chain
        elif self.peek() is not None:
            raise ValueError(f"trailing tokens: {self.tokens[self.i:]}")
        return Query(select, table, where, where_text, group_by, window,
                     having=having, having_text=having_text,
                     order_by=order_by, limit=limit, union_all=union_all,
                     where_ast=where_ast, having_ast=having_ast)

    def select_item(self) -> SelectItem:
        t = self.next()
        up = t.upper()
        if up in AGG_FUNCS:
            self.expect("(")
            arg = self.next()
            self.expect(")")
            item = SelectItem("agg", arg, func=up)
        elif up == "ML_PREDICT":
            # ML_PREDICT(model, feature_col [, feature_col...]) — the SQL
            # model-inference function (T5; reference: ML_PREDICT TVF via
            # PredictRuntimeProvider.java:26)
            self.expect("(")
            model = self.next()
            feats: List[str] = []
            while self.peek() == ",":
                self.next()
                feats.append(self.next())
            self.expect(")")
            item = SelectItem("ml_predict", model, args=feats)
        elif up in ("WINDOW_START", "WINDOW_END"):
            item = SelectItem(up.lower(), up.lower())
        else:
            item = SelectItem("column", t)
        if self.peek_upper() == "AS":
            self.next()
            item.alias = self.next()
        return item

    def window_spec(self, time_col_optional: bool = False) -> WindowSpec:
        kind = self.next().upper()
        self.expect("(")
        time_col = ""
        if not (time_col_optional and self.peek_upper() == "INTERVAL"):
            time_col = self.next()
            self.expect(",")
        first = self.interval()
        if kind == "HOP":
            self.expect(",")
            second = self.interval()
            self.expect(")")
            # HOP(time, slide, size) — reference TVF argument order
            return WindowSpec("hop", time_col, size_ms=second, slide_ms=first)
        self.expect(")")
        return WindowSpec(kind.lower(), time_col, size_ms=first)

    def interval(self) -> int:
        self.expect("INTERVAL")
        at = self.pos()
        lit = self.next()
        if not (lit.startswith("'") and lit.endswith("'")):
            raise self.error(f"INTERVAL literal expected, got {lit!r}", at=at)
        try:
            n = float(lit[1:-1])
        except ValueError:
            raise self.error(
                f"INTERVAL literal must be numeric, got {lit!r}", at=at
            ) from None
        at = self.pos()
        unit = self.next().upper()
        key = unit[:-1] if unit.endswith("S") and unit[:-1] in _UNIT_MS else unit
        if key not in _UNIT_MS:
            raise self.error(f"unknown interval unit {unit!r}", at=at)
        return int(n * _UNIT_MS[key])

    # -- WHERE ------------------------------------------------------------
    def where_expr(self) -> Tuple[Callable[[dict], bool], str, Any]:
        """(compiled closure, source text, predicate AST)."""
        start = self.i
        node = self.or_expr()
        text = " ".join(self.tokens[start:self.i])
        return compile_predicate(node), text, node

    def or_expr(self):
        left = self.and_expr()
        while self.peek_upper() == "OR":
            self.next()
            left = BoolExpr("or", left, self.and_expr())
        return left

    def and_expr(self):
        left = self.comparison()
        while self.peek_upper() == "AND":
            self.next()
            left = BoolExpr("and", left, self.comparison())
        return left

    def comparison(self):
        if self.peek() == "(":
            self.next()
            inner = self.or_expr()
            self.expect(")")
            return inner
        lhs = self.operand()
        at = self.pos()
        op = self.next()
        rhs = self.operand()
        if op not in _CMP_OPS:
            raise self.error(f"unknown comparison operator {op!r}", at=at)
        return Comparison(lhs, op, rhs)

    def operand(self) -> Operand:
        at = self.pos()
        t = self.next()
        if t.startswith("'") and t.endswith("'"):
            return Operand("string", t[1:-1])
        try:
            return Operand("number", float(t) if "." in t else int(t))
        except ValueError:
            pass
        if not re.match(r"[A-Za-z_]", t):
            raise self.error(
                f"expected a column or literal operand, got {t!r}", at=at)
        return Operand("column", t)


def parse_query(sql: str) -> Query:
    """Parse one statement. Every parse failure surfaces as SqlParseError
    (a ValueError subclass) with position + snippet context — a raw
    IndexError/ValueError escaping the recursive descent is a crash, not a
    diagnostic, so any stray one is wrapped at the current token here."""
    tokens, positions = _tokenize(sql)
    parser = _Parser(tokens, positions, sql)
    try:
        return parser.query()
    except SqlParseError:
        raise
    except (ValueError, IndexError) as e:
        raise SqlParseError(
            str(e) or type(e).__name__, sql, parser.pos()) from e
