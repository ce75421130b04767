"""SQL frontend — tokenizer + recursive-descent parser + planner for a
streaming SQL subset, lowering onto the Table API (and through it onto
the device pane-state runtime).

ref role: flink-sql-parser (Calcite dialect) + flink-table-planner
(SURVEY §3.8). Deliberately NOT a Calcite port: the supported subset is
chosen to cover the windowed streaming queries the runtime executes
natively, and each query plans in one pass with no optimizer — the
heavy lifting (window slicing, pane state, top-n) already lives in the
compiled device kernels, so the planner's only job is a faithful
lowering. Unsupported constructs raise ``SqlError`` with the offending
token position rather than silently degrading.

Supported grammar (case-insensitive keywords):

    SELECT sel [, sel ...]
    FROM source [[AS] ident]
         [JOIN source [[AS] ident] ON eq [AND eq ...]]
    [WHERE expr]
    [GROUP BY ident [, ident ...]]
    [HAVING expr]
    [ORDER BY ident [DESC] LIMIT n | LIMIT n]

    eq     := [ident.]ident = [ident.]ident     (JOIN: one cross-side
              key equality; window_start/window_end equalities allowed
              and tautological under the shared window spec)

    sel    := expr [AS ident] | agg(arg) [AS ident] | *
    agg    := COUNT(*|col) | {SUM|MAX|MIN|AVG}(col-or-expression)
    source := ident
            | TABLE(TUMBLE(TABLE ident, DESCRIPTOR(col), interval))
            | TABLE(HOP(TABLE ident, DESCRIPTOR(col), interval, interval))
            | TABLE(SESSION(TABLE ident, DESCRIPTOR(col), interval))
    interval := INTERVAL 'n' {MILLISECOND|SECOND|MINUTE|HOUR|DAY}[S]
    expr   := OR-expr over AND / NOT / comparisons / + - * / % / ( )
              with idents, numbers, 'strings'

Window TVFs follow FLIP-145 (the windowing table-valued functions of
Flink SQL): HOP's interval order is (slide, size), and the TVF adds
``window_start``/``window_end`` columns which GROUP BY then uses.
ORDER BY <agg-alias> DESC LIMIT n on a windowed aggregation lowers to
the fused device top-n (per-window RANK() <= n, Q5's hot-items shape).
"""
from __future__ import annotations

import dataclasses
import re
from typing import Any, List, Optional, Tuple

from flink_tpu_torch.table.api import (
    _AGG_FACTORIES,
    AggCall,
    Hop,
    Session,
    Table,
    TableEnvironment,
    Tumble,
    finish_projection,
)
from flink_tpu_torch.table.expressions import BinOp, Col, Expression, Lit, UnaryOp

__all__ = ["SqlError", "plan_sql", "parse"]


class SqlError(ValueError):
    pass


# ---------------------------------------------------------------------------
# Tokenizer
# ---------------------------------------------------------------------------

_TOKEN_RE = re.compile(
    r"\s*(?:"
    r"(?P<num>\d+(?:\.\d+)?)"
    r"|(?P<str>'(?:[^']|'')*')"
    r"|(?P<ident>[A-Za-z_][A-Za-z_0-9]*)"
    r"|(?P<op><>|<=|>=|!=|=|<|>|\(|\)|,|\*|\+|-|/|%|\.)"
    r")")


@dataclasses.dataclass
class Tok:
    kind: str  # num/str/ident/op/kw
    text: str
    pos: int


_KEYWORDS = {
    "select", "from", "where", "group", "by", "order", "limit", "desc",
    "asc", "as", "and", "or", "not", "table", "tumble", "hop", "session",
    "descriptor", "interval", "having", "join", "on",
}


def _tokenize(sql: str) -> List[Tok]:
    out: List[Tok] = []
    i = 0
    while i < len(sql):
        m = _TOKEN_RE.match(sql, i)
        if not m or m.end() == i:
            if sql[i:].strip():
                raise SqlError(f"cannot tokenize at position {i}: "
                               f"{sql[i:i+20]!r}")
            break
        i = m.end()
        if m.lastgroup == "ident":
            text = m.group("ident")
            kind = "kw" if text.lower() in _KEYWORDS else "ident"
            out.append(Tok(kind, text.lower() if kind == "kw" else text,
                           m.start()))
        elif m.lastgroup == "num":
            out.append(Tok("num", m.group("num"), m.start()))
        elif m.lastgroup == "str":
            out.append(Tok("str", m.group("str")[1:-1].replace("''", "'"),
                           m.start()))
        else:
            out.append(Tok("op", m.group("op"), m.start()))
    return out


# ---------------------------------------------------------------------------
# AST
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class SelectItem:
    expr: Optional[Expression]        # scalar expression, or None if agg
    agg: Optional[Tuple[str, Optional[str]]]  # (fn, col) for aggregates
    alias: Optional[str]
    star: bool = False


@dataclasses.dataclass
class WindowTvf:
    kind: str          # tumble/hop/session
    table: str
    time_col: str
    intervals: List[int]  # ms


@dataclasses.dataclass
class JoinSource:
    """FROM <tvf> [AS a] JOIN <tvf> [AS b] ON conjunction-of-equalities
    (FLIP-145 window join shape). Each condition is a pair of
    (qualifier-or-None, column) references."""

    left: Any
    left_alias: Optional[str]
    right: Any
    right_alias: Optional[str]
    conds: List[Tuple[Tuple[Optional[str], str], Tuple[Optional[str], str]]]


@dataclasses.dataclass
class Query:
    items: List[SelectItem]
    source: Any                 # str table name | WindowTvf | JoinSource
    where: Optional[Expression]
    group_by: List[str]
    having: Optional[Expression]
    order_by: Optional[Tuple[str, bool]]  # (col, desc)
    limit: Optional[int]


class _Parser:
    def __init__(self, toks: List[Tok]) -> None:
        self.toks = toks
        self.i = 0

    # -- plumbing -------------------------------------------------------
    def peek(self) -> Optional[Tok]:
        return self.toks[self.i] if self.i < len(self.toks) else None

    def next(self) -> Tok:
        t = self.peek()
        if t is None:
            raise SqlError("unexpected end of query")
        self.i += 1
        return t

    def accept(self, kind: str, text: Optional[str] = None) -> Optional[Tok]:
        t = self.peek()
        if t and t.kind == kind and (text is None or t.text == text):
            self.i += 1
            return t
        return None

    def expect(self, kind: str, text: Optional[str] = None) -> Tok:
        t = self.accept(kind, text)
        if t is None:
            got = self.peek()
            raise SqlError(
                f"expected {text or kind}, got "
                f"{(got.text if got else 'end of query')!r}"
                + (f" at position {got.pos}" if got else ""))
        return t

    # -- grammar --------------------------------------------------------
    def query(self) -> Query:
        self.expect("kw", "select")
        items = [self.select_item()]
        while self.accept("op", ","):
            items.append(self.select_item())
        self.expect("kw", "from")
        source = self.source()
        left_alias = self.alias()
        if self.accept("kw", "join"):
            right = self.source()
            right_alias = self.alias()
            self.expect("kw", "on")
            conds = [self.join_eq()]
            while self.accept("kw", "and"):
                conds.append(self.join_eq())
            source = JoinSource(source, left_alias, right, right_alias,
                                conds)
        where = None
        if self.accept("kw", "where"):
            where = self.expr()
        group_by: List[str] = []
        if self.accept("kw", "group"):
            self.expect("kw", "by")
            group_by.append(self.expect("ident").text)
            while self.accept("op", ","):
                group_by.append(self.expect("ident").text)
        having = None
        if self.accept("kw", "having"):
            having = self.expr()
        order_by = None
        if self.accept("kw", "order"):
            self.expect("kw", "by")
            c = self.expect("ident").text
            desc = bool(self.accept("kw", "desc"))
            if not desc:
                self.accept("kw", "asc")
            order_by = (c, desc)
        limit = None
        if self.accept("kw", "limit"):
            ltok = self.expect("num")
            if "." in ltok.text:
                raise SqlError(f"LIMIT must be an integer, got {ltok.text}")
            limit = int(ltok.text)
        t = self.peek()
        if t is not None:
            raise SqlError(f"unexpected trailing input at position "
                           f"{t.pos}: {t.text!r}")
        return Query(items, source, where, group_by, having, order_by,
                     limit)

    def select_item(self) -> SelectItem:
        if self.accept("op", "*"):
            return SelectItem(None, None, None, star=True)
        t = self.peek()
        if (t and t.kind == "ident"
                and t.text.lower() in _AGG_FACTORIES
                and self.i + 1 < len(self.toks)
                and self.toks[self.i + 1].text == "("):
            fn = self.next().text.lower()
            self.expect("op", "(")
            if self.accept("op", "*"):
                arg = None
                if fn != "count":
                    raise SqlError(f"{fn}(*) is not valid; only COUNT(*)")
            else:
                # full expression argument: SUM(a * b), AVG(p + t), ...
                # plain columns stay strings; expressions lower through
                # a derived pre-projection in the planner
                e = self.expr()
                arg = e.name if isinstance(e, Col) else e
            self.expect("op", ")")
            alias = self.alias()
            return SelectItem(None, (fn, arg), alias)
        e = self.expr()
        return SelectItem(e, None, self.alias())

    def join_eq(self) -> Tuple[Tuple[Optional[str], str],
                               Tuple[Optional[str], str]]:
        a = self.qualified_ref()
        self.expect("op", "=")
        return (a, self.qualified_ref())

    def qualified_ref(self) -> Tuple[Optional[str], str]:
        n1 = self.expect("ident").text
        if self.accept("op", "."):
            return (n1, self.expect("ident").text)
        return (None, n1)

    def alias(self) -> Optional[str]:
        if self.accept("kw", "as"):
            return self.expect("ident").text
        t = self.peek()
        if t and t.kind == "ident":
            return self.next().text
        return None

    def source(self):
        if self.accept("kw", "table"):
            self.expect("op", "(")
            kind_tok = self.next()
            kind = kind_tok.text
            if kind not in ("tumble", "hop", "session"):
                raise SqlError(
                    f"unsupported table function {kind!r} (TUMBLE/HOP/"
                    "SESSION)")
            self.expect("op", "(")
            self.expect("kw", "table")
            name = self.expect("ident").text
            self.expect("op", ",")
            self.expect("kw", "descriptor")
            self.expect("op", "(")
            time_col = self.expect("ident").text
            self.expect("op", ")")
            intervals = []
            while self.accept("op", ","):
                intervals.append(self.interval_ms())
            self.expect("op", ")")
            self.expect("op", ")")
            need = {"tumble": 1, "hop": 2, "session": 1}[kind]
            if len(intervals) != need:
                raise SqlError(
                    f"{kind.upper()} takes {need} interval(s), got "
                    f"{len(intervals)}")
            return WindowTvf(kind, name, time_col, intervals)
        return self.expect("ident").text

    _UNIT_MS = {
        "millisecond": 1, "second": 1000, "minute": 60_000,
        "hour": 3_600_000, "day": 86_400_000,
    }

    def interval_ms(self) -> int:
        self.expect("kw", "interval")
        val = self.expect("str").text
        unit_tok = self.expect("ident")
        unit = unit_tok.text.lower().rstrip("s")
        if unit not in self._UNIT_MS:
            raise SqlError(f"unknown interval unit {unit_tok.text!r}")
        try:
            n = float(val)
        except ValueError:
            raise SqlError(f"bad interval value {val!r}") from None
        return int(n * self._UNIT_MS[unit])

    # -- expressions (precedence climbing) ------------------------------
    def expr(self) -> Expression:
        return self.or_expr()

    def or_expr(self) -> Expression:
        e = self.and_expr()
        while self.accept("kw", "or"):
            e = BinOp("or", e, self.and_expr())
        return e

    def and_expr(self) -> Expression:
        e = self.not_expr()
        while self.accept("kw", "and"):
            e = BinOp("and", e, self.not_expr())
        return e

    def not_expr(self) -> Expression:
        if self.accept("kw", "not"):
            return UnaryOp("not", self.not_expr())
        return self.comparison()

    _CMP = {"=": "==", "<>": "!=", "!=": "!=", "<": "<", "<=": "<=",
            ">": ">", ">=": ">="}

    def comparison(self) -> Expression:
        e = self.additive()
        t = self.peek()
        if t and t.kind == "op" and t.text in self._CMP:
            op = self._CMP[self.next().text]
            return BinOp(op, e, self.additive())
        return e

    def additive(self) -> Expression:
        e = self.multiplicative()
        while True:
            t = self.peek()
            if t and t.kind == "op" and t.text in ("+", "-"):
                e = BinOp(self.next().text, e, self.multiplicative())
            else:
                return e

    def multiplicative(self) -> Expression:
        e = self.unary()
        while True:
            t = self.peek()
            if t and t.kind == "op" and t.text in ("*", "/", "%"):
                e = BinOp(self.next().text, e, self.unary())
            else:
                return e

    def unary(self) -> Expression:
        if self.accept("op", "-"):
            return UnaryOp("neg", self.unary())
        return self.primary()

    def primary(self) -> Expression:
        t = self.next()
        if t.kind == "num":
            return Lit(float(t.text) if "." in t.text else int(t.text))
        if t.kind == "str":
            return Lit(t.text)
        if t.kind == "ident":
            if self.accept("op", "."):
                # qualified reference (join queries): kept as a dotted
                # Col name; the join planner resolves the qualifier
                return Col(f"{t.text}.{self.expect('ident').text}")
            return Col(t.text)
        if t.kind == "op" and t.text == "(":
            e = self.expr()
            self.expect("op", ")")
            return e
        raise SqlError(f"unexpected token {t.text!r} at position {t.pos}")


def parse(sql: str) -> Query:
    return _Parser(_tokenize(sql)).query()


# ---------------------------------------------------------------------------
# Planner: Query AST -> Table pipeline
# ---------------------------------------------------------------------------

def plan_sql(t_env: "TableEnvironment", sql: str) -> "Table":
    q = parse(sql)

    if isinstance(q.source, JoinSource):
        return _plan_join(t_env, q)

    # resolve source
    if isinstance(q.source, WindowTvf):
        base = t_env.table(q.source.table)
        iv = q.source.intervals
        if q.source.kind == "tumble":
            wdef = Tumble.over_ms(iv[0])
        elif q.source.kind == "hop":
            # FLIP-145 HOP argument order: (slide, size)
            wdef = Hop.of_ms(size_ms=iv[1], slide_ms=iv[0])
        else:
            wdef = Session.with_gap_ms(iv[0])
        wdef = wdef.on(q.source.time_col)
    else:
        base = t_env.table(q.source)
        wdef = None

    table = base
    if q.where is not None:
        table = table.filter(q.where)

    aggs = [it for it in q.items if it.agg is not None]
    if aggs:
        return _plan_aggregate(q, table, wdef)

    # pure projection query
    if q.having is not None:
        raise SqlError("HAVING without aggregate functions in SELECT")
    if wdef is not None:
        raise SqlError(
            "a window TVF source needs aggregate functions in SELECT "
            "(per-row window column attachment is not in v1)")
    if q.group_by:
        raise SqlError(
            "GROUP BY without aggregate functions in SELECT")
    if q.order_by is not None or q.limit is not None:
        raise SqlError(
            "ORDER BY/LIMIT is only supported over a windowed "
            "aggregation (per-window top-n)")
    if any(it.star for it in q.items):
        if len(q.items) != 1:
            raise SqlError("SELECT * cannot mix with other columns")
        return table
    sels = []
    for it in q.items:
        e = it.expr
        name = it.alias or (e.name if isinstance(e, Col) else None)
        if name is None:
            raise SqlError(f"computed column needs AS alias: {e!r}")
        sels.append(e.alias(name))
    return table.select(*sels)


def _plan_join(t_env: "TableEnvironment", q: Query) -> "Table":
    """Windowed equi-join (FLIP-145 window join): both sides are the
    SAME window TVF, ON carries exactly one cross-side key equality
    (plus optional window_start/window_end equalities, which the shared
    window spec makes tautological). Lowers onto the DataStream windowed
    join (ops/join.py, Q8's exact-pairs operator). Everything outside
    this shape raises SqlError naming what is unsupported."""
    from flink_tpu_torch.api.windowing import (
        SlidingEventTimeWindows, TumblingEventTimeWindows)
    from flink_tpu_torch.table.api import Table, TableSchema

    src: JoinSource = q.source
    if q.group_by or any(it.agg for it in q.items):
        return _plan_join_aggregate(t_env, q)
    if q.order_by is not None or q.limit is not None:
        raise SqlError("ORDER BY/LIMIT over a JOIN is not supported")
    if not isinstance(src.left, WindowTvf) or not isinstance(
            src.right, WindowTvf):
        raise SqlError(
            "streaming JOIN requires a window TVF on BOTH sides "
            "(an unbounded join has unbounded state); wrap each input "
            "in TABLE(TUMBLE(...)/HOP(...))")
    l, r = src.left, src.right
    if l.kind == "session" or r.kind == "session":
        raise SqlError("SESSION window JOIN is not supported")
    if (l.kind, l.intervals) != (r.kind, r.intervals):
        raise SqlError(
            f"JOIN sides must share one window spec, got "
            f"{l.kind.upper()}{l.intervals} vs {r.kind.upper()}"
            f"{r.intervals}")
    lt = t_env.table(l.table)
    rt = t_env.table(r.table)
    lname = src.left_alias or l.table
    rname = src.right_alias or r.table
    if lname == rname:
        raise SqlError(f"ambiguous join side name {lname!r} — alias one")

    def side_of(ref: Tuple[Optional[str], str], ctx: str) -> str:
        qual, col = ref
        if qual == lname:
            return "L"
        if qual == rname:
            return "R"
        if qual is not None:
            raise SqlError(f"unknown qualifier {qual!r} in {ctx}")
        in_l = col in lt.schema.columns
        in_r = col in rt.schema.columns
        if in_l and in_r:
            raise SqlError(
                f"column {col!r} in {ctx} is ambiguous — qualify it "
                f"with {lname!r} or {rname!r}")
        if in_l:
            return "L"
        if in_r:
            return "R"
        raise SqlError(f"unknown column {col!r} in {ctx}")

    key_pairs = []
    for a, b in src.conds:
        if a[1] in ("window_start", "window_end") and a[1] == b[1]:
            continue  # tautological under the shared window spec
        sa, sb = side_of(a, "ON"), side_of(b, "ON")
        if sa == sb:
            raise SqlError(
                "ON condition must compare columns across the two "
                f"sides, got both from one side: {a[1]} = {b[1]}")
        key_pairs.append((a[1], b[1]) if sa == "L" else (b[1], a[1]))
    if len(key_pairs) != 1:
        raise SqlError(
            f"exactly one cross-side key equality is supported, got "
            f"{len(key_pairs)}")
    lk, rk = key_pairs[0]
    lt.schema.check(lk)
    rt.schema.check(rk)

    # selected fields decide what each side carries through the join
    out_names: List[str] = []
    l_fields: List[str] = []
    r_fields: List[str] = []
    plan: List[Tuple[str, str]] = []  # (runtime field, output name)
    for it in q.items:
        if it.star:
            raise SqlError(
                "SELECT * over a JOIN is not supported — name the "
                "columns (output schema would be ambiguous)")
        if not isinstance(it.expr, Col):
            raise SqlError(
                "JOIN SELECT items must be plain columns in v1")
        name = it.expr.name
        qual, col = (name.split(".", 1) if "." in name else (None, name))
        out = it.alias or col
        if col in ("window_start", "window_end") or (
                qual is None and col in (lk, rk) and lk == rk):
            plan.append((col if col.startswith("window_") else "key", out))
            out_names.append(out)
            continue
        side = side_of((qual, col), "SELECT")
        if side == "L":
            if col == lk:
                plan.append(("key", out))
            else:
                l_fields.append(col)
                plan.append((f"left_{col}", out))
        else:
            if col == rk:
                plan.append(("key", out))
            else:
                r_fields.append(col)
                plan.append((f"right_{col}", out))
        out_names.append(out)

    joined = (lt.stream.join(rt.stream)
              .where(lk).equal_to(rk)
              .window(TumblingEventTimeWindows.of(l.intervals[0])
                      if l.kind == "tumble"
                      else SlidingEventTimeWindows.of(
                          l.intervals[1], l.intervals[0]))
              .apply(left_fields=tuple(dict.fromkeys(l_fields)),
                     right_fields=tuple(dict.fromkeys(r_fields)),
                     name="sql_window_join"))

    def project(data):
        return {out: data[fieldname] for fieldname, out in plan}

    out_stream = joined.map(project, name="sql_join_project")
    table = Table(t_env, out_stream, TableSchema(tuple(out_names)))
    if q.where is not None:
        table = table.filter(q.where)
    return table


def _plan_join_aggregate(t_env: "TableEnvironment", q: Query) -> "Table":
    """Aggregation over a window JOIN — ``SELECT k, AGG(x) FROM
    TABLE(TUMBLE(a)) JOIN TABLE(TUMBLE(b)) ON ... GROUP BY k`` (the
    Nexmark Q8-then-count shape). Plans as join → derived stream →
    re-window → aggregate: the joined rows carry the pane they were
    produced in as their stream timestamp (window_end - 1, the driver's
    fired-row stamping), so re-assigning them with the SAME tumbling
    spec lands every row back in its own pane — which is exactly why
    only TUMBLE qualifies (a sliding assigner would fan each joined row
    into ``size/slide`` windows, multi-counting it)."""
    src: JoinSource = q.source
    l, r = src.left, src.right
    if not isinstance(l, WindowTvf) or not isinstance(r, WindowTvf):
        raise SqlError(
            "streaming JOIN requires a window TVF on BOTH sides "
            "(an unbounded join has unbounded state); wrap each input "
            "in TABLE(TUMBLE(...))")
    if l.kind != "tumble" or r.kind != "tumble":
        raise SqlError(
            "aggregation over a JOIN supports TUMBLE windows only: "
            "joined rows re-window by their pane timestamp, which only "
            "tumbling panes make unambiguous (a HOP row belongs to "
            "several windows)")
    if q.order_by is not None or q.limit is not None:
        raise SqlError(
            "ORDER BY/LIMIT over a JOIN aggregation is not supported — "
            "aggregate into a view first")
    group_cols = [g for g in q.group_by
                  if g not in ("window_start", "window_end")]
    if len(group_cols) != 1:
        raise SqlError(
            "aggregation over a JOIN needs exactly one non-window "
            f"grouping column; got {group_cols}")

    # columns the derived (joined) stream must carry: the grouping
    # column, every aggregate argument, and WHERE references — each
    # projected to its UNQUALIFIED name
    needed: dict = {}  # out name -> (possibly qualified) source ref

    def need(ref: str, ctx: str) -> str:
        base = ref.split(".", 1)[1] if "." in ref else ref
        if base in ("window_start", "window_end"):
            return base  # re-derived by the downstream window
        prev = needed.get(base)
        if prev is not None and prev != ref:
            # an unqualified ref names the same column as its qualified
            # twin (GROUP BY columns parse unqualified); only two
            # DIFFERENT qualified refs are a genuine cross-side clash
            if ref == base:
                return base
            if prev != base:
                raise SqlError(
                    f"column name {base!r} is needed from both join "
                    f"sides ({prev} and {ref} in {ctx}) — alias one "
                    "side's column")
        needed[base] = ref
        return base

    items3: List[SelectItem] = []
    for it in q.items:
        if it.star:
            raise SqlError("SELECT * cannot mix with aggregates")
        if it.agg is not None:
            fn, arg = it.agg
            if arg is not None and not isinstance(arg, str):
                raise SqlError(
                    f"{fn.upper()}(<expression>) over a JOIN is not "
                    "supported — aggregate arguments must be plain "
                    "columns")
            arg3 = need(arg, "SELECT") if arg is not None else None
            items3.append(SelectItem(None, (fn, arg3), it.alias))
        else:
            if not isinstance(it.expr, Col):
                raise SqlError(
                    "non-aggregate SELECT items over a JOIN aggregation "
                    f"must be plain columns, got {it.expr!r}")
            items3.append(SelectItem(
                Col(need(it.expr.name, "SELECT")), None, it.alias))
    for g in group_cols:
        need(g, "GROUP BY")
    if q.where is not None:
        for f in q.where.fields():
            need(f, "WHERE")

    # phase 1: the plain window join, projecting exactly the needed
    # columns under their unqualified names (reuses the whole join
    # validation/lowering path)
    q2 = Query(
        items=[SelectItem(Col(ref), None, out)
               for out, ref in needed.items()],
        source=src, where=q.where, group_by=[], having=None,
        order_by=None, limit=None)
    joined = _plan_join(t_env, q2)

    # phase 2: re-key and re-window the derived stream with the same
    # tumbling spec; the synthetic time attribute names the stream
    # timestamp (joined rows are stamped window_end - 1 by the driver —
    # no column carries it)
    from flink_tpu_torch.table.api import Table, TableSchema
    tbl = Table(t_env, joined.stream,
                TableSchema(joined.schema.columns, time_attr="__rowtime__"))
    wdef = Tumble.over_ms(l.intervals[0]).on("__rowtime__")
    q3 = Query(items=items3, source=l.table, where=None,
               group_by=q.group_by, having=q.having, order_by=None,
               limit=None)
    return _plan_aggregate(q3, tbl, wdef)


def _plan_running_aggregate(q: Query, table: "Table", group_cols,
                            calls, plain) -> "Table":
    """`SELECT k, agg FROM t GROUP BY k` with NO window TVF: the
    canonical streaming-SQL shape emitting a CHANGELOG. Lowers onto the
    retract-mode KeyedStream.running_aggregate (ops/global_agg.py): each
    per-key update emits a -U retraction of the previous row and a +U
    assertion of the new one, op-typed via records.OP_FIELD (ref:
    table-runtime GroupAggFunction). Materialize with a
    changelog-capable sink — ``RetractSink``/``UpsertSink`` — or window
    the changelog downstream (the changelog_* lanes in ops/aggregates
    fold retractions).

    HAVING is a per-row filter over the op-typed rows, and the case
    analysis is exactly why that is correct: a key UPDATING INTO the
    predicate passes only its +U (an insert to the view); a key
    updating OUT of it passes only its -U, which changelog-capable
    sinks treat as the key's deletion."""
    from flink_tpu_torch.ops import aggregates
    from flink_tpu_torch.table.api import finish_projection

    if q.order_by is not None or q.limit is not None:
        raise SqlError(
            "ORDER BY/LIMIT over an unwindowed aggregation would need "
            "a continuously re-ranked changelog; use a window TVF")
    if len(group_cols) != 1:
        raise SqlError(
            "an unwindowed aggregate needs exactly one grouping "
            f"column in v1; got {group_cols}")
    uniq = {}
    for c in calls:
        uniq.setdefault((c.fn, c.field), c)
    lanes = [c.build() for c in uniq.values()]
    lane = lanes[0] if len(lanes) == 1 else aggregates.multi(*lanes)
    key = group_cols[0]
    agg_stream = table.stream.key_by(key).running_aggregate(
        lane, retract=True)
    pairs = [(c.runtime_field, c.out_name) for c in calls]
    want = plain + [c.out_name for c in calls]
    result = finish_projection(table.t_env, agg_stream, pairs,
                               key if key in plain else None, want)
    if q.having is not None:
        # row-level filter over the changelog (op column rides through
        # the filter untouched): -U rows that leave the predicate while
        # their +U partner stays inside become genuine deletions
        result = result.filter(q.having)
    return result


def _plan_aggregate(q: Query, table: "Table",
                    wdef) -> "Table":
    group_cols = [g for g in q.group_by
                  if g not in ("window_start", "window_end")]
    if wdef is None and any(
            g in ("window_start", "window_end") for g in q.group_by):
        raise SqlError(
            "window_start/window_end grouping needs a window TVF source")
    if len(group_cols) > 1:
        raise SqlError(
            f"v1 supports one non-window grouping column; got "
            f"{group_cols}")

    # build agg calls with output names; EXPRESSION arguments
    # (SUM(a*b), AVG(p+t), ...) lower through a derived pre-projection
    # computed before the window aggregation — the streaming equivalent
    # of the planner's calc-before-agg rewrite
    calls: List[AggCall] = []
    plain: List[str] = []
    derived: List[Tuple[str, Expression]] = []
    for it in q.items:
        if it.star:
            raise SqlError("SELECT * cannot mix with aggregates")
        if it.agg is not None:
            fn, arg = it.agg
            if arg is not None and not isinstance(arg, str):
                if it.alias is None:
                    raise SqlError(
                        f"{fn.upper()}(<expression>) needs an AS alias")
                name = f"__agg_expr_{len(derived)}"
                derived.append((name, arg))
                arg = name
            default = fn if fn == "count" else f"{fn}_{arg}"
            calls.append(AggCall(fn, arg, it.alias or default))
        else:
            e = it.expr
            if not isinstance(e, Col):
                raise SqlError(
                    "non-aggregate SELECT items in a grouped query must "
                    f"be plain grouping columns, got {e!r}")
            plain.append(it.alias or e.name)
            if it.alias and it.alias != e.name:
                raise SqlError(
                    "aliasing grouping columns is not supported in v1")
    allowed = set(group_cols) | {"window_start", "window_end"}
    for p in plain:
        if p not in allowed:
            raise SqlError(
                f"column {p!r} in SELECT is neither grouped nor "
                "aggregated")

    if derived:
        # keep the grouping columns, the time attribute, and every
        # plain aggregate argument alongside the derived columns
        keep = list(dict.fromkeys(
            group_cols
            + ([q.source.time_col] if wdef is not None else [])
            + [c.field for c in calls
               if isinstance(c.field, str)
               and not c.field.startswith("__agg_expr_")]))
        sels = [Col(k).alias(k) for k in keep]
        sels += [e.alias(name) for name, e in derived]
        table = table.select(*sels)
    if wdef is None:
        return _plan_running_aggregate(q, table, group_cols, calls,
                                       plain)
    gt = (table.window(wdef).group_by(*q.group_by)
          if q.group_by else table.window(wdef).group_by())
    want = plain + [c.out_name for c in calls]

    # ORDER BY <agg output> DESC LIMIT n -> fused device per-window top-n
    if q.order_by is not None or q.limit is not None:
        if q.order_by is None or q.limit is None:
            raise SqlError("ORDER BY and LIMIT must appear together")
        by_col, desc = q.order_by
        if not desc:
            raise SqlError(
                "only ORDER BY <agg> DESC LIMIT n (per-window top-n) "
                "is supported")
        by_call = next((c for c in calls if c.out_name == by_col), None)
        if by_call is None:
            raise SqlError(
                f"ORDER BY column {by_col!r} must be one of the "
                f"aggregates {[c.out_name for c in calls]}")
        if not group_cols:
            raise SqlError(
                "ORDER BY ... DESC LIMIT n ranks keys within each "
                "window and needs a grouping column; a global windowed "
                "aggregate has one row per window already")
        agg_stream, pairs, key_out = gt._aggregate_stream(*calls)
        if not hasattr(agg_stream, "top"):
            # session windows aggregate through the merge registry, not
            # the pane fire path that hosts the fused top-n
            raise SqlError(
                "ORDER BY ... DESC LIMIT n is not supported over "
                "SESSION windows in v1 (TUMBLE/HOP only)")
        topped = agg_stream.top(q.limit, by=by_call.runtime_field)
        out = finish_projection(
            table.t_env, topped, pairs, key_out, want)
        if q.having is not None:
            for f in q.having.fields():
                if f not in out.schema.columns:
                    raise SqlError(
                        f"HAVING references {f!r}, which the top-n "
                        "output does not carry — select it")
            out = out.filter(q.having)
        return out

    result = gt.aggregate(*calls)
    # HAVING filters the AGGREGATED rows (it may reference aggregate
    # aliases and grouping columns — the full pre-projection schema)
    if q.having is not None:
        result = result.filter(q.having)
    # drop columns not selected (grouping col might be omitted)
    if set(want) != set(result.schema.columns):
        result = result.select(*want)
    return result
