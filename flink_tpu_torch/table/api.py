"""Table API — relational view over DataStream pipelines.

ref role: flink-table-api-java (`TableEnvironment`, `Table` —
flink-table/flink-table-api-java/.../table/api/{TableEnvironment,
Table}.java) and the planner's lowering into DataStream-era ExecNodes
(flink-table-planner, SURVEY §3.8). There is no Calcite and no
generated Java — a Table is a thin logical wrapper over the SAME
Transformation graph the DataStream API builds, scalar expressions
evaluate as vectorized numpy over the columnar batches on the host
(expressions.py), and windowed grouped aggregation lowers onto the
device pane-state WindowOperator exactly like
``stream.key_by().window().aggregate()`` does, so a SQL job launches
the same kernels as its DataStream form. SQL (sql.py) parses into
these Table operations; both APIs meet the runtime at one seam.

Streaming semantics: a bare (non-windowed) GROUP BY over an unbounded
stream produces a CHANGELOG — continuous per-key updates. It lowers
onto the retract-mode running aggregation (ops/global_agg.py): each
emission retracts the key's previous row (-U) and asserts the new one
(+U), op-typed via records.OP_FIELD (ref: Flink's update/changelog
tables, table-runtime GroupAggFunction). Materialize the result
through a changelog-capable sink (RetractSink / UpsertSink).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from flink_tpu_torch.api.datastream import DataStream
from flink_tpu_torch.api.windowing import (
    EventTimeSessionWindows,
    SlidingEventTimeWindows,
    TumblingEventTimeWindows,
    WindowAssigner,
)
from flink_tpu_torch.ops import aggregates
from flink_tpu_torch.table.expressions import Aliased, Col, Expression, col

__all__ = [
    "TableEnvironment", "Table", "TableResult", "TableSchema",
    "Tumble", "Hop", "Session", "col",
]


# ---------------------------------------------------------------------------
# Window definitions (Table-API side; ref: table/api/{Tumble,Slide,
# Session}.java builders)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class WindowDef:
    """A window spec over an event-time attribute."""
    assigner: WindowAssigner
    time_attr: Optional[str] = None  # None = the table's time attribute

    def on(self, time_attr: str) -> "WindowDef":
        return dataclasses.replace(self, time_attr=time_attr)


class Tumble:
    @staticmethod
    def over_ms(size_ms: int) -> WindowDef:
        return WindowDef(TumblingEventTimeWindows.of(size_ms))


class Hop:
    @staticmethod
    def of_ms(size_ms: int, slide_ms: int) -> WindowDef:
        return WindowDef(SlidingEventTimeWindows.of(size_ms, slide_ms))


class Session:
    @staticmethod
    def with_gap_ms(gap_ms: int) -> WindowDef:
        return WindowDef(EventTimeSessionWindows.with_gap(gap_ms))


# ---------------------------------------------------------------------------
# Aggregate call descriptors (SELECT list entries that are aggregates)
# ---------------------------------------------------------------------------

_AGG_FACTORIES = {
    "count": lambda f: aggregates.count(),
    "sum": lambda f: aggregates.sum_of(f),
    "max": lambda f: aggregates.max_of(f),
    "min": lambda f: aggregates.min_of(f),
    "avg": lambda f: aggregates.avg_of(f),
}

@dataclasses.dataclass(frozen=True)
class AggCall:
    fn: str                  # count/sum/max/min/avg
    field: Optional[str]     # None for count(*)
    out_name: str            # output column name

    @property
    def runtime_field(self) -> str:
        # the runtime's own default naming is the single source of
        # truth — ask the built lane rather than mirroring the
        # aggregates module's f"sum_{field}" conventions here
        return aggregates.result_fields(self.build())[0]

    def build(self) -> aggregates.LaneAggregate:
        if self.fn not in _AGG_FACTORIES:
            raise ValueError(f"unsupported aggregate {self.fn!r}")
        if self.fn != "count" and not self.field:
            raise ValueError(f"{self.fn}() needs a column argument")
        return _AGG_FACTORIES[self.fn](self.field)


# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class TableSchema:
    columns: Tuple[str, ...]
    time_attr: Optional[str] = None  # event-time column (ms)

    def check(self, name: str) -> None:
        if name not in self.columns and name != self.time_attr:
            raise ValueError(
                f"column {name!r} not in schema {self.columns}")


class TableResult:
    """Materialized query result (ref: TableResult.collect)."""

    def __init__(self, rows: List[Dict[str, Any]], job_result=None) -> None:
        self.rows = rows
        self.job_result = job_result

    def collect(self) -> List[Dict[str, Any]]:
        return self.rows

    def to_pandas(self):  # optional convenience; imported only when called
        import pandas as pd

        return pd.DataFrame(self.rows)


class TableEnvironment:
    """Catalog of named tables over one StreamExecutionEnvironment.
    ref: TableEnvironment.create / StreamTableEnvironment."""

    def __init__(self, env) -> None:
        self.env = env
        self._views: Dict[str, Table] = {}

    @classmethod
    def create(cls, env) -> "TableEnvironment":
        return cls(env)

    # -- catalog --------------------------------------------------------
    def create_temporary_view(self, name: str, table_or_stream,
                              schema: Optional[Sequence[str]] = None,
                              time_attr: Optional[str] = None) -> None:
        """Register a Table (or a DataStream + schema) under a name.
        ref: TableEnvironment.createTemporaryView."""
        if isinstance(table_or_stream, Table):
            self._views[name] = table_or_stream
        else:
            if schema is None:
                raise ValueError(
                    "registering a DataStream needs schema=[columns...]")
            self._views[name] = Table(
                self, table_or_stream,
                TableSchema(tuple(schema), time_attr))

    def from_data_stream(self, stream, schema: Sequence[str],
                         time_attr: Optional[str] = None) -> "Table":
        return Table(self, stream, TableSchema(tuple(schema), time_attr))

    def table(self, name: str) -> "Table":
        if name not in self._views:
            raise KeyError(
                f"no table {name!r}; registered: {sorted(self._views)}")
        return self._views[name]

    def sql_query(self, query: str) -> "Table":
        """Parse + plan a SQL query against the registered views.
        ref: TableEnvironment.sqlQuery (SURVEY §3.8 SQL parser/planner)."""
        from flink_tpu_torch.table.sql import plan_sql

        return plan_sql(self, query)


class Table:
    """Logical relational view over a DataStream. Immutable — every
    operation returns a new Table wrapping a longer pipeline."""

    def __init__(self, t_env: TableEnvironment, stream: DataStream,
                 schema: TableSchema) -> None:
        self.t_env = t_env
        self.stream = stream
        self.schema = schema

    # -- row-level ------------------------------------------------------
    def filter(self, predicate: Expression) -> "Table":
        for f in predicate.fields():
            self.schema.check(f)

        def pred(data):
            return np.asarray(predicate.eval(data), bool)

        return Table(self.t_env, self.stream.filter(pred, name="sql_filter"),
                     self.schema)

    where = filter

    def select(self, *exprs: Union[str, Expression]) -> "Table":
        """Project/compute columns. Plain strings and Col pass through;
        computed expressions need .alias(name)."""
        parsed: List[Tuple[str, Expression]] = []
        for e in exprs:
            if isinstance(e, str):
                parsed.append((e, Col(e)))
            elif isinstance(e, Aliased):
                parsed.append((e.name, e.expr))
            elif isinstance(e, Col):
                parsed.append((e.name, e))
            else:
                raise ValueError(
                    f"computed select expression needs .alias(name): {e!r}")
        for _, e in parsed:
            for f in e.fields():
                self.schema.check(f)
        time_attr = self.schema.time_attr
        keep_time = time_attr in [n for n, _ in parsed]

        def project(data):
            n = len(next(iter(data.values()))) if data else 0
            out = {}
            for name, e in parsed:
                v = np.asarray(e.eval(data))
                if v.ndim == 0:  # literal column: broadcast to batch
                    v = np.full(n, v[()])
                out[name] = v
            return out

        out_cols = tuple(n for n, _ in parsed)
        return Table(
            self.t_env, self.stream.map(project, name="sql_project"),
            TableSchema(out_cols, time_attr if keep_time else None))

    # -- windowed grouped aggregation ----------------------------------
    def window(self, wdef: WindowDef) -> "WindowedTable":
        ta = wdef.time_attr or self.schema.time_attr
        if ta is None:
            raise ValueError(
                "window needs a time attribute: set time_attr on the "
                "table or use .on('ts_col')")
        return WindowedTable(self, dataclasses.replace(wdef, time_attr=ta))

    def group_by(self, *cols: Union[str, Col]) -> "GroupedTable":
        names = [c if isinstance(c, str) else c.name for c in cols]
        for n in names:
            self.schema.check(n)
        return GroupedTable(self, names, wdef=None)

    # -- execution ------------------------------------------------------
    def to_data_stream(self) -> DataStream:
        return self.stream

    def add_sink(self, sink) -> DataStream:
        return self.stream.add_sink(sink)

    def execute(self, job_name: str = "table-query",
                device: "str | torch.device" = "cuda") -> TableResult:
        """Run THIS query's lineage only — the environment may hold
        other queries' pipelines (each with sinks that must not re-fire;
        ref: TableEnvironment executes per-statement, not per-session)
        — on ``device`` ("cuda" by default; raises when there is no CUDA
        device — pass "cpu" explicitly)."""
        from flink_tpu_torch.api.sinks import CollectSink

        sink = CollectSink()
        sink_stream = self.stream.add_sink(sink)
        keep = set()
        stack = [sink_stream.transform]
        while stack:
            t = stack.pop()
            if id(t) in keep:
                continue
            keep.add(id(t))
            stack.extend(t.inputs)
        lineage = [t for t in self.t_env.env._transforms if id(t) in keep]
        res = self.t_env.env.execute(job_name, device=device,
                                     transforms=lineage)
        return TableResult(sink.rows, res)


class WindowedTable:
    def __init__(self, table: Table, wdef: WindowDef) -> None:
        self.table = table
        self.wdef = wdef

    def group_by(self, *cols: Union[str, Col]) -> "GroupedTable":
        names = [c if isinstance(c, str) else c.name for c in cols]
        names = [n for n in names
                 if n not in ("window_start", "window_end")]
        for n in names:
            self.table.schema.check(n)
        return GroupedTable(self.table, names, self.wdef)

    def aggregate(self, *aggs: AggCall) -> Table:
        """Global (non-keyed) windowed aggregation → windowAll path."""
        return GroupedTable(self.table, [], self.wdef).aggregate(*aggs)


class GroupedTable:
    def __init__(self, table: Table, keys: List[str],
                 wdef: Optional[WindowDef]) -> None:
        if len(keys) > 1:
            raise ValueError(
                "v1 supports one grouping column (plus window_start/"
                f"window_end); got {keys}. Pre-combine keys with a "
                "select expression if needed.")
        self.table = table
        self.keys = keys
        self.wdef = wdef

    def window(self, wdef: WindowDef) -> "GroupedTable":
        ta = wdef.time_attr or self.table.schema.time_attr
        if ta is None:
            raise ValueError("window needs a time attribute")
        return GroupedTable(self.table, self.keys,
                            dataclasses.replace(wdef, time_attr=ta))

    def _aggregate_stream(self, *aggs: AggCall):
        """Build the windowed aggregation pipeline WITHOUT the output
        projection. Returns ``(agg_stream, pairs, key_out)`` where
        ``pairs`` maps each call's runtime result field to its SELECT
        alias (two aliases may share a runtime field: duplicate
        aggregates are computed once and fanned out at projection)."""
        if not aggs:
            raise ValueError("aggregate() needs at least one AggCall")
        uniq: Dict[Tuple[str, Optional[str]], AggCall] = {}
        for a in aggs:
            uniq.setdefault((a.fn, a.field), a)
        lanes = [a.build() for a in uniq.values()]
        lane = lanes[0] if len(lanes) == 1 else aggregates.multi(*lanes)
        stream = self.table.stream
        if self.wdef is None:
            # unwindowed GROUP BY → retract-mode running aggregation:
            # a changelog stream of op-typed rows, one -U/+U pair per
            # per-key update (the table-runtime GroupAggFunction shape)
            if not self.keys:
                raise ValueError(
                    "non-windowed aggregation without GROUP BY (a single "
                    "global running row) is not supported — group by a "
                    "key column, or add a window for append output")
            pairs = [(a.runtime_field, a.out_name) for a in aggs]
            agg_stream = (stream.key_by(self.keys[0])
                          .running_aggregate(lane, retract=True))
            return agg_stream, pairs, self.keys[0]
        ta = self.wdef.time_attr
        schema = self.table.schema
        if ta != schema.time_attr:
            raise ValueError(
                f"window is over {ta!r} but the table's event-time "
                f"attribute is {schema.time_attr!r}; timestamps/"
                "watermarks follow the source's declared attribute")

        if self.keys:
            key = self.keys[0]
            agg_stream = (stream.key_by(key)
                          .window(self.wdef.assigner)
                          .aggregate(lane))
            key_out: Optional[str] = key
        else:
            agg_stream = (stream.window_all(self.wdef.assigner)
                          .aggregate(lane))
            key_out = None
        pairs = [(a.runtime_field, a.out_name) for a in aggs]
        return agg_stream, pairs, key_out

    def aggregate(self, *aggs: AggCall) -> Table:
        agg_stream, pairs, key_out = self._aggregate_stream(*aggs)
        cols = [key_out] if key_out else []
        if self.wdef is not None:
            cols += ["window_start", "window_end"]
        return finish_projection(
            self.table.t_env, agg_stream, pairs, key_out,
            cols + [name for _, name in pairs])

def finish_projection(t_env: TableEnvironment, agg_stream, pairs,
                      key_out: Optional[str],
                      want: Sequence[str]) -> Table:
    """Shared output projection for aggregations: rename the runtime
    result fields (key/window_start/window_end/<agg lanes>) to the
    SELECT aliases, emitting exactly ``want`` columns in order — plus
    the changelog op column when the input carries one (the op lane is
    runtime metadata riding OUTSIDE the SELECT list; a projection that
    dropped it would turn retractions back into inserts)."""
    from flink_tpu_torch.records import OP_FIELD

    def finish(data):
        out: Dict[str, np.ndarray] = {}
        for name in want:
            if name == key_out:
                out[name] = data["key"]
            elif name in ("window_start", "window_end"):
                out[name] = data[name]
        for rt, name in pairs:
            if name in want:
                out[name] = data[rt]
        if OP_FIELD in data:
            out[OP_FIELD] = data[OP_FIELD]
        return out

    return Table(t_env, agg_stream.map(finish, name="sql_agg_project"),
                 TableSchema(tuple(want)))
