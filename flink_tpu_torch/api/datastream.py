"""The fluent DataStream API: each call appends a transformation;
nothing runs until ``StreamExecutionEnvironment.execute()``. The port
has map, map_with_timestamps, filter, flat_map,
assign_timestamps_and_watermarks, union, key_by (a column or a key
function), print, collect and add_sink; window (with allowed_lateness,
trigger and evictor), count_window, count/sum/max/min/aggregate, apply
and top; session windows (``window(EventTimeSessionWindows.with_gap(
gap))``, with allowed_lateness and a retracting ``aggregate``);
window_all (``AllWindowedStream``); and the windowed equi-join
``join(other).where(k).equal_to(k).window(w).apply(...)`` in its two
modes; and the partitioners rebalance, rescale, shuffle, broadcast and
global_. ``map`` and ``filter`` also take a ``MapFunction`` or a
``FilterFunction`` (``api/functions.py``). ``aggregate`` takes a
``LaneAggregate``; a user ``AggregateFunction`` goes through
``ops.aggregates.lower_aggregate`` first, as in the JAX package. An
evictor, or a trigger outside the pane kernels' families, routes a
window onto the element path (``ops/evicting_window.py``). Async
I/O, connect, running_aggregate and process are in
ROADMAP.md."""
from __future__ import annotations

from typing import Any, Callable, Optional, Sequence, Union

import numpy as np

from flink_tpu_torch.api.functions import as_batch_fn, as_predicate
from flink_tpu_torch.api.windowing import (
    EventTimeSessionWindows, Trigger, WindowAssigner)
from flink_tpu_torch.graph.transformations import (
    CountWindowAggregateTransformation,
    EvictingWindowTransformation,
    KeyByTransformation,
    MapTransformation,
    PartitionTransformation,
    SessionAggregateTransformation,
    SinkTransformation,
    Transformation,
    UnionTransformation,
    WindowAggregateTransformation,
    WindowAllAggregateTransformation,
    WindowJoinTransformation,
)
from flink_tpu_torch.ops.aggregates import LaneAggregate
from flink_tpu_torch.time.watermarks import WatermarkStrategy


class DataStream:
    def __init__(self, env, transform: Transformation):
        self.env = env
        self.transform = transform

    def map(self, fn, name: str = "map") -> "DataStream":
        """``fn(data_dict) -> data_dict`` over (B,) numpy field arrays
        (or a MapFunction's ``map_batch``)."""
        batch_fn = as_batch_fn(fn)

        def op(data, ts, valid):
            return batch_fn(data), ts, valid

        return self._append(MapTransformation(name, (self.transform,), fn=op))

    def map_with_timestamps(self, fn: Callable,
                            name: str = "map_ts") -> "DataStream":
        """``fn(data, ts, valid) -> (data, ts, valid)``: a map that may
        also rewrite the timestamps and the valid mask."""
        return self._append(MapTransformation(name, (self.transform,), fn=fn))

    def filter(self, pred: Callable, name: str = "filter") -> "DataStream":
        """``pred(data) -> (B,) bool`` (or a FilterFunction's
        ``filter_batch``), ANDed into the valid mask."""
        pred = as_predicate(pred)

        def op(data, ts, valid):
            return data, ts, valid & np.asarray(pred(data), bool)

        return self._append(MapTransformation(name, (self.transform,), fn=op,
                                              kind="filter"))

    def flat_map(self, fn: Callable, name: str = "flat_map") -> "DataStream":
        """``fn(data, ts, valid) -> (data', ts', valid')`` of any length;
        runs on the host like every chain function."""
        return self._append(MapTransformation(name, (self.transform,), fn=fn,
                                              kind="flatmap"))

    def assign_timestamps_and_watermarks(
            self, strategy: WatermarkStrategy, ts_field: Optional[str] = None,
            name: str = "assign_ts") -> "DataStream":
        """Set the job's watermark strategy; with ``ts_field`` the records'
        timestamps are re-read from that column."""
        self.env._watermark_strategy = strategy
        if ts_field is None:
            return self

        def op(data, ts, valid):
            return data, np.asarray(data[ts_field]).astype(np.int64), valid

        return self._append(MapTransformation(name, (self.transform,), fn=op))

    def union(self, *others: "DataStream") -> "DataStream":
        inputs = (self.transform,) + tuple(o.transform for o in others)
        return self._append(UnionTransformation("union", inputs))

    def key_by(self, key: Union[str, Callable],
               name: str = "keyBy") -> "KeyedStream":
        """Key by an int64 column, or by ``key(data) -> (B,)`` int64,
        written to a column of the keyBy's own (two keyBys off one
        stream never share it)."""
        if callable(key):
            t = KeyByTransformation(name, (self.transform,), key_fn=key)
            t.key_field = f"__key_{t.id}__"
        else:
            t = KeyByTransformation(name, (self.transform,), key_field=key)
        self.env._register(t)
        return KeyedStream(self.env, t)

    # -- non-keyed partitioning (ref: DataStream.{rebalance,rescale,
    # shuffle,broadcast,global} → PartitionTransformation) ---------------
    def rebalance(self) -> "DataStream":
        """Round-robin across parallel subtasks: an exact equal spread."""
        return self._partition("rebalance")

    def rescale(self) -> "DataStream":
        """Round-robin within the local scale group (never cross-host)."""
        return self._partition("rescale")

    def shuffle(self) -> "DataStream":
        """A uniform random subtask a record (seeded: replay-stable)."""
        return self._partition("shuffle")

    def broadcast(self) -> "DataStream":
        """Every record to every subtask."""
        return self._partition("broadcast")

    def global_(self) -> "DataStream":
        """Everything to subtask 0 (``global`` is a Python keyword)."""
        return self._partition("global")

    def _partition(self, strategy: str) -> "DataStream":
        return self._append(PartitionTransformation(
            strategy, (self.transform,), strategy=strategy))

    def window_all(self, assigner: WindowAssigner) -> "AllWindowedStream":
        """A global (non-keyed) window over all records, folded per pane
        on the host (``ops/window_all.py``)."""
        return AllWindowedStream(self, assigner)

    def join(self, other: "DataStream") -> "JoinBuilder":
        """``join(other).where(k).equal_to(k).window(w).apply(...)``: a
        windowed equi-join of this stream (left) with ``other`` (right)."""
        return JoinBuilder(self, other)

    def add_sink(self, sink: Any, name: str = "sink") -> "DataStream":
        return self._append(SinkTransformation(name, (self.transform,), sink=sink))

    def print(self, prefix: str = "", limit: Optional[int] = None) -> "DataStream":
        from flink_tpu_torch.api.sinks import PrintSink

        return self.add_sink(PrintSink(prefix, limit), name="print")

    def collect(self):
        """Attach a ``CollectSink`` and return it; its rows fill during
        ``execute()``."""
        from flink_tpu_torch.api.sinks import CollectSink

        sink = CollectSink()
        self.add_sink(sink, name="collect")
        return sink

    def _append(self, t: Transformation) -> "DataStream":
        self.env._register(t)
        return DataStream(self.env, t)


class KeyedStream(DataStream):
    def window(self, assigner: WindowAssigner) -> "WindowedStream":
        if isinstance(assigner, EventTimeSessionWindows):
            return SessionWindowedStream(self, assigner)
        return WindowedStream(self, assigner)

    def count_window(self, size: int) -> "CountWindowedStream":
        """Fire each key every ``size`` records (GlobalWindows + a
        purging count trigger). The trigger is checked per batch: a key
        crossing ``size`` inside a batch fires once with its full
        aggregate (``ops/count_window.py``)."""
        return CountWindowedStream(self, size, purge=True)


class _AggregateShortcuts:
    """count/sum/max/min, shared by the windowed stream kinds; each
    delegates to the subclass's ``aggregate``."""

    def count(self):
        from flink_tpu_torch.ops.aggregates import count as count_agg

        return self.aggregate(count_agg())

    def sum(self, field: str):
        from flink_tpu_torch.ops.aggregates import sum_of

        return self.aggregate(sum_of(field))

    def max(self, field: str):
        from flink_tpu_torch.ops.aggregates import max_of

        return self.aggregate(max_of(field))

    def min(self, field: str):
        from flink_tpu_torch.ops.aggregates import min_of

        return self.aggregate(min_of(field))


class WindowedStream(_AggregateShortcuts):
    def __init__(self, keyed: KeyedStream, assigner: WindowAssigner):
        self.keyed = keyed
        self.assigner = assigner
        self._lateness = 0
        self._trigger: Optional[Trigger] = None
        self._evictor = None

    def allowed_lateness(self, ms: int) -> "WindowedStream":
        """Keep each window's state ``ms`` past its end: a late record
        within it re-fires the window with the updated result."""
        self._lateness = ms
        return self

    def trigger(self, trigger: Trigger) -> "WindowedStream":
        self._trigger = trigger
        return self

    def evictor(self, evictor) -> "WindowedStream":
        """Evict before the window function: routes the window onto the
        element path, which keeps the window's elements until it fires."""
        self._evictor = evictor
        return self

    def _element_path(self) -> bool:
        """Whether the window runs on the element path: an evictor is
        set, or the trigger is outside the pane kernels' families (a
        user trigger, a count trigger on time windows, a purging
        event-time trigger with lateness)."""
        from flink_tpu_torch.api.windowing import (
            EventTimeTrigger, ProcessingTimeTrigger, PurgingTrigger)

        if self._evictor is not None:
            return True
        t = self._trigger
        if t is None or isinstance(t, (EventTimeTrigger, ProcessingTimeTrigger)):
            return False
        return not (isinstance(t, PurgingTrigger)
                    and isinstance(t.inner, EventTimeTrigger)
                    and self._lateness == 0)

    def apply(self, window_fn, name: str = "evicting_window") -> DataStream:
        """``window_fn(elements) -> row fields`` over each fired window's
        surviving elements (field arrays plus ``__ts__``), on the
        element path."""
        self._check_element_path()
        kt = self.keyed.transform
        t = EvictingWindowTransformation(
            name, (kt,), assigner=self.assigner, window_fn=window_fn,
            trigger=self._trigger, evictor=self._evictor,
            allowed_lateness_ms=self._lateness, key_field=kt.key_field)
        self.keyed.env._register(t)
        return DataStream(self.keyed.env, t)

    def _check_element_path(self) -> None:
        """The element path assigns and fires on event time: refuse a
        processing-time assigner or trigger there."""
        from flink_tpu_torch.api.windowing import (
            ProcessingTimeTrigger, PurgingTrigger)

        if self.assigner.is_processing_time:
            raise NotImplementedError(
                "processing-time window assigners are not supported on "
                "the element-buffer (evictor/custom-trigger) path — it "
                "assigns and fires on event time; use an event-time "
                "assigner or drop the evictor/custom trigger")
        t = self._trigger
        inner = t.inner if isinstance(t, PurgingTrigger) else t
        if isinstance(inner, ProcessingTimeTrigger):
            raise NotImplementedError(
                "ProcessingTimeTrigger is not supported on the element-"
                "buffer (evictor/custom-trigger) path — fires are "
                "driven by the event watermark there")

    def _check_trigger(self) -> None:
        """Refuse, at build time, a trigger and window pair the pane
        kernels cannot run."""
        from flink_tpu_torch.api.windowing import (
            CountTrigger, EventTimeTrigger, ProcessingTimeTrigger,
            PurgingTrigger)

        proc = self.assigner.is_processing_time
        if proc and self._lateness:
            raise NotImplementedError(
                "allowed lateness is an event-time concept; processing-"
                "time windows cannot see late records")
        t = self._trigger
        if isinstance(t, ProcessingTimeTrigger):
            if proc:
                return  # the processing-time assigners' default trigger
            raise NotImplementedError(
                "ProcessingTimeTrigger requires a processing-time window "
                "assigner (Tumbling/SlidingProcessingTimeWindows)")
        if proc and isinstance(t, EventTimeTrigger):
            raise NotImplementedError(
                "EventTimeTrigger on processing-time windows is not "
                "supported — the window's time axis is the clock")
        if t is None or isinstance(t, EventTimeTrigger):
            return
        if isinstance(t, PurgingTrigger) and isinstance(t.inner,
                                                        EventTimeTrigger):
            # with no lateness the state is purged at the fire anyway
            if self._lateness == 0:
                return
            raise NotImplementedError(
                "PurgingTrigger(EventTimeTrigger) with allowed lateness "
                "> 0 is not supported (late records would need "
                "fresh-state semantics); drop the lateness or the "
                "purging wrapper")
        inner = t.inner if isinstance(t, PurgingTrigger) else t
        if isinstance(inner, CountTrigger):
            raise NotImplementedError(
                "count triggers on time windows are not supported; use "
                "key_by(...).count_window(n)")
        raise NotImplementedError(
            f"unsupported trigger {type(t).__name__} for time windows")

    def aggregate(self, agg: LaneAggregate, name: str = "window_agg"):
        """A ``WindowedAggregateStream`` over the pane kernels, or, on the
        element path, a ``DataStream`` whose windows reduce through
        ``segment_lanes``."""
        if self._element_path():
            return self.apply(_element_window_fn(agg), name=name)
        self._check_trigger()
        kt = self.keyed.transform
        t = WindowAggregateTransformation(
            name, (kt,), assigner=self.assigner, aggregate=agg,
            key_field=kt.key_field, allowed_lateness_ms=self._lateness,
            trigger=self._trigger)
        self.keyed.env._register(t)
        return WindowedAggregateStream(self.keyed.env, t)


def _element_window_fn(agg: LaneAggregate):
    """A lane aggregate as the element path's window function: the
    operator recognises it and reduces all pending fires' survivors in
    one ``segment_lanes`` launch, then finalizes them on the grid."""
    from flink_tpu_torch.ops.evicting_window import ElementAggregate

    return ElementAggregate(agg)


class CountWindowedStream(_AggregateShortcuts):
    def __init__(self, keyed: KeyedStream, size: int, purge: bool = True):
        self.keyed = keyed
        self.size = size
        self.purge = purge

    def aggregate(self, agg: LaneAggregate,
                  name: str = "count_window_agg") -> DataStream:
        kt = self.keyed.transform
        t = CountWindowAggregateTransformation(
            name, (kt,), size=self.size, purge=self.purge, aggregate=agg,
            key_field=kt.key_field)
        self.keyed.env._register(t)
        return DataStream(self.keyed.env, t)


class WindowedAggregateStream(DataStream):
    def top(self, n: int, by: Optional[str] = None,
            name: str = "window_top") -> DataStream:
        """Keep each window's top-``n`` rows by result field ``by`` (ties
        at the n-th value kept), selected on the device in the fire."""
        t = self.transform
        if by is None:
            from flink_tpu_torch.ops.aggregates import result_fields

            fields = result_fields(t.aggregate)
            if len(fields) != 1:
                raise ValueError(
                    f"aggregate produces {fields}; pass by= explicitly")
            by = fields[0]
        t.top_n = (by, n)
        return self


class SessionWindowedStream(WindowedStream):
    """Keyed session windows (``ops/session.py``): allowed_lateness and
    the aggregate shortcuts as on time windows."""

    def aggregate(self, agg: LaneAggregate, name: str = "session_agg",
                  retract: bool = False) -> DataStream:
        """``retract=True``: a merge that consumes a fired session emits
        -U for its stale row before the merged session fires +I/+U."""
        if self._evictor is not None:
            raise NotImplementedError(
                "an evictor on session windows is not supported: the "
                "session operator keeps lanes, not elements")
        self._check_trigger()
        kt = self.keyed.transform
        t = SessionAggregateTransformation(
            name, (kt,), gap_ms=self.assigner.gap, aggregate=agg,
            allowed_lateness_ms=self._lateness, key_field=kt.key_field,
            retract=retract)
        self.keyed.env._register(t)
        return DataStream(self.keyed.env, t)


class AllWindowedStream(_AggregateShortcuts):
    def __init__(self, stream: DataStream, assigner: WindowAssigner):
        self.stream = stream
        self.assigner = assigner
        self._lateness = 0

    def allowed_lateness(self, ms: int) -> "AllWindowedStream":
        self._lateness = ms
        return self

    def aggregate(self, agg: LaneAggregate,
                  name: str = "window_all_agg") -> DataStream:
        t = WindowAllAggregateTransformation(
            name, (self.stream.transform,), assigner=self.assigner,
            aggregate=agg, allowed_lateness_ms=self._lateness)
        self.stream.env._register(t)
        return DataStream(self.stream.env, t)


class JoinBuilder:
    """The where / equal_to / window chain of a windowed join."""

    def __init__(self, left: DataStream, right: DataStream):
        self._left = left
        self._right = right
        self._left_key: Optional[str] = None
        self._right_key: Optional[str] = None

    def where(self, key_field: str) -> "JoinBuilder":
        self._left_key = key_field
        return self

    def equal_to(self, key_field: str) -> "JoinBuilder":
        self._right_key = key_field
        return self

    def window(self, assigner: WindowAssigner) -> "WindowedJoin":
        return WindowedJoin(self, assigner)


class WindowedJoin:
    def __init__(self, builder: JoinBuilder, assigner: WindowAssigner):
        self.b = builder
        self.assigner = assigner

    def apply(self, left_fields: Sequence[str] = (),
              right_fields: Sequence[str] = (), name: str = "window_join",
              mode: str = "pairs") -> DataStream:
        """``mode='pairs'`` (default): one row per matching left × right
        pair, Flink's JoinFunction semantics. ``mode='aggregate'``: one
        row per (key, window) present on both sides with each side's
        count and max-carried fields (``ops/join.py``)."""
        env = self.b._left.env
        t = WindowJoinTransformation(
            name, (self.b._left.transform, self.b._right.transform),
            assigner=self.assigner,
            left_key=self.b._left_key or "key",
            right_key=self.b._right_key or "key",
            left_fields=tuple(left_fields), right_fields=tuple(right_fields),
            mode=mode)
        env._register(t)
        return DataStream(env, t)
