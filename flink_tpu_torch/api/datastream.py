"""The fluent DataStream API: each call appends a transformation;
nothing runs until ``StreamExecutionEnvironment.execute()``. The port
has map, key_by, window (with allowed_lateness), count_window,
count/sum/max/min/aggregate, top and add_sink. ``aggregate`` takes a
``LaneAggregate``; a user ``AggregateFunction`` goes through
``ops.aggregates.lower_aggregate`` first, as in the JAX package.
Triggers and the other operators are in ROADMAP.md."""
from __future__ import annotations

from typing import Any, Optional

from flink_tpu_torch.api.functions import as_batch_fn
from flink_tpu_torch.api.windowing import WindowAssigner
from flink_tpu_torch.graph.transformations import (
    CountWindowAggregateTransformation,
    KeyByTransformation,
    MapTransformation,
    SinkTransformation,
    Transformation,
    WindowAggregateTransformation,
)
from flink_tpu_torch.ops.aggregates import LaneAggregate


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

    def key_by(self, key: str, name: str = "keyBy") -> "KeyedStream":
        """Key by an int64 column."""
        if not isinstance(key, str):
            raise NotImplementedError(
                "key_by with a key function is not ported yet (ROADMAP.md); "
                "pass an int64 column name")
        t = KeyByTransformation(name, (self.transform,), key_field=key)
        self.env._register(t)
        return KeyedStream(self.env, t)

    def add_sink(self, sink: Any, name: str = "sink") -> "DataStream":
        return self._append(SinkTransformation(name, (self.transform,), sink=sink))

    def _append(self, t: Transformation) -> "DataStream":
        self.env._register(t)
        return DataStream(self.env, t)


class KeyedStream(DataStream):
    def window(self, assigner: WindowAssigner) -> "WindowedStream":
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

    def allowed_lateness(self, ms: int) -> "WindowedStream":
        """Keep each window's state ``ms`` past its end: a late record
        within it re-fires the window with the updated result."""
        self._lateness = ms
        return self

    def aggregate(self, agg: LaneAggregate,
                  name: str = "window_agg") -> "WindowedAggregateStream":
        kt = self.keyed.transform
        t = WindowAggregateTransformation(
            name, (kt,), assigner=self.assigner, aggregate=agg,
            key_field=kt.key_field, allowed_lateness_ms=self._lateness)
        self.keyed.env._register(t)
        return WindowedAggregateStream(self.keyed.env, t)


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
