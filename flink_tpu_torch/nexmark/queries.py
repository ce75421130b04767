"""Nexmark query pipelines over the port's DataStream API: Q5 hot items,
Q7 highest bid (windowAll) and Q8 new users (a windowed join)."""
from __future__ import annotations

from flink_tpu_torch.api.datastream import DataStream
from flink_tpu_torch.api.environment import StreamExecutionEnvironment
from flink_tpu_torch.api.sinks import Sink
from flink_tpu_torch.api.windowing import (
    SlidingEventTimeWindows, TumblingEventTimeWindows)
from flink_tpu_torch.time.watermarks import WatermarkStrategy


def q5_hot_items(
    env: StreamExecutionEnvironment,
    bids,
    sink: Sink,
    *,
    window_ms: int = 10_000,
    slide_ms: int = 1_000,
    out_of_orderness_ms: int = 0,
) -> DataStream:
    """Q5: the auctions with the most bids per sliding window — a
    per-auction COUNT over the window, and each window's top-1 auctions
    (ties kept) selected on the device in the fire."""
    stream = env.from_source(
        bids, WatermarkStrategy.for_bounded_out_of_orderness(out_of_orderness_ms))
    top = (
        stream.key_by("auction")
        .window(SlidingEventTimeWindows.of(window_ms, slide_ms))
        .count()
        .top(1, by="count")
    )

    def rename(data):
        return {"auction": data["key"], "window_end": data["window_end"],
                "bid_count": data["count"]}

    out = top.map(rename, name="q5_rename")
    out.add_sink(sink)
    return out


def q7_highest_bid(
    env: StreamExecutionEnvironment,
    bids,
    sink: Sink,
    *,
    window_ms: int = 10_000,
    out_of_orderness_ms: int = 0,
) -> DataStream:
    """Q7: the highest bid price per tumbling window — the windowAll
    shape, folded per pane on the host (``ops/window_all.py``), with no
    key and no funnel to one subtask."""
    stream = env.from_source(
        bids, WatermarkStrategy.for_bounded_out_of_orderness(out_of_orderness_ms))
    out = (
        stream.window_all(TumblingEventTimeWindows.of(window_ms))
        .max("price")
    )
    out.add_sink(sink)
    return out


def q8_monitor_new_users(
    env: StreamExecutionEnvironment,
    persons,
    auctions,
    sink: Sink,
    *,
    window_ms: int = 10_000,
    out_of_orderness_ms: int = 0,
    mode: str = "pairs",
) -> DataStream:
    """Q8: persons who created an auction in the tumbling window they
    registered in (person ⋈ auction on seller). ``mode`` is the join's
    (``ops/join.py``): 'pairs', the default, or 'aggregate'."""
    wm = WatermarkStrategy.for_bounded_out_of_orderness(out_of_orderness_ms)
    p = env.from_source(persons, wm)
    a = env.from_source(auctions, wm)
    out = (
        p.join(a).where("person").equal_to("seller")
        .window(TumblingEventTimeWindows.of(window_ms))
        .apply(left_fields=("state_id",), right_fields=("reserve",),
               mode=mode)
    )
    out.add_sink(sink)
    return out
