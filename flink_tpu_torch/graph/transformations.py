"""The logical transformation DAG the fluent API builds; nothing runs
until ``StreamExecutionEnvironment.execute()`` lowers it."""
from __future__ import annotations

import dataclasses
import itertools
from typing import Any, Callable, Optional, Tuple

from flink_tpu_torch.api.windowing import Trigger, WindowAssigner
from flink_tpu_torch.ops.aggregates import LaneAggregate
from flink_tpu_torch.time.watermarks import WatermarkStrategy

_ids = itertools.count()


@dataclasses.dataclass
class Transformation:
    name: str
    inputs: Tuple["Transformation", ...] = ()

    def __post_init__(self) -> None:
        self.id = next(_ids)

    def __hash__(self) -> int:
        return self.id

    def __eq__(self, other: object) -> bool:
        return self is other


@dataclasses.dataclass(eq=False)
class SourceTransformation(Transformation):
    source: Any = None
    watermark_strategy: Optional[WatermarkStrategy] = None


@dataclasses.dataclass(eq=False)
class MapTransformation(Transformation):
    """fn(data, ts, valid) -> (data, ts, valid), run on the host; ``kind``
    is map, filter or flatmap (all chain alike)."""

    fn: Optional[Callable] = None
    kind: str = "map"


@dataclasses.dataclass(eq=False)
class KeyByTransformation(Transformation):
    """Hash partition by an int64 key column; ``key_fn(data) -> (B,)``
    derives that column first when given."""

    key_field: str = "key"
    key_fn: Optional[Callable] = None


@dataclasses.dataclass(eq=False)
class WindowAggregateTransformation(Transformation):
    """Keyed window + aggregate; ``top_n = (result_field, n)`` fuses a
    per-window top-n into the fire; late records within
    ``allowed_lateness_ms`` re-fire their windows."""

    assigner: Optional[WindowAssigner] = None
    aggregate: Optional[LaneAggregate] = None
    key_field: str = "key"
    top_n: Optional[Tuple[str, int]] = None
    allowed_lateness_ms: int = 0
    trigger: Optional[Trigger] = None


@dataclasses.dataclass(eq=False)
class EvictingWindowTransformation(Transformation):
    """Keyed window with an evictor or a trigger outside the pane
    kernels' families: the element path (``ops/evicting_window.py``)."""

    assigner: Optional[WindowAssigner] = None
    window_fn: Any = None        # fn(elements incl. __ts__) -> row, or ElementAggregate
    trigger: Optional[Trigger] = None
    evictor: Any = None
    allowed_lateness_ms: int = 0
    key_field: str = "key"


@dataclasses.dataclass(eq=False)
class CountWindowAggregateTransformation(Transformation):
    """Keyed count window + aggregate: fires each key every ``size``
    records (GlobalWindows + a count trigger, purging when ``purge``)."""

    size: int = 0
    purge: bool = True
    aggregate: Optional[LaneAggregate] = None
    key_field: str = "key"


@dataclasses.dataclass(eq=False)
class WindowAllAggregateTransformation(Transformation):
    """Non-keyed global window + aggregate, folded per pane on the host
    (``ops/window_all.py``)."""

    assigner: Optional[WindowAssigner] = None
    aggregate: Optional[LaneAggregate] = None
    allowed_lateness_ms: int = 0


@dataclasses.dataclass(eq=False)
class WindowJoinTransformation(Transformation):
    """Two-input window equi-join (``ops/join.py``); ``inputs`` are
    (left, right)."""

    assigner: Optional[WindowAssigner] = None
    left_key: str = "key"
    right_key: str = "key"
    left_fields: Tuple[str, ...] = ()
    right_fields: Tuple[str, ...] = ()
    mode: str = "pairs"  # "pairs" (exact) | "aggregate" (per-side summary)


@dataclasses.dataclass(eq=False)
class SessionAggregateTransformation(Transformation):
    """Keyed session windows + aggregate (``ops/session.py``);
    ``retract=True`` op-types the output: a merge that consumes a fired
    span retracts its row (-U) before the merged session (re)fires
    (+U)."""

    gap_ms: int = 0
    aggregate: Optional[LaneAggregate] = None
    allowed_lateness_ms: int = 0
    key_field: str = "key"
    retract: bool = False


@dataclasses.dataclass(eq=False)
class PartitionTransformation(Transformation):
    """Non-keyed redistribution: ``strategy`` is one of
    rebalance|rescale|shuffle|broadcast|global|forward, lowered to a
    node of its own (an exchange boundary); the subtask assignment lives
    in ``exchange/partitioners.py``."""

    strategy: str = "rebalance"


@dataclasses.dataclass(eq=False)
class SinkTransformation(Transformation):
    sink: Any = None


@dataclasses.dataclass(eq=False)
class UnionTransformation(Transformation):
    """Merge of several streams with one schema."""
