"""The logical transformation DAG the fluent API builds; nothing runs
until ``StreamExecutionEnvironment.execute()`` lowers it."""
from __future__ import annotations

import dataclasses
import itertools
from typing import Any, Callable, Optional, Tuple

from flink_tpu_torch.api.windowing import WindowAssigner
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
    """fn(data, ts, valid) -> (data, ts, valid), run on the host."""

    fn: Optional[Callable] = None
    kind: str = "map"


@dataclasses.dataclass(eq=False)
class KeyByTransformation(Transformation):
    """Hash partition by an int64 key column."""

    key_field: str = "key"


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


@dataclasses.dataclass(eq=False)
class CountWindowAggregateTransformation(Transformation):
    """Keyed count window + aggregate: fires each key every ``size``
    records (GlobalWindows + a count trigger, purging when ``purge``)."""

    size: int = 0
    purge: bool = True
    aggregate: Optional[LaneAggregate] = None
    key_field: str = "key"


@dataclasses.dataclass(eq=False)
class SinkTransformation(Transformation):
    sink: Any = None
