"""Event-time watermarks: the host watermark clock advances once per
batch from the batch's max timestamp, and the driver takes the min over
a source's splits and over a node's inputs. A generator's state (its
max timestamp) rides in checkpoints (``snapshot``/``restore``)."""
from __future__ import annotations

import dataclasses
from typing import Dict

from flink_tpu_torch.records import MIN_TS

LONG_MIN = int(MIN_TS)


@dataclasses.dataclass(frozen=True)
class WatermarkStrategy:
    """How far behind the max seen timestamp the watermark trails."""

    max_out_of_orderness_ms: int = 0

    @classmethod
    def for_monotonous_timestamps(cls) -> "WatermarkStrategy":
        return cls(0)

    @classmethod
    def for_bounded_out_of_orderness(cls, ms: int) -> "WatermarkStrategy":
        return cls(ms)


class MonotonousWatermarks:
    """wm = max_ts - 1."""

    def __init__(self) -> None:
        self._max_ts = LONG_MIN

    def on_batch(self, max_ts: int) -> int:
        if max_ts > self._max_ts:
            self._max_ts = max_ts
        return self.current()

    def current(self) -> int:
        return self._max_ts - 1 if self._max_ts != LONG_MIN else LONG_MIN

    def snapshot(self) -> int:
        return self._max_ts

    def restore(self, state: int) -> None:
        self._max_ts = state


class BoundedOutOfOrdernessWatermarks:
    """wm = max_ts - delay - 1."""

    def __init__(self, delay_ms: int) -> None:
        self._delay = int(delay_ms)
        self._max_ts = LONG_MIN

    def on_batch(self, max_ts: int) -> int:
        if max_ts > self._max_ts:
            self._max_ts = max_ts
        return self.current()

    def current(self) -> int:
        if self._max_ts == LONG_MIN:
            return LONG_MIN
        return self._max_ts - self._delay - 1

    def snapshot(self) -> int:
        return self._max_ts

    def restore(self, state: int) -> None:
        self._max_ts = state


def make_generator(strategy: WatermarkStrategy):
    if strategy.max_out_of_orderness_ms <= 0:
        return MonotonousWatermarks()
    return BoundedOutOfOrdernessWatermarks(strategy.max_out_of_orderness_ms)


class WatermarkTracker:
    """Min-over-inputs watermark combiner with idle inputs left out of
    the min; the combined watermark never regresses."""

    def __init__(self) -> None:
        self._per_input: Dict[str, int] = {}
        self._idle: Dict[str, bool] = {}
        self._current = LONG_MIN

    def register_input(self, input_id: str) -> None:
        self._per_input.setdefault(input_id, LONG_MIN)
        self._idle.setdefault(input_id, False)

    def update(self, input_id: str, watermark: int, idle: bool = False) -> int:
        self._idle[input_id] = idle
        if not idle:
            prev = self._per_input.get(input_id, LONG_MIN)
            self._per_input[input_id] = max(prev, watermark)
        return self.current()

    def current(self) -> int:
        active = [wm for iid, wm in self._per_input.items()
                  if not self._idle.get(iid, False)]
        if not active:
            active = list(self._per_input.values())
        if not active:
            return self._current
        combined = min(active)
        if combined > self._current:
            self._current = combined
        return self._current
