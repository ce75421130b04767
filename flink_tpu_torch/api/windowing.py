"""Window assigners and triggers. A time window is lowered to panes: a
run of ``panes_per_window`` panes of ``pane_ms = gcd(size, slide)``, and
every record folds into exactly one (key, pane) cell. The processing-time
assigners use the same panes with the operator's clock as the time axis.
Session windows (``EventTimeSessionWindows``) merge by gap and have no
pane layout.

Triggers (``on_element`` / ``on_event_time`` returning CONTINUE, FIRE,
PURGE or FIRE_AND_PURGE) are evaluated per element only on the element
path (``ops/evicting_window.py``); the pane kernels fire at the
watermark (or the clock) alone."""
from __future__ import annotations

import dataclasses
import math

from flink_tpu_torch.records import MIN_TS


@dataclasses.dataclass(frozen=True, order=True)
class TimeWindow:
    """[start, end) in epoch ms."""

    start: int
    end: int

    def max_timestamp(self) -> int:
        return self.end - 1


class WindowAssigner:
    is_event_time: bool = True
    is_processing_time: bool = False
    is_merging: bool = False

    @property
    def pane_ms(self) -> int:
        raise NotImplementedError

    @property
    def size_ms(self) -> int:
        raise NotImplementedError

    @property
    def slide_ms(self) -> int:
        raise NotImplementedError

    @property
    def offset_ms(self) -> int:
        return 0

    @property
    def panes_per_window(self) -> int:
        return self.size_ms // self.pane_ms

    @property
    def panes_per_slide(self) -> int:
        return self.slide_ms // self.pane_ms

    def pane_index(self, timestamp: int) -> int:
        return (timestamp - self.offset_ms) // self.pane_ms

    def window_for_end_pane(self, end_pane: int) -> TimeWindow:
        end = end_pane * self.pane_ms + self.offset_ms
        return TimeWindow(end - self.size_ms, end)

    def assign_windows(self, timestamp: int) -> list:
        """Per-record window assignment (reference semantics for tests)."""
        if timestamp == MIN_TS:
            return []
        last_start = timestamp - (timestamp - self.offset_ms) % self.slide_ms
        out = []
        start = last_start
        while start > timestamp - self.size_ms:
            out.append(TimeWindow(start, start + self.size_ms))
            start -= self.slide_ms
        return list(reversed(out))


@dataclasses.dataclass(frozen=True)
class TumblingEventTimeWindows(WindowAssigner):
    size: int
    offset: int = 0

    @classmethod
    def of(cls, size_ms: int, offset_ms: int = 0) -> "TumblingEventTimeWindows":
        return cls(size_ms, offset_ms)

    def __post_init__(self) -> None:
        if self.size <= 0:
            raise ValueError("size must be positive")

    @property
    def pane_ms(self) -> int:
        return self.size

    @property
    def size_ms(self) -> int:
        return self.size

    @property
    def slide_ms(self) -> int:
        return self.size

    @property
    def offset_ms(self) -> int:
        return self.offset


@dataclasses.dataclass(frozen=True)
class SlidingEventTimeWindows(WindowAssigner):
    size: int
    slide: int
    offset: int = 0

    @classmethod
    def of(cls, size_ms: int, slide_ms: int,
           offset_ms: int = 0) -> "SlidingEventTimeWindows":
        return cls(size_ms, slide_ms, offset_ms)

    def __post_init__(self) -> None:
        if self.size <= 0 or self.slide <= 0:
            raise ValueError("size and slide must be positive")

    @property
    def pane_ms(self) -> int:
        return math.gcd(self.size, self.slide)

    @property
    def size_ms(self) -> int:
        return self.size

    @property
    def slide_ms(self) -> int:
        return self.slide

    @property
    def offset_ms(self) -> int:
        return self.offset


@dataclasses.dataclass(frozen=True)
class TumblingProcessingTimeWindows(WindowAssigner):
    """Tumbling windows over processing time: records are stamped with
    the operator's clock at ingest and fire as the clock passes their
    end, so nothing is late or out of order."""

    size: int
    offset: int = 0
    is_event_time = False
    is_processing_time = True

    @classmethod
    def of(cls, size_ms: int, offset_ms: int = 0) -> "TumblingProcessingTimeWindows":
        return cls(size_ms, offset_ms)

    @property
    def pane_ms(self) -> int:
        return self.size

    @property
    def size_ms(self) -> int:
        return self.size

    @property
    def slide_ms(self) -> int:
        return self.size

    @property
    def offset_ms(self) -> int:
        return self.offset


@dataclasses.dataclass(frozen=True)
class SlidingProcessingTimeWindows(WindowAssigner):
    """Sliding windows over processing time, panes as the event-time
    ones."""

    size: int
    slide: int
    offset: int = 0
    is_event_time = False
    is_processing_time = True

    @classmethod
    def of(cls, size_ms: int, slide_ms: int,
           offset_ms: int = 0) -> "SlidingProcessingTimeWindows":
        return cls(size_ms, slide_ms, offset_ms)

    def __post_init__(self) -> None:
        if self.size <= 0 or self.slide <= 0:
            raise ValueError("size and slide must be positive")

    @property
    def pane_ms(self) -> int:
        return math.gcd(self.size, self.slide)

    @property
    def size_ms(self) -> int:
        return self.size

    @property
    def slide_ms(self) -> int:
        return self.slide

    @property
    def offset_ms(self) -> int:
        return self.offset


@dataclasses.dataclass(frozen=True)
class EventTimeSessionWindows(WindowAssigner):
    """Gap-merged sessions: each record opens ``[ts, ts + gap)`` and a
    key's overlapping windows merge. A session's bounds come from its
    data, so it has no pane layout; ``ops/session.py`` keeps a span
    registry on the host."""

    gap: int
    is_merging = True

    @classmethod
    def with_gap(cls, gap_ms: int) -> "EventTimeSessionWindows":
        return cls(gap_ms)

    @property
    def pane_ms(self) -> int:
        raise TypeError("session windows are not pane-decomposable")


@dataclasses.dataclass(frozen=True)
class GlobalWindows(WindowAssigner):
    """One eternal window, fired only by a count or custom trigger."""

    is_event_time = False

    @classmethod
    def create(cls) -> "GlobalWindows":
        return cls()

    @property
    def pane_ms(self) -> int:
        raise TypeError("global windows are not pane-decomposable")


# ---------------------------------------------------------------------------
# Triggers: on_element / on_event_time return one of TriggerResult's four
# words; fires_on_watermark says whether the watermark fires the window.
# ---------------------------------------------------------------------------

class TriggerResult:
    CONTINUE = "CONTINUE"
    FIRE = "FIRE"
    PURGE = "PURGE"
    FIRE_AND_PURGE = "FIRE_AND_PURGE"


class Trigger:
    def on_element(self, timestamp: int, window: TimeWindow, count: int) -> str:
        return TriggerResult.CONTINUE

    def on_event_time(self, time: int, window: TimeWindow) -> str:
        return TriggerResult.CONTINUE

    def fires_on_watermark(self) -> bool:
        """Whether the watermark fires the window (event-time family)."""
        return False


class EventTimeTrigger(Trigger):
    """FIRE once the watermark passes the window's last timestamp."""

    @classmethod
    def create(cls) -> "EventTimeTrigger":
        return cls()

    def on_event_time(self, time: int, window: TimeWindow) -> str:
        return (TriggerResult.FIRE if time >= window.max_timestamp()
                else TriggerResult.CONTINUE)

    def fires_on_watermark(self) -> bool:
        return True


class ProcessingTimeTrigger(Trigger):
    """FIRE once the processing-time clock passes the window's last
    timestamp: the processing-time assigners' default trigger."""

    @classmethod
    def create(cls) -> "ProcessingTimeTrigger":
        return cls()

    def on_processing_time(self, time: int, window: TimeWindow) -> str:
        return (TriggerResult.FIRE if time >= window.max_timestamp()
                else TriggerResult.CONTINUE)

    def fires_on_watermark(self) -> bool:
        return False


@dataclasses.dataclass(frozen=True)
class CountTrigger(Trigger):
    """FIRE every ``max_count`` elements of a (key, window): the count
    is the window's, reset by each fire."""

    max_count: int

    @classmethod
    def of(cls, n: int) -> "CountTrigger":
        return cls(n)

    def on_element(self, timestamp: int, window: TimeWindow, count: int) -> str:
        return (TriggerResult.FIRE if count >= self.max_count
                else TriggerResult.CONTINUE)


@dataclasses.dataclass(frozen=True)
class PurgingTrigger(Trigger):
    """Wraps a trigger, turning its FIRE into FIRE_AND_PURGE."""

    inner: Trigger

    @classmethod
    def of(cls, inner: Trigger) -> "PurgingTrigger":
        return cls(inner)

    def on_element(self, timestamp: int, window: TimeWindow, count: int) -> str:
        r = self.inner.on_element(timestamp, window, count)
        return TriggerResult.FIRE_AND_PURGE if r == TriggerResult.FIRE else r

    def on_event_time(self, time: int, window: TimeWindow) -> str:
        r = self.inner.on_event_time(time, window)
        return TriggerResult.FIRE_AND_PURGE if r == TriggerResult.FIRE else r

    def fires_on_watermark(self) -> bool:
        return self.inner.fires_on_watermark()
