"""Restart backoff strategies.

ref: runtime/executiongraph/failover/{FixedDelayRestartBackoffTimeStrategy,
ExponentialDelayRestartBackoffTimeStrategy,
FailureRateRestartBackoffTimeStrategy}.java and the
``restart-strategy.*`` option namespace.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, List

from flink_tpu_torch.config import Configuration, RestartOptions


class RestartStrategy:
    def can_restart(self) -> bool:
        raise NotImplementedError

    def next_delay_ms(self) -> int:
        """Record one failure and return the backoff before restarting."""
        raise NotImplementedError


class NoRestartStrategy(RestartStrategy):
    def can_restart(self) -> bool:
        return False

    def next_delay_ms(self) -> int:
        raise RuntimeError("restart disabled (restart-strategy: none)")


@dataclasses.dataclass
class FixedDelayRestartStrategy(RestartStrategy):
    max_attempts: int = 3
    delay_ms: int = 1000
    _failures: int = 0

    def can_restart(self) -> bool:
        return self._failures < self.max_attempts

    def next_delay_ms(self) -> int:
        self._failures += 1
        return self.delay_ms


@dataclasses.dataclass
class ExponentialDelayRestartStrategy(RestartStrategy):
    """Delay doubles per failure up to max; resets after a quiet period
    (ref: ExponentialDelayRestartBackoffTimeStrategy defaults 1s→5min,
    backoff multiplier 2, reset threshold 1h).

    ``now_fn`` is the clock seam: time-dependent backoff logic is
    tested with an injected fake clock instead of wall time (ref: the
    ManualClock every reference backoff-strategy test drives)."""

    initial_ms: int = 1000
    max_ms: int = 300_000
    multiplier: float = 2.0
    reset_after_ms: int = 3_600_000
    now_fn: Callable[[], float] = time.time
    _current: int = 0
    _last_failure: float = 0.0

    def can_restart(self) -> bool:
        return True

    def next_delay_ms(self) -> int:
        now = self.now_fn()
        if self._last_failure and (now - self._last_failure) * 1000 >= self.reset_after_ms:
            self._current = 0
        self._last_failure = now
        if self._current == 0:
            self._current = self.initial_ms
        else:
            self._current = min(int(self._current * self.multiplier), self.max_ms)
        return self._current


@dataclasses.dataclass
class FailureRateRestartStrategy(RestartStrategy):
    """Allow at most ``max_failures`` per ``interval_ms`` window
    (ref: FailureRateRestartBackoffTimeStrategy)."""

    max_failures: int = 3
    interval_ms: int = 60_000
    delay_ms: int = 1000
    now_fn: Callable[[], float] = time.time

    def __post_init__(self) -> None:
        self._times: List[float] = []

    def can_restart(self) -> bool:
        cut = self.now_fn() - self.interval_ms / 1000
        self._times = [t for t in self._times if t >= cut]
        return len(self._times) < self.max_failures

    def next_delay_ms(self) -> int:
        self._times.append(self.now_fn())
        return self.delay_ms


def from_config(config: Configuration) -> RestartStrategy:
    kind = config.get(RestartOptions.STRATEGY)
    if kind == "none":
        return NoRestartStrategy()
    if kind == "fixed-delay":
        return FixedDelayRestartStrategy(
            config.get(RestartOptions.ATTEMPTS),
            config.get(RestartOptions.DELAY))
    if kind == "failure-rate":
        return FailureRateRestartStrategy()
    return ExponentialDelayRestartStrategy()
