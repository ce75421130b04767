"""Tracing: spans for checkpoints and recovery.

A process-global ``Tracer`` keeps a bounded ring of completed spans
(the JAX package's ``obs/tracing.py``). Spans are one dataclass and two
clock reads, started and ended on the driver loop and the checkpoint
executor at checkpoint frequency, never per record. Reporters receive
each completed span synchronously; a failing reporter never fails the
job.

Spans the port records: ``checkpoint.barrier`` (the fire drain a
checkpoint starts with) and ``checkpoint.freeze`` (the sinks' staging
and the snapshot), the loop thread's part of a checkpoint;
``checkpoint.persist`` (the executor's fetch,
encoding and write, with ``bytes``), ``checkpoint.failed`` (a tolerated
periodic failure), ``checkpoint.abort-notify-failed``, ``restore``,
``recovery`` (a supervised restart) and ``fault`` (an injected fault).
The thread sampler of the reference's REST flame graph comes with
``obs/rest.py`` (ROADMAP.md queue 1 item 10).
"""
from __future__ import annotations

import collections
import dataclasses
import threading
import time
from typing import Any, Callable, Dict, List, Optional

__all__ = ["Span", "Tracer", "tracer"]


@dataclasses.dataclass
class Span:
    name: str
    start: float
    end: Optional[float] = None
    attributes: Dict[str, Any] = dataclasses.field(default_factory=dict)

    @property
    def duration_ms(self) -> Optional[float]:
        return None if self.end is None else (self.end - self.start) * 1e3

    def to_dict(self) -> Dict[str, Any]:
        return {"name": self.name, "start": self.start,
                "duration_ms": self.duration_ms,
                "attributes": dict(self.attributes)}


class _SpanHandle:
    """Context manager recording one span; ``set(k, v)`` attaches
    attributes mid-flight (e.g. bytes persisted)."""

    def __init__(self, trc: "Tracer", span: Span) -> None:
        self._trc = trc
        self.span = span

    def set(self, key: str, value: Any) -> "_SpanHandle":
        self.span.attributes[key] = value
        return self

    def __enter__(self) -> "_SpanHandle":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        if exc is not None:
            self.span.attributes["error"] = f"{type(exc).__name__}: {exc}"
        self._trc._finish(self.span)


class Tracer:
    def __init__(self, capacity: int = 512) -> None:
        self._done: collections.deque = collections.deque(maxlen=capacity)
        self._reporters: List[Callable[[Span], None]] = []
        self._lock = threading.Lock()

    def span(self, name: str, **attributes: Any) -> _SpanHandle:
        return _SpanHandle(self, Span(name, time.time(),
                                      attributes=dict(attributes)))

    def add_reporter(self, fn: Callable[[Span], None]) -> None:
        with self._lock:
            self._reporters.append(fn)

    def _finish(self, span: Span) -> None:
        span.end = time.time()
        with self._lock:
            self._done.append(span)
            reporters = list(self._reporters)
        for r in reporters:
            try:
                r(span)
            except Exception:  # noqa: BLE001 — reporters must not break jobs
                pass

    def spans(self, name_prefix: str = "") -> List[Dict[str, Any]]:
        with self._lock:
            items = list(self._done)
        return [s.to_dict() for s in items
                if s.name.startswith(name_prefix)]

    def clear(self) -> None:
        with self._lock:
            self._done.clear()


# process-global tracer: one per process, sub-systems attach by name
tracer = Tracer()
