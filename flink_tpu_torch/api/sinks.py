"""Sinks consume fired/transformed batches on the host. Only the
write-through sinks are ported; the two-phase-commit sinks are in
ROADMAP.md with checkpointing."""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional

import numpy as np


def rows_of(batch: Dict[str, np.ndarray]) -> List[Dict[str, Any]]:
    """Explode a columnar batch into per-record dicts."""
    if not batch:
        return []
    n = len(next(iter(batch.values())))
    return [{k: v[i] for k, v in batch.items()} for i in range(n)]


class Sink:
    def write(self, batch: Dict[str, np.ndarray]) -> None:
        raise NotImplementedError

    def close(self) -> None:
        pass


@dataclasses.dataclass
class CollectSink(Sink):
    """Gather result rows in memory."""

    rows: List[Dict[str, Any]] = dataclasses.field(default_factory=list)

    def write(self, batch: Dict[str, np.ndarray]) -> None:
        self.rows.extend(rows_of(batch))


@dataclasses.dataclass
class PrintSink(Sink):
    """Print each row as ``prefix`` + its dict, up to ``limit`` rows."""

    prefix: str = ""
    limit: Optional[int] = None
    _printed: int = 0

    def write(self, batch: Dict[str, np.ndarray]) -> None:
        for row in rows_of(batch):
            if self.limit is not None and self._printed >= self.limit:
                return
            print(f"{self.prefix}{row}")
            self._printed += 1


@dataclasses.dataclass
class FnSink(Sink):
    """Adapter for a plain callable(batch_dict)."""

    fn: Callable[[Dict[str, np.ndarray]], None]

    def write(self, batch: Dict[str, np.ndarray]) -> None:
        self.fn(batch)
