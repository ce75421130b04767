"""User functions: the map path, and incremental aggregation. A map is
a batch function over a dict of field → (B,) numpy arrays (filters and
flat maps are batch functions too, see ``api/datastream.py``); an
``AggregateFunction`` lowers to lanes through
``ops.aggregates.lower_aggregate``. Per-record functions and reduce
functions are in ROADMAP.md."""
from __future__ import annotations

from typing import Any, Callable, Dict, Union

import numpy as np


class MapFunction:
    """1→1 batch transform: override ``map_batch``."""

    def map_batch(self, values: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        raise NotImplementedError


def as_batch_fn(fn: Union[MapFunction, Callable]) -> Callable:
    """The batch callable behind a MapFunction or a plain function."""
    if isinstance(fn, MapFunction):
        return fn.map_batch
    if not callable(fn):
        raise TypeError(f"map expects a MapFunction or a callable, got {fn!r}")
    return fn


class AggregateFunction:
    """Incremental aggregation ACC/IN/OUT (create_accumulator / add /
    merge / get_result). The accumulator is a pytree of scalars, and
    ``add`` and ``merge`` are torch code that ``torch.func.vmap`` can
    batch; ``ops.aggregates.lower_aggregate`` lowers an instance whose
    merge is a per-leaf sum, max or min to the dense lanes and refuses
    any other."""

    def create_accumulator(self) -> Any:
        raise NotImplementedError

    def add(self, value: Dict[str, Any], acc: Any) -> Any:
        raise NotImplementedError

    def merge(self, a: Any, b: Any) -> Any:
        raise NotImplementedError

    def get_result(self, acc: Any) -> Any:
        raise NotImplementedError
