"""User functions: the map and filter path, and incremental aggregation.
A map is a batch function over a dict of field → (B,) arrays (filters
and flat maps are batch functions too, see ``api/datastream.py``).

``MapFunction`` / ``FilterFunction`` take either form: override
``map_batch`` / ``filter_batch`` for the batch path, or ``map`` /
``filter`` for one record, which the default batch method runs over
the batch with ``torch.func.vmap`` (the JAX package's ``jax.vmap``).
The vmapped form runs on the device of the tensors it is given; numpy
fields (as the driver's chains hand them) run as CPU tensors and come
back as numpy. ``LambdaMap`` / ``LambdaFilter`` wrap a function of
either form (``batch=False``: per record).

An ``AggregateFunction`` lowers to lanes through
``ops.aggregates.lower_aggregate``. A ``KeyedProcessFunction`` runs in
``ops/process.py``'s operator (``KeyedStream.process``).
``ReduceFunction`` and ``ProcessWindowFunction`` are the interfaces
alone, as in the JAX package: no path of either package calls them."""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Union

import numpy as np
import torch


def _vmapped(fn: Callable, values: Dict[str, Any]) -> Any:
    """``torch.func.vmap(fn)`` over a dict of (B,) field arrays: tensors
    stay on their device; numpy fields go as CPU tensors and the
    result's tensors come back as numpy."""
    from_numpy = any(isinstance(v, np.ndarray) for v in values.values())
    args = {k: torch.from_numpy(np.ascontiguousarray(v))
            if isinstance(v, np.ndarray) else v for k, v in values.items()}
    out = torch.func.vmap(fn)(args)
    if not from_numpy:
        return out
    if isinstance(out, torch.Tensor):
        return out.numpy()
    return {k: v.numpy() if isinstance(v, torch.Tensor) else v
            for k, v in out.items()}


class MapFunction:
    """1→1 transform: override ``map_batch`` for the batch path, or
    ``map`` for one record (run over the batch by ``torch.func.vmap``)."""

    def map(self, value: Dict[str, Any]) -> Dict[str, Any]:
        raise NotImplementedError

    def map_batch(self, values: Dict[str, Any]) -> Dict[str, Any]:
        return _vmapped(self.map, values)


class FilterFunction:
    """Keep the rows where the predicate holds; lowered to an AND into
    the valid mask. Override ``filter_batch``, or ``filter`` for one
    record (run over the batch by ``torch.func.vmap``)."""

    def filter(self, value: Dict[str, Any]) -> Any:
        raise NotImplementedError

    def filter_batch(self, values: Dict[str, Any]) -> Any:
        return _vmapped(self.filter, values)


@dataclasses.dataclass
class LambdaMap(MapFunction):
    fn: Callable[[Dict[str, Any]], Dict[str, Any]]
    batch: bool = True

    def map(self, value):
        return self.fn(value)

    def map_batch(self, values):
        if self.batch:
            return self.fn(values)
        return _vmapped(self.fn, values)


@dataclasses.dataclass
class LambdaFilter(FilterFunction):
    fn: Callable[[Dict[str, Any]], Any]
    batch: bool = True

    def filter(self, value):
        return self.fn(value)

    def filter_batch(self, values):
        if self.batch:
            return self.fn(values)
        return _vmapped(self.fn, values)


def as_batch_fn(fn: Union[MapFunction, Callable]) -> Callable:
    """The batch callable behind a MapFunction or a plain function."""
    if isinstance(fn, MapFunction):
        return fn.map_batch
    if not callable(fn):
        raise TypeError(f"map expects a MapFunction or a callable, got {fn!r}")
    return fn


def as_predicate(pred: Union[FilterFunction, Callable]) -> Callable:
    """The batch predicate behind a FilterFunction or a plain function."""
    if isinstance(pred, FilterFunction):
        return pred.filter_batch
    if not callable(pred):
        raise TypeError(
            f"filter expects a FilterFunction or a callable, got {pred!r}")
    return pred


class ReduceFunction:
    """Commutative and associative combine of two values of one type
    (ref: ReduceFunction.java), over dicts of torch tensors. It must be
    expressible as elementwise sum, max or min lanes for the dense pane
    path; compose ``ops.aggregates`` lanes for anything else."""

    def reduce(self, a: Dict[str, torch.Tensor],
               b: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        raise NotImplementedError


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


class ProcessWindowFunction:
    """Post-aggregation hook a fired batch with the window's metadata
    (ref: streaming/api/functions/windowing/ProcessWindowFunction.java,
    applied through InternalAggregateProcessWindowFunction): the fired
    (key, window, result) columns as torch tensors, vectorized. The
    default returns ``results`` unchanged."""

    def process_batch(self, keys: torch.Tensor, window_starts: torch.Tensor,
                      window_ends: torch.Tensor, results: Any,
                      valid: torch.Tensor) -> Any:
        return results


class KeyedProcessFunction:
    """General keyed processing with state and timers (ref: streaming/
    api/functions/KeyedProcessFunction.java via KeyedProcessOperator).

    Native authoring style is per-BATCH: override ``process_batch(ctx)``
    and ``on_timer(ctx)`` — ``ctx`` (ops/process.ProcessContext) carries
    the microbatch as struct-of-arrays (``ctx.keys/slots/timestamps/
    data``), columnar state handles (``ctx.value_state/list_state/
    map_state``), vectorized timer registration, and ``ctx.emit``.

    The reference's element-at-a-time style is available by overriding
    ``process_element(key, ts, row, ctx, slot)`` instead — the default
    ``process_batch`` loops it over the batch (host-loop speed; use it
    only when the logic is truly sequential per record)."""

    def process_batch(self, ctx) -> None:
        for i in range(len(ctx.keys)):
            row = {k: v[i] for k, v in ctx.data.items()}
            self.process_element(int(ctx.keys[i]), int(ctx.timestamps[i]),
                                 row, ctx, int(ctx.slots[i]))

    def process_element(self, key: int, ts: int, row: Dict[str, Any],
                        ctx, slot: int) -> None:
        raise NotImplementedError(
            "override process_batch (vectorized) or process_element")

    def on_timer(self, ctx) -> None:
        """Called once per watermark advance with ALL due timers as
        arrays (ctx.keys/slots/timestamps)."""
