"""Keyed state API — descriptors and vectorized state views, the JAX
package's ``state/api.py`` (host numpy, no device code in either).

ref: flink-core/.../api/common/state/{ValueStateDescriptor,
ListStateDescriptor,MapStateDescriptor,StateTtlConfig}.java and the
runtime views in runtime/state/heap/* (per-key object cells probed per
record).

TPU-first redesign: a "state cell per key" becomes a COLUMN indexed by
the key directory's slot id. ValueState is a dense numpy column
(vectorized read/update across a whole microbatch); List/Map state are
object columns (host-side ragged data — the reference's heap state is
host-side too). The per-record `.value()/.update()` probe of the
reference becomes `state[slots]` / `state[slots] = v` over the batch's
slot vector — one C-speed gather/scatter instead of B hash lookups.

TTL follows OnCreateAndWrite visibility (ref: StateTtlConfig): every
write stamps the slot; reads through ``fresh_mask`` expire entries
older than the ttl against the operator's watermark clock.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import numpy as np


@dataclasses.dataclass(frozen=True)
class StateTtlConfig:
    """Time-to-live on event time (ref: StateTtlConfig — simplified to
    the OnCreateAndWrite / NeverReturnExpired corner, the common one)."""

    ttl_ms: int


@dataclasses.dataclass(frozen=True)
class ValueStateDescriptor:
    name: str
    default: float = 0.0
    dtype: Any = np.float64
    ttl: Optional[StateTtlConfig] = None


@dataclasses.dataclass(frozen=True)
class ListStateDescriptor:
    name: str
    ttl: Optional[StateTtlConfig] = None


@dataclasses.dataclass(frozen=True)
class MapStateDescriptor:
    name: str
    ttl: Optional[StateTtlConfig] = None


class _StateColumn:
    """Base: a slot-indexed column with a TTL stamp column."""

    def __init__(self, capacity: int, ttl: Optional[StateTtlConfig]):
        self.ttl = ttl
        self._stamp = (np.full(capacity, np.iinfo(np.int64).min, np.int64)
                       if ttl else None)

    def _grow_stamp(self, capacity: int) -> None:
        if self._stamp is not None and capacity > len(self._stamp):
            pad = np.full(capacity - len(self._stamp),
                          np.iinfo(np.int64).min, np.int64)
            self._stamp = np.concatenate([self._stamp, pad])

    def touch(self, slots: np.ndarray, now_ms: int) -> None:
        if self._stamp is not None:
            self._stamp[slots] = now_ms

    def fresh_mask(self, slots: np.ndarray, now_ms: int) -> np.ndarray:
        """True where the slot's entry is live under the TTL."""
        if self._stamp is None:
            return np.ones(len(slots), bool)
        return self._stamp[slots] > now_ms - self.ttl.ttl_ms


class ValueStateVector(_StateColumn):
    """Dense per-slot value column (ref: ValueState). Read with
    ``vs[slots]``, write with ``vs[slots] = values`` — whole-batch.
    TTL-configured state must read/write via ``get``/``update`` (which
    stamp the entry); plain indexing raises for it."""

    def __init__(self, desc: ValueStateDescriptor, capacity: int):
        super().__init__(capacity, desc.ttl)
        self.desc = desc
        self.col = np.full(capacity, desc.default, desc.dtype)

    def grow(self, capacity: int) -> None:
        if capacity > len(self.col):
            pad = np.full(capacity - len(self.col),
                          self.desc.default, self.desc.dtype)
            self.col = np.concatenate([self.col, pad])
            self._grow_stamp(capacity)

    def __getitem__(self, slots) -> np.ndarray:
        return self.col[slots]

    def __setitem__(self, slots, values) -> None:
        if self._stamp is not None:
            # a write that doesn't stamp would read back as expired —
            # TTL state must go through update(slots, values, now_ms)
            raise TypeError(
                f"state '{self.desc.name}' has a TTL: write with "
                ".update(slots, values, now_ms) so the entry is stamped")
        self.col[slots] = values

    def get(self, slots: np.ndarray, now_ms: int) -> np.ndarray:
        """TTL-aware read: expired slots yield the default."""
        v = self.col[slots]
        if self._stamp is not None:
            v = np.where(self.fresh_mask(slots, now_ms), v,
                         self.desc.default)
        return v

    def update(self, slots: np.ndarray, values, now_ms: int = 0) -> None:
        self.col[slots] = values
        self.touch(slots, now_ms)

    def clear(self, slots: np.ndarray) -> None:
        self.col[slots] = self.desc.default

    def snapshot(self) -> Dict[str, Any]:
        return {"col": self.col.copy(),
                "stamp": None if self._stamp is None else self._stamp.copy()}

    def restore(self, snap: Dict[str, Any]) -> None:
        self.col = np.array(snap["col"])
        if snap["stamp"] is not None:
            self._stamp = np.array(snap["stamp"])


class _ObjectStateColumn(_StateColumn):
    """Object column for ragged per-key state (lists/maps). Host-side —
    exactly where the reference's heap state lives too."""

    FACTORY = list

    def __init__(self, desc, capacity: int):
        super().__init__(capacity, desc.ttl)
        self.desc = desc
        self.col = np.empty(capacity, object)

    def grow(self, capacity: int) -> None:
        if capacity > len(self.col):
            new = np.empty(capacity, object)
            new[: len(self.col)] = self.col
            self.col = new
            self._grow_stamp(capacity)

    def cell(self, slot: int):
        if self.col[slot] is None:
            self.col[slot] = self.FACTORY()
        return self.col[slot]

    def clear(self, slots: np.ndarray) -> None:
        self.col[slots] = None

    def snapshot(self) -> Dict[str, Any]:
        import copy

        return {"col": copy.deepcopy(list(self.col)),
                "stamp": None if self._stamp is None else self._stamp.copy()}

    def restore(self, snap: Dict[str, Any]) -> None:
        self.col = np.empty(len(snap["col"]), object)
        self.col[:] = snap["col"]
        if snap["stamp"] is not None:
            self._stamp = np.array(snap["stamp"])


class ListStateVector(_ObjectStateColumn):
    """ref: ListState — per-key append list. ``append_batch`` adds one
    element per record, vectorized over the batch's slot vector."""

    FACTORY = list

    def append_batch(self, slots: np.ndarray, values: np.ndarray,
                     now_ms: int = 0) -> None:
        for s, v in zip(slots.tolist(), np.asarray(values).tolist()):
            self.cell(s).append(v)
        self.touch(slots, now_ms)

    def get(self, slot: int) -> list:
        return self.cell(int(slot))


class MapStateVector(_ObjectStateColumn):
    """ref: MapState — per-key dict."""

    FACTORY = dict

    def put_batch(self, slots: np.ndarray, keys, values,
                  now_ms: int = 0) -> None:
        for s, k, v in zip(slots.tolist(), list(keys), list(values)):
            self.cell(s)[k] = v
        self.touch(slots, now_ms)

    def get(self, slot: int) -> dict:
        return self.cell(int(slot))
