"""KeyedProcessFunction — general keyed state + user timers, the JAX
package's ``ops/process.py``: host numpy in both packages, no kernel.

ref: streaming/api/functions/KeyedProcessFunction.java lowered through
streaming/api/operators/KeyedProcessOperator.java, with timers in
InternalTimerServiceImpl (a per-key-group heap of (key, namespace, ts),
polled on each watermark advance).

TPU-first redesign: the reference's contract is per-RECORD —
``processElement(value, ctx)`` with state probes and timer calls per
element. Here the contract is per-BATCH: ``process_batch(ctx)`` sees
the whole microbatch as struct-of-arrays plus a slot vector into
columnar state (state/api.py), so state access is one gather/scatter
per column instead of B hash probes, and timer registration is one
append of (slot, ts) pairs. The timer service itself is an array pair
sorted at fire time — firing every due timer is one mask + one user
callback over the due set (the vectorized analogue of the reference's
heap-poll loop). A per-record adapter (``api.functions
.KeyedProcessFunction.process_element``) recovers the reference's
element-at-a-time authoring style at host-loop speed for logic that
truly needs sequential per-record semantics.
"""
from __future__ import annotations

import collections
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from flink_tpu_torch.state.api import (
    ListStateDescriptor, ListStateVector, MapStateDescriptor,
    MapStateVector, ValueStateDescriptor, ValueStateVector)
from flink_tpu_torch.state.keyed import KeyDirectory, account_full_drop
from flink_tpu_torch.time.watermarks import LONG_MIN


class TimerService:
    """Vectorized event-time timer wheel (ref: InternalTimerServiceImpl).
    The consolidated set stays SORTED by (ts, slot) and deduplicated, so
    a watermark sweep is one binary search for the due boundary — the
    O(due) analogue of the reference's heap poll. New registrations
    accumulate in append buffers and merge in one sort on the next sweep
    (cost proportional to what changed, not to the pending-set size)."""

    def __init__(self) -> None:
        self._ts = np.zeros(0, np.int64)     # sorted, deduped with _slots
        self._slots = np.zeros(0, np.int64)
        self._pend_ts: List[np.ndarray] = []
        self._pend_slots: List[np.ndarray] = []
        self._del_ts: List[np.ndarray] = []
        self._del_slots: List[np.ndarray] = []

    def register_batch(self, slots: np.ndarray, ts: np.ndarray) -> None:
        """Register one event-time timer per (slot, ts) pair."""
        if len(slots):
            self._pend_slots.append(np.asarray(slots, np.int64).copy())
            self._pend_ts.append(np.asarray(ts, np.int64).copy())

    def delete_batch(self, slots: np.ndarray, ts: np.ndarray) -> None:
        if len(slots):
            self._del_slots.append(np.asarray(slots, np.int64).copy())
            self._del_ts.append(np.asarray(ts, np.int64).copy())

    @property
    def pending_count(self) -> int:
        return len(self._ts) + sum(len(a) for a in self._pend_ts)

    def max_pending_ts(self) -> Optional[int]:
        vals = [int(self._ts[-1])] if len(self._ts) else []
        vals += [int(a.max()) for a in self._pend_ts if len(a)]
        return max(vals) if vals else None

    def _consolidate(self) -> None:
        if self._pend_ts:
            ts = np.concatenate([self._ts] + self._pend_ts)
            slots = np.concatenate([self._slots] + self._pend_slots)
            order = np.lexsort((slots, ts))
            ts, slots = ts[order], slots[order]
            if len(ts):  # adjacent dedup (timer-SET semantics)
                keep = np.empty(len(ts), bool)
                keep[0] = True
                keep[1:] = (ts[1:] != ts[:-1]) | (slots[1:] != slots[:-1])
                ts, slots = ts[keep], slots[keep]
            self._ts, self._slots = ts, slots
            self._pend_ts, self._pend_slots = [], []
        if self._del_ts and len(self._ts):
            # few deletions against a sorted set: binary-search each
            dts = np.concatenate(self._del_ts)
            dsl = np.concatenate(self._del_slots)
            pos = np.searchsorted(self._ts, dts, "left")
            kill = np.zeros(len(self._ts), bool)
            for p, t, s in zip(pos.tolist(), dts.tolist(), dsl.tolist()):
                while p < len(self._ts) and self._ts[p] == t:
                    if self._slots[p] == s:
                        kill[p] = True
                        break
                    p += 1
            if kill.any():
                self._ts, self._slots = self._ts[~kill], self._slots[~kill]
        self._del_ts, self._del_slots = [], []

    def due(self, wm: int) -> Tuple[np.ndarray, np.ndarray]:
        """Pop every timer with ts <= wm, fire-ordered by (ts, slot)."""
        self._consolidate()
        cut = int(np.searchsorted(self._ts, wm, "right"))
        if cut == 0:
            return np.zeros(0, np.int64), np.zeros(0, np.int64)
        due_s, due_t = self._slots[:cut].copy(), self._ts[:cut].copy()
        self._ts, self._slots = self._ts[cut:], self._slots[cut:]
        return due_s, due_t

    def snapshot(self) -> Dict[str, Any]:
        self._consolidate()
        return {"slots": self._slots.copy(), "ts": self._ts.copy(),
                "deleted": []}

    def restore(self, snap: Dict[str, Any]) -> None:
        self._ts = np.array(snap["ts"])
        self._slots = np.array(snap["slots"])
        self._pend_ts, self._pend_slots = [], []
        self._del_ts, self._del_slots = [], []
        for s, t in snap.get("deleted", ()):  # legacy snapshots
            self.delete_batch(np.array([s]), np.array([t]))


class ProcessContext:
    """What the user function sees — batch-vectorized (ref: the
    Context/OnTimerContext pair of KeyedProcessFunction)."""

    def __init__(self, op: "KeyedProcessOperator") -> None:
        self._op = op
        # per-call fields (set by the operator before each invocation)
        self.keys: np.ndarray = np.zeros(0, np.int64)
        self.slots: np.ndarray = np.zeros(0, np.int64)
        self.timestamps: np.ndarray = np.zeros(0, np.int64)
        self.data: Dict[str, np.ndarray] = {}
        # which timer family invoked on_timer: "event" | "processing"
        # (ref: OnTimerContext.timeDomain())
        self.time_domain: str = "event"

    @property
    def watermark(self) -> int:
        return self._op.watermark

    # -- state -----------------------------------------------------------

    def value_state(self, desc: ValueStateDescriptor) -> ValueStateVector:
        return self._op._state(desc, ValueStateVector)

    def list_state(self, desc: ListStateDescriptor) -> ListStateVector:
        return self._op._state(desc, ListStateVector)

    def map_state(self, desc: MapStateDescriptor) -> MapStateVector:
        return self._op._state(desc, MapStateVector)

    # -- timers ----------------------------------------------------------

    def register_event_time_timers(self, ts: np.ndarray,
                                   slots: Optional[np.ndarray] = None) -> None:
        self._op.timers.register_batch(
            self.slots if slots is None else slots, np.asarray(ts))

    def delete_event_time_timers(self, ts: np.ndarray,
                                 slots: Optional[np.ndarray] = None) -> None:
        self._op.timers.delete_batch(
            self.slots if slots is None else slots, np.asarray(ts))

    def register_processing_time_timers(
            self, ts: np.ndarray,
            slots: Optional[np.ndarray] = None) -> None:
        """Per-key timers on the WALL clock (ref: TimerService.
        registerProcessingTimeTimer — the proc-time half of
        InternalTimerServiceImpl). Fired by the runtime's clock advance
        between steps; resolution is one microbatch."""
        self._op.proc_timers.register_batch(
            self.slots if slots is None else slots, np.asarray(ts))

    def delete_processing_time_timers(
            self, ts: np.ndarray,
            slots: Optional[np.ndarray] = None) -> None:
        self._op.proc_timers.delete_batch(
            self.slots if slots is None else slots, np.asarray(ts))

    def current_processing_time(self) -> int:
        return self._op.clock.now_ms()

    # -- output ----------------------------------------------------------

    def emit(self, rows: Dict[str, np.ndarray],
             ts: Optional[np.ndarray] = None) -> None:
        """Collect output rows (struct-of-arrays). Every emit within one
        drain window must use the SAME field set. ``ts`` may be omitted
        only for a full-batch emission (one row per input record, in
        order); any other shape must pass explicit per-row timestamps —
        silently stamping unrelated rows with the batch prefix's times
        would route them into the wrong downstream windows."""
        n = len(next(iter(rows.values()))) if rows else 0
        if ts is None:
            if n != len(self.timestamps):
                raise ValueError(
                    f"emit of {n} rows without ts: defaults only apply "
                    f"to full-batch emissions ({len(self.timestamps)} "
                    "records); pass ts= explicitly")
            out_ts = self.timestamps
        else:
            out_ts = np.asarray(ts, np.int64)
            if len(out_ts) != n:
                raise ValueError(
                    f"emit ts length {len(out_ts)} != rows length {n}")
        self._op._emitted.append(({k: np.asarray(v) for k, v in rows.items()},
                                  out_ts))


class KeyedProcessOperator:
    """Driver-facing operator for ``KeyedStream.process`` (ref:
    KeyedProcessOperator). The user function gets batch-vectorized
    ``process_batch(ctx)`` and ``on_timer(ctx)`` hooks."""

    def __init__(self, fn: Any, *, num_shards: int = 128,
                 slots_per_shard: int = 1024) -> None:
        from flink_tpu_torch.time.clock import SystemProcessingTimeService

        self.fn = fn
        self.directory = KeyDirectory(num_shards, slots_per_shard)
        self.capacity = num_shards * slots_per_shard
        self.timers = TimerService()
        self.proc_timers = TimerService()
        self.clock = SystemProcessingTimeService()
        self.watermark = LONG_MIN
        self.late_records = 0
        self.records_dropped_full = 0
        self.state_version = 0
        self._states: Dict[str, Any] = {}
        self._descs: Dict[str, Any] = {}
        self._emitted: collections.deque = collections.deque()
        self.ctx = ProcessContext(self)

    def _state(self, desc, cls):
        st = self._states.get(desc.name)
        if st is None:
            st = cls(desc, self.capacity)
            self._states[desc.name] = st
            self._descs[desc.name] = desc
        elif not isinstance(st, cls):
            raise TypeError(
                f"state '{desc.name}' already registered as "
                f"{type(st).__name__}")
        return st

    # -- data plane ------------------------------------------------------

    def process_batch(self, keys, ts, data: Dict[str, np.ndarray],
                      valid=None) -> None:
        self.state_version += 1
        keys = np.asarray(keys, np.int64)
        ts = np.asarray(ts, np.int64)
        valid = (np.ones(len(ts), bool) if valid is None
                 else np.asarray(valid, bool))
        # assign slots for VALID rows only — filtered-out records must
        # not consume directory capacity for the life of the job
        idx = np.nonzero(valid)[0]
        if len(idx) == 0:
            return
        slots = self.directory.assign(keys[idx])
        bad = slots < 0
        if bad.any():
            account_full_drop(self, int(bad.sum()))
            idx = idx[~bad]
            slots = slots[~bad]
        if len(idx) == 0:
            return
        ctx = self.ctx
        ctx.keys = keys[idx]
        ctx.slots = slots.astype(np.int64)
        ctx.timestamps = ts[idx]
        ctx.data = {k: np.asarray(v)[idx] for k, v in data.items()}
        self.fn.process_batch(ctx)

    # -- time plane ------------------------------------------------------

    def advance_watermark(self, wm: int):
        from flink_tpu_torch.ops.window import FiredWindows

        if wm > self.watermark:
            self.watermark = wm
            due_slots, due_ts = self.timers.due(wm)
            if len(due_slots):
                self.state_version += 1
                ctx = self.ctx
                ctx.slots = due_slots
                ctx.keys = self.directory.key_of_slots(due_slots)
                ctx.timestamps = due_ts
                ctx.data = {}
                ctx.time_domain = "event"
                self.fn.on_timer(ctx)
        return FiredWindows(data=self._drain_emitted())

    def advance_processing_time_timers(self, fire_all: bool = False):
        """Fire processing-time timers the clock has passed (the
        proc-time half of InternalTimerServiceImpl.advanceWatermark;
        driven by the runtime between steps). ``fire_all`` implements
        drain semantics at end of input. Returns a FiredWindows batch
        or None when nothing fired."""
        from flink_tpu_torch.ops.window import FiredWindows

        horizon = (np.iinfo(np.int64).max - 1 if fire_all
                   else self.clock.now_ms())
        due_slots, due_ts = self.proc_timers.due(horizon)
        if not len(due_slots):
            return None
        self.state_version += 1
        ctx = self.ctx
        ctx.slots = due_slots
        ctx.keys = self.directory.key_of_slots(due_slots)
        ctx.timestamps = due_ts
        ctx.data = {}
        ctx.time_domain = "processing"
        self.fn.on_timer(ctx)
        return FiredWindows(data=self._drain_emitted())

    def take_fired(self):
        """Rows emitted by process_batch calls since the last take (the
        driver forwards them immediately, like count-window fires)."""
        from flink_tpu_torch.ops.window import FiredWindows

        if not self._emitted:
            return None
        return FiredWindows(data=self._drain_emitted())

    def _drain_emitted(self) -> Dict[str, np.ndarray]:
        if not self._emitted:
            return {"__ts__": np.zeros(0, np.int64)}
        parts = list(self._emitted)
        self._emitted.clear()
        fields = set(parts[0][0])
        for p in parts[1:]:
            if set(p[0]) != fields:
                raise ValueError(
                    "ctx.emit calls in one drain window used differing "
                    f"schemas: {sorted(fields)} vs {sorted(p[0])}")
        out = {k: np.concatenate([p[0][k] for p in parts]) for k in fields}
        out["__ts__"] = np.concatenate([p[1] for p in parts])
        return out

    def final_watermark(self) -> int:
        # fire every remaining registered timer at end of input (the
        # reference advances to MAX_WATERMARK)
        mx = self.timers.max_pending_ts()
        if mx is not None:
            return max(mx, self.watermark)
        return self.watermark if self.watermark != LONG_MIN else 0

    def quiesce(self) -> None:
        pass

    def throttle(self) -> None:
        pass

    # -- snapshot seam ----------------------------------------------------

    def snapshot_state(self) -> Dict[str, Any]:
        return {
            "kind": "process",
            "directory": self.directory.snapshot(),
            "timers": self.timers.snapshot(),
            "proc_timers": self.proc_timers.snapshot(),
            "watermark": self.watermark,
            "late_records": self.late_records,
            "records_dropped_full": self.records_dropped_full,
            "states": {n: (type(s).__name__, self._descs[n], s.snapshot())
                       for n, s in self._states.items()},
        }

    def restore_state(self, snap: Dict[str, Any]) -> None:
        import flink_tpu_torch.state.api as state_api

        self.directory = KeyDirectory.restore(
            self.directory.num_shards, self.directory.slots_per_shard,
            snap["directory"],
            (self.directory.shard_lo, self.directory.shard_hi))
        self.timers.restore(snap["timers"])
        if snap.get("proc_timers") is not None:
            self.proc_timers.restore(snap["proc_timers"])
        self.watermark = snap["watermark"]
        self.late_records = snap["late_records"]
        self.records_dropped_full = snap["records_dropped_full"]
        self._states = {}
        self._descs = {}
        for name, (cls_name, desc, st_snap) in snap["states"].items():
            cls = getattr(state_api, cls_name)
            st = cls(desc, self.capacity)
            st.restore(st_snap)
            self._states[name] = st
            self._descs[name] = desc
        self._emitted.clear()
