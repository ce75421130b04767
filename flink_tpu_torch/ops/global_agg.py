"""Unwindowed keyed running aggregation (``KeyedStream.running_aggregate``):
the UPSERT / changelog path, the JAX package's ``ops/global_agg.py``.

ref: table/runtime aggregate/GroupAggFunction + the retract/changelog
stream model: ``SELECT k, agg FROM t GROUP BY k`` with no window emits
an ever-updating result per key. For insert-only input the changelog
degenerates to an UPSERT stream, each emitted row replacing the previous
row for its key; ``UpsertSink`` keeps the latest row a key.

``retract=True`` emits the full changelog instead: each update becomes
a ``-U`` row carrying the previously emitted values followed by a
``+U`` replacement (first emission: ``+I``), op-typed in the
``records.OP_FIELD`` int8 column; ``RetractSink`` folds it.

The per-key accumulators are flat host numpy arrays behind the key
directory's slot map; a batch folds in with one argsort and a reduceat
a lane, and each batch emits exactly the keys it touched (the
mini-batch emission of MiniBatchGroupAggFunction). The aggregate's lift
and finalize are its torch functions on tensors of an explicit CPU
device, as the spill store's are: the operator is on the host by
design, in both packages, and launches no kernel.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from flink_tpu_torch import faults
from flink_tpu_torch.ops.window import FiredWindows
from flink_tpu_torch.records import (
    OP_DTYPE,
    OP_FIELD,
    OP_INSERT,
    OP_UPDATE_AFTER,
    OP_UPDATE_BEFORE,
    device_cast,
)
from flink_tpu_torch.state.keyed import KeyDirectory, account_full_drop
from flink_tpu_torch.time.watermarks import LONG_MIN

_CPU = torch.device("cpu")


class GlobalAggregateOperator:
    """Driver-protocol operator: per-step upsert emission via
    ``take_fired`` (the count_window/process emission pattern).

    ``retract=True`` switches the output from the degenerate upsert
    stream to the full changelog (ref: GroupAggFunction's
    generateUpdateBefore path): a touched key whose result was emitted
    before first RETRACTS the stale row (``-U``, finalized from the
    accumulators as they stood at the previous emission) and then emits
    the replacement (``+U``); a key's first result is ``+I``. Rows carry
    the op type in the ``__op__`` int8 column (records.OP_FIELD). The
    ``-U`` block precedes the ``+I/+U`` block within one emission — a
    key appears at most once in each, so per-key changelog order holds.
    """

    def __init__(self, agg, *, num_shards: int,
                 slots_per_shard: int, retract: bool = False) -> None:
        self.agg = agg
        self.retract = bool(retract)
        self.directory = KeyDirectory(num_shards, slots_per_shard)
        n = self.directory.local_slots
        self.counts = np.zeros(n, np.int64)
        self.sums = np.zeros((n, agg.sum_width), np.float64)
        self.maxs = np.full((n, agg.max_width), -np.inf, np.float32)
        self.mins = np.full((n, agg.min_width), np.inf, np.float32)
        if self.retract:
            # accumulators AS EMITTED — the -U row's payload; a slot
            # retracts only after its first emission (emitted mask)
            self.prev_counts = np.zeros(n, np.int64)
            self.prev_sums = np.zeros((n, agg.sum_width), np.float64)
            self.prev_maxs = np.full((n, agg.max_width), -np.inf,
                                     np.float32)
            self.prev_mins = np.full((n, agg.min_width), np.inf,
                                     np.float32)
            self.emitted = np.zeros(n, bool)
        self.watermark = LONG_MIN
        self.late_records = 0          # unwindowed: nothing is late
        self.records_dropped_full = 0
        self.allow_drops = False
        self.state_version = 0
        self._touched: Optional[np.ndarray] = None

    # -- data plane ------------------------------------------------------

    def process_batch(self, keys, ts, data: Dict[str, np.ndarray],
                      valid=None) -> None:
        self.state_version += 1
        keys = np.asarray(keys, np.int64)
        valid = (np.ones(len(keys), bool) if valid is None
                 else np.asarray(valid, bool))
        if not valid.any():
            return
        keys = keys[valid]
        data = {k: np.asarray(v)[valid] for k, v in data.items()}
        slots = self.directory.assign(keys)
        bad = slots < 0
        if bad.any():
            account_full_drop(self, int(bad.sum()))
            keys, slots = keys[~bad], slots[~bad]
            data = {k: v[~bad] for k, v in data.items()}
            if not len(keys):
                return
        order = np.argsort(slots, kind="stable")
        so = slots[order]
        bnd = np.empty(len(so), bool)
        bnd[0] = True
        bnd[1:] = so[1:] != so[:-1]
        starts = np.nonzero(bnd)[0]
        uslots = so[starts]
        self.counts[uslots] += np.add.reduceat(
            np.ones(len(so), np.int64), starts)
        if self.agg.sum_width or self.agg.max_width or self.agg.min_width:
            s_l, mx_l, mn_l = self._lift(
                {k: v[order] for k, v in data.items()}, len(so))
            if self.agg.sum_width:
                self.sums[uslots] += np.add.reduceat(s_l, starts, axis=0)
            if self.agg.max_width:
                self.maxs[uslots] = np.maximum(
                    self.maxs[uslots],
                    np.maximum.reduceat(mx_l, starts, axis=0))
            if self.agg.min_width:
                self.mins[uslots] = np.minimum(
                    self.mins[uslots],
                    np.minimum.reduceat(mn_l, starts, axis=0))
        self._touched = (uslots if self._touched is None
                         else np.union1d(self._touched, uslots))

    def _lift(self, data: Dict[str, np.ndarray], n: int):
        """The aggregate's lane lift of ``n`` host rows, in torch on the
        CPU, as numpy."""
        cols = {k: torch.from_numpy(np.ascontiguousarray(device_cast(v)))
                for k, v in data.items()}
        s, mx, mn = self.agg.lift_masked(
            cols, torch.ones(n, dtype=torch.bool, device=_CPU))
        return s.numpy(), mx.numpy(), mn.numpy()

    def _finalize(self, sums, maxs, mins, counts) -> Dict[str, np.ndarray]:
        """The aggregate's finalize of host lanes, in torch on the CPU."""
        res = self.agg.finalize(
            *(torch.from_numpy(np.ascontiguousarray(a))
              for a in (sums, maxs, mins, counts)))
        return {k: v.numpy() for k, v in res.items()}

    def take_fired(self) -> Optional["FiredWindows"]:
        """Emit the upsert rows for every key this step touched (or the
        -U/+U changelog pairs in retract mode)."""
        if self._touched is None or not len(self._touched):
            self._touched = None
            return None
        sl = self._touched
        self._touched = None
        wm = self.watermark if self.watermark != LONG_MIN else 0
        if not self.retract:
            res = self._finalize(
                self.sums[sl].astype(np.float32), self.maxs[sl],
                self.mins[sl], self.counts[sl])
            out: Dict[str, np.ndarray] = {
                "key": self.directory.key_of_slots(sl)}
            out["count"] = self.counts[sl]
            for k, v in res.items():
                out[k] = np.asarray(v)
            # upserts carry the emission-time watermark as their
            # timestamp (the process-function emission contract,
            # driver _emit_fired)
            out["__ts__"] = np.full(len(sl), wm, np.int64)
            return FiredWindows(data=out)
        # retract mode: fired BEFORE any emission bookkeeping mutates,
        # so an injected failure here leaves (prev_*, emitted) exactly
        # as the last successful emission left them — recovery replays
        # the whole step and the changelog stays consistent
        faults.fire("changelog.retract.emit", exc=RuntimeError,
                    touched=len(sl))
        retr = sl[self.emitted[sl]]
        keys_new = self.directory.key_of_slots(sl)
        blocks = []
        if len(retr):
            res_old = self._finalize(
                self.prev_sums[retr].astype(np.float32),
                self.prev_maxs[retr], self.prev_mins[retr],
                self.prev_counts[retr])
            old: Dict[str, np.ndarray] = {
                "key": self.directory.key_of_slots(retr),
                "count": self.prev_counts[retr]}
            for k, v in res_old.items():
                old[k] = np.asarray(v)
            old[OP_FIELD] = np.full(len(retr), OP_UPDATE_BEFORE,
                                    OP_DTYPE)
            blocks.append(old)
        res = self._finalize(
            self.sums[sl].astype(np.float32), self.maxs[sl],
            self.mins[sl], self.counts[sl])
        new: Dict[str, np.ndarray] = {"key": keys_new,
                                      "count": self.counts[sl]}
        for k, v in res.items():
            new[k] = np.asarray(v)
        new[OP_FIELD] = np.where(self.emitted[sl], OP_UPDATE_AFTER,
                                 OP_INSERT).astype(OP_DTYPE)
        blocks.append(new)
        out = {k: np.concatenate([b[k] for b in blocks])
               for k in blocks[-1]}
        out["__ts__"] = np.full(len(out["key"]), wm, np.int64)
        # the emitted view is now the current accumulators
        self.prev_counts[sl] = self.counts[sl]
        self.prev_sums[sl] = self.sums[sl]
        self.prev_maxs[sl] = self.maxs[sl]
        self.prev_mins[sl] = self.mins[sl]
        self.emitted[sl] = True
        return FiredWindows(data=out)

    # -- time plane ------------------------------------------------------

    def advance_watermark(self, wm: int):
        if wm > self.watermark:
            self.watermark = wm
        return FiredWindows(data=dict(self._empty()))

    def _empty(self) -> Dict[str, np.ndarray]:
        res = self._finalize(
            np.zeros((0, self.agg.sum_width), np.float32),
            np.zeros((0, self.agg.max_width), np.float32),
            np.zeros((0, self.agg.min_width), np.float32),
            np.zeros(0, np.int64))
        out = {"key": np.zeros(0, np.int64),
               "count": np.zeros(0, np.int64)}
        for k, v in res.items():
            out[k] = np.asarray(v)
        if self.retract:
            out[OP_FIELD] = np.zeros(0, OP_DTYPE)
        return out

    def final_watermark(self) -> int:
        return self.watermark if self.watermark != LONG_MIN else 0

    def quiesce(self) -> None:
        pass

    def throttle(self) -> None:
        pass

    # -- snapshot seam ---------------------------------------------------

    def snapshot_state(self) -> Dict[str, Any]:
        snap = {
            "kind": "global_agg",
            "directory": self.directory.snapshot(),
            "counts": self.counts.copy(),
            "sums": self.sums.copy(),
            "maxs": self.maxs.copy(),
            "mins": self.mins.copy(),
            "watermark": self.watermark,
            "records_dropped_full": self.records_dropped_full,
        }
        if self.retract:
            snap["prev_counts"] = self.prev_counts.copy()
            snap["prev_sums"] = self.prev_sums.copy()
            snap["prev_maxs"] = self.prev_maxs.copy()
            snap["prev_mins"] = self.prev_mins.copy()
            snap["emitted"] = self.emitted.copy()
        return snap

    def restore_state(self, snap: Dict[str, Any]) -> None:
        self.directory = KeyDirectory.restore(
            self.directory.num_shards, self.directory.slots_per_shard,
            snap["directory"],
            (self.directory.shard_lo, self.directory.shard_hi))
        self.counts = np.asarray(snap["counts"]).copy()
        self.sums = np.asarray(snap["sums"]).copy()
        self.maxs = np.asarray(snap["maxs"]).copy()
        self.mins = np.asarray(snap["mins"]).copy()
        if self.retract:
            # a pre-retract snapshot restoring into a retract-mode op:
            # treat the restored view as already emitted so the first
            # post-restore update retracts it (no double +I)
            self.prev_counts = np.asarray(snap.get(
                "prev_counts", self.counts)).copy()
            self.prev_sums = np.asarray(snap.get(
                "prev_sums", self.sums)).copy()
            self.prev_maxs = np.asarray(snap.get(
                "prev_maxs", self.maxs)).copy()
            self.prev_mins = np.asarray(snap.get(
                "prev_mins", self.mins)).copy()
            self.emitted = np.asarray(snap.get(
                "emitted", self.counts > 0)).copy()
        self.watermark = snap["watermark"]
        self.records_dropped_full = snap.get("records_dropped_full", 0)
        self._touched = None
