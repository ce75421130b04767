"""Count windows: ``count_window(n)`` as GlobalWindows + a (purging)
count trigger, over keyed lane state on the device.

Per batch the host assigns each record a key slot, uploads the valid
records' slots (and the fields the aggregate reads), and the device
folds them into one row per key: ``scatter_lanes`` when the aggregate
has sum/max/min lanes (each row's records in record order),
``scatter_counts`` for ``count()``. The state is the window operator's
pane state with a ring of one column, so those kernels run unchanged.
Then ``count_fire`` fires every row whose count since its last fire
reached ``n``, packs the fired rows in ascending row order, and resets
them; the aggregate's finalize runs on the packed rows in torch, and
the buffer starts its device→host copy into pinned memory at once.

The trigger count needs no lane of its own. With ``purge=True`` (the
public API's ``countWindow``) it equals the count lane: both start at 0,
grow by the same records and restart at every fire. With
``purge=False`` (a bare count trigger: the lanes keep accumulating) it
is ``counts - base``, where ``base`` holds each row's count at its last
fire, which ``count_fire`` sets. Snapshots keep the reference's layout
``(sums, maxs, mins, counts, since)`` and convert.

Semantics are the reference's (``flink_tpu/ops/count_window.py``): the
trigger is checked at batch boundaries, so a key that crosses ``n``
inside a batch fires once with its full aggregate; a key short of ``n``
at the end of input emits nothing; event time plays no part.
"""
from __future__ import annotations

import collections
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from flink_tpu_torch.device import resolve_device
from flink_tpu_torch.kernels import count_window_kernels as cwk
from flink_tpu_torch.kernels import lane_kernels as lk
from flink_tpu_torch.kernels import window_kernels as wk
from flink_tpu_torch.ops.aggregates import LaneAggregate, probe_finalize
from flink_tpu_torch.ops.window import (
    DeviceTimer, FiredWindows, _next_pow2, copy_to_host,
    empty_fired, staged)
from flink_tpu_torch.records import device_cast
from flink_tpu_torch.state.keyed import (
    KeyDirectory, PaneState, PaneStateLayout, account_full_drop, init_state)
from flink_tpu_torch.time.watermarks import LONG_MIN

# the eternal window's end (GlobalWindow.maxTimestamp() analogue)
GLOBAL_WINDOW_END = np.int64(1) << 62


class CountWindowOperator:
    """Keyed count-window aggregation on one device, firing each key
    every ``size`` records. ``purge=True`` resets a key's window at its
    fire; ``purge=False`` keeps accumulating and restarts only the
    trigger count."""

    def __init__(self, agg: LaneAggregate, size: int, *, purge: bool = True,
                 num_shards: int = 128, slots_per_shard: int = 1024,
                 device: "str | torch.device" = "cuda") -> None:
        if size < 1:
            raise ValueError(f"count window size must be >= 1, got {size}")
        if agg.fields is None:
            raise NotImplementedError(
                f"aggregate {agg.name!r} does not declare the record fields "
                "its lift reads; the port uploads only declared fields")
        self.agg = agg
        self.size = int(size)
        self.purge = bool(purge)
        self.device = resolve_device(device)
        self.directory = KeyDirectory(num_shards, slots_per_shard)
        self.R = num_shards * slots_per_shard
        self.layout = PaneStateLayout(slots=self.R, ring=1,
                                      sum_width=agg.sum_width,
                                      max_width=agg.max_width,
                                      min_width=agg.min_width)
        self.state = init_state(self.layout, self.device)
        # each row's count at its last fire (non-purging windows only)
        self._base: Optional[torch.Tensor] = (
            None if self.purge else torch.zeros(
                self.layout.rows, dtype=torch.int32, device=self.device))
        res = probe_finalize(agg)
        self._res_fields = sorted(res)
        self._res_is_int = {k: not torch.is_floating_point(v)
                            for k, v in res.items()}
        self._res_empty = {k: v.numpy() for k, v in res.items()}
        self._fields = [f for f in self._res_fields if f != "count"]
        self.watermark = LONG_MIN
        self.late_records = 0
        # state.allow-drops: records of a full key shard are dropped and
        # counted instead of failing the job (account_full_drop)
        self.allow_drops = False
        self.records_dropped_full = 0
        # bumped wherever the snapshotted state may change (the
        # reference's sites): a checkpoint hardlinks the previous blob of
        # an operator whose version it already holds
        self.state_version = 0
        # fired buffers' host copies (host, error word, CUDA event) since
        # the last take_fired
        self._pending: collections.deque = collections.deque()
        self.prof: Dict[str, float] = collections.defaultdict(float)
        self.timer = DeviceTimer(self.device)

    # -- data path ----------------------------------------------------------
    def process_batch(self, keys: np.ndarray, ts: np.ndarray,
                      data: Dict[str, np.ndarray],
                      valid: Optional[np.ndarray] = None) -> None:
        """Fold a batch in, fire every key whose count reached the size,
        and start the fired rows' copy to the host (``take_fired``)."""
        self.state_version += 1
        t0 = time.perf_counter()
        keys = np.asarray(keys, dtype=np.int64)
        valid = (np.ones(len(keys), bool) if valid is None
                 else np.asarray(valid, bool))
        slots = self.directory.assign(keys)
        bad = valid & (slots < 0)
        if bad.any():
            account_full_drop(self, int(bad.sum()))
            valid = valid & ~bad
        t1 = time.perf_counter()
        self.prof["pb_assign"] += t1 - t0
        # invalid records never leave the host
        idx = slots.astype(np.int32)
        fields = {k: device_cast(data[k]) for k in self.agg.fields}
        if not valid.all():
            idx = idx[valid]
            fields = {k: v[valid] for k, v in fields.items()}
        self.prof["pb_pack"] += time.perf_counter() - t1
        t2 = time.perf_counter()
        st, dev = self.state, self.device
        if len(idx):
            idx_h = staged(idx, dev)
            fields_h = {k: staged(v, dev) for k, v in fields.items()}
            with self.timer.span("apply"):
                idx_d = idx_h.to(dev, non_blocking=True)
                if self._has_lanes():
                    data_d = {k: v.to(dev, non_blocking=True)
                              for k, v in fields_h.items()}
                    ones = torch.ones(len(idx), dtype=torch.bool, device=dev)
                    s, mx, mn = self.agg.lift_masked(data_d, ones)
                    lk.scatter_lanes(st.counts, st.sums, st.maxs, st.mins,
                                     idx_d, s.contiguous(), mx.contiguous(),
                                     mn.contiguous())
                else:
                    wk.scatter_counts(st.counts, idx_d, None)
        rows = self.layout.rows
        with self.timer.span("fire"):
            buf = cwk.count_fire(
                st.counts.view(rows), self._base,
                *(None if t is None else t.view(rows, t.shape[2])
                  for t in (st.sums, st.maxs, st.mins)),
                self.size, self._fire_cap())
            buf = self._finalize(buf)
        self._pending.append(copy_to_host(buf, self.timer))
        self.timer.collect()
        self.prof["pb_dispatch"] += time.perf_counter() - t2

    def _has_lanes(self) -> bool:
        lay = self.layout
        return (lay.sum_width, lay.max_width, lay.min_width) != (0, 0, 0)

    def _fire_cap(self) -> int:
        """Rows of a fire buffer: only a registered key's row can fire,
        so this bound never truncates."""
        return _next_pow2(max(1, min(self.directory.num_keys(), self.R)))

    def _finalize(self, buf: torch.Tensor) -> torch.Tensor:
        """The aggregate's finalize on a fire buffer's rows: ``[row,
        count]`` and then the result fields in sorted order (``count``
        excluded), int fields as int32 and float fields as f32 bits."""
        if not self._fields:
            return buf[:, :2]
        lay = self.layout
        sw, mw = lay.sum_width, lay.max_width
        lanes = buf[1:, 2:].view(torch.float32)
        res = self.agg.finalize(lanes[:, :sw], lanes[:, sw:sw + mw],
                                lanes[:, sw + mw:], buf[1:, 1])
        out = torch.zeros((buf.shape[0], 2 + len(self._fields)),
                          dtype=torch.int32, device=buf.device)
        out[:, :2] = buf[:, :2]
        for i, name in enumerate(self._fields):
            v = res[name]
            out[1:, 2 + i] = (v.to(torch.int32) if self._res_is_int[name]
                              else v.to(torch.float32).view(torch.int32))
        return out

    def take_fired(self) -> Optional[FiredWindows]:
        """The fires of the batches pushed since the last take, as a lazy
        ``FiredWindows`` (None when there were none): count fires follow
        each batch, not the watermark."""
        if not self._pending:
            return None
        packs = list(self._pending)
        self._pending.clear()
        return FiredWindows(op=self, packs=packs)

    def _decode_packs(self, packs) -> Dict[str, np.ndarray]:
        """Host decode of landed fire buffers: slot → key, the eternal
        window's bounds, bit columns → result fields."""
        segs = []
        for host, err, ev in packs:
            if ev is not None:
                ev.synchronize()
            if err is not None:
                wk.raise_for_error_bits(int(err[0]))
            arr = host.numpy()
            n = int(arr[0, 0])
            if n > len(arr) - 1:
                raise RuntimeError(
                    f"fired-row buffer overflow: {n} rows > capacity "
                    f"{len(arr) - 1}")
            segs.append(arr[1:1 + n])
        body = (np.concatenate(segs) if segs
                else np.zeros((0, 2 + len(self._fields)), np.int32))
        nrec = len(body)
        out: Dict[str, np.ndarray] = {
            "key": self.directory.key_of_slots(body[:, 0].astype(np.int64)),
            "window_start": np.zeros(nrec, np.int64),
            "window_end": np.full(nrec, GLOBAL_WINDOW_END, np.int64),
            "count": np.ascontiguousarray(body[:, 1]),
        }
        for i, f in enumerate(self._fields):
            col = np.ascontiguousarray(body[:, 2 + i])
            out[f] = col if self._res_is_int[f] else col.view(np.float32)
        return out

    # -- time path (count windows are blind to event time) ------------------
    def advance_watermark(self, wm: int) -> FiredWindows:
        if wm > self.watermark:
            self.watermark = wm
            self.state_version += 1  # a snapshotted field changed
        return empty_fired(self._res_empty)

    def final_watermark(self) -> int:
        # GlobalWindows never completes: no end-of-input flush, so a key
        # short of the size emits nothing
        return self.watermark

    def quiesce(self) -> None:
        """Block until every dispatched step has completed."""
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()
            wk.check_errors(self.device)
        self.timer.collect(block=True)

    def throttle(self) -> None:
        """Nothing to wait for: the driver takes each batch's fires at
        once."""

    def hbm_bytes(self) -> int:
        """Planned device bytes: the pane lanes and counts, and a
        non-purging window's per-row count at its last fire."""
        base = 0 if self.purge else 4 * self.layout.rows
        return self.layout.bytes() + base

    # -- snapshots ----------------------------------------------------------
    def snapshot_state(self) -> Dict[str, Any]:
        """The state as the reference lays it out: ``arrays`` = (sums,
        maxs, mins, counts, since), each ``(R + 1, width)`` or ``(R +
        1,)`` (device clones, ordered on the stream), the key directory
        and the watermark."""
        rows = self.layout.rows
        counts = self.state.counts.view(rows)
        since = counts if self._base is None else counts - self._base
        lanes = tuple(
            torch.zeros((rows, 0), dtype=torch.float32, device=self.device)
            if t is None else t.view(rows, t.shape[2]).clone()
            for t in (self.state.sums, self.state.maxs, self.state.mins))
        return {
            "kind": "count_window",
            "arrays": lanes + (counts.clone(), since.clone()),
            "directory": self.directory.snapshot(),
            "watermark": self.watermark,
            "late_records": self.late_records,
            "records_dropped_full": self.records_dropped_full,
        }

    def restore_state(self, snap: Dict[str, Any]) -> None:
        """Restore from ``snapshot_state()`` output — this package's, or
        the reference's with its arrays as host arrays
        (``load_jax_snapshot``)."""
        rows = self.layout.rows
        arrays = [a if isinstance(a, torch.Tensor)
                  else torch.from_numpy(np.array(a)) for a in snap["arrays"]]
        if len(arrays) != 5:
            raise ValueError("a count-window snapshot holds (sums, maxs, "
                             f"mins, counts, since), got {len(arrays)} arrays")
        lay = self.layout
        want = ((lay.sum_width, torch.float32), (lay.max_width, torch.float32),
                (lay.min_width, torch.float32))
        for name, a, (width, dtype) in zip(("sums", "maxs", "mins"), arrays,
                                           want):
            if tuple(a.shape) != (rows, width) or a.dtype != dtype:
                raise ValueError(
                    f"snapshot lane {name} {tuple(a.shape)} {a.dtype} does "
                    f"not match this operator's ({rows}, {width}) {dtype} "
                    f"(aggregate {self.agg.name!r})")
        counts, since = arrays[3], arrays[4]
        for name, a in (("counts", counts), ("since", since)):
            if tuple(a.shape) != (rows,) or a.dtype != torch.int32:
                raise ValueError(f"snapshot {name} {tuple(a.shape)} {a.dtype} "
                                 f"does not match ({rows},) int32")
        if self.purge and not torch.equal(counts, since):
            raise ValueError("a purging count window's trigger count equals "
                             "its count; the snapshot's differ")
        dev = self.device
        self.state = PaneState(*(
            None if a.shape[1] == 0
            else a.to(dev).reshape(rows, 1, a.shape[1]).contiguous().clone()
            for a in arrays[:3]), counts.to(dev).reshape(rows, 1).clone())
        self._base = (None if self.purge
                      else (counts - since).to(dev).contiguous())
        self.directory = KeyDirectory.restore(
            self.directory.num_shards, self.directory.slots_per_shard,
            snap["directory"])
        self.watermark = snap["watermark"]
        self.late_records = snap["late_records"]
        self.records_dropped_full = snap.get("records_dropped_full", 0)
        self._pending.clear()

    def load_jax_snapshot(self, snap: Dict[str, Any]) -> None:
        """Carry state across from the reference package: ``snap`` is
        ``flink_tpu``'s ``CountWindowOperator.snapshot_state()`` with its
        ``arrays`` fetched to host arrays (``np.asarray`` each). The
        lanes must be this operator's aggregate's."""
        if snap.get("kind") != "count_window":
            raise ValueError("not a count-window snapshot")
        if snap.get("records_dropped_full", 0) and not self.allow_drops:
            raise ValueError(
                "snapshot's operator dropped records on a full key "
                "directory; this operator raises on a full directory "
                "(state.allow-drops is false), so it cannot carry that "
                "state on")
        self.restore_state(snap)
