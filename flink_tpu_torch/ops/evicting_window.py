"""The element path: keyed time windows with an evictor or a trigger
outside the pane kernels' families (a count trigger on time windows, a
user ``Trigger``). Those need the window's elements at fire time, which
the pane state never keeps, so this operator keeps a buffer of elements
per (key, window) on the host, evaluates the trigger per element, evicts
before the window function and hands it the survivors.

Semantics are the JAX package's (``flink_tpu/ops/evicting_window.py``)
rule for rule: per element, in batch order, each live window appends the
element, bumps its trigger count and asks ``on_element``; a window the
watermark has already passed (late within the allowed lateness) fires
again at once under a watermark-family trigger; a fire evicts first and
the survivors replace the buffer, resets the trigger count and, under
FIRE_AND_PURGE, empties the buffer; ``advance_watermark`` fires in
``(window end, key)`` order and drops windows past the lateness horizon;
snapshots keep the reference's dict layout.

Buffers hold columns (arrays of the batch's fields, in arrival order),
not per-element dicts. For the built-in triggers (event time, count, and
either under ``PurgingTrigger``) over the built-in assigners a batch is
grouped by (key, window) with one stable sort and each group's fire
points follow from its trigger count, so host work is per window and per
fire, not per element; fires still run in the reference's order. Any
other trigger or assigner takes the per-element loop.

A plain window function is called once per fire on the host. A lane
aggregate (``.aggregate(agg)``, ``.count()``, ...) arrives as an
``ElementAggregate``: each fire appends its survivors to a pending list,
and at the end of ``process_batch``, ``advance_watermark`` and
``take_fired`` the whole list goes to the device in one upload, is
lifted (``agg.lift_masked``), reduced by ``segment_lanes`` (one segment
per fired window), finalized over the (windows, width) grid and copied
back once; rows keep their fire order and the reference's dtypes.
"""
from __future__ import annotations

import collections
import dataclasses
import heapq
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from flink_tpu_torch.api.windowing import (
    CountTrigger, EventTimeTrigger, PurgingTrigger, TimeWindow, Trigger,
    TriggerResult, WindowAssigner)
from flink_tpu_torch.device import resolve_device
from flink_tpu_torch.kernels import element_kernels as ek
from flink_tpu_torch.ops.aggregates import LaneAggregate
from flink_tpu_torch.ops.window import DeviceTimer, FiredWindows, staged
from flink_tpu_torch.records import MIN_TS, device_cast
from flink_tpu_torch.time.watermarks import LONG_MIN

Columns = Dict[str, np.ndarray]
_FIRES = (TriggerResult.FIRE, TriggerResult.FIRE_AND_PURGE)


class Evictor:
    """``evict_before(ts, data, window)`` gets the window's elements
    (timestamps and field arrays, in arrival order) and returns the mask
    of those to KEEP."""

    def evict_before(self, ts: np.ndarray, data: Columns,
                     window: TimeWindow) -> np.ndarray:
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class CountEvictor(Evictor):
    """Keep only the last ``max_count`` elements."""

    max_count: int

    @classmethod
    def of(cls, n: int) -> "CountEvictor":
        return cls(n)

    def evict_before(self, ts, data, window):
        keep = np.zeros(len(ts), bool)
        keep[max(0, len(ts) - self.max_count):] = True
        return keep


@dataclasses.dataclass(frozen=True)
class TimeEvictor(Evictor):
    """Keep the elements within ``keep_ms`` of the window's newest."""

    keep_ms: int

    @classmethod
    def of_ms(cls, keep_ms: int) -> "TimeEvictor":
        return cls(keep_ms)

    def evict_before(self, ts, data, window):
        if not len(ts):
            return np.zeros(0, bool)
        return ts > ts.max() - self.keep_ms


@dataclasses.dataclass(frozen=True)
class ElementAggregate:
    """A lane aggregate as the element path's window function: the
    operator reduces every fired window's survivors together on its
    device (``reduce_windows``) instead of calling a function per
    window. Only the fields the aggregate declares go up."""

    agg: LaneAggregate

    def __post_init__(self) -> None:
        if self.agg.fields is None:
            raise NotImplementedError(
                f"aggregate {self.agg.name!r} does not declare the record "
                "fields its lift reads; the port uploads only declared fields")


def upload_packed(arrays: List[np.ndarray], device: torch.device
                  ) -> List[torch.Tensor]:
    """The arrays on ``device`` through one host→device copy: packed
    into one byte buffer (each start 8-byte aligned), pinned, copied,
    then viewed back. On the CPU the arrays themselves."""
    arrays = [np.ascontiguousarray(a) for a in arrays]
    if device.type == "cpu":
        return [torch.from_numpy(a) for a in arrays]
    starts, pos = [], 0
    for a in arrays:
        starts.append(pos)
        pos += -(-a.nbytes // 8) * 8
    buf = np.empty(max(pos, 8), np.uint8)
    for a, s in zip(arrays, starts):
        buf[s:s + a.nbytes] = a.reshape(-1).view(np.uint8)
    dev = staged(buf, device).to(device, non_blocking=True)
    return [dev[s:s + a.nbytes].view(torch.from_numpy(a[:0]).dtype)
            .view(a.shape) for a, s in zip(arrays, starts)]


def reduce_windows(agg: LaneAggregate, offsets: np.ndarray,
                   fields: Columns, device: torch.device) -> Dict[str, np.ndarray]:
    """The result fields of ``agg`` for each window ``[offsets[w],
    offsets[w + 1])`` of the element columns ``fields``: one upload, the
    lift, ``segment_lanes``, the finalize over the grid and one copy
    back. Columns come back as numpy in the finalize's order and
    dtypes."""
    names = list(fields)
    dev = upload_packed([np.asarray(offsets, np.int64)]
                        + [device_cast(fields[f]) for f in names], device)
    offsets_t, cols = dev[0], dict(zip(names, dev[1:]))
    n = int(offsets[-1])
    s, mx, mn = agg.lift_masked(
        cols, torch.ones(n, dtype=torch.bool, device=device))
    sums, maxs, mins, counts = ek.segment_lanes(
        offsets_t, s.contiguous(), mx.contiguous(), mn.contiguous())
    res = agg.finalize(sums, maxs, mins, counts)
    res = {k: torch.as_tensor(v, device=device).contiguous()
           for k, v in res.items()}
    flat = [v.reshape(-1).view(torch.uint8) for v in res.values()]
    host = (torch.cat(flat) if flat
            else torch.zeros(0, dtype=torch.uint8, device=device)).cpu().numpy()
    out, pos = {}, 0
    for k, v in res.items():
        dt = torch.empty(0, dtype=v.dtype).numpy().dtype
        nbytes = v.numel() * v.element_size()
        out[k] = host[pos:pos + nbytes].view(dt).reshape(tuple(v.shape))
        pos += nbytes
    return out


class _Buf:
    """One (key, window)'s elements in arrival order: column chunks, plus
    the indices into the current batch that the per-element loop has
    appended but not yet copied out."""

    __slots__ = ("chunks", "n", "pending", "src", "fired", "trig_count")

    def __init__(self) -> None:
        self.chunks: List[Tuple[np.ndarray, Columns]] = []
        self.n = 0
        self.pending: List[int] = []
        self.src: Optional[Tuple[np.ndarray, Columns]] = None
        self.fired = False
        # the trigger count, reset by a fire that emits
        self.trig_count = 0

    def _add(self, ts: np.ndarray, data: Columns) -> None:
        if len(ts):
            self.chunks.append((ts, data))

    def append(self, ts: np.ndarray, data: Columns) -> None:
        self._add(ts, data)
        self.n += len(ts)

    def settle(self) -> None:
        """Copy the pending indices' elements out of their batch (``n``
        already counts them)."""
        if self.pending:
            ix = np.asarray(self.pending, np.int64)
            ts, data = self.src
            self.pending = []
            self._add(ts[ix], {f: v[ix] for f, v in data.items()})

    def columns(self) -> Tuple[np.ndarray, Columns]:
        """The elements as one column chunk (kept so)."""
        self.settle()
        if len(self.chunks) != 1:
            if not self.chunks:
                return np.zeros(0, np.int64), {}
            ts = np.concatenate([c[0] for c in self.chunks])
            data = {f: np.concatenate([c[1][f] for c in self.chunks])
                    for f in self.chunks[0][1]}
            self.chunks = [(ts, data)]
        return self.chunks[0]

    def replace(self, ts: np.ndarray, data: Columns) -> None:
        self.chunks, self.n = [], 0
        self.append(ts, data)


def _trigger_family(trigger: Trigger) -> Optional[Tuple[str, int, bool]]:
    """(family, count, purge) for the built-in triggers whose per-element
    decisions follow from the trigger count alone; None for any other."""
    purge = type(trigger) is PurgingTrigger
    inner = trigger.inner if purge else trigger
    if type(inner) is EventTimeTrigger:
        return "event", 0, purge
    if type(inner) is CountTrigger:
        return "count", int(inner.max_count), purge
    return None


class EvictingWindowOperator:
    """Driver-protocol operator (``process_batch`` / ``advance_watermark``
    / ``take_fired`` / snapshots) over host element buffers; a lane
    aggregate's reductions run on ``device``."""

    def __init__(
        self,
        assigner: WindowAssigner,
        window_fn: Any,
        *,
        trigger: Optional[Trigger] = None,
        evictor: Optional[Evictor] = None,
        allowed_lateness_ms: int = 0,
        device: "str | torch.device" = "cuda",
    ) -> None:
        self.device = resolve_device(device)
        self.assigner = assigner
        self.window_fn = window_fn
        self.trigger = trigger or EventTimeTrigger.create()
        self.evictor = evictor
        self.lateness = allowed_lateness_ms
        self.watermark = LONG_MIN
        self.late_records = 0
        self.records_dropped_full = 0
        self.state_version = 0
        self.allow_drops = False
        self._bufs: Dict[Tuple[int, TimeWindow], _Buf] = {}
        # finished rows (column dicts) in fire order, and the fires of a
        # lane aggregate waiting for the next reduction:
        # (key, window, survivor count, the aggregate's fields of them)
        self._done: List[Columns] = []
        self._segments: List[Tuple[int, TimeWindow, int, Columns]] = []
        self._family = (
            _trigger_family(self.trigger)
            if type(assigner).assign_windows is WindowAssigner.assign_windows
            else None)
        self.prof: Dict[str, float] = collections.defaultdict(float)
        self.timer = DeviceTimer(self.device)

    # -- data plane ---------------------------------------------------------
    def process_batch(self, keys, ts, data: Columns, valid=None) -> None:
        t0 = time.perf_counter()
        self.state_version += 1
        keys = np.asarray(keys, np.int64)
        ts = np.asarray(ts, np.int64)
        valid = (np.ones(len(ts), bool) if valid is None
                 else np.asarray(valid, bool))
        fields = {k: np.asarray(v) for k, v in data.items()}
        idx = np.nonzero(valid)[0]
        if self._family is not None:
            self._process_grouped(keys, ts, fields, idx)
        else:
            self._process_per_element(keys, ts, fields, idx)
        self.prof["pb_host"] += time.perf_counter() - t0
        self._reduce_pending()

    def _live(self, w: TimeWindow) -> bool:
        return not (w.end - 1 + self.lateness <= self.watermark)

    def _process_per_element(self, keys, ts, fields, idx) -> None:
        """The reference's loop, element by element, for any trigger."""
        src = (ts, fields)
        touched = []
        for i in idx.tolist():
            t, k = int(ts[i]), int(keys[i])
            live = [w for w in self.assigner.assign_windows(t) if self._live(w)]
            if not live:
                self.late_records += 1
                continue
            for w in live:
                buf = self._bufs.get((k, w))
                if buf is None:
                    buf = self._bufs[(k, w)] = _Buf()
                if buf.src is not src:
                    buf.settle()
                    buf.src = src
                    touched.append(buf)
                buf.pending.append(i)
                buf.n += 1
                buf.trig_count += 1
                r = self.trigger.on_element(t, w, buf.trig_count)
                if r in _FIRES:
                    self._fire(k, w, buf, r == TriggerResult.FIRE_AND_PURGE)
                elif (self.watermark >= w.end - 1
                        and self.trigger.fires_on_watermark()):
                    rl = self.trigger.on_event_time(self.watermark, w)
                    if rl in _FIRES:
                        self._fire(k, w, buf,
                                   rl == TriggerResult.FIRE_AND_PURGE)
        for buf in touched:
            buf.settle()
            buf.src = None

    def _pairs(self, ts: np.ndarray, idx: np.ndarray):
        """(element, window start) of every valid element's windows, in
        element order and each element's windows by ascending start, as
        ``assign_windows`` lists them."""
        a = self.assigner
        size, slide, off = a.size_ms, a.slide_ms, a.offset_ms
        t = ts[idx]
        last = t - (t - off) % slide
        ok = t != MIN_TS
        js = []
        for j in range(-(-size // slide)):
            start = last - j * slide
            hit = ok & (start > t - size)
            if not hit.any():
                break
            js.append((j, hit, start))
        if not js:
            return np.zeros(0, np.int64), np.zeros(0, np.int64)
        elem = np.concatenate([idx[h] for _, h, _ in js])
        start = np.concatenate([s[h] for _, h, s in js])
        rank = np.concatenate([np.full(int(h.sum()), -j) for j, h, _ in js])
        order = np.lexsort((rank, elem))
        return elem[order], start[order]

    def _process_grouped(self, keys, ts, fields, idx) -> None:
        """One batch under a built-in trigger: the elements' windows
        grouped by (key, window) with one stable sort, each group's
        fire points from its trigger count, the fires run in the
        reference's element order (a heap of each group's next)."""
        family, n_trig, purge = self._family
        size = self.assigner.size_ms
        elem, start = self._pairs(ts, idx)
        live = start + size - 1 + self.lateness > self.watermark
        has_live = np.zeros(len(ts), bool)
        has_live[elem[live]] = True
        self.late_records += int(len(idx) - has_live[idx].sum())
        elem, start = elem[live], start[live]
        if not len(elem):
            return
        pk = keys[elem]
        order = np.lexsort((start, pk))          # stable: arrival order kept
        sk, ss = pk[order], start[order]
        cut = np.flatnonzero((sk[1:] != sk[:-1]) | (ss[1:] != ss[:-1])) + 1
        lo = np.concatenate([[0], cut])
        hi = np.concatenate([cut, [len(order)]])
        # columns of the pairs in group order: each group a run of views
        rows = elem[order]
        g_ts = ts[rows]
        g_data = {f: v[rows] for f, v in fields.items()}
        firsts = order[lo]                        # first pair of each group
        heap = []
        groups = []
        for g in np.argsort(firsts, kind="stable").tolist():
            k, s0 = int(sk[lo[g]]), int(ss[lo[g]])
            w = TimeWindow(s0, s0 + size)
            buf = self._bufs.get((k, w))
            if buf is None:
                buf = self._bufs[(k, w)] = _Buf()
            gi = len(groups)
            groups.append([k, w, buf, int(lo[g]), int(hi[g])])
            j = self._next_fire(family, n_trig, w, buf, int(lo[g]), int(hi[g]))
            if j is not None:
                heap.append((int(order[j]), gi, j))
        heapq.heapify(heap)
        while heap:
            _, gi, j = heapq.heappop(heap)
            grp = groups[gi]
            k, w, buf, a = grp[0], grp[1], grp[2], grp[3]
            buf.append(g_ts[a:j + 1], {f: v[a:j + 1] for f, v in g_data.items()})
            buf.trig_count += j + 1 - a
            grp[3] = j + 1
            self._fire(k, w, buf, purge)
            nxt = self._next_fire(family, n_trig, w, buf, j + 1, grp[4])
            if nxt is not None:
                heapq.heappush(heap, (int(order[nxt]), gi, nxt))
        for k, w, buf, a, b in groups:
            if a < b:
                buf.append(g_ts[a:b], {f: v[a:b] for f, v in g_data.items()})
                buf.trig_count += b - a

    def _next_fire(self, family: str, n_trig: int, w: TimeWindow, buf: _Buf,
                   a: int, b: int) -> Optional[int]:
        """The group position in ``[a, b)`` whose append fires next, given
        the buffer's trigger count before position ``a``."""
        if a >= b:
            return None
        if family == "event":
            # a window the watermark has passed fires at every element
            return a if self.watermark >= w.end - 1 else None
        j = a + max(n_trig - buf.trig_count - 1, 0)
        return j if j < b else None

    def _fire(self, key: int, w: TimeWindow, buf: _Buf, purge: bool) -> None:
        t0 = time.perf_counter()
        ts, data = buf.columns()
        if self.evictor is not None:
            keep = np.asarray(self.evictor.evict_before(ts, data, w), bool)
            ts = ts[keep]
            data = {f: v[keep] for f, v in data.items()}
            # eviction is permanent: the survivors replace the buffer
            buf.replace(ts, data)
        if len(ts):
            if isinstance(self.window_fn, ElementAggregate):
                self._segments.append(
                    (key, w, len(ts), {f: data[f]
                                       for f in self.window_fn.agg.fields}))
            else:
                res = self.window_fn(
                    {**{f: v.copy() for f, v in data.items()},
                     "__ts__": ts.copy()})
                row = {"key": np.asarray([key], np.int64),
                       "window_start": np.asarray([w.start], np.int64),
                       "window_end": np.asarray([w.end], np.int64)}
                for f, v in res.items():
                    row[f] = np.asarray([v])
                self._done.append(row)
            buf.fired = True
            buf.trig_count = 0
            if purge:
                buf.replace(np.zeros(0, np.int64), {})
        self.prof["fire_host"] += time.perf_counter() - t0

    def _reduce_pending(self) -> None:
        """Reduce the pending fires of a lane aggregate on the device: one
        upload, one lift, one ``segment_lanes``, one finalize, one copy
        back."""
        if not self._segments:
            return
        t0 = time.perf_counter()
        segs, self._segments = self._segments, []
        n = len(segs)
        offsets = np.zeros(n + 1, np.int64)
        np.cumsum(np.fromiter((m for _, _, m, _ in segs), np.int64, n),
                  out=offsets[1:])
        cols = {f: np.concatenate([c[f] for _, _, _, c in segs])
                for f in segs[0][3]}
        with self.timer.span("reduce"):
            res = reduce_windows(self.window_fn.agg, offsets, cols, self.device)
        out = {"key": np.fromiter((s[0] for s in segs), np.int64, n),
               "window_start": np.fromiter((s[1].start for s in segs),
                                           np.int64, n),
               "window_end": np.fromiter((s[1].end for s in segs), np.int64, n)}
        out.update(res)
        self._done.append(out)
        self.prof["reduce"] += time.perf_counter() - t0

    # -- time plane ---------------------------------------------------------
    def advance_watermark(self, wm: int) -> FiredWindows:
        t0 = time.perf_counter()
        if wm > self.watermark:
            prev, self.watermark = self.watermark, wm
            due = sorted(((w.end, k, w, buf)
                          for (k, w), buf in self._bufs.items()
                          if prev < w.end - 1 <= wm and buf.n),
                         key=lambda e: (e[0], e[1]))
            for _, k, w, buf in due:
                r = self.trigger.on_event_time(wm, w)
                if r in _FIRES:
                    self._fire(k, w, buf, r == TriggerResult.FIRE_AND_PURGE)
            # drop windows past the lateness horizon
            dead = [kw for kw in self._bufs
                    if kw[1].end - 1 + self.lateness <= wm]
            for kw in dead:
                del self._bufs[kw]
        self.prof["aw_host"] += time.perf_counter() - t0
        self._reduce_pending()
        return FiredWindows(data=self._drain())

    def take_fired(self) -> Optional[FiredWindows]:
        self._reduce_pending()
        if not self._done:
            return None
        return FiredWindows(data=self._drain())

    def _drain(self) -> Columns:
        if not self._done:
            return {"key": np.zeros(0, np.int64),
                    "window_start": np.zeros(0, np.int64),
                    "window_end": np.zeros(0, np.int64)}
        parts, self._done = self._done, []
        if len(parts) == 1:
            return parts[0]
        return {f: np.concatenate([p[f] for p in parts]) for f in parts[0]}

    def final_watermark(self) -> int:
        base = self.watermark if self.watermark != LONG_MIN else 0
        return max([base] + [w.end for (_, w) in self._bufs])

    def quiesce(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()
        self.timer.collect(block=True)

    def throttle(self) -> None:
        pass

    # -- snapshots ----------------------------------------------------------
    def snapshot_state(self) -> Dict[str, Any]:
        """The reference's layout: watermark, late count and one dict per
        buffer (key, window bounds, fired, trigger count, timestamps and
        field columns; no fields for an empty buffer)."""
        bufs = []
        for (k, w), b in self._bufs.items():
            ts, data = b.columns()
            bufs.append({"key": k, "start": w.start, "end": w.end,
                         "fired": b.fired, "trig_count": b.trig_count,
                         "ts": np.asarray(ts, np.int64).copy(),
                         "fields": ({f: v.copy() for f, v in data.items()}
                                    if len(ts) else {})})
        return {"kind": "evicting_window", "watermark": self.watermark,
                "late_records": self.late_records, "bufs": bufs}

    def restore_state(self, snap: Dict[str, Any]) -> None:
        self.watermark = snap["watermark"]
        self.late_records = snap["late_records"]
        self._bufs = {}
        for e in snap["bufs"]:
            b = _Buf()
            b.fired = bool(e["fired"])
            b.trig_count = int(e.get("trig_count", 0))
            ts = np.asarray(e["ts"], np.int64)
            b.append(ts.copy(), {f: np.asarray(v).copy()
                                 for f, v in e["fields"].items()})
            self._bufs[(int(e["key"]),
                        TimeWindow(int(e["start"]), int(e["end"])))] = b
        self._done, self._segments = [], []
