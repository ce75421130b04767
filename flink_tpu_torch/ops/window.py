"""The keyed event-time window operator over dense device pane state:
an int32 ``(rows, ring)`` count lane plus the aggregate's f32 ``(rows,
ring, width)`` sum, max and min lanes.

Per batch the host assigns each record a key slot and a pane. A
count-only batch first tries the native lane (``_process_batch_fused``,
when the key directory holds the C table of the port's host codec): one
C scan probes the keys, computes panes, late and re-fire accounting and
the per-(slot, ring column) histogram, and C writes the pairs into a
reused pinned buffer: a word ``pair << 12 | count`` each, or, for a pair
count of 0xFFF or more or a pair domain past 20 bits, a uint16 triple
``[pair lo16, pair hi16, count]`` each (the real pairs only). With
top-n those pairs are stashed, and the next watermark advance fills the
buffer's header and runs apply + fire + top-n + purge as one upload and
one ``fused_step`` call in either form; without top-n
``apply_pairs_u32`` or ``apply_pairs_u16`` folds them in at once.
Counts past 0xFFFF go up as an int32 index + count to
``scatter_counts``. Otherwise (the general path): when every lane is a
host-combinable sum (count, sum, avg) and the combined upload is
decisively smaller, the host combines the batch per (slot, pane-ring
column) pair — in C on the native lane, then the same word forms; with
the numpy key table in numpy, then an int32 index + count upload to
``scatter_counts`` — and ``scatter_pair_lanes`` folds sum lanes in;
otherwise one cell per record goes up with the fields the aggregate
reads — 3 bytes (slot, ring column) while the slot id fits uint16 and
the ring 256 columns, else a flat index, int32 below
``CELL_INDEX_LIMIT`` cells and int64 past it (as the reference packs
them). Count only, ``scatter_split_counts`` decodes the 3 bytes and
counts them in one launch (``scatter_counts`` takes a flat index); with
lanes, ``lift_masked`` lifts the fields on the device and
``scatter_lanes`` decodes the 3 bytes where it reads them and folds the
records in.

A watermark advance fires every window it completes (over a stashed
native-lane batch, inside its fused step). With ``.top(n)``:
``window_counts`` sums each window's live panes for all rows at once
and ``topn_select_append`` appends each window's top-n rows to a
device-resident emit ring, which the host reads through announced
copies — for count() ranked by its count. Any other ranking field or
aggregate adds ``window_lanes`` (the lanes of every (row, window) cell),
the aggregate's finalize in torch on that grid, and
``topn_select_lanes``, which ranks by the field and appends each winner
with its result columns (emit ring ``3 + F`` wide). Without top-n:
``fire_pack`` fires chunks of up to
``MAX_FIRE_CHUNK`` windows into packed buffers (every non-empty
(key, window) cell, with its lanes), the aggregate's ``finalize`` runs
on them in torch, and each buffer starts its device→host copy into
pinned memory at once, with a CUDA event. Either way
``ring_columns_block`` purges panes no window can need any more, every
lane of a state block in one launch (and remaps the ring when it grows,
the same way).

A device-made source (``attach_device_source``) skips the host ingest:
its batch index is stashed, and the next watermark advance makes the
records on the card and folds them in with ``devgen_ingest`` (for the
Nexmark bids in one launch that makes them in registers, the
generator's ``ingest_into``; any other source's ``device_keys_ts``
first, into memory), and then fires every
window end of the advance in one ``window_counts`` +
``topn_select_append`` pair, as the reference's one-dispatch step does.
The ingest's stats vector is made and copied back only when the batch
can carry late, re-fire or miss work.

With ``spill`` (``state.backend = spill``) a record whose key's shard
is full aggregates in a ``HostSpillStore`` on the host instead; each
fire adds the store's rows for the same ends, and a top-n re-ranks the
union per window (the emit ring drained at each fire). With
``state.backend = lsm`` the factory passes the disk tier
(``state/lsm.py``'s ``LsmSpillStore``) as ``spill_store``, used in its
place: a snapshot carries its delta inline and names its sealed runs
(``__aux_files__``, hardlinked by the checkpoint plane), and a restore
takes the LSM form, with the run files at ``__aux_paths__``, or a plain
spill snapshot. Under
``state.allow-drops`` a full shard's records are dropped and counted
(``records_dropped_full``); by default they fail the job.

Host control flow (watermark clock, ring bookkeeping, lateness, late
re-firing, the key directory, the device-made ingest's stash, flush and
reconciliation) mirrors ``flink_tpu/ops/window.py`` rule for rule, so
both packages fire the same windows and emit the same rows in the same
order. A processing-time assigner stamps each record with the
operator's clock (``op.clock``, injectable) at ingest, and
``advance_processing_time`` fires what the clock has passed, over the
same kernels.

With a ``mesh_plan`` (``cluster.mesh-devices``) the operator is sharded
by key, as the reference's ``_build_sharded_kernels`` is: the pane state is
one block of ``rows_per_device`` rows per device of the plan, each
block's key slots a contiguous range of the global slots. A batch takes
the per-record path with global cells (3 bytes a record while the global
slot fits uint16 and the ring 256 columns, decoded by ``bucket_records``
where it reads them, or by ``split_cells`` for a registered shuffle that
takes flat cells), split on the host so that no exchange bucket overflows
(``_split_for_exchange``); source block j is records ``[j L, (j + 1)
L)`` of the padded chunk. Each source block's records are lifted,
bucketed by owner with ``bucket_records`` and exchanged
(``exchange/spi.py``); each block folds what it received into its own
state with ``scatter_counts`` / ``scatter_lanes``. A fire without top-n
runs ``fire_pack`` on every block with its first global row as the row
offset; a count top-n runs ``window_counts`` and ``topn_candidates`` on
every block, each block's candidates landing in its columns of one
gathered buffer on the home device, and ``topn_select_given`` on every
block against that buffer (each select works out the global k-th
itself) into that block's own emit ring, which the drain reads in block
order. Purge and growth run on every
block. Across processes (``shard_range``, this process's span) the key
directory keeps the global shard space but owns only this process's
span: slot ids count from the span's first shard, so the cells are
already local to the process's blocks, and a key outside the span (a
routing error) fails the job, or with ``state.allow-drops`` is dropped
and counted; the spill store never takes it. On a hybrid plan the
all-to-all exchange is ``keyby.intra_slice_exchange`` over the process's
own blocks. Snapshots hold the blocks end to end (the reference's global row
layout) and restore across block counts.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import time
from collections.abc import Mapping
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from flink_tpu_torch import native_codec as nc
from flink_tpu_torch.api.windowing import WindowAssigner
from flink_tpu_torch.config import READINESS_VALUES, PipelineOptions
from flink_tpu_torch.device import on_device, resolve_device
from flink_tpu_torch.exchange.keyby import intra_slice_exchange
from flink_tpu_torch.exchange.spi import (
    all_to_all_shuffle, get_shuffle, takes_split_bytes)
from flink_tpu_torch.kernels import devgen_kernels as dk
from flink_tpu_torch.kernels import fused_kernels as fk
from flink_tpu_torch.kernels import lane_kernels as lk
from flink_tpu_torch.kernels import topn_lanes_kernels as tk
from flink_tpu_torch.kernels import window_kernels as wk
from flink_tpu_torch.ops.aggregates import LaneAggregate, probe_finalize
from flink_tpu_torch.parallel.mesh import (
    HybridMeshPlan, row_to_slot, slot_to_row)
from flink_tpu_torch.records import device_cast
from flink_tpu_torch.state.keyed import (
    KeyDirectory, PaneState, PaneStateLayout, account_full_drop, init_state)
from flink_tpu_torch.state.spill import HostSpillStore
from flink_tpu_torch.time.clock import SystemProcessingTimeService
from flink_tpu_torch.time.watermarks import LONG_MIN

# host-fed advances fire in chunks of this many windows, each chunk one
# window_counts + topn_select_append pair (the reference's numpy path)
MAX_FIRE_CHUNK_RING = 16
# an advance over a device-made or stashed native-lane batch fires up to
# this many windows in one pass, as the reference's one-dispatch steps do
# (the fused step's header has this many window slots); more go in chunks
MIN_FIRE_PAD = fk.MIN_FIRE_PAD
# header words ahead of the pair words of a native-lane upload
FUSED_HDR = fk.FUSED_HDR
# fires without top-n go in chunks of this many windows, one fire_pack
# buffer each; also the top-n winner capacity factor (_topn_cap)
MAX_FIRE_CHUNK = 4
# the host pre-combine runs only while the (slot, ring column) pair
# domain stays this small
PREAGG_MAX_DOMAIN = 1 << 23
# flat cells (row * ring + column) travel as int32 below this many (a
# mesh's global cells, with the reference's one spare row), as int64 at
# or past it: the reference's switch (flink_tpu/ops/window.py:1762)
CELL_INDEX_LIMIT = 2 ** 31
# refire bitmap span of the device-made ingest (panes above
# dead_below); a longer lateness span sends the batch to the host path
DEVGEN_REFIRE_BITS = dk.REFIRE_BITS


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


def _lanes(st: PaneState) -> Tuple[Optional[torch.Tensor], ...]:
    """A state block's lanes in ``PaneState`` order, None at zero width:
    what ``ring_columns_block`` takes."""
    return (st.sums, st.maxs, st.mins, st.counts)


def preagg_combine(slots: np.ndarray, cols: np.ndarray, valid: np.ndarray,
                   ring: int, data: Optional[Dict[str, np.ndarray]] = None,
                   sum_fields: Tuple[str, ...] = ()
                   ) -> Tuple[np.ndarray, np.ndarray, List[np.ndarray]]:
    """Combine one batch per (slot, ring column) pair on the host: pair
    ids ``slot * ring + col`` (int32, ascending), int32 counts, and per
    sum field the pair's sum, accumulated in f64 in record order and
    rounded to f32 once (the reference's ``np.add.at`` order)."""
    pk = (slots[valid] * ring + cols[valid]).astype(np.int32)
    if not sum_fields:
        pairs, cnts = np.unique(pk, return_counts=True)
        return pairs, cnts.astype(np.int32), []
    pairs, inv, cnts = np.unique(pk, return_inverse=True, return_counts=True)
    lanes = [np.bincount(inv, weights=np.asarray(data[f], np.float64)[valid],
                         minlength=len(pairs)).astype(np.float32)
             for f in sum_fields]
    return pairs, cnts.astype(np.int32), lanes


# one record of the split upload: the little-endian slot id, the column
_SPLIT_RECORD = np.dtype([("slot", "<u2"), ("col", "u1")])


def split_encode(slots: np.ndarray, cols: np.ndarray,
                 valid: np.ndarray) -> np.ndarray:
    """The split upload's host half: (B,) slots + (B,) ring columns →
    (B, 3) uint8, bytes 0-1 the little-endian slot id and byte 2 the
    column, with slot 0xFFFF marking an invalid row (the device's
    kernels decode it by ``split_cells``' rule)."""
    n = len(slots)
    rec = np.empty(n, _SPLIT_RECORD)
    rec["slot"] = (slots if np.all(valid)
                   else np.where(valid, slots, wk.INVALID_SLOT_U16))
    rec["col"] = cols
    return rec.view(np.uint8).reshape(n, 3)


def ring_column(panes: np.ndarray, ring: int) -> np.ndarray:
    """Each pane's ring column, ``panes mod ring`` (a mask when the ring
    is a power of two, as it is after any growth)."""
    return panes & (ring - 1) if ring & (ring - 1) == 0 else panes % ring


def preagg_encode_u16(pairs: np.ndarray, cnts: np.ndarray,
                      cap: int) -> np.ndarray:
    """(pairs, counts) as one ``(cap, 3)`` uint16 upload ``[pair lo16,
    pair hi16, count]``; padding rows carry the 0xFFFF/0xFFFF pair
    (``apply_pairs_u16``)."""
    n = len(pairs)
    buf = np.empty((cap, 3), np.uint16)
    pu = pairs.astype(np.uint32)
    buf[:n, 0] = pu & 0xFFFF
    buf[:n, 1] = pu >> 16
    buf[:n, 2] = cnts.astype(np.uint16)
    buf[n:] = 0xFFFF
    return buf


def preagg_encode_u32(pairs: np.ndarray, cnts: np.ndarray,
                      cap: int) -> np.ndarray:
    """(pairs, counts) as ``cap`` int32 words ``pair << 12 | count``,
    padded with -1 (``apply_pairs_u32``); every count < 0xFFF."""
    buf = np.full(cap, -1, np.int32)
    buf[:len(pairs)] = (pairs.astype(np.int64) << 12
                        | cnts.astype(np.int64)).astype(np.uint32).view(np.int32)
    return buf


def preagg_encode_i32(pairs: np.ndarray, cnts: np.ndarray,
                      lanes: List[np.ndarray]) -> np.ndarray:
    """(pairs, counts, sum lanes) as one ``(P, 2 + S)`` int32 upload:
    ``[pair, count, f32 bits of each lane]`` (``scatter_pair_lanes``)."""
    buf = np.empty((len(pairs), 2 + len(lanes)), np.int32)
    buf[:, 0] = pairs
    buf[:, 1] = cnts
    for i, ln in enumerate(lanes):
        buf[:, 2 + i] = np.asarray(ln, np.float32).view(np.int32)
    return buf


# ---------------------------------------------------------------------------
# Planning: static layout from assigner + timing characteristics.
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class WindowPlan:
    pane_ms: int
    offset_ms: int
    size_ms: int
    slide_ms: int
    panes_per_window: int
    panes_per_slide: int
    ring: int
    allowed_lateness_ms: int

    @classmethod
    def plan(cls, assigner: WindowAssigner, *, allowed_lateness_ms: int = 0,
             max_out_of_orderness_ms: int = 0,
             headroom_panes: int = 4) -> "WindowPlan":
        pane = assigner.pane_ms
        # live pane span: a pane stays until wm >= pane_start + size +
        # lateness, and the newest writable pane is at wm + delay;
        # headroom covers event time running ahead between advances
        span_ms = assigner.size_ms + allowed_lateness_ms + max_out_of_orderness_ms
        ring = -(-span_ms // pane) + 1 + headroom_panes
        if ring > 65536:
            raise ValueError(
                f"pane ring of {ring} panes (pane={pane}ms from gcd(size="
                f"{assigner.size_ms}, slide={assigner.slide_ms})) is "
                "degenerate — choose a slide that divides the window size")
        return cls(pane_ms=pane, offset_ms=assigner.offset_ms,
                   size_ms=assigner.size_ms, slide_ms=assigner.slide_ms,
                   panes_per_window=assigner.panes_per_window,
                   panes_per_slide=assigner.panes_per_slide, ring=ring,
                   allowed_lateness_ms=allowed_lateness_ms)

    def pane_of(self, ts: np.ndarray) -> np.ndarray:
        return (ts - self.offset_ms) // self.pane_ms

    def window_dead(self, end_pane: int, wm: int) -> bool:
        """maxTimestamp + allowed lateness <= watermark."""
        end_ms = end_pane * self.pane_ms + self.offset_ms
        return end_ms - 1 + self.allowed_lateness_ms <= wm

    def first_dead_pane(self, wm: int) -> int:
        """Panes strictly below this are purged at watermark wm: the last
        window containing the pane is dead."""
        if wm == LONG_MIN:
            return np.iinfo(np.int64).min // 2
        pps, ppw = self.panes_per_slide, self.panes_per_window
        t = wm + 1 - self.allowed_lateness_ms - self.offset_ms
        q = t // self.pane_ms - ppw
        return (q // pps + 1) * pps

    def fireable_end_panes(self, wm_prev: int, wm_now: int,
                           min_pane_seen: Optional[int] = None) -> List[int]:
        """Slide-aligned window end panes e with wm_prev < end-1 <= wm_now."""
        if wm_now == LONG_MIN:
            return []
        pps, ppw = self.panes_per_slide, self.panes_per_window

        # window starts are slide-aligned, so end panes are ≡ ppw (mod pps)
        def align_down(m: int) -> int:
            return m - ((m - ppw) % pps)

        hi_end = align_down((wm_now + 1 - self.offset_ms) // self.pane_ms)
        if wm_prev == LONG_MIN:
            if min_pane_seen is None:
                return []
            lo_end = align_down(min_pane_seen)
        else:
            lo_end = align_down((wm_prev + 1 - self.offset_ms) // self.pane_ms)
        out = []
        e = lo_end + pps
        while e <= hi_end:
            out.append(int(e))
            e += pps
        return out

    def late_refire_ends(self, late_panes: np.ndarray, fired_below_end: int,
                         wm: int) -> List[int]:
        """Ends of already-fired, still-live windows that a late-within-
        lateness record in ``late_panes`` must re-fire."""
        out: List[int] = []
        pps, ppw = self.panes_per_slide, self.panes_per_window
        for p in np.unique(late_panes).tolist():
            e = (p // pps) * pps + ppw
            while e > p:
                if e <= fired_below_end and not self.window_dead(e, wm):
                    out.append(int(e))
                e -= pps
        return out

    def fire_frontier(self, wm: int) -> int:
        """Highest slide-aligned end pane the watermark has passed."""
        pps, ppw = self.panes_per_slide, self.panes_per_window
        m = (wm + 1 - self.offset_ms) // self.pane_ms
        return m - ((m - ppw) % pps)

    def last_data_end_ms(self, max_pane_seen: int) -> int:
        pps = self.panes_per_slide
        last_end = (max_pane_seen // pps) * pps + self.panes_per_window
        return last_end * self.pane_ms + self.offset_ms

    def enumerate_fire_ends(self, prev_wm: int, wm: int,
                            min_pane_seen: Optional[int],
                            max_pane_seen: Optional[int]) -> List[int]:
        """First-time fireable end panes for prev_wm → wm, clamped to
        windows that can contain data."""
        if max_pane_seen is None:
            return []
        ends_wm = min(wm, self.last_data_end_ms(max_pane_seen) - 1)
        if prev_wm != LONG_MIN and prev_wm >= ends_wm:
            return []
        return self.fireable_end_panes(prev_wm, ends_wm, min_pane_seen)

    def final_watermark_for(self, watermark: int,
                            max_pane_seen: Optional[int]) -> int:
        """Watermark completing and purging every window with data."""
        if max_pane_seen is None:
            return watermark if watermark != LONG_MIN else 0
        return (self.last_data_end_ms(max_pane_seen)
                + self.allowed_lateness_ms + 1)


def staged(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    """Host tensor ready for an asynchronous upload to ``device``: pinned
    for the card (a copy from pageable memory synchronizes the stream
    first), the array itself for the CPU."""
    t = torch.from_numpy(np.ascontiguousarray(arr))
    return t if device.type == "cpu" else t.pin_memory()


def small_upload(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    """Host bytes on ``device`` without waiting on its stream."""
    return staged(arr, device).to(device, non_blocking=True)


class PinnedStage:
    """Host→device uploads of one operator through a few reused pinned
    host slots. A copy from pageable memory synchronizes the stream
    first, and a fresh pinned tensor per copy costs an allocation each
    time; a slot is rewritten only once the copy that last read it has
    run (its CUDA event), and a held slot is not handed out at all.
    ``upload`` stages a small array (larger ones take a fresh pinned
    tensor); ``acquire`` hands out a whole slot as writable numpy to a
    producer that writes in place (the native lane's C finalize), and
    ``upload_slot`` copies a byte range of it. On the CPU an upload is
    the array itself and the slots are plain memory."""

    SLOTS = 8
    SLOT_BYTES = 4096

    def __init__(self, device: torch.device, slots: int = SLOTS,
                 slot_bytes: int = SLOT_BYTES) -> None:
        self.device = device
        self.slots, self.slot_bytes = slots, slot_bytes
        self._host_t: Optional[torch.Tensor] = None
        self._events: List[Optional[torch.cuda.Event]] = [None] * slots
        self._held: Optional[int] = None
        self._next = 0

    def acquire(self) -> Tuple[int, np.ndarray]:
        """(slot, its bytes as writable numpy), once free: never the held
        slot, and never before its last copy has run."""
        i = self._next
        if i == self._held:
            i = (i + 1) % self.slots
        self._next = (i + 1) % self.slots
        if self._events[i] is not None:
            self._events[i].synchronize()
            self._events[i] = None
        if self._host_t is None:
            self._host_t = torch.empty(
                (self.slots, self.slot_bytes), dtype=torch.uint8,
                pin_memory=self.device.type == "cuda")
        return i, self._host_t[i].numpy()

    def hold(self, i: Optional[int]) -> None:
        """Keep slot ``i`` (None: none) from ``acquire``: a stash."""
        self._held = i

    def upload_slot(self, i: int, lo: int, hi: int) -> torch.Tensor:
        """Bytes ``[lo, hi)`` of slot ``i`` on the device as uint8: one
        non-blocking copy, after which the slot's event is recorded."""
        t = self._host_t[i, lo:hi]
        if self.device.type == "cpu":
            return t
        dev = torch.empty(hi - lo, dtype=torch.uint8, device=self.device)
        dev.copy_(t, non_blocking=True)
        ev = torch.cuda.Event()
        ev.record()
        self._events[i] = ev
        return dev

    def upload(self, arr: np.ndarray) -> torch.Tensor:
        arr = np.ascontiguousarray(arr)
        t = torch.from_numpy(arr)
        if self.device.type == "cpu":
            return t
        if arr.nbytes > self.slot_bytes or arr.nbytes == 0:
            return small_upload(arr, self.device)
        i, host = self.acquire()
        host[:arr.nbytes] = arr.reshape(-1).view(np.uint8)
        return self.upload_slot(i, 0, arr.nbytes).view(t.dtype).view(t.shape)


def copy_to_host(buf: torch.Tensor, timer: "DeviceTimer"):
    """(host copy, host copy of the kernels' error word, CUDA event):
    non-blocking copies into pinned memory (a pageable copy would
    synchronize the stream), read once the event has passed; torch's
    pinned allocator hands a block out again only after the copies that
    used it have run. On the CPU a clone, no error word, no event."""
    if buf.device.type == "cpu":
        return buf.clone(), None, None
    with timer.span("drain"):
        host = torch.empty(buf.shape, dtype=buf.dtype, pin_memory=True)
        host.copy_(buf, non_blocking=True)
        err = torch.empty(1, dtype=torch.int32, pin_memory=True)
        err.copy_(wk.error_word(buf.device), non_blocking=True)
        ev = torch.cuda.Event()
        ev.record()
    return host, err, ev


# the native lane's pinned pair buffers: FUSED_HDR header words + up to
# the scan's cap of 2^21 pairs a batch, as 4-byte words or 6-byte
# triples; two slots, one of which a stash may hold
PAIR_SLOTS = 2
PAIR_SLOT_BYTES = 4 * FUSED_HDR + 6 * (1 << 21)


class PairStash(collections.namedtuple("PairStash", "slot buf form")):
    """A native-lane batch held for the next advance's fused step: its
    pinned slot, the slot's int32 words written so far (``FUSED_HDR``
    header words, then the pairs) and the pairs' form
    (``fk.FORM_WORDS`` or ``fk.FORM_TRIPLES``)."""
    __slots__ = ()


class DeviceTimer:
    """Busy time of the device per launch group, from a CUDA event pair
    recorded around each group on the current stream. Completed pairs
    fold into ``busy_ms``; a pair spans whatever the stream ran between
    its two events, so host gaps inside a group count as busy. No-op on
    the CPU."""

    def __init__(self, device: torch.device) -> None:
        self.enabled = device.type == "cuda"
        self.busy_ms: Dict[str, float] = collections.defaultdict(float)
        self._open: collections.deque = collections.deque()

    @contextlib.contextmanager
    def span(self, name: str):
        if not self.enabled:
            yield
            return
        start = torch.cuda.Event(enable_timing=True)
        start.record()
        try:
            yield
        finally:
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            self._open.append((name, start, end))

    def collect(self, block: bool = False) -> None:
        while self._open:
            name, start, end = self._open[0]
            if not block and not end.query():
                return
            end.synchronize()
            self.busy_ms[name] += start.elapsed_time(end)
            self._open.popleft()


# ---------------------------------------------------------------------------
# Host-side operator runtime.
# ---------------------------------------------------------------------------

class WindowOperator:
    """Drives the window kernels for one keyed event-time window
    aggregation on one device, or key-sharded over a mesh of device
    blocks: with ``.top(n)`` through the emit ring, without through
    packed fires; keys past the directory's slots on the host with
    ``spill``."""

    # rows of the device emit ring between host polls; overflow is
    # detected from the ring's monotone head counter and raises
    EMIT_RING_ROWS = 2048

    def __init__(
        self,
        assigner: WindowAssigner,
        agg: LaneAggregate,
        *,
        num_shards: int = 128,
        slots_per_shard: int = 1024,
        allowed_lateness_ms: int = 0,
        max_out_of_orderness_ms: int = 0,
        top_n: Optional[Tuple[str, int]] = None,
        spill: bool = False,
        spill_store: Optional[Any] = None,
        max_inflight_steps: int = PipelineOptions.MAX_INFLIGHT_STEPS.default,
        fire_gate: bool = PipelineOptions.FIRE_GATE.default,
        device: "str | torch.device" = "cuda",
        mesh_plan: Optional[Any] = None,
        exchange_capacity: Optional[int] = None,
        exchange_impl: str = "all-to-all",
        readiness: str = PipelineOptions.READINESS.default,
        host_pool: Optional[Any] = None,
        fold_chunk_records: Optional[int] = None,
        shard_range: Optional[Tuple[int, int]] = None,
    ) -> None:
        # processing-time mode: records are stamped with the operator's
        # clock at ingest and fires ride advance_processing_time — the
        # same panes with the clock as the time axis, so nothing is late
        # or out of order
        self.uses_processing_time = bool(assigner.is_processing_time)
        if not (assigner.is_event_time or self.uses_processing_time):
            raise NotImplementedError(
                f"{type(assigner).__name__} is not pane-decomposable: a "
                "global window needs a count window or a trigger")
        self.clock = None
        if self.uses_processing_time:
            self.clock = SystemProcessingTimeService()
            if allowed_lateness_ms:
                raise ValueError(
                    "allowed lateness is event-time-only; processing-"
                    "time windows cannot see late records")
            max_out_of_orderness_ms = 0
        if agg.fields is None:
            raise NotImplementedError(
                f"aggregate {agg.name!r} does not declare the record fields "
                "its lift reads; the port uploads only declared fields")
        self.agg = agg
        res = probe_finalize(agg)
        self._topn: Optional[Tuple[str, int]] = None
        # top-n over lanes: any ranking field or aggregate but count()
        # ranked by its count, which keeps the count-only kernels (and
        # the fused step and the device-made ingest)
        self._topn_lanes = False
        if top_n is not None:
            by, n = top_n
            if int(n) < 1:
                raise ValueError(f"top_n needs n >= 1, got {top_n}")
            if by not in res:
                raise ValueError(
                    f"top-n by {by!r}: aggregate {agg.name!r} has result "
                    f"fields {sorted(res)}")
            self._topn = (by, int(n))
            self._topn_lanes = not (
                by == "count" and sorted(res) == ["count"]
                and (agg.sum_width, agg.max_width, agg.min_width) == (0, 0, 0))
        if exchange_capacity is not None and exchange_capacity < 0:
            raise ValueError(
                f"exchange_capacity must be >= 0, got {exchange_capacity}")
        # 0 means auto, as the configuration option does
        self.exchange_capacity = exchange_capacity or None
        self.exchange_overflow = 0
        # bytes the exchange copied between distinct device blocks
        self.exchange_bytes = 0
        # one device-side overflow total per sharded push, resolved lazily
        self._overflow_markers: collections.deque = collections.deque()
        self.mesh_plan = mesh_plan
        if mesh_plan is not None:
            if self._topn_lanes:
                raise NotImplementedError(
                    "top-n by a result field over lanes on a device mesh "
                    "(the lane form of the reference's topn_shard) is still "
                    "to port: ROADMAP.md queue 1 item 9.1; a mesh ranks "
                    "count() by its count")
            if spill or spill_store is not None:
                backend = "lsm" if spill_store is not None else "spill"
                raise NotImplementedError(
                    f"state.backend='{backend}' on a device mesh is still "
                    "to port: ROADMAP.md queue 1 item 9.2")
            self._shuffle = get_shuffle(exchange_impl)
            if (self._shuffle is all_to_all_shuffle
                    and isinstance(mesh_plan, HybridMeshPlan)):
                # one process of a job across processes: the exchange
                # among this process's own blocks
                self._shuffle = intra_slice_exchange
            slots_per_shard = mesh_plan.slots_per_shard
            if shard_range is None:
                # one process: the directory covers every shard, each
                # block a contiguous range of its rows
                num_shards = mesh_plan.num_shards
            elif shard_range[1] - shard_range[0] != mesh_plan.num_shards:
                # across processes the local blocks span exactly this
                # process's shards; the directory keeps the global space
                # so a misrouted key is caught (-1)
                raise ValueError(
                    f"local mesh covers {mesh_plan.num_shards} shards "
                    f"but this process's range {shard_range} spans "
                    f"{shard_range[1] - shard_range[0]}")
            self._devices = [resolve_device(d) for d in mesh_plan.devices]
        else:
            self._devices = [resolve_device(device)]
        # the home device: host uploads, the emit ring's first block,
        # the timer's spans
        self.device = self._devices[0]
        self.plan = WindowPlan.plan(
            assigner, allowed_lateness_ms=allowed_lateness_ms,
            max_out_of_orderness_ms=max_out_of_orderness_ms)
        self.directory = KeyDirectory(num_shards, slots_per_shard,
                                      shard_range)
        self.layout = PaneStateLayout(
            slots=(mesh_plan.slots_per_device if mesh_plan is not None
                   else self.directory.local_slots),
            ring=self.plan.ring, sum_width=agg.sum_width,
            max_width=agg.max_width, min_width=agg.min_width)
        # the pane state: one block per device of the mesh (one block
        # without a mesh, ``state``)
        self._blocks = [init_state(self.layout, d) for d in self._devices]
        # result fields in packed-buffer column order, which are ints,
        # and their empty columns for a fire with no rows
        self._res_fields = sorted(res)
        self._res_is_int = {k: not torch.is_floating_point(v)
                            for k, v in res.items()}
        self._res_empty = {k: v.numpy() for k, v in res.items()}
        self.watermark = LONG_MIN
        self._cleared_below = self.plan.first_dead_pane(LONG_MIN)
        self._fired_below_end: Optional[int] = None
        self._refire: set = set()
        self._min_pane_seen: Optional[int] = None
        self._max_pane_seen: Optional[int] = None
        self.late_records = 0
        # state.backend = spill: keys past the directory's slots
        # aggregate on the host; a top-n with spill queues the store's
        # rows here for the drain that re-ranks them with the ring's.
        # state.backend = lsm passes the disk tier (state/lsm.py, the
        # same interface) as spill_store
        self._spill: Optional[Any] = (
            spill_store if spill_store is not None
            else HostSpillStore(agg, pool=host_pool,
                                fold_chunk_records=fold_chunk_records)
            if spill else None)
        self._pending_ring_extras: collections.deque = collections.deque()
        # state.allow-drops: drop and count the records of a full shard
        # instead of failing the job (account_full_drop)
        self.allow_drops = False
        self.records_dropped_full = 0
        # bumped wherever the snapshotted state may change (the
        # reference's five sites): a checkpoint hardlinks the previous
        # blob of an operator whose version it already holds
        self.state_version = 0
        # bounded in-flight dispatch: ingest waits on the oldest step's
        # CUDA event once more than this many are outstanding
        self.max_inflight_steps = int(max_inflight_steps)
        self._inflight: collections.deque = collections.deque()
        # pipeline.readiness: how that wait learns a step is done (see
        # throttle); a driver that sets external_throttle calls throttle
        # itself, at its own cadence
        if readiness not in READINESS_VALUES:
            raise ValueError(
                f"pipeline.readiness must be 'piggyback' or 'probe', "
                f"got {readiness!r}")
        self.readiness = readiness
        self.external_throttle = False
        # pipeline.fire-gate: a fused step skips its fire on the card when
        # the header lists no window end, and its purge when the clear
        # mask is empty; it also sizes the fire to the ends it has
        # (_fire_pad_bucket). The bytes are the same either way.
        self.fire_gate = bool(fire_gate)
        # native lane: a count-only top-n batch's pairs (PairStash)
        # waiting for the next advance's fused step, the pinned buffers,
        # and the C scan's zeroed workspace
        self._stash: Optional[PairStash] = None
        self._pairs = PinnedStage(self.device, PAIR_SLOTS, PAIR_SLOT_BYTES)
        self._preagg_ws: Optional[nc.PreaggWorkspace] = None
        # device emit ring, one per block: row 0 = head [total appended,
        # truncated, 0], rows 1..EMIT_RING_ROWS = data, last row reserved;
        # the rows drained of each
        self._emit_rings: Optional[List[torch.Tensor]] = None
        self._ring_drained = [0] * len(self._devices)
        self._ring_anchor: Optional[int] = None
        # announced ring versions (version_no, per block (host copy, host
        # copy of its device's error word, CUDA event; both None on the
        # CPU)): each row-carrying fire starts a non-blocking device→host
        # copy; a poll reads the newest copy that landed
        self._ring_versions: collections.deque = collections.deque(maxlen=4)
        self._ring_version_no = 0
        self._used_pushed = -1
        self._used_dev: Optional[torch.Tensor] = None
        self._stage = PinnedStage(self.device)
        # device constants of the fire and purge: all-valid window flags
        # (sliced per fire) and the identity column map (per ring size)
        self._w_valid = torch.ones(MIN_FIRE_PAD, dtype=torch.bool,
                                   device=self.device)
        self._ident_cols: Optional[torch.Tensor] = None
        # the host-driven fire's (rows, W) window counts, a buffer a width
        # (_wc_out)
        self._wc_bufs: Dict[int, torch.Tensor] = {}
        # the sharded top-n's gathered candidates, a buffer a (W, M)
        # (_gathered)
        self._gathered_bufs: Dict[Tuple[int, int], torch.Tensor] = {}
        self.prof: Dict[str, float] = collections.defaultdict(float)
        self.timer = DeviceTimer(self.device)
        # device-made source (attach_device_source): its spec, the batch
        # (index, dead_below, refire_below, need_stats) waiting for the
        # next advance, and dispatched batches' stats copies (batch
        # index, dead_below, host stats, CUDA event) awaiting
        # reconciliation
        self._devgen_spec = None
        self._stash_devgen: Optional[Tuple[int, int, int, bool]] = None
        self._devstats_pending: collections.deque = collections.deque()

    @property
    def state(self) -> PaneState:
        """The pane state of an operator on one device."""
        return self._blocks[0]

    @state.setter
    def state(self, value: PaneState) -> None:
        self._blocks = [value]

    @property
    def _emit_ring(self) -> Optional[torch.Tensor]:
        return self._emit_rings[0] if self._emit_rings else None

    def _on_blocks(self, t: torch.Tensor) -> List[torch.Tensor]:
        """``t`` on each block's device (itself where it lies there)."""
        return [t if t.device == d else t.to(d, non_blocking=True)
                for d in self._devices]

    # -- sizes ------------------------------------------------------------
    def _topn_cap(self) -> int:
        """Winner capacity of one fire: n rows per window plus generous
        tie headroom; more selected rows than this raise at the drain."""
        return _next_pow2(MAX_FIRE_CHUNK * max(64, 8 * self._topn[1]))

    # -- data path --------------------------------------------------------
    def process_batch(self, keys: np.ndarray, ts: np.ndarray,
                      data: Dict[str, np.ndarray],
                      valid: Optional[np.ndarray] = None) -> None:
        """Fold a batch in. Late-beyond-lateness rows are dropped and
        counted; late-within-lateness rows schedule re-fires. In
        processing-time mode every record takes the clock's time."""
        if self.uses_processing_time:
            ts = np.full(len(np.asarray(ts)), self.clock.now_ms(), np.int64)
        if (self.mesh_plan is None and self._spill is None
                and self._preagg_lanes() == ()
                and (valid is None or bool(np.all(valid)))
                and self._process_batch_fused(keys, ts)):
            return
        self._flush_stash()
        t0 = time.perf_counter()
        self.state_version += 1
        keys = np.asarray(keys, dtype=np.int64)
        ts = np.asarray(ts, dtype=np.int64)
        valid = (np.ones(len(ts), bool) if valid is None
                 else np.asarray(valid, bool))
        panes = self.plan.pane_of(ts)

        dead = self._cleared_below
        late_mask = valid & (panes < dead)
        self.late_records += int(late_mask.sum())
        valid = valid & ~late_mask

        if valid.any():
            mn = int(panes[valid].min())
            mx = int(panes[valid].max())
            prev_min, prev_max = self._min_pane_seen, self._max_pane_seen
            if prev_min is None or mn < prev_min:
                self._min_pane_seen = mn
            if prev_max is None or mx > prev_max:
                self._max_pane_seen = mx
            # at most one live pane per ring column: grow (remapping only
            # the panes already applied) before this batch lands
            live_lo = max(dead, self._min_pane_seen)
            live_hi = self._max_pane_seen
            if live_hi - live_lo >= self.plan.ring:
                self._grow_ring(live_hi - live_lo + 1, prev_min, prev_max)

        if self._fired_below_end is not None:
            late_ok = valid & (panes < self._fired_below_end)
            if late_ok.any():
                self._refire.update(self.plan.late_refire_ends(
                    panes[late_ok], self._fired_below_end, self.watermark))

        t1 = time.perf_counter()
        self.prof["pb_host_pre"] += t1 - t0
        slots = self.directory.assign(keys)
        self.prof["pb_assign"] += time.perf_counter() - t1
        bad = valid & (slots < 0)
        if bad.any():
            full = bad & (slots == KeyDirectory.FULL)
            if self._spill is not None and full.any():
                # a full shard's keys aggregate on the host; a key
                # outside the directory (-1) is never absorbed
                self._spill.absorb(keys[full], panes[full],
                                   {k: data[k][full] for k in self.agg.fields})
                bad = bad & ~full
            if bad.any():
                account_full_drop(self, int(bad.sum()))
            valid = valid & ~bad & ~full
        t2 = time.perf_counter()
        ring = self.plan.ring
        if self.mesh_plan is not None:
            self._apply_sharded(slots, panes, valid, data, t2)
            self._throttle()
            return
        lanes_f = self._preagg_lanes()
        cap = (self._preagg_gate(panes, valid, lanes_f)
               if lanes_f is not None else 0)
        if cap:
            self._preagg_dispatch(slots, panes, valid, data, lanes_f, cap)
        else:
            # per-record: one cell per valid record (plus the fields the
            # aggregate reads), as 3 bytes while the split upload holds,
            # else a flat index (int32, int64 past CELL_INDEX_LIMIT);
            # invalid records never leave the host
            cols = ring_column(panes, ring)
            if self._split_upload:
                idx = split_encode(slots, cols, valid)
            else:
                idx = (slots * ring + cols).astype(self._cell_dtype())
            fields = {k: device_cast(data[k]) for k in self.agg.fields}
            if not valid.all():
                idx = idx[valid]
                fields = {k: v[valid] for k, v in fields.items()}
            self.prof["pb_pack"] += time.perf_counter() - t2
            if self._has_lanes():
                self._apply_records(idx, fields)
            else:
                self._apply_cells(idx, None)
        self._throttle()

    @property
    def _split_upload(self) -> bool:
        """The per-record upload goes as 3 bytes a record while the slot
        id fits uint16 with 0xFFFF reserved (dump row included; under a
        mesh the global slot id, below 0xFFFF) and the ring column fits a
        byte: the reference's rule, current after every ring growth. Its
        cells (under 2^24) always stay below the real
        ``CELL_INDEX_LIMIT``; past a lowered one the flat upload goes."""
        if self._cell_dtype() is not np.int32:
            return False
        if self.mesh_plan is not None:
            return (len(self._devices) * self.layout.slots
                    < wk.INVALID_SLOT_U16 and self.plan.ring <= 256)
        return (self.layout.rows <= wk.INVALID_SLOT_U16
                and self.plan.ring <= 256)

    def _has_lanes(self) -> bool:
        lay = self.layout
        return (lay.sum_width, lay.max_width, lay.min_width) != (0, 0, 0)

    def _preagg_lanes(self) -> Optional[Tuple[str, ...]]:
        """The sum fields the host may pre-combine — ``()`` for count
        only — or None when a lane is not a host-combinable sum or the
        pair domain is too large (the reference's eligibility rule)."""
        agg = self.agg
        if (agg.max_width == 0 and agg.min_width == 0
                and agg.sum_fields is not None
                and len(agg.sum_fields) == agg.sum_width
                and self.layout.slots * self.plan.ring <= PREAGG_MAX_DOMAIN):
            return agg.sum_fields
        return None

    def _preagg_gate(self, panes: np.ndarray, valid: np.ndarray,
                     lanes_f: Tuple[str, ...]) -> int:
        """Combine on the host when the pair buffer is decisively smaller
        than the per-record upload (the reference's gate: 6 bytes per
        count-only pair bucket, 4 per column of an ``[pair, count, sum
        lanes...]`` row, against 2 bytes per record): the pair capacity
        when it is, else 0."""
        nv = int(valid.sum())
        if nv == 0:
            return 0
        pv = panes[valid]
        span = int(pv.max() - pv.min()) + 1
        nk = self.directory.num_keys()
        bound = min(nv, max(nk, 1) * min(span, self.plan.ring))
        bpp = 6 if not lanes_f else 4 * (2 + len(lanes_f))
        cap = _next_pow2(max(bound, 256))
        return cap if bpp * cap <= 2 * len(panes) else 0

    def _preagg_dispatch(self, slots: np.ndarray, panes: np.ndarray,
                         valid: np.ndarray, data: Dict[str, np.ndarray],
                         lanes_f: Tuple[str, ...], cap: int) -> None:
        """The general path's host combine: in C on the native lane (at
        most ``cap`` pairs; more fall back to numpy, as in the
        reference), in numpy with the numpy key table; then sum lanes as
        one ``(P, 2 + S)`` upload, count-only pairs in the native lane's
        word forms (``_apply_combined``) or, on the numpy lane, as an
        int32 index + count upload."""
        t0 = time.perf_counter()
        ring = self.plan.ring
        native = None
        if self.directory.native() and cap <= (1 << 21):
            ws = self._workspace(self.layout.slots * ring, len(lanes_f))
            native = nc.preagg_combine_native(
                slots, panes, valid, [data[f] for f in lanes_f], ring, ws, cap)
        if native is not None:
            pairs, cnts, sums = native
        else:
            pairs, cnts, sums = preagg_combine(slots, panes % ring, valid,
                                               ring, data, lanes_f)
        self.prof["preagg_combine"] += time.perf_counter() - t0
        if lanes_f:
            self._apply_pairs(preagg_encode_i32(pairs, cnts, sums))
        elif native is not None:
            self._apply_combined(pairs, cnts)
        else:
            self._apply_cells(pairs, cnts)

    def _workspace(self, domain: int, nlanes: int) -> nc.PreaggWorkspace:
        ws = self._preagg_ws
        if ws is None or ws.domain != domain or ws.nlanes != nlanes:
            ws = self._preagg_ws = nc.PreaggWorkspace(domain, nlanes)
        return ws

    # -- native lane --------------------------------------------------------
    def _fused_ok(self) -> bool:
        """The fused step exists for count-only top-n operators on one
        device without spill whose ring fits the header's 64-bit clear
        mask."""
        return (self.mesh_plan is None
                and self._topn is not None and not self._topn_lanes
                and self._spill is None
                and self.plan.ring <= fk.MAX_FUSED_RING)

    def _process_batch_fused(self, keys: np.ndarray, ts: np.ndarray) -> bool:
        """Count-only ingest in one C scan (``ingest_fused_scan``): the
        key probe, panes, late and re-fire accounting and the (slot, ring
        column) histogram, then the pair words written by C. Returns
        False — with no pane state touched, at most new keys registered,
        as ``assign`` would — when the directory holds the numpy table,
        the batch looks high-cardinality (the pair capacity is not
        decisively below the batch), the pairs overflow it, or the
        re-fire span is degenerate; the caller then runs the general
        path. The reference's gates and order, rule for rule."""
        if not self.directory.native():
            return False
        table = self.directory._table
        keys = np.asarray(keys, dtype=np.int64)
        ts = np.asarray(ts, dtype=np.int64)
        n = len(ts)
        nk = self.directory.num_keys()
        cap = _next_pow2(max(min(n, max(nk, 1) * self.plan.ring), 256))
        if 4 * cap > 2 * n or cap > (1 << 21):
            return False
        dead = self._cleared_below
        refire_below = (self._fired_below_end
                        if self._fired_below_end is not None
                        else int(np.iinfo(np.int64).min))
        bits = 0
        if refire_below > dead:
            if refire_below - dead > (1 << 20):
                return False  # degenerate lateness span: general path
            bits = int(refire_below - dead)
        prev_min, prev_max = self._min_pane_seen, self._max_pane_seen
        pane_ms, off = self.plan.pane_ms, self.plan.offset_ms
        t_scan = time.perf_counter()
        for attempt in (0, 1):
            ws = self._workspace(self.layout.slots * self.plan.ring, 0)
            scan = nc.ingest_fused_scan_native(
                keys, ts, table, pane_ms, off, self.plan.ring, ws, cap, dead,
                refire_below, bits, miss_cap=n)
            if scan is None:
                return False
            res, miss_ix = scan
            if len(miss_ix):
                # new keys: register them (the probe proved them absent),
                # then continue the same scan over just their records
                t1 = time.perf_counter()
                self.directory.register_misses(keys[miss_ix])
                self.prof["pb_assign"] += time.perf_counter() - t1
                scan = nc.ingest_fused_scan_native(
                    keys[miss_ix], ts[miss_ix], table, pane_ms, off,
                    self.plan.ring, ws, cap, dead, refire_below, bits,
                    cont=res, miss_cap=1)
                if scan is None:
                    return False
                res, miss2 = scan
                if len(miss2):  # registered keys cannot miss
                    ws.rezero()
                    return False
            (n_valid, n_late, n_bad, pmin, pmax, n_refire, _,
             cmax) = (int(x) for x in res.stats)
            if n_valid == 0:
                break
            if self._min_pane_seen is None or pmin < self._min_pane_seen:
                self._min_pane_seen = pmin
            if self._max_pane_seen is None or pmax > self._max_pane_seen:
                self._max_pane_seen = pmax
            live_lo = max(dead, self._min_pane_seen)
            live_hi = self._max_pane_seen
            if live_hi - live_lo >= self.plan.ring and attempt == 0:
                # the histogram's columns were taken mod the old ring:
                # grow (remapping only the panes applied before this
                # batch) and scan again
                ws.rezero()
                self._grow_ring(live_hi - live_lo + 1, prev_min, prev_max)
                continue
            break
        self.state_version += 1
        self.prof["preagg_combine"] += time.perf_counter() - t_scan
        self.late_records += n_late
        if n_bad:
            if not self.allow_drops:
                ws.rezero()
            account_full_drop(self, n_bad)
        if n_refire:
            late_panes = (np.flatnonzero(
                np.unpackbits(res.bitmap, bitorder="little")) + dead)
            self._refire.update(self.plan.late_refire_ends(
                late_panes, self._fired_below_end, self.watermark))
        if n_valid == 0:
            return True
        tc = time.perf_counter()
        domain = self.layout.slots * self.plan.ring
        if cmax <= 0xFFFF:
            # C writes the pairs into a pinned buffer behind FUSED_HDR
            # header words, which the next advance fills for its fused
            # step: a u32 word a pair while every count < 0xFFF and the
            # pair domain fits 20 bits (the reference's rule), else a
            # uint16 triple a pair. The real pairs only (the reference
            # pads them to a power of two to bound its recompiles), so no
            # padding is uploaded or read
            slot, out = self._pairs.acquire()
            if cmax < 0xFFF and domain <= (1 << 20):
                stash = PairStash(slot, nc.ingest_fused_finalize_u32_native(
                    res, ws, FUSED_HDR, res.npairs, out.view(np.int32)),
                    fk.FORM_WORDS)
            else:
                stash = PairStash(slot, nc.ingest_fused_finalize_u16_native(
                    res, ws, FUSED_HDR, out.view(np.int32)), fk.FORM_TRIPLES)
            if self._fused_ok() and self._stash is None:
                self._stash = stash
                self._pairs.hold(slot)
                self.prof["pb_preagg"] += time.perf_counter() - tc
                return True
            self._apply_stash(stash)
        else:
            self._apply_combined(
                *nc.ingest_fused_finalize_pairs_native(res, ws))
        self.prof["pb_preagg"] += time.perf_counter() - tc
        self._throttle()
        return True

    def _apply_stash(self, stash: PairStash) -> None:
        """Fold a pinned buffer's pairs (after its header) in on their
        own: words with ``apply_pairs_u32``, triples with
        ``apply_pairs_u16``."""
        t0 = time.perf_counter()
        lo = 4 * FUSED_HDR
        with self.timer.span("apply"):
            if stash.form == fk.FORM_WORDS:
                words = self._pairs.upload_slot(
                    stash.slot, lo, 4 * len(stash.buf)).view(torch.int32)
                fk.apply_pairs_u32(self.state.counts, words, self.layout.slots)
            else:
                n = (4 * len(stash.buf) - lo) // 6
                triples = self._pairs.upload_slot(stash.slot, lo, lo + 6 * n)
                fk.apply_pairs_u16(self.state.counts,
                                   triples.view(torch.uint16).view(n, 3))
        self._note_dispatch()
        self.prof["pb_dispatch"] += time.perf_counter() - t0

    def _apply_combined(self, pairs: np.ndarray, cnts: np.ndarray) -> None:
        """Count-only pairs of the native lane in the tightest form that
        holds them (the reference's rule): a u32 word each while every
        count < 0xFFF and the pair domain fits 20 bits
        (``apply_pairs_u32``), uint16 triples while counts fit 16 bits
        (``apply_pairs_u16``), else an int32 index + count upload
        (``scatter_counts``); the real pairs only, no padding. Triples
        are written into a pinned slot, as the scan's finalize writes
        them: on an operator that takes fused steps they are stashed for
        the next advance's, so its count-only batches never launch
        ``apply_pairs_u16``; words are applied at once, as the reference
        applies them."""
        n = len(pairs)
        if n == 0:
            return
        cmax = int(cnts.max())
        if cmax < 0xFFF and self.layout.slots * self.plan.ring <= (1 << 20):
            # a word a real pair, no padding
            t0 = time.perf_counter()
            buf_h = staged(preagg_encode_u32(pairs, cnts, n), self.device)
            with self.timer.span("apply"):
                fk.apply_pairs_u32(self.state.counts,
                                   buf_h.to(self.device, non_blocking=True),
                                   self.layout.slots)
            self._note_dispatch()
            self.prof["pb_dispatch"] += time.perf_counter() - t0
        elif cmax <= 0xFFFF:
            # the C combine holds at most 2^21 pairs (_preagg_dispatch), so
            # they fit a slot
            t0 = time.perf_counter()
            slot, out = self._pairs.acquire()
            words = out.view(np.int32)
            words[:FUSED_HDR] = -1
            t = words[FUSED_HDR:].view(np.uint16)
            t[:3 * n] = preagg_encode_u16(pairs, cnts, n).reshape(-1)
            t[3 * n:3 * n + (n & 1)] = 0xFFFF
            stash = PairStash(slot, words[:FUSED_HDR + (6 * n + 3) // 4],
                              fk.FORM_TRIPLES)
            self.prof["pb_dispatch"] += time.perf_counter() - t0
            if self._fused_ok() and self._stash is None:
                self._stash = stash
                self._pairs.hold(slot)
            else:
                self._apply_stash(stash)
        else:
            self._apply_cells(pairs, cnts)

    def _flush_stash(self) -> None:
        """Fold a stashed native-lane batch in on its own, in its form
        (``apply_pairs_u32`` or ``apply_pairs_u16``). Every consumer of
        up-to-date state calls this first: the general ingest path, an
        advance that takes no fused step, ring growth (so the pairs land
        under the ring they were counted for), quiesce and snapshots."""
        stash = self._stash
        if stash is None:
            return
        self._stash = None
        self._pairs.hold(None)
        self._apply_stash(stash)

    def _fire_pad_bucket(self, n_ends: int) -> int:
        """Delta slots a fused step reads: with the fire gate its end
        count, its fire's width (the reference rounds it up to a power of
        two, which bounds its recompiles; the port compiles nothing per
        width, and the unused slots cost the fire their windows), else
        all MIN_FIRE_PAD."""
        if not self.fire_gate:
            return MIN_FIRE_PAD
        return min(MIN_FIRE_PAD, max(n_ends, 1))

    def _fused_fill_header(self, wm: int, ends: List[int], buf: np.ndarray,
                           max_ends: int = MIN_FIRE_PAD
                           ) -> Optional[Tuple[List[int], int]]:
        """Fill the stashed buffer's FUSED_HDR header in place: pane
        bounds, ring anchor, clear mask, window-end deltas (the layout
        ``fused_step`` documents). Returns (the ends it fires, the purge
        frontier after it), or None when more than ``max_ends`` ends
        fire."""
        ppw = self.plan.panes_per_window
        if self._max_pane_seen is None:
            ends_f: List[int] = []
            lo = self._cleared_below
        else:
            lo = max(self._cleared_below, self._min_pane_seen)
            ends_f = [e for e in ends if e > lo and e - ppw <= self._max_pane_seen]
        if len(ends_f) > max_ends:
            return None
        # the purge, as advance_watermark's: its mask rides the header
        clear, cleared_after = self._purge_columns(wm)
        clear_word = 0
        if clear is not None:
            for c in np.flatnonzero(clear).tolist():
                clear_word |= 1 << c
        if self._ring_anchor is None:
            self._ring_anchor = lo
        hi = self._max_pane_seen if self._max_pane_seen is not None else lo - 1
        buf[:6] = np.array([lo, hi, self._ring_anchor], np.int64).view(np.int32)
        cw = np.array([clear_word], np.uint64).view(np.int32)
        buf[7], buf[6] = cw[0], cw[1]
        deltas = np.full(MIN_FIRE_PAD, fk.DELTA_SENTINEL, np.int64)
        deltas[:len(ends_f)] = np.asarray(ends_f, np.int64) - lo
        buf[8:8 + MIN_FIRE_PAD] = deltas.astype(np.int32)
        return ends_f, cleared_after

    def _advance_fused(self, wm: int, ends: List[int]) -> Optional["FiredWindows"]:
        """The advance over a stashed batch as one upload and one
        ``fused_step`` call: the stash's apply in its form, the fire of
        up to MIN_FIRE_PAD window ends (rows row-major over all of them)
        and the purge. None when more ends fire; the caller then flushes
        the stash and takes the chunked path. Triples take at most
        MAX_FIRE_CHUNK_RING ends: the reference folds such a batch in at
        once and fires in chunks of that many, and a fused step's rows
        run row-major over all its ends, the same order only up to one
        chunk."""
        stash = self._stash
        filled = self._fused_fill_header(
            wm, ends, stash.buf, MIN_FIRE_PAD if stash.form == fk.FORM_WORDS
            else MAX_FIRE_CHUNK_RING)
        if filled is None:
            return None
        ends_f, cleared_after = filled
        self._stash = None
        self._pairs.hold(None)
        used = self._used_mask_device()[0]
        ring_buf = self._ensure_ring()[0]
        with self.timer.span("step"):
            fk.fused_step(self.state.counts, ring_buf,
                          self._pairs.upload_slot(
                              stash.slot, 0, 4 * len(stash.buf))
                          .view(torch.int32), used,
                          ppw=self.plan.panes_per_window, n=self._topn[1],
                          sel_cap=self._topn_cap(), dump_row=self.layout.slots,
                          fire_gate=self.fire_gate,
                          fire_pad=self._fire_pad_bucket(len(ends_f)),
                          form=stash.form)
        self._note_dispatch()
        self._cleared_below = cleared_after
        return self._ring_after_fire(len(ends_f))

    def _cell_dtype(self) -> type:
        """The dtype of an upload's flat cells (row * ring + column; a
        mesh's global cells over every block's rows): int32 while they
        stay below ``CELL_INDEX_LIMIT``, else int64 — where the reference
        switches. Current after every ring growth."""
        rows = len(self._devices) * self.layout.rows + 1
        return (np.int32 if rows * self.plan.ring < CELL_INDEX_LIMIT
                else np.int64)

    def _apply_cells(self, idx: np.ndarray, cnt: Optional[np.ndarray]) -> None:
        """Count-lane cells: flat indices (``scatter_counts``), or a split
        upload's (B, 3) bytes, per record with no counts
        (``scatter_split_counts``, one launch)."""
        if len(idx) == 0:
            return
        t0 = time.perf_counter()
        idx_h = staged(idx, self.device)
        cnt_h = staged(cnt, self.device) if cnt is not None else None
        with self.timer.span("apply"):
            idx_d = idx_h.to(self.device, non_blocking=True)
            if idx_d.dtype == torch.uint8:
                # the split upload's bytes, decoded inside the count
                wk.scatter_split_counts(self.state.counts, idx_d,
                                        self.layout.slots)
            else:
                cnt_d = (cnt_h.to(self.device, non_blocking=True)
                         if cnt_h is not None else None)
                wk.scatter_counts(self.state.counts, idx_d, cnt_d)
        self._note_dispatch()
        self.prof["pb_dispatch"] += time.perf_counter() - t0

    def _apply_records(self, idx: np.ndarray,
                       fields: Dict[str, np.ndarray]) -> None:
        """Per-record lanes: upload the cells (flat indices or a
        split upload's bytes, which ``scatter_lanes`` decodes in its own
        launch) and the fields the aggregate reads, lift them on the
        device, ``scatter_lanes``."""
        if len(idx) == 0:
            return
        t0 = time.perf_counter()
        idx_h = staged(idx, self.device)
        fields_h = {k: staged(v, self.device) for k, v in fields.items()}
        with self.timer.span("apply"):
            idx_d = idx_h.to(self.device, non_blocking=True)
            data = {k: v.to(self.device, non_blocking=True)
                    for k, v in fields_h.items()}
            ones = torch.ones(len(idx), dtype=torch.bool, device=self.device)
            s, mx, mn = self.agg.lift_masked(data, ones)
            st = self.state
            lk.scatter_lanes(st.counts, st.sums, st.maxs, st.mins, idx_d,
                             s.contiguous(), mx.contiguous(), mn.contiguous(),
                             dump_row=(self.layout.slots
                                       if idx_d.dtype == torch.uint8
                                       else None))
        self._note_dispatch()
        self.prof["pb_dispatch"] += time.perf_counter() - t0

    def _apply_pairs(self, buf: np.ndarray) -> None:
        """Host-combined pairs with sum lanes: one ``(P, 2 + S)`` int32
        upload, ``scatter_pair_lanes``."""
        if len(buf) == 0:
            return
        t0 = time.perf_counter()
        buf_h = staged(buf, self.device)
        with self.timer.span("apply"):
            buf_d = buf_h.to(self.device, non_blocking=True)
            lk.scatter_pair_lanes(self.state.counts, self.state.sums, buf_d)
        self._note_dispatch()
        self.prof["pb_dispatch"] += time.perf_counter() - t0

    # -- key-sharded ingest -------------------------------------------------
    def _apply_sharded(self, slots: np.ndarray, panes: np.ndarray,
                       valid: np.ndarray, data: Dict[str, np.ndarray],
                       t2: float) -> None:
        """A batch over the mesh: global cells ``slot * ring + column``
        (-1 invalid) with the fields the aggregate reads, split so that
        no exchange bucket overflows, each chunk padded to its dispatch
        length and pushed through ``_dispatch_sharded``; one device-side
        overflow total per batch."""
        ring = self.plan.ring
        packed = (slots * ring + ring_column(panes, ring)).astype(
            self._cell_dtype())
        packed[~valid] = -1
        fields = {k: device_cast(data[k]) for k in self.agg.fields}
        t3 = time.perf_counter()
        self.prof["pb_pack"] += t3 - t2
        n_dev = len(self._devices)
        overflow = None
        for pk, chunk, target in self._split_for_exchange(packed, fields,
                                                          n_dev):
            pad = target - len(pk)
            if pad:
                # the padded layout the splitter checked: source block j
                # is records [j L, (j + 1) L) of it
                pk = np.concatenate([pk, np.full(pad, -1, pk.dtype)])
                chunk = {k: np.concatenate(
                    [v, np.zeros((pad,) + v.shape[1:], v.dtype)])
                    for k, v in chunk.items()}
            ov = self._dispatch_sharded(pk, chunk)
            overflow = ov if overflow is None else overflow + ov
        if overflow is not None:
            self._overflow_markers.append(overflow)
        self.prof["pb_dispatch"] += time.perf_counter() - t3

    def _dispatch_sharded(self, pk: np.ndarray,
                          fields: Dict[str, np.ndarray]) -> torch.Tensor:
        """One padded chunk: each source block's cells uploaded to its
        device (as 3 bytes a record while the split upload holds, with
        the row past every block as the invalid one: the built-in
        shuffles' ``bucket_records`` decodes them where it reads them, a
        registered shuffle gets them decoded by ``split_cells``), its
        fields lifted there, then the exchange and each block's fold of
        what it received. Returns the chunk's overflow total (a device
        scalar on the home device)."""
        devs, n = self._devices, len(self._devices)
        ring, spd = self.plan.ring, self.layout.slots
        L = len(pk) // n
        cap = self.exchange_capacity or L
        lay = self.layout
        widths = (lay.sum_width, lay.max_width, lay.min_width)
        lanes = sum(widths)
        split = self._split_upload
        flat_only = not takes_split_bytes(self._shuffle)
        cells, payload = [], []
        with self.timer.span("apply"):
            for j, dev in enumerate(devs):
                blk = pk[j * L:(j + 1) * L]
                with on_device(dev):
                    if split:
                        ok = blk >= 0
                        sc = split_encode(np.where(ok, blk // ring, 0),
                                          np.where(ok, blk % ring,
                                                   0).astype(np.uint8), ok)
                        sc_d = small_upload(sc, dev)
                        cells.append(wk.split_cells(sc_d, ring, n * spd)
                                     if flat_only else sc_d)
                    else:
                        cells.append(small_upload(blk, dev))
                    if not lanes:
                        payload.append(None)
                        continue
                    data = {k: small_upload(v[j * L:(j + 1) * L], dev)
                            for k, v in fields.items()}
                    ones = torch.ones(L, dtype=torch.bool, device=dev)
                    payload.append(torch.cat(self.agg.lift_masked(data, ones),
                                             dim=1).contiguous())
            recv, overflow, moved = self._shuffle(
                cells, payload, devices=devs, capacity=cap, spd=spd,
                ring=ring)
            for st, dev, (r_cells, r_lanes, _) in zip(self._blocks, devs,
                                                      recv):
                with on_device(dev):
                    if not lanes:
                        wk.scatter_counts(st.counts, r_cells,
                                          skip_negative=True)
                        continue
                    s, mx, mn = torch.split(r_lanes, widths, dim=1)
                    lk.scatter_lanes(st.counts, st.sums, st.maxs, st.mins,
                                     r_cells, s.contiguous(), mx.contiguous(),
                                     mn.contiguous(), skip_negative=True)
            total = sum(ov.to(self.device).sum() for ov in overflow)
        # bytes the exchange copied between distinct blocks
        self.exchange_bytes += moved
        self._note_dispatch()
        return total

    @staticmethod
    def _pow2_target(b: int, n_dev: int) -> int:
        """Dispatch length of a ``b``-record chunk: the next power of two,
        then aligned to the block count (the reference's rule)."""
        t = max(n_dev, _next_pow2(max(b, 1)))
        return t + (-t) % n_dev

    def _split_for_exchange(self, packed: np.ndarray,
                            data: Dict[str, np.ndarray], n_dev: int
                            ) -> List[Tuple[np.ndarray, Dict, int]]:
        """Split a batch so that no (source block, destination) bucket of
        the exchange exceeds ``exchange_capacity``: data loss becomes
        impossible instead of counted (a skewed key costs more steps).
        Yields ``(chunk, data, target)``, ``target`` the padded dispatch
        length; the check runs against the same padded block layout the
        dispatch uses (block length ``target // n_dev``). Capacity None =
        block-sized buckets, which cannot overflow: one chunk, no check.
        A one-record chunk is always accepted (capacity >= 1). The
        reference's splitter, rule for rule."""
        cap = self.exchange_capacity
        if cap is None:
            return [(packed, data, self._pow2_target(len(packed), n_dev))]
        ring, spd = self.plan.ring, self.layout.slots
        out: List[Tuple[np.ndarray, Dict, int]] = []
        stack = [(packed, data)]
        while stack:
            pk, dt = stack.pop()
            b = len(pk)
            if not b:
                continue
            target = self._pow2_target(b, n_dev)
            L = target // n_dev
            ok = pk >= 0
            dest = np.where(ok, (pk // ring) // spd, 0)
            block = np.arange(b) // L
            flat = np.where(ok, block * n_dev + dest, n_dev * n_dev)
            counts = np.bincount(flat, minlength=n_dev * n_dev + 1)
            if counts[:n_dev * n_dev].max(initial=0) <= cap or b <= 1:
                out.append((pk, dt, target))
            else:
                mid = b // 2
                stack.append((pk[mid:], {k: v[mid:] for k, v in dt.items()}))
                stack.append((pk[:mid], {k: v[:mid] for k, v in dt.items()}))
        return out

    def _resolve_overflow(self, bound: int = 0) -> None:
        """Fold pending overflow totals (beyond the newest ``bound``) into
        ``exchange_overflow``. With the host-side split any record lost
        is a routing fault: raise, never under-count."""
        while len(self._overflow_markers) > bound:
            self.exchange_overflow += int(self._overflow_markers.popleft())
        if self.exchange_overflow:
            raise RuntimeError(
                f"exchange overflow: {self.exchange_overflow} records "
                "dropped by the keyBy exchange despite the host-side split "
                "— per-destination routing fault")

    def _note_dispatch(self) -> None:
        if self.device.type == "cuda":
            ev = torch.cuda.Event()
            ev.record()
            self._inflight.append(ev)

    def _throttle(self) -> None:
        """The ingest's own backpressure, unless a driver throttles."""
        if not self.external_throttle:
            self.throttle()

    def throttle(self) -> None:
        """Backpressure: wait on the oldest outstanding step once more
        than ``max_inflight_steps`` are in flight. Each step is the CUDA
        event recorded on the stream right behind its launches
        (``_note_dispatch``); ``readiness`` says how the wait learns
        that the card has passed it. 'piggyback' blocks in
        ``Event.synchronize()``, the host thread asleep in the CUDA
        runtime until then; 'probe' polls ``Event.query()``, yielding
        the thread between polls (the reference's is_ready spin on its
        in-flight marker). Either way no copy or launch is added, and
        the state and rows are the same."""
        t0 = time.perf_counter()
        while len(self._inflight) > self.max_inflight_steps:
            ev = self._inflight.popleft()
            if self.readiness == "piggyback":
                ev.synchronize()
            else:
                while not ev.query():
                    time.sleep(0)
        self._resolve_overflow(bound=self.max_inflight_steps)
        self.timer.collect()
        self.prof["pb_throttle_wait"] += time.perf_counter() - t0

    def quiesce(self) -> None:
        """Dispatch a stashed device-made batch, fold in every step's
        stats, fold in a stashed native-lane batch, and block until every
        dispatched step has completed."""
        self._flush_devgen()
        if self._devstats_pending:
            self._reconcile_devstats()
        self._flush_stash()
        while self._inflight:
            self._inflight.popleft().synchronize()
        for dev in dict.fromkeys(self._devices):
            if dev.type == "cuda":
                torch.cuda.current_stream(dev).synchronize()
                wk.check_errors(dev)
        self._resolve_overflow()
        self.timer.collect(block=True)

    def _grow_ring(self, need: int, applied_min: Optional[int],
                   applied_max: Optional[int]) -> None:
        """Resize the pane ring to hold >= ``need`` live panes, moving
        each applied live pane p from column p % old to p % new."""
        # stashed batches land in the old layout
        self._flush_stash()
        self._flush_devgen()
        old_ring = self.plan.ring
        new_ring = _next_pow2(need + 4)
        lo = self._cleared_below
        if applied_min is not None:
            lo = max(lo, applied_min)
        hi = applied_max if applied_max is not None else lo - 1
        cmap = np.full(new_ring, -1, np.int64)
        if hi >= lo:
            ps = np.arange(lo, hi + 1)
            cmap[ps % new_ring] = ps % old_ring
        src_cols = self._on_blocks(
            self._stage.upload(np.maximum(cmap, 0).astype(np.int32)))
        keeps = self._on_blocks(self._stage.upload(cmap >= 0))
        blocks = []
        with self.timer.span("grow"):
            for st, dev, src_col, keep in zip(self._blocks, self._devices,
                                              src_cols, keeps):
                lanes = _lanes(st)
                with on_device(dev):
                    moved = tuple(
                        None if lane is None else torch.empty(
                            (lane.shape[0], new_ring) + lane.shape[2:],
                            dtype=lane.dtype, device=dev)
                        for lane in lanes)
                    wk.ring_columns_block(lanes, moved, src_col, keep)
                blocks.append(PaneState(*moved))
        self._blocks = blocks
        self.plan = dataclasses.replace(self.plan, ring=new_ring)
        self.layout = dataclasses.replace(self.layout, ring=new_ring)

    # -- time path --------------------------------------------------------
    def advance_processing_time(self) -> "FiredWindows":
        """Fire the windows the processing-time clock has passed."""
        return self.advance_watermark(self.clock.now_ms() - 1)

    def advance_watermark(self, wm: int) -> "FiredWindows":
        """Advance event time; fire newly complete windows plus pending
        re-fires; purge dead panes. Returns a lazy ``FiredWindows``."""
        if wm < self.watermark or (wm == self.watermark and not self._refire):
            return self._empty()
        taw = time.perf_counter()
        # device-made steps whose stats have landed: late accounting,
        # re-fire scheduling and miss repair before this advance
        # enumerates its ends
        if self._devstats_pending:
            self._reconcile_devstats(force=False)
        self.state_version += 1
        prev = self.watermark
        self.watermark = wm
        ends = sorted(set(self.plan.enumerate_fire_ends(
            prev, wm, self._min_pane_seen, self._max_pane_seen))
            | self._refire)
        # the fired frontier tracks the watermark, so a late record in
        # any window it passed re-fires that window
        frontier = self.plan.fire_frontier(wm)
        if self._fired_below_end is None or frontier > self._fired_below_end:
            self._fired_below_end = frontier
        self._refire.clear()
        # a stashed device-made batch lands first (after pairs its miss
        # repair stashed); its advance fires its ends in one pair (see
        # MIN_FIRE_PAD). A stashed native-lane batch rides one fused step
        # with this advance's fires and purge, when they fit it.
        stashed = self._stash_devgen is not None
        if not stashed and self._stash is not None and self._fused_ok():
            out = self._advance_fused(wm, ends)
            if out is not None:
                self.prof["aw_dispatch"] += time.perf_counter() - taw
                return out
        self._flush_stash()
        self._flush_devgen()
        # the host store's keys fire on the same ends (re-fires too);
        # its keys are disjoint from the device's, so rows ride along
        extra = (self._spill.fire(
            ends, self.plan.panes_per_window, self.plan.pane_ms,
            self.plan.offset_ms, self.plan.size_ms)
            if self._spill is not None and ends else None)
        out = self._fire_ends(ends, whole=stashed)
        if self._topn is not None and self._spill is not None:
            # top-n + spill: drain the ring at each fire, so the host rows
            # re-rank against this fire's device winners only
            if extra is not None:
                self._pending_ring_extras.append(extra)
            if out._ring or extra is not None:
                out = FiredWindows(data=self.drain_ring())
        elif extra is not None:
            out._extra = extra

        # purge panes no window can need any more
        clear, cleared_after = self._purge_columns(wm)
        if clear is not None:
            ring = self.plan.ring
            if self._ident_cols is None or len(self._ident_cols[0]) != ring:
                self._ident_cols = self._on_blocks(torch.arange(
                    ring, dtype=torch.int32, device=self.device))
            keeps = self._on_blocks(self._stage.upload(~clear))
            with self.timer.span("purge"):
                for st, dev, ident, keep_t in zip(
                        self._blocks, self._devices, self._ident_cols, keeps):
                    with on_device(dev):
                        lanes = _lanes(st)
                        wk.ring_columns_block(lanes, lanes, ident, keep_t)
        if self._spill is not None and cleared_after > self._cleared_below:
            self._spill.purge_below(cleared_after)
        self._cleared_below = cleared_after
        self.prof["aw_dispatch"] += time.perf_counter() - taw
        return out

    def _purge_columns(self, wm: int) -> Tuple[Optional[np.ndarray], int]:
        """The purge of an advance to ``wm``: the (ring,) bool mask of the
        columns whose panes no window can need any more (None when there
        are none), and the purge frontier after it. Only columns written
        (panes >= the min pane seen) can hold data."""
        new_dead = self.plan.first_dead_pane(wm)
        if new_dead <= self._cleared_below:
            return None, self._cleared_below
        if self._min_pane_seen is None:
            return None, new_dead
        lo = max(self._cleared_below, self._min_pane_seen)
        if new_dead <= lo:
            return None, new_dead
        ring = self.plan.ring
        clear = np.zeros(ring, bool)
        if new_dead - lo >= ring:
            clear[:] = True
        else:
            clear[np.arange(lo, new_dead) % ring] = True
        return clear, new_dead

    def _fire_ends(self, ends: List[int],
                   whole: bool = False) -> "FiredWindows":
        """Fire ``ends``. Top-n: in chunks of MAX_FIRE_CHUNK_RING windows
        into the emit ring; with ``whole`` (an advance over a device-made
        batch) in one chunk when there are at most MIN_FIRE_PAD, so rows
        land row-major over all of them. Otherwise: in chunks of
        MAX_FIRE_CHUNK windows, one packed buffer each."""
        if not ends or self._max_pane_seen is None:
            return self._empty()
        lo = max(self._cleared_below, self._min_pane_seen)
        hi = self._max_pane_seen
        ppw = self.plan.panes_per_window
        # windows entirely outside the written pane range are empty
        ends = [e for e in ends if e > lo and e - ppw <= hi]
        if not ends:
            return self._empty()
        used = self._used_mask_device()
        if self._topn is None:
            return self._fire_packs(ends, lo, hi, used)
        if self._ring_anchor is None:
            self._ring_anchor = lo
        rings = self._ensure_ring()
        step = (len(ends) if whole and len(ends) <= MIN_FIRE_PAD
                else MAX_FIRE_CHUNK_RING)
        for c0 in range(0, len(ends), step):
            chunk = ends[c0:c0 + step]
            end_t = self._stage.upload(np.asarray(chunk, np.int64))
            w_valid = self._w_valid[:len(chunk)]
            with self.timer.span("fire"):
                if self.mesh_plan is not None:
                    self._topn_sharded(end_t, w_valid, lo, hi, used, rings)
                    continue
                wc = wk.window_counts(self.state.counts, end_t, w_valid, lo,
                                      hi, ppw, self._wc_out(len(chunk)))
                if self._topn_lanes:
                    self._topn_lanes_fire(wc, end_t, w_valid, lo, hi, used[0],
                                          rings[0])
                else:
                    wk.topn_select_append(wc, used[0], end_t, w_valid,
                                          self._ring_anchor, self._topn[1],
                                          self._topn_cap(), rings[0])
        return self._ring_after_fire(len(ends))

    def _wc_out(self, W: int) -> torch.Tensor:
        """The one-device fire's (rows, W) window-count buffer, one a
        width, reused by every fire: a chunk's counts are read only by
        the top-n launched right after them on the same stream, so the
        next chunk's counts, queued later, cannot overwrite them early.
        (The mesh holds every block's counts at once and allocates.)"""
        buf = self._wc_bufs.get(W)
        if buf is None:
            buf = self._wc_bufs[W] = torch.empty(
                (self.layout.rows, W), dtype=torch.int32, device=self.device)
        return buf

    def _topn_sharded(self, end_t: torch.Tensor, w_valid: torch.Tensor,
                      lo: int, hi: int, used: List[torch.Tensor],
                      rings: List[torch.Tensor]) -> None:
        """A count top-n chunk over the mesh (the reference's topn_shard):
        each block's window counts and its top-k candidates per window,
        k = min(n, rows_per_device), gathered into one (W, blocks * k)
        buffer on the home device (a block there writes its own columns;
        one on another card sends them); each block's rows at or above
        the gathered candidates' k-th (worked out by the select itself)
        appended to its own emit ring with their global row ids."""
        ppw, rows = self.plan.panes_per_window, self.layout.rows
        k = min(self._topn[1], rows)
        ends, wvs = self._on_blocks(end_t), self._on_blocks(w_valid)
        gathered = self._gathered(end_t.numel(), len(self._blocks) * k)
        wcs = []
        for b, (st, dev, e, wv, u) in enumerate(zip(
                self._blocks, self._devices, ends, wvs, used)):
            cols = gathered[:, b * k:(b + 1) * k]
            with on_device(dev):
                wc = wk.window_counts(st.counts, e, wv, lo, hi, ppw)
                wcs.append(wc)
                if dev == self.device:
                    wk.topn_candidates(wc, u, wv, k, out=cols)
                else:
                    cols.copy_(wk.topn_candidates(wc, u, wv, k),
                               non_blocking=True)
        for b, (dev, wc, e, wv, u, g, ring_b) in enumerate(zip(
                self._devices, wcs, ends, wvs, used,
                self._on_blocks(gathered), rings)):
            with on_device(dev):
                wk.topn_select_given(wc, u, e, wv, self._ring_anchor, g, k,
                                     b * rows, self._topn_cap(), ring_b)

    def _gathered(self, W: int, M: int) -> torch.Tensor:
        """The sharded top-n's (W, M) gathered candidates on the home
        device. On blocks of one card one buffer a shape, reused by every
        chunk, as ``_wc_out``: one stream orders a chunk's selects before
        the next chunk's candidates. Between cards a new one a chunk, as
        its copies to the blocks run on other streams."""
        if any(d != self.device for d in self._devices):
            return torch.empty((W, M), dtype=torch.float32,
                               device=self.device)
        buf = self._gathered_bufs.get((W, M))
        if buf is None:
            buf = self._gathered_bufs[(W, M)] = torch.empty(
                (W, M), dtype=torch.float32, device=self.device)
        return buf

    def _topn_lanes_fire(self, wc: torch.Tensor, end_t: torch.Tensor,
                         w_valid: torch.Tensor, lo: int, hi: int,
                         used: torch.Tensor, ring_buf: torch.Tensor) -> None:
        """A top-n chunk over lanes: ``window_lanes`` over the (rows, W)
        grid, the aggregate's finalize on it in torch (the ranking field
        as f32 and the result columns as int32 words, ``_finalize_pack``'s
        forms), then ``topn_select_lanes``."""
        st = self.state
        sums, maxs, mins = tk.window_lanes(
            st.sums, st.maxs, st.mins, end_t, w_valid, lo, hi,
            self.plan.panes_per_window, self.layout.rows)
        res = self.agg.finalize(sums, maxs, mins, wc)
        by, n = self._topn
        v = res[by].to(torch.float32).contiguous()
        cols = [res[f].to(torch.int32) if self._res_is_int[f]
                else res[f].to(torch.float32).view(torch.int32)
                for f in self._pack_fields()]
        grid = (torch.stack(cols, dim=2) if cols
                else torch.zeros(wc.shape + (0,), dtype=torch.int32,
                                 device=wc.device))
        tk.topn_select_lanes(wc, v, grid.contiguous(), used, end_t, w_valid,
                             self._ring_anchor, n, self._topn_cap(), ring_buf)

    def _fire_packs(self, ends: List[int], lo: int, hi: int,
                    used: torch.Tensor) -> "FiredWindows":
        """One ``fire_pack`` buffer per chunk of MAX_FIRE_CHUNK ends, the
        aggregate's finalize on its rows, and its device→host copy
        started at once."""
        packed2 = self._fire_packed2()
        packs = []
        for c0 in range(0, len(ends), MAX_FIRE_CHUNK):
            chunk = ends[c0:c0 + MAX_FIRE_CHUNK]
            end_t = self._stage.upload(np.asarray(chunk, np.int64))
            cap = self._fire_cap(_next_pow2(len(chunk)))
            # one buffer per block, in block order, its rows global
            for b, (st, dev, e, wv, u) in enumerate(zip(
                    self._blocks, self._devices, self._on_blocks(end_t),
                    self._on_blocks(self._w_valid[:len(chunk)]), used)):
                with on_device(dev):
                    with self.timer.span("fire"):
                        buf, lanes = lk.fire_pack(
                            st.counts, st.sums, st.maxs, st.mins, e, wv, u,
                            lo, hi, self.plan.panes_per_window, cap, packed2,
                            row_offset=b * self.layout.rows)
                        if not packed2:
                            buf = self._finalize_pack(buf, lanes, cap)
                    packs.append((lo,) + copy_to_host(buf, self.timer))
        return FiredWindows(op=self, packs=packs)

    def _finalize_pack(self, buf: torch.Tensor, lanes: Optional[torch.Tensor],
                       cap: int) -> torch.Tensor:
        """The aggregate's finalize on a fire buffer's rows, its result
        lanes packed after ``[row, delta, count]`` in sorted field order
        (``count`` excluded): int lanes as int32, float lanes as f32
        bits."""
        fields = self._pack_fields()
        if not fields:
            return buf
        lay = self.layout
        sw, mw = lay.sum_width, lay.max_width
        if lanes is None:
            lanes = torch.zeros((cap, 0), dtype=torch.float32,
                                device=buf.device)
        res = self.agg.finalize(lanes[:, :sw], lanes[:, sw:sw + mw],
                                lanes[:, sw + mw:], buf[1:, 2])
        out = torch.zeros((cap + 1, 3 + len(fields)), dtype=torch.int32,
                          device=buf.device)
        out[:, :3] = buf
        for i, name in enumerate(fields):
            v = res[name].reshape(cap)
            out[1:, 3 + i] = (v.to(torch.int32) if self._res_is_int[name]
                              else v.to(torch.float32).view(torch.int32))
        return out

    def _fire_cap(self, w: int) -> int:
        """Rows of a W-window fire buffer: a window fires at most one
        row per registered key, so this bound never truncates."""
        nk = max(1, self.directory.num_keys())
        return _next_pow2(min(nk, self.layout.slots) * w)

    def _fire_packed2(self) -> bool:
        """The 2-column ``[(row << 8) | delta, count]`` layout: a
        count-only result on one device, slot ids < 2^23, end deltas <
        2^8."""
        return (self.mesh_plan is None and not self._pack_fields()
                and self.layout.slots < (1 << 23)
                and self.plan.ring + self.plan.panes_per_window < (1 << 8))

    def _pack_fields(self) -> List[str]:
        """Result fields carried after ``[row, delta, count]``, in sorted
        order; ``count`` rides column 2."""
        return [f for f in self._res_fields if f != "count"]

    @staticmethod
    def _check_fire_cap(n: int, cap: int) -> None:
        if n > cap:
            raise RuntimeError(
                f"fired-row buffer overflow: {n} rows > capacity {cap}")

    def _decode_packs(self, packs) -> Dict[str, np.ndarray]:
        """Host decode of landed fire buffers: slot → key, pane → window
        times, bit lanes → result fields. Each buffer's layout is read
        from its own width (a growth may flip the packed2 gate between
        fire and decode)."""
        rows_l, ep_l, cnt_l, lane_l = [], [], [], []
        for lo, host, err, ev in packs:
            if ev is not None:
                ev.synchronize()
            buf = host.numpy()
            n = int(buf[0, 0])
            self._check_fire_cap(n, len(buf) - 1)
            if err is not None:
                wk.raise_for_error_bits(int(err[0]))
            body = buf[1:1 + n]
            if body.shape[1] == 2:
                rows_l.append(body[:, 0] >> 8)
                ep_l.append(lo + (body[:, 0] & 0xFF).astype(np.int64))
                cnt_l.append(body[:, 1])
            else:
                rows_l.append(body[:, 0])
                ep_l.append(lo + body[:, 1].astype(np.int64))
                cnt_l.append(body[:, 2])
                lane_l.append(body[:, 3:])
        rows = np.concatenate(rows_l)
        end_pane = np.concatenate(ep_l)
        window_end = end_pane * self.plan.pane_ms + self.plan.offset_ms
        out: Dict[str, np.ndarray] = {
            "key": self.directory.key_of_slots(
                row_to_slot(rows, self.layout.rows)),
            "window_start": window_end - self.plan.size_ms,
            "window_end": window_end,
            "count": np.ascontiguousarray(np.concatenate(cnt_l)),
        }
        fields = self._pack_fields()
        if fields:
            lanes = np.concatenate(lane_l)
            for i, k in enumerate(fields):
                col = np.ascontiguousarray(lanes[:, i])
                out[k] = col if self._res_is_int[k] else col.view(np.float32)
        return out

    def _ring_after_fire(self, n_ends: int) -> "FiredWindows":
        self._ring_version_no += 1
        if n_ends > 0:
            self._announce_ring()
        return FiredWindows(op=self, ring=True, ring_no=self._ring_version_no)

    def _announce_ring(self) -> None:
        """Start a non-blocking copy of each block's emit ring, and of its
        device's error word, to the host."""
        copies = []
        for ring_b in self._emit_rings:
            with on_device(ring_b.device):
                copies.append(copy_to_host(ring_b, self.timer))
        self._ring_versions.append((self._ring_version_no, copies))

    def _ensure_ring(self) -> List[torch.Tensor]:
        """The emit rings, one per block, made at first use: row 0 the
        head, rows 1 .. EMIT_RING_ROWS the data, the last row reserved;
        ``3 + F`` columns (``[row, end - anchor, count]`` and the result
        fields but the count)."""
        if self._emit_rings is None:
            self._emit_rings = [torch.zeros(
                (self.EMIT_RING_ROWS + 2, 3 + len(self._pack_fields())),
                dtype=torch.int32, device=d) for d in self._devices]
        return self._emit_rings

    def drain_ring(self, min_no: Optional[int] = None) -> Dict[str, np.ndarray]:
        """Decode every emit-ring row appended since the previous drain.

        ``min_no``: the oldest ring version this drain may read; None =
        the latest (a barrier). ``0`` is a periodic poll: it reads the
        newest copy that already landed and returns nothing when none
        has — later polls pick the rows up, since the head counter is
        monotone."""
        # the host store's rows of the fires this drain reads
        extras = list(self._pending_ring_extras)
        self._pending_ring_extras.clear()
        if self._emit_rings is None or self._ring_anchor is None:
            return self._merge_extras(dict(self._empty()), extras)
        t0 = time.perf_counter()
        need = self._ring_version_no if min_no is None else min_no
        acceptable = [v for v in self._ring_versions if v[0] >= need]
        copies = None
        for _, cand in reversed(acceptable):
            if all(ev is None or ev.query() for _, _, ev in cand):
                copies = cand
                break
        if copies is None:
            if min_no == 0:
                return self._merge_extras(dict(self._empty()), extras)
            if not acceptable:
                self._announce_ring()
                acceptable = [self._ring_versions[-1]]
            copies = acceptable[0][1]
            for _, _, ev in copies:
                if ev is not None:
                    ev.synchronize()
        for _, err, _ in copies:
            if err is not None:
                wk.raise_for_error_bits(int(err[0]))
        self.prof["drain_fetch"] += time.perf_counter() - t0
        row_cap = self.EMIT_RING_ROWS
        bodies = []
        # block by block, each from its own drained count (block-major
        # order, the reference's sharded drain)
        for b, (host, _, _) in enumerate(copies):
            arr = host.numpy()
            total = int(arr[0, 0])
            truncated = int(arr[0, 1])
            if truncated > 0:
                raise RuntimeError(
                    f"top-n winner-buffer truncation: {truncated} selected "
                    "rows exceeded the per-fire selection capacity (tie "
                    "explosion at the n-th value); raise n or aggregate "
                    "first")
            drained = self._ring_drained[b]
            new = total - drained
            if new > row_cap:
                raise RuntimeError(
                    f"emit ring overflow: {new} rows appended since last "
                    f"drain > capacity {row_cap}; drain more often or "
                    "raise EMIT_RING_ROWS")
            # a fetched ring decodes even when it holds no new row, so an
            # empty drain has the decoded rows' columns (the reference's)
            bodies.append(arr[(drained + np.arange(max(new, 0))) % row_cap
                              + 1])
            self._ring_drained[b] = max(total, drained)
        body = np.concatenate(bodies)
        end_pane = self._ring_anchor + body[:, 1].astype(np.int64)
        window_end = end_pane * self.plan.pane_ms + self.plan.offset_ms
        out = {
            "key": self.directory.key_of_slots(
                row_to_slot(body[:, 0], self.layout.rows)),
            "window_start": window_end - self.plan.size_ms,
            "window_end": window_end,
            "count": np.ascontiguousarray(body[:, 2]),
        }
        for i, k in enumerate(self._pack_fields()):
            col = np.ascontiguousarray(body[:, 3 + i])
            out[k] = col if self._res_is_int[k] else col.view(np.float32)
        return self._merge_extras(out, extras)

    def _merge_extras(self, out: Dict[str, np.ndarray],
                      extras: List[Dict[str, np.ndarray]]
                      ) -> Dict[str, np.ndarray]:
        return (drain_merge_extras(out, extras, self._topn) if extras
                else out)

    def _used_mask_device(self) -> List[torch.Tensor]:
        """Per block, (rows,) bool on its device marking registered-key
        rows, re-uploaded only after new keys registered."""
        nk = self.directory.num_keys()
        if self._used_pushed != nk or self._used_dev is None:
            rows = self.layout.rows
            used = np.zeros(len(self._devices) * rows, dtype=bool)
            used[slot_to_row(np.flatnonzero(self.directory.used_mask()),
                             self.layout.slots)] = True
            parts = [used[b * rows:(b + 1) * rows]
                     for b in range(len(self._devices))]
            self._used_dev = [
                self._stage.upload(part) if dev == self.device
                else small_upload(part, dev)
                for part, dev in zip(parts, self._devices)]
            self._used_pushed = nk
        return self._used_dev

    def final_watermark(self) -> int:
        return self.plan.final_watermark_for(self.watermark,
                                             self._max_pane_seen)

    def _empty(self) -> "FiredWindows":
        return empty_fired(self._res_empty)

    # -- device-made ingest -------------------------------------------------
    # how many dispatched batches' stats may wait before an advance blocks
    # on the oldest; miss repair stays well inside the pane ring's life
    DEVSTATS_MAX_LAG = 2

    def attach_device_source(self, spec) -> bool:
        """Chain a ``DeviceGeneratorSource``: its batches are made on the
        card inside this operator's step. The directory registers the
        source's key domain densely (slot == key). Returns False when
        this operator cannot host it; the driver then feeds the batches
        from the host."""
        # miss repair's probe needs the C key table, as in the reference;
        # with spill or a mesh the reference feeds the batches from the
        # host too
        if self.mesh_plan is not None \
                or self._topn is None or self._topn_lanes or self._spill is not None \
                or self._preagg_lanes() != () or self.uses_processing_time \
                or self.plan.ring > 64 or not self.directory.native():
            return False
        d = getattr(spec, "key_domain", None)
        if d is None or d <= 0 or d > self.layout.slots:
            return False
        if self.directory.num_keys() == 0:
            self.directory.register_dense(d)
        else:
            # a restored directory must already hold the identity over
            # the whole domain: a prefix would leave device-writable
            # slots unregistered and free to the allocator
            if self.directory.num_keys() < d:
                return False
            probe = np.arange(d, dtype=np.int64)
            vals, found = self.directory.lookup(probe)
            if not (found.all() and (vals == probe).all()):
                return False
        self._devgen_spec = spec
        return True

    def process_batch_device(self, batch_index: int) -> bool:
        """Accept one device-made batch: check the gates, grow the ring
        from the source's exact ts bounds, and stash the index for the
        next advance. False when a gate closed (the ring outgrew the
        reference's 64 clear bits, the re-fire span outgrew the bitmap,
        or the whole batch is late); the caller then feeds this batch
        from the host."""
        spec = self._devgen_spec
        if spec is None or self.plan.ring > 64:
            return False
        t0 = time.perf_counter()
        dead = self._cleared_below
        refire_below = (self._fired_below_end
                        if self._fired_below_end is not None
                        else int(np.iinfo(np.int64).min))
        if refire_below > dead and refire_below - dead > DEVGEN_REFIRE_BITS:
            return False
        ts_min, ts_max = spec.ts_bounds(batch_index)
        pane_ms, off = self.plan.pane_ms, self.plan.offset_ms
        pmin = (int(ts_min) - off) // pane_ms
        pmax = (int(ts_max) - off) // pane_ms
        if pmax < dead:
            return False  # whole batch late: the host path accounts it
        # a pending batch dispatches against the current ring layout,
        # before any growth below
        self._flush_devgen()
        eff_min = max(pmin, dead)
        prev_min, prev_max = self._min_pane_seen, self._max_pane_seen
        new_min = eff_min if prev_min is None else min(prev_min, eff_min)
        new_max = pmax if prev_max is None else max(prev_max, pmax)
        if new_max - max(dead, new_min) >= self.plan.ring:
            self._grow_ring(new_max - max(dead, new_min) + 1,
                            prev_min, prev_max)
            if self.plan.ring > 64:
                return False  # outgrew the clear bits: host path
        self.state_version += 1
        self._min_pane_seen = new_min
        self._max_pane_seen = new_max
        # the stats can be non-zero only with an unproven key bound
        # (misses) or panes below the dead or fired frontier (late,
        # re-fire); otherwise their copy is skipped
        need_stats = (not spec.keys_bounded or pmin < dead
                      or pmin < refire_below)
        self._stash_devgen = (int(batch_index), int(dead),
                              int(refire_below), bool(need_stats))
        self.prof["pbd_host"] += time.perf_counter() - t0
        self._throttle()
        return True

    def _flush_devgen(self) -> None:
        """Make a stashed device-made batch on the card and fold it in
        (``devgen_ingest``; one launch for the Nexmark bids, which its
        Nexmark form makes in registers). An advance calls this before
        its fires; so does every other consumer of up-to-date state
        (snapshots, quiesce, ring growth)."""
        if self._stash_devgen is None:
            return
        batch_index, dead, refire_below, need_stats = self._stash_devgen
        self._stash_devgen = None
        spec = self._devgen_spec
        ingest = dict(key_domain=int(spec.key_domain),
                      pane_ms=self.plan.pane_ms, offset_ms=self.plan.offset_ms,
                      dead_below=dead, refire_below=refire_below,
                      dump_row=self.layout.slots, with_stats=need_stats)
        # a generator that can make its batch inside the ingest (the
        # Nexmark bids) does; any other makes it first, into memory
        ingest_into = getattr(spec.device_keys_ts, "ingest_into", None)
        if ingest_into is not None:
            with self.timer.span("ingest"):
                stats = ingest_into(self.state.counts, batch_index, **ingest)
        else:
            with self.timer.span("gen"):
                keys, ts = spec.device_keys_ts(batch_index, self.device)
            with self.timer.span("ingest"):
                stats = dk.devgen_ingest(self.state.counts, keys, ts,
                                         **ingest)
        if need_stats:
            if self.device.type == "cpu":
                self._devstats_pending.append((batch_index, dead, stats, None))
            else:
                host = torch.empty(stats.shape, dtype=stats.dtype,
                                   pin_memory=True)
                host.copy_(stats, non_blocking=True)
                ev = torch.cuda.Event()
                ev.record()
                self._devstats_pending.append((batch_index, dead, host, ev))
        self._note_dispatch()

    def _reconcile_devstats(self, force: bool = True) -> None:
        """Fold dispatched steps' stats into host accounting: late
        records, re-fire scheduling, and miss repair — the batch is made
        again on the host (bit-exact with the device), and its records
        outside the key domain go through ``process_batch``, which
        registers their keys and re-fires windows already fired.

        ``force=False`` takes only stats whose copy has landed, unless
        more than DEVSTATS_MAX_LAG are waiting."""
        while self._devstats_pending:
            batch_index, dead, host, ev = self._devstats_pending[0]
            if (not force
                    and len(self._devstats_pending) <= self.DEVSTATS_MAX_LAG
                    and ev is not None and not ev.query()):
                return
            self._devstats_pending.popleft()
            if ev is not None:
                ev.synchronize()
            arr = host.numpy()
            n_late, n_miss, n_refire = int(arr[1]), int(arr[2]), int(arr[4])
            self.late_records += n_late
            if n_refire:
                rbm = arr[dk.STATS_HEAD:dk.STATS_HEAD + DEVGEN_REFIRE_BITS]
                late_panes = np.flatnonzero(rbm) + dead
                self._refire.update(self.plan.late_refire_ends(
                    late_panes, self._fired_below_end, self.watermark))
            if n_miss:
                keys, ts = self._devgen_spec.keys_ts_host(batch_index)
                out = (keys < 0) | (keys >= self._devgen_spec.key_domain)
                # keys the directory already refused as FULL stay
                # refused: the drop policy decides (account_full_drop);
                # the rest register through the ordinary path
                vals, found = self.directory.lookup(keys[out])
                refused = found & (vals < 0)
                n_full = int(refused.sum())
                if n_full:
                    account_full_drop(self, n_full)
                if (~refused).any():
                    self.process_batch(keys[out][~refused], ts[out][~refused],
                                       {})

    def hbm_bytes(self) -> int:
        """Planned device bytes on the busiest device (a block a device,
        or several blocks of one): the pane lanes, with top-n the emit
        ring, and with the native lane's fused step its pair uploads
        (``PAIR_SLOTS`` slots in flight)."""
        per_dev = collections.Counter(str(d) for d in self._devices)
        blocks = max(per_dev.values())
        ring = 0
        if self._topn is not None:
            ring = (self.EMIT_RING_ROWS + 2) * (3 + len(self._pack_fields())) * 4
            if self.mesh_plan is None and not self._topn_lanes:
                ring += PAIR_SLOTS * PAIR_SLOT_BYTES
        return blocks * (self.layout.bytes() + ring)

    # -- snapshots ----------------------------------------------------------
    def snapshot_state(self) -> Dict[str, Any]:
        """The operator's state as the reference package lays it out: a
        device clone of the panes (ordered on the stream, no sync), the
        key directory arrays and the watermark bookkeeping. A stashed
        device-made batch is dispatched, every step's stats folded in
        and a stashed native-lane batch applied first."""
        self._flush_devgen()
        if self._devstats_pending:
            self._reconcile_devstats()
        self._flush_stash()
        self._resolve_overflow()  # a checkpoint must not hide a loss
        spill_snap = (self._spill.snapshot() if self._spill is not None
                      else None)
        # the LSM tier's sealed runs ride the checkpoint as hardlinks,
        # not serialized state: their name -> path map goes to the top
        # level, where the coordinator hands it to storage's aux plane
        aux_files = (spill_snap.pop("aux_files", None)
                     if isinstance(spill_snap, dict) else None)
        out = {
            "spill": spill_snap,
            "n_dev": len(self._devices),
            "ring": self.plan.ring,
            # the blocks end to end: the reference's global row layout
            "panes": self._global_panes(),
            "directory": self.directory.snapshot(),
            "watermark": self.watermark,
            "cleared_below": self._cleared_below,
            "fired_below_end": self._fired_below_end,
            "min_pane_seen": self._min_pane_seen,
            "max_pane_seen": self._max_pane_seen,
            "refire": sorted(self._refire),
            "late_records": self.late_records,
            "records_dropped_full": self.records_dropped_full,
        }
        if aux_files:
            out["__aux_files__"] = aux_files
        return out

    def _global_panes(self) -> PaneState:
        """A copy of the pane state with the blocks end to end on the
        home device (the reference's global row layout)."""
        if len(self._blocks) == 1:
            return self.state.clone()
        return PaneState(*(
            None if getattr(self._blocks[0], k) is None else torch.cat(
                [getattr(b, k).to(self.device) for b in self._blocks])
            for k in ("sums", "maxs", "mins", "counts")))

    @property
    def records_spilled(self) -> int:
        return self._spill.records_spilled if self._spill is not None else 0

    def restore_state(self, snap: Dict[str, Any]) -> None:
        """Restore from ``snapshot_state()`` output — this package's, or
        the reference package's once its panes are host arrays (see
        ``load_jax_snapshot``). A snapshot taken over another number of
        device blocks is re-blocked (``reblock_panes``). Host-spill state
        restores into an operator with spill or lsm; an LSM snapshot with
        sealed runs only into lsm (its run files at ``__aux_paths__``,
        which checkpoint storage's load injects); an operator without a
        store refuses either rather than lose it."""
        snap_spill = snap.get("spill")
        if self._spill is None and snap_spill and (
                snap_spill.get("panes") or snap_spill.get("runs")
                or (snap_spill.get("delta") or {}).get("panes")):
            raise ValueError(
                "snapshot contains host-spill state but state.backend "
                "is 'hbm'; restore with state.backend='spill' or 'lsm'")
        if (isinstance(self._spill, HostSpillStore) and snap_spill
                and snap_spill.get("kind") == "lsm"
                and snap_spill.get("runs")):
            # an lsm->spill flip: the delta would restore, but the sealed
            # runs hold state the RAM store has no files for
            raise ValueError(
                "snapshot carries "
                f"{len(snap_spill['runs'])} sealed lsm "
                "run(s) the RAM spill store cannot adopt; "
                "restore with state.backend='lsm'")
        panes = snap["panes"]
        names = ("sums", "maxs", "mins", "counts")
        lanes = {}
        for k in names:
            v = (panes.get(k) if isinstance(panes, Mapping)
                 else getattr(panes, k, None))
            if v is not None and not isinstance(v, torch.Tensor):
                v = torch.from_numpy(np.array(v))
            lanes[k] = v
        ring = int(snap.get("ring", lanes["counts"].shape[1]))
        n_blocks = len(self._devices)
        snap_dev = int(snap.get("n_dev", 1))
        if snap_dev != n_blocks:
            lanes = reblock_panes(lanes, snap_dev, n_blocks)
        rows = n_blocks * self.layout.rows
        lay = self.layout
        want = {"sums": (lay.sum_width, torch.float32),
                "maxs": (lay.max_width, torch.float32),
                "mins": (lay.min_width, torch.float32)}
        for k, (width, dtype) in want.items():
            v = lanes[k]
            shape = None if v is None else (tuple(v.shape), v.dtype)
            if shape != (None if width == 0 else ((rows, ring, width), dtype)):
                raise ValueError(
                    f"snapshot lane {k} {shape} does not match this "
                    f"operator's layout ({rows}, {ring}, {width}) {dtype} "
                    f"(aggregate {self.agg.name!r})")
        counts = lanes["counts"]
        if counts.dtype != torch.int32 or tuple(counts.shape) != (rows, ring):
            raise ValueError(
                f"snapshot panes {tuple(counts.shape)} {counts.dtype} do not "
                f"match this operator's layout ({rows}, {ring}) int32")
        if ring != self.plan.ring:
            # the snapshotted operator had grown its pane ring
            self.plan = dataclasses.replace(self.plan, ring=ring)
            self.layout = dataclasses.replace(self.layout, ring=ring)
        per = self.layout.rows
        self._blocks = [PaneState(*(
            None if lanes[k] is None
            else lanes[k][b * per:(b + 1) * per].to(dev).contiguous().clone()
            for k in names)) for b, dev in enumerate(self._devices)]
        self.directory = KeyDirectory.restore(
            self.directory.num_shards, self.directory.slots_per_shard,
            snap["directory"],
            (self.directory.shard_lo, self.directory.shard_hi))
        self.watermark = snap["watermark"]
        self._cleared_below = snap["cleared_below"]
        self._fired_below_end = snap["fired_below_end"]
        self._min_pane_seen = snap["min_pane_seen"]
        self._max_pane_seen = snap["max_pane_seen"]
        self._refire = set(snap["refire"])
        self.late_records = snap["late_records"]
        self.records_dropped_full = snap.get("records_dropped_full", 0)
        if self._spill is not None and snap_spill is not None:
            if not isinstance(self._spill, HostSpillStore):
                # the disk tier: the lsm form or a plain spill snapshot
                self._spill.restore(
                    snap_spill, aux_paths=snap.get("__aux_paths__"))
            elif snap_spill.get("kind") == "lsm":
                self._spill.restore(snap_spill["delta"])
            else:
                self._spill.restore(snap_spill)
        self._pending_ring_extras.clear()
        # stashed and device-made steps from before the restore belong to
        # another timeline
        self._stash = None
        self._pairs.hold(None)
        self._stash_devgen = None
        self._devstats_pending.clear()
        self._inflight.clear()
        self._used_pushed = -1
        self._overflow_markers.clear()
        # the emit ring restarts: a checkpoint delivers its rows first,
        # and replay re-fires
        self._emit_rings = None
        self._ring_drained = [0] * len(self._devices)
        self._ring_anchor = None
        self._ring_versions.clear()

    def load_jax_snapshot(self, snap: Dict[str, Any]) -> None:
        """Carry state across from the reference package: ``snap`` is
        ``flink_tpu``'s ``WindowOperator.snapshot_state()`` with its
        ``panes`` fetched to host arrays (``np.asarray`` per lane) — pane
        counts and sum/max/min lanes, key directory, watermark,
        cleared/fired frontiers, pane range, re-fire set and ring size.
        The lanes must be this operator's aggregate's. A snapshot of the
        reference's sharded operator (its blocks end to end, ``n_dev``
        of them) loads into any number of blocks."""
        if snap.get("records_dropped_full", 0) and not self.allow_drops:
            raise ValueError(
                "snapshot's operator dropped records on a full key "
                "directory; this operator raises on a full directory "
                "(state.allow-drops is false), so it cannot carry that "
                "state on")
        self.restore_state(snap)


def reblock_panes(lanes: Dict[str, Optional[torch.Tensor]], old_dev: int,
                  new_dev: int) -> Dict[str, Optional[torch.Tensor]]:
    """Pane lanes laid out as ``old_dev`` blocks (each its slots then a
    dump row) re-cut into ``new_dev`` blocks, every slot kept in order
    and each new block given a fresh dump row at the lane's identity
    (the reference's ``_reblock_panes``)."""
    fills = {"sums": 0.0, "maxs": -float("inf"), "mins": float("inf"),
             "counts": 0}

    def reblock(arr: torch.Tensor, fill) -> torch.Tensor:
        per = arr.shape[0] // old_dev
        logical = torch.cat([arr[d * per:(d + 1) * per - 1]
                             for d in range(old_dev)])
        if logical.shape[0] % new_dev:
            raise ValueError(
                f"cannot reshard {logical.shape[0]} slots onto {new_dev} "
                "devices — num_shards * slots_per_shard must be divisible "
                "by the device count (the key-group contract)")
        n = logical.shape[0] // new_dev
        dump = torch.full((1,) + tuple(arr.shape[1:]), fill, dtype=arr.dtype,
                          device=arr.device)
        return torch.cat([torch.cat([logical[d * n:(d + 1) * n], dump])
                          for d in range(new_dev)])

    return {k: None if v is None else reblock(v, fills[k])
            for k, v in lanes.items()}


def empty_fired(res_empty: Dict[str, np.ndarray]) -> "FiredWindows":
    """A fire with no rows: the window columns and the aggregate's result
    fields (``res_empty``), each empty with its dtype."""
    data = {
        "key": np.zeros(0, np.int64),
        "window_start": np.zeros(0, np.int64),
        "window_end": np.zeros(0, np.int64),
        "count": np.zeros(0, np.int32),
    }
    data.update(res_empty)
    return FiredWindows(data=data)


def merge_spill_rows(dev: Dict[str, np.ndarray],
                     extra: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Device-fired rows, then the host store's rows of the same fire
    (a fire without top-n: a field-wise concatenation)."""
    return {k: np.concatenate([np.asarray(dev[k]), np.asarray(extra[k])])
            for k in dev}


def topn_keep(we: np.ndarray, v: np.ndarray, n: int,
              windows: Optional[np.ndarray] = None) -> np.ndarray:
    """Keep-mask of a per-window top-n with ties kept, over the windows
    ``windows`` (all when None); rows of other windows pass."""
    keep = np.ones(len(we), bool)
    for w in (np.unique(we) if windows is None else windows):
        grp = np.flatnonzero(we == w)
        if len(grp) > n:
            gv = v[grp]
            thresh = np.partition(gv, len(gv) - n)[len(gv) - n]
            keep[grp[gv < thresh]] = False  # ties at thresh stay
    return keep


def drain_merge_extras(dev: Dict[str, np.ndarray],
                       extras: List[Dict[str, np.ndarray]],
                       topn: Optional[Tuple[str, int]]
                       ) -> Dict[str, np.ndarray]:
    """A ring drain's rows plus the host store's rows of the same fire,
    re-ranked in the windows the host rows touch: the device rows are
    the top-n of the resident keys, so the union's top-n is exact over
    one fire (a top-n with spill drains at every fire)."""
    ex = {k: np.concatenate([np.asarray(e[k]) for e in extras])
          for k in extras[0]}
    comb = {k: np.concatenate([np.asarray(dev[k]), ex[k]]) for k in dev}
    if topn is None:
        return comb
    field, n = topn
    keep = topn_keep(comb["window_end"], np.asarray(comb[field]), n,
                     windows=np.unique(ex["window_end"]))
    return {k: v[keep] for k, v in comb.items()}


class FiredWindows(Mapping):
    """A fired-window batch, materialized on first access: an emit-ring
    fire reads the ring then, a packed fire decodes its buffers once
    their copies have landed (``op._decode_packs``; each pack ends with
    its copy's CUDA event, None on the CPU), and a ``fetch`` fire (the
    windowed join's aggregate mode) materializes its ``parts`` and then
    combines them. ``_extra``: the host spill store's rows of the same
    fire, appended at materialization."""

    def __init__(self, data: Optional[Dict[str, np.ndarray]] = None,
                 op: Any = None, ring: bool = False,
                 ring_no: int = 0, packs: Optional[list] = None,
                 fetch: Optional[Any] = None,
                 parts: Optional[List["FiredWindows"]] = None) -> None:
        self._data = data
        self._op = op
        self._ring = ring
        self._ring_no = ring_no
        self._packs = packs
        self._fetch = fetch
        self._parts = parts or []
        self._extra: Optional[Dict[str, np.ndarray]] = None

    def ready(self) -> bool:
        """True unless a packed buffer's device→host copy is still in
        flight (an emit-ring fire reads whatever copy has landed)."""
        if self._data is None and self._fetch is not None:
            return all(p.ready() for p in self._parts)
        return self._data is not None or not self._packs or all(
            p[-1] is None or p[-1].query() for p in self._packs)

    def materialize(self) -> Dict[str, np.ndarray]:
        if self._data is None:
            if self._fetch is not None:
                FiredWindows.materialize_many(self._parts)
                self._data = self._fetch()
                self._fetch = None
            elif self._packs is not None:
                self._data = self._op._decode_packs(self._packs)
                self._packs = None
            else:
                self._data = self._op.drain_ring()
            self._op = None
        if self._extra is not None:
            self._data = merge_spill_rows(self._data, self._extra)
            self._extra = None
        return self._data

    @staticmethod
    def materialize_many(fireds: List["FiredWindows"],
                         barrier: bool = False) -> None:
        """One ring read per operator serves every pending ring fire of
        it (later ones read empty). A barrier pins each operator's newest
        fire version, so every appended row is delivered; otherwise the
        read takes whatever copy already landed. Packed fires decode
        their own buffers, waiting for copies still in flight; a fetch
        fire materializes its parts first."""
        for f in fireds:
            if f._data is None and f._fetch is not None:
                FiredWindows.materialize_many(f._parts, barrier=barrier)
                f.materialize()
        need: Dict[int, int] = {}
        for f in fireds:
            if f._data is None and f._packs is None:
                cur = need.get(id(f._op), 0)
                need[id(f._op)] = max(cur, f._ring_no) if barrier else 0
        done = set()
        for f in fireds:
            if f._data is not None:
                continue
            if f._packs is not None:
                f.materialize()
                continue
            op = f._op
            if id(op) in done:
                f._data = op._empty().materialize()
            else:
                f._data = op.drain_ring(min_no=need[id(op)])
                done.add(id(op))
            f._op = None

    def __getitem__(self, key: str) -> np.ndarray:
        return self.materialize()[key]

    def __iter__(self):
        return iter(self.materialize())

    def __len__(self) -> int:
        return len(self.materialize())
