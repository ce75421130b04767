"""Session windows: gap-merged windows whose bounds come from the data.

Each record opens ``[ts, ts + gap)`` and overlapping windows of a key
merge (Flink's ``EventTimeSessionWindows`` with ``MergingWindowSet``).
Merging cannot be a static pane layout, so, as in the JAX package:

- a batch is sessionized in vectorized numpy: sorted by (key, ts), a
  session boundary wherever the key changes or the gap is exceeded, and
  each batch segment's lanes summed with ``reduceat``;
- the span registry is columnar, sorted by (key, start), one row per
  open or retained session: batch segments merge into it through one
  lexsort, an interval-union scan over offset-encoded bands, and
  ``reduceat`` combines (``_merge_segments``);
- fired sessions stay in the registry until the allowed lateness
  expires, so late records re-open, merge and re-fire them;
- under ``host.parallelism`` W > 1 the registry splits into W stores by
  ``key % W`` and their merge, fire and expiry passes run as tasks of
  the driver's host pool. Sessions never merge across keys, so no
  invariant crosses stores; fired rows re-sort by (key, start), so the
  output bytes equal the serial path's at every W. W = 1 is the serial
  path: one store, no pool threads.

Retract mode op-types the output (``records.OP_FIELD``): a merge that
consumes a fired span emits its stale row as -U (``take_fired``, after
each batch), and the merged session fires as +U; first firings are +I.

The lane lift of each batch (``_host_lift``) and the finalize of fired
sessions (``_emit``) are the aggregate's torch functions on tensors of
an explicit ``torch.device("cpu")``. The JAX package pins both to its
CPU backend by design (a round trip a batch for per-segment lane math
would cost more than it), so this is the reference's placement, not a
fallback. Segment sums add in numpy ``reduceat`` order in both packages.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from flink_tpu_torch.ops.aggregates import LaneAggregate
from flink_tpu_torch.ops.window import FiredWindows
from flink_tpu_torch.records import (
    OP_DTYPE,
    OP_FIELD,
    OP_INSERT,
    OP_UPDATE_AFTER,
    OP_UPDATE_BEFORE,
    device_cast,
)
from flink_tpu_torch.time.watermarks import LONG_MIN

_CPU = torch.device("cpu")


class _SpanStore:
    """Columnar open / retained session registry, sorted by (key, start).

    Per key, spans are disjoint and more than ``gap`` apart (anything
    closer would have merged), so two registry spans merge only when a
    new batch segment bridges them."""

    _COLS = ("key", "start", "last", "sums", "maxs", "mins", "count",
             "fired", "refire", "retracted")

    def __init__(self, sum_w: int, max_w: int, min_w: int) -> None:
        self.key = np.zeros(0, np.int64)
        self.start = np.zeros(0, np.int64)
        self.last = np.zeros(0, np.int64)   # max event ts; end = last + gap
        self.sums = np.zeros((0, sum_w), np.float32)
        self.maxs = np.zeros((0, max_w), np.float32)
        self.mins = np.zeros((0, min_w), np.float32)
        self.count = np.zeros(0, np.int64)
        self.fired = np.zeros(0, bool)
        self.refire = np.zeros(0, bool)
        # retract mode: a -U went out for a consumed predecessor, so the
        # span's next fire is +U, not +I
        self.retracted = np.zeros(0, bool)

    def __len__(self) -> int:
        return len(self.key)

    def _take(self, idx) -> Tuple[np.ndarray, ...]:
        return tuple(getattr(self, c)[idx] for c in self._COLS)

    def _filter(self, keep: np.ndarray) -> None:
        for c in self._COLS:
            setattr(self, c, getattr(self, c)[keep])

    def ranges_for(self, uk: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """[lo, hi) row ranges of the sorted unique keys ``uk``."""
        return (np.searchsorted(self.key, uk, "left"),
                np.searchsorted(self.key, uk, "right"))

    def rows_for(self, uk: np.ndarray) -> np.ndarray:
        """Every row index whose key is in ``uk`` (sorted unique)."""
        lo, hi = self.ranges_for(uk)
        lens = hi - lo
        total = int(lens.sum())
        if total == 0:
            return np.zeros(0, np.int64)
        reps = np.repeat(lo - np.concatenate(([0], np.cumsum(lens)[:-1])),
                         lens)
        return reps + np.arange(total)

    def insert_sorted(self, cols: Tuple[np.ndarray, ...]) -> None:
        """Insert merge results in (key, start) order. The store may
        still hold a key's cold prefix (spans the merge's participation
        cut passed through); every inserted span of that key starts
        later, so it goes at the key block's right edge."""
        pos = np.searchsorted(self.key, cols[0], side="right")
        n_old, n_new = len(self.key), len(cols[0])
        new_at = pos + np.arange(n_new)
        old_mask = np.ones(n_old + n_new, bool)
        old_mask[new_at] = False
        for c, new in zip(self._COLS, cols):
            cur = getattr(self, c)
            out = np.empty((n_old + n_new,) + cur.shape[1:], cur.dtype)
            out[old_mask] = cur
            out[new_at] = new
            setattr(self, c, out)


class SessionOperator:
    """Keyed event-time session aggregation with allowed lateness."""

    def __init__(
        self,
        gap_ms: int,
        agg: LaneAggregate,
        *,
        allowed_lateness_ms: int = 0,
        num_shards: int = 128,
        slots_per_shard: int = 1024,
        max_out_of_orderness_ms: int = 0,
        host_pool: Optional[Any] = None,
        retract: bool = False,
    ) -> None:
        if gap_ms <= 0:
            raise ValueError("session gap must be positive")
        self.gap = int(gap_ms)
        self.agg = agg
        self.retract = bool(retract)
        # -U rows of this step's merges, drained by take_fired right
        # after each process_batch: empty at every checkpoint boundary
        self._pending_retracts: List[Dict[str, np.ndarray]] = []
        self.lateness = int(allowed_lateness_ms)
        self.watermark = LONG_MIN
        self.late_records = 0
        self.state_version = 0
        # W key-sharded stores at host.parallelism W; one (the serial
        # path) at W = 1
        self._pool = (host_pool if host_pool is not None
                      and host_pool.parallelism > 1 else None)
        n_shards = self._pool.parallelism if self._pool is not None else 1
        self._shards: List[_SpanStore] = [
            _SpanStore(agg.sum_width, agg.max_width, agg.min_width)
            for _ in range(n_shards)]
        self._has_refire = False

    # -- ingest ----------------------------------------------------------
    def process_batch(self, keys, ts, data: Dict[str, np.ndarray],
                      valid=None) -> None:
        self.state_version += 1
        keys = np.asarray(keys, np.int64)
        ts = np.asarray(ts, np.int64)
        valid = (np.ones(len(ts), bool) if valid is None
                 else np.asarray(valid, bool))
        data = {k: np.asarray(data[k]) for k in self._lift_fields(data)}
        if self._pool is None:
            results = [self._process_shard(self._shards[0], keys, ts,
                                           data, valid)]
        else:
            # per-key work is the serial path's (no session logic crosses
            # keys), so the shards' passes compose to the serial result
            shard = keys % len(self._shards)
            tasks = []
            for w in range(len(self._shards)):
                m = shard == w
                if not bool(m.any()):
                    continue
                tasks.append(lambda st=self._shards[w], m=m:
                             self._process_shard(
                                 st, keys[m], ts[m],
                                 {k: v[m] for k, v in data.items()},
                                 valid[m]))
            results = self._pool.run_tasks(tasks)
        self.late_records += sum(late for late, _, _ in results)
        self._has_refire = self._has_refire or any(
            refire for _, refire, _ in results)
        self._pending_retracts.extend(
            retr for _, _, retr in results if retr is not None)

    def _lift_fields(self, data: Dict[str, np.ndarray]):
        """The record fields the lift reads (all, for an aggregate that
        does not declare them)."""
        if self.agg.fields is not None:
            return self.agg.fields
        return list(data)

    def _process_shard(self, st: _SpanStore, keys, ts,
                       data: Dict[str, np.ndarray], valid
                       ) -> Tuple[int, bool, Optional[Dict[str, np.ndarray]]]:
        """One shard's whole ingest pass against its store (at
        parallelism 1 the whole batch): (records dropped beyond the
        lateness, whether a re-fire is pending, -U rows of consumed
        fired spans or None). The results ride the return value, so a
        pool task touches no shared state."""
        late_count = 0
        # a record is late iff its singleton session is dead AND it
        # cannot merge into a retained span (the lateness check is on the
        # window after the merge)
        if self.watermark != LONG_MIN:
            late = valid & (ts + self.gap - 1 + self.lateness <= self.watermark)
            cand = np.nonzero(late)[0]
            if len(cand):
                # per key, spans are disjoint and > gap apart, so the only
                # span a record t can merge with is the rightmost one with
                # start <= t + gap: one searchsorted over the candidate
                # keys' spans finds it
                uk = np.unique(keys[cand])
                rows = st.rows_for(uk)
                if len(rows):
                    sk_sub = st.key[rows]
                    ss_sub = st.start[rows]
                    sl_sub = st.last[rows]
                    tmin = int(ss_sub.min())
                    span = int(ss_sub.max()) - tmin + 2
                    if (len(uk) + 1) * span < 2**62:
                        krank = np.searchsorted(uk, sk_sub).astype(np.int64)
                        enc = krank * span + (ss_sub - tmin)
                        ck = np.searchsorted(uk, keys[cand]).astype(np.int64)
                        q = ck * span + np.clip(
                            ts[cand] + self.gap - tmin, 0, span - 1)
                        pos = np.searchsorted(enc, q, "right") - 1
                        posc = np.clip(pos, 0, len(rows) - 1)
                        ok = ((pos >= 0) & (krank[posc] == ck)
                              & (ts[cand] <= sl_sub[posc] + self.gap)
                              & (ss_sub[posc] <= ts[cand] + self.gap))
                        late[cand[ok]] = False
                    else:  # a time range too wide to encode: per record
                        lo, hi = st.ranges_for(uk)
                        p = np.searchsorted(uk, keys[cand])
                        for j, i in enumerate(cand):
                            a, b = lo[p[j]], hi[p[j]]
                            t = ts[i]
                            if a < b and bool(np.any(
                                    (st.start[a:b] <= t + self.gap)
                                    & (t <= st.last[a:b] + self.gap))):
                                late[i] = False
            late_count = int(late.sum())
            valid = valid & ~late
        if not valid.any():
            return late_count, False, None
        keys = keys[valid]
        ts = ts[valid]
        data = {k: v[valid] for k, v in data.items()}

        # batch sessionization: sort by (key, ts) through one encoded key
        # (key band + the ts offset in the batch)
        tmin = int(ts.min())
        tspan = int(ts.max()) - tmin + 1
        if int(np.abs(keys).max()) < (2**62) // max(tspan, 1):
            enc = keys * tspan + (ts - tmin)
            if data:
                order = np.argsort(enc, kind="stable")
                sk, st_ = keys[order], ts[order]
            else:
                es = np.sort(enc)
                sk, st_ = es // tspan, es % tspan + tmin
                order = None
        else:  # a key domain too wide to encode
            order = np.lexsort((ts, keys))
            sk, st_ = keys[order], ts[order]
        sdata = {k: v[order] for k, v in data.items()} if data else {}
        new_seg = np.empty(len(sk), bool)
        new_seg[0] = True
        new_seg[1:] = (sk[1:] != sk[:-1]) | (st_[1:] - st_[:-1] > self.gap)
        seg_starts = np.nonzero(new_seg)[0]

        s_l, mx_l, mn_l = self._host_lift(sdata, len(sk))
        G = len(seg_starts)
        seg_sum = (np.add.reduceat(s_l, seg_starts, axis=0)
                   if s_l.shape[1] else np.zeros((G, 0), np.float32))
        seg_max = (np.maximum.reduceat(mx_l, seg_starts, axis=0)
                   if mx_l.shape[1] else np.zeros((G, 0), np.float32))
        seg_min = (np.minimum.reduceat(mn_l, seg_starts, axis=0)
                   if mn_l.shape[1] else np.zeros((G, 0), np.float32))
        seg_ends = np.append(seg_starts[1:], len(sk))
        refire, retr = self._merge_segments(
            st, sk[seg_starts], st_[seg_starts], st_[seg_ends - 1],
            seg_sum, seg_max, seg_min,
            (seg_ends - seg_starts).astype(np.int64))
        return late_count, refire, retr

    def _host_lift(self, data: Dict[str, np.ndarray], n: int
                   ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """The aggregate's lane lift of ``n`` sorted records, in torch on
        the CPU (the JAX package's ``_host_lift`` runs it on CPU JAX)."""
        cols = {k: torch.from_numpy(np.ascontiguousarray(device_cast(v)))
                for k, v in data.items()}
        s, mx, mn = self.agg.lift_masked(
            cols, torch.ones(n, dtype=torch.bool, device=_CPU))
        return s.numpy(), mx.numpy(), mn.numpy()

    def _merge_segments(self, st: _SpanStore, seg_key, seg_tmin, seg_tmax,
                        seg_sum, seg_max, seg_min, seg_count
                        ) -> Tuple[bool, Optional[Dict[str, np.ndarray]]]:
        """Merge batch segments into the store ``st`` (the
        MergingWindowSet role): pull every touched key's spans, run one
        interval-union scan over them and the new segments sorted by
        (key, start), combine each group with ``reduceat`` and splice
        the results back. In retract mode, returns a -U row for every
        fired registry span a merge consumes: its emitted row is stale,
        and its accumulators still hold the values it fired with."""
        gap = self.gap
        uk, first = np.unique(seg_key, return_index=True)
        touched_idx = st.rows_for(uk)
        if len(touched_idx):
            # participation cut: a span whose chain end (last + gap)
            # precedes its key's oldest new segment can neither merge nor
            # be bridged in this batch, so it stays untouched
            key_min = seg_tmin[first]  # segments are (key, ts)-sorted
            kr = np.searchsorted(uk, st.key[touched_idx])
            touched_idx = touched_idx[
                st.last[touched_idx] + gap >= key_min[kr]]
        (tk, tstart, tlast, tsum, tmax, tmin, tcount, tfired,
         trefire, tretr) = st._take(touched_idx)
        if len(touched_idx):
            keep = np.ones(len(st), bool)
            keep[touched_idx] = False
            st._filter(keep)

        n_t = len(tk)
        all_key = np.concatenate([tk, seg_key])
        all_start = np.concatenate([tstart, seg_tmin])
        all_last = np.concatenate([tlast, seg_tmax])
        all_sum = np.concatenate([tsum, seg_sum])
        all_max = np.concatenate([tmax, seg_max])
        all_min = np.concatenate([tmin, seg_min])
        all_count = np.concatenate([tcount, seg_count])
        all_fired = np.concatenate([tfired, np.zeros(len(seg_key), bool)])
        all_refire = np.concatenate([trefire, np.zeros(len(seg_key), bool)])
        all_retr = np.concatenate([tretr, np.zeros(len(seg_key), bool)])
        is_new = np.concatenate(
            [np.zeros(n_t, bool), np.ones(len(seg_key), bool)])

        order = np.lexsort((all_start, all_key))
        k_o = all_key[order]
        s_o = all_start[order]
        l_o = all_last[order]

        # interval-union scan: each key's timeline gets its own numeric
        # band, so one maximum.accumulate is every key's running chain
        # end (merge iff start <= chain last + gap)
        base = int(s_o.min())
        span = int(l_o.max()) + gap - base + 2
        krank = np.searchsorted(uk, k_o).astype(np.int64)
        if (len(uk) + 1) * span < 2**62:
            enc_start = krank * span + (s_o - base)
            enc_chain = krank * span + (l_o - base) + gap
            cm = np.maximum.accumulate(enc_chain)
            grp = np.empty(len(order), bool)
            grp[0] = True
            grp[1:] = enc_start[1:] > cm[:-1]
        else:  # a time range too wide to encode: a scan that resets a key
            grp = np.empty(len(order), bool)
            grp[0] = True
            chain = l_o[0]
            for i in range(1, len(order)):
                if k_o[i] != k_o[i - 1] or s_o[i] > chain + gap:
                    grp[i] = True
                    chain = l_o[i]
                else:
                    grp[i] = False
                    chain = max(chain, l_o[i])

        gs = np.nonzero(grp)[0]
        m_key = k_o[gs]
        m_start = s_o[gs]  # the group's min: sorted by start within a key
        m_last = np.maximum.reduceat(l_o, gs)
        m_sum = (np.add.reduceat(all_sum[order], gs, axis=0)
                 if all_sum.shape[1] else np.zeros((len(gs), 0), np.float32))
        m_max = (np.maximum.reduceat(all_max[order], gs, axis=0)
                 if all_max.shape[1] else np.zeros((len(gs), 0), np.float32))
        m_min = (np.minimum.reduceat(all_min[order], gs, axis=0)
                 if all_min.shape[1] else np.zeros((len(gs), 0), np.float32))
        m_count = np.add.reduceat(all_count[order], gs)
        fired_any = np.logical_or.reduceat(all_fired[order], gs)
        refire_any = np.logical_or.reduceat(all_refire[order], gs)
        retr_any = np.logical_or.reduceat(all_retr[order], gs)
        new_any = np.logical_or.reduceat(is_new[order], gs)
        size1 = np.append(gs[1:], len(order)) - gs == 1

        # an untouched singleton registry span passes through; a group
        # that absorbs new content resets fired and (re-)fires at the
        # next advance when it merged a fired span or is already complete
        complete_now = (self.watermark != LONG_MIN) & (
            m_last + gap - 1 <= self.watermark)
        passthrough = size1 & ~new_any
        m_fired = np.where(passthrough, fired_any, False)
        m_refire = np.where(passthrough, refire_any,
                            fired_any | refire_any | complete_now)
        # a merged span whose members emitted (and now retract) a row,
        # or that inherited a pending retraction, fires as +U
        m_retr = np.where(passthrough, retr_any, fired_any | retr_any)
        retract_rows = None
        if self.retract:
            # -U a consumed fired registry span (a member that is not
            # new, fired, in a group that is not a passthrough)
            grp_sizes = np.append(gs[1:], len(order)) - gs
            pass_m = np.repeat(passthrough, grp_sizes)
            rm = ~is_new[order] & all_fired[order] & ~pass_m
            if rm.any():
                retract_rows = self._emit((
                    k_o[rm], s_o[rm], l_o[rm], all_sum[order][rm],
                    all_max[order][rm], all_min[order][rm],
                    all_count[order][rm]))
                retract_rows[OP_FIELD] = np.full(
                    int(rm.sum()), OP_UPDATE_BEFORE, OP_DTYPE)
        st.insert_sorted((m_key, m_start, m_last, m_sum, m_max, m_min,
                          m_count, m_fired, m_refire, m_retr))
        return bool(m_refire.any()), retract_rows

    # -- time ------------------------------------------------------------
    def advance_watermark(self, wm: int) -> FiredWindows:
        if wm < self.watermark and not self._has_refire:
            return FiredWindows(data=self._empty())
        self.state_version += 1
        self.watermark = max(self.watermark, wm)
        self._has_refire = False
        if self._pool is None:
            rows = self._advance_shard(self._shards[0])
        else:
            # shards fire and expire on the pool; their rows re-sort by
            # (key, start), the serial store's order
            parts = [r for r in self._pool.run_tasks(
                [lambda st=st: self._advance_shard(st)
                 for st in self._shards]) if r is not None]
            if not parts:
                rows = None
            elif len(parts) == 1:
                rows = parts[0]
            else:
                cat = {k: np.concatenate([p[k] for p in parts])
                       for k in parts[0]}
                order = np.lexsort((cat["window_start"], cat["key"]))
                rows = {k: v[order] for k, v in cat.items()}
        if rows is None:
            return FiredWindows(data=self._empty())
        return FiredWindows(data=rows)

    def _advance_shard(self, st: _SpanStore) -> Optional[Dict[str, np.ndarray]]:
        """Fire and expiry of one shard at the current watermark; the
        shard's rows in store order, (key, start)."""
        if not len(st):
            return None
        end1 = st.last + self.gap - 1
        complete = end1 <= self.watermark
        emit = complete & (~st.fired | st.refire)
        rows = None
        if emit.any():
            idx = np.nonzero(emit)[0]
            rows = self._emit(st._take(idx))
            if self.retract:
                # a span whose predecessors were retracted (re)fires as
                # +U, a first firing as +I; the row now stands
                rows[OP_FIELD] = np.where(
                    st.retracted[idx], OP_UPDATE_AFTER,
                    OP_INSERT).astype(OP_DTYPE)
                st.retracted[idx] = False
        st.fired |= complete
        st.refire[:] = False
        dead = end1 + self.lateness <= self.watermark
        if dead.any():
            st._filter(~dead)
        return rows

    def _emit(self, cols: Tuple[np.ndarray, ...]) -> Dict[str, np.ndarray]:
        """Rows of merged sessions: the aggregate's finalize in torch on
        the CPU (the JAX package's ``_emit`` runs it on CPU JAX)."""
        key, start, last, sums, maxs, mins, count = cols[:7]
        res = self.agg.finalize(
            torch.from_numpy(np.ascontiguousarray(sums, np.float32)),
            torch.from_numpy(np.ascontiguousarray(maxs, np.float32)),
            torch.from_numpy(np.ascontiguousarray(mins, np.float32)),
            torch.from_numpy(count.astype(np.int32)))
        out = {
            "key": key.astype(np.int64),
            "window_start": start.astype(np.int64),
            "window_end": (last + self.gap).astype(np.int64),
            "count": count.astype(np.int32),
        }
        # finalize's fields win, one named "count" too: an aggregate with
        # result_field="count" is not shadowed by the record count
        for k, v in res.items():
            out[k] = v.numpy()
        return out

    def _empty(self) -> Dict[str, np.ndarray]:
        if not hasattr(self, "_empty_cache"):
            w = self.agg
            self._empty_cache = self._emit((
                np.zeros(0, np.int64), np.zeros(0, np.int64),
                np.zeros(0, np.int64), np.zeros((0, w.sum_width), np.float32),
                np.zeros((0, w.max_width), np.float32),
                np.zeros((0, w.min_width), np.float32),
                np.zeros(0, np.int64)))
            if self.retract:
                self._empty_cache[OP_FIELD] = np.zeros(0, OP_DTYPE)
        return dict(self._empty_cache)

    # -- the per-step retraction drain -----------------------------------
    def take_fired(self) -> Optional[FiredWindows]:
        """The -U rows this step's merges produced (retract mode; None
        otherwise). The driver calls it right after each
        ``process_batch``, so a consumed span's retraction reaches the
        sink before the merged session's (re)fire."""
        if not self._pending_retracts:
            return None
        parts = self._pending_retracts
        self._pending_retracts = []
        if len(parts) == 1:
            rows = parts[0]
        else:
            rows = {k: np.concatenate([p[k] for p in parts])
                    for k in parts[0]}
        # the same order at every shard count
        order = np.lexsort((rows["window_start"], rows["key"]))
        return FiredWindows(data={k: v[order] for k, v in rows.items()})

    def final_watermark(self) -> int:
        lasts = [int(st.last.max()) for st in self._shards if len(st)]
        if not lasts:
            return self.watermark if self.watermark != LONG_MIN else 0
        return max(lasts) + self.gap + self.lateness + 1

    def quiesce(self) -> None:
        pass

    # -- snapshot --------------------------------------------------------
    def _merged_columns(self) -> Dict[str, np.ndarray]:
        """The registry as ONE (key, start)-sorted block: the checkpoint
        does not depend on the shard count, so a snapshot restores at
        any ``host.parallelism`` (and stays byte-stable for the
        incremental checkpoint's reuse check)."""
        if len(self._shards) == 1:
            st = self._shards[0]
            return {c: getattr(st, c).copy() for c in st._COLS}
        cols = {c: np.concatenate([getattr(st, c) for st in self._shards])
                for c in _SpanStore._COLS}
        order = np.lexsort((cols["start"], cols["key"]))
        return {c: v[order] for c, v in cols.items()}

    def snapshot_state(self) -> Dict[str, Any]:
        return {
            "watermark": self.watermark,
            "late_records": self.late_records,
            "columns": self._merged_columns(),
        }

    def restore_state(self, snap: Dict[str, Any]) -> None:
        self.watermark = snap["watermark"]
        self.late_records = snap["late_records"]
        st = _SpanStore(self.agg.sum_width, self.agg.max_width,
                        self.agg.min_width)
        for c in st._COLS:
            # a copy: advance_watermark changes columns in place, and the
            # caller's snapshot may be reused (recovery retries)
            setattr(st, c, np.array(snap["columns"][c]))
        self._install_store(st)
        self._has_refire = bool(st.refire.any())

    def _install_store(self, st: _SpanStore) -> None:
        """Adopt a merged (key, start)-sorted store, re-sharded to this
        operator's parallelism (a snapshot of W = 1 restores into W = 4
        and back)."""
        n_shards = len(self._shards)
        if n_shards == 1:
            self._shards = [st]
            return
        shards = []
        sh = st.key % n_shards
        for w in range(n_shards):
            part = _SpanStore(self.agg.sum_width, self.agg.max_width,
                              self.agg.min_width)
            m = sh == w
            for c in st._COLS:  # a mask keeps (key, start) order
                setattr(part, c, getattr(st, c)[m])
            shards.append(part)
        self._shards = shards
