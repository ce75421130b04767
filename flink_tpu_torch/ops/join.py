"""Windowed equi-join: the Nexmark Q8 shape.

Flink lowers ``join(a, b).where(k).equalTo(k).window(w)`` onto a window
operator over the union of both inputs, buffers raw elements and emits
the cross product of left × right per (key, window) when it fires. Two
lowerings, chosen per job, as in the JAX package:

- ``mode="pairs"`` (default, Flink's JoinFunction semantics): each side
  buffers its rows on the host in columnar chunks (pane, key, fields),
  and a fire emits one row per matching left × right pair, expanded by
  vectorized ragged-group arithmetic (``_cross_join_per_key``). The rows
  would only cross to the card to be echoed back at the fire, so they
  stay on the host. Fire, lateness and re-fire ride ``HostPaneControl``.
- ``mode="aggregate"``: each side folds into a device ``WindowOperator``
  (a count and a max-carried lane a field) on the driver's device, and
  a fire emits one row per (key, window) present on both sides, both
  sides' rows fetched in one pass (``FiredWindows.materialize_many``).
  Its ingest, fire and purge are the window kernels' launches.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from flink_tpu_torch.api.windowing import WindowAssigner
from flink_tpu_torch.ops import aggregates
from flink_tpu_torch.ops.host_control import HostPaneControl
from flink_tpu_torch.ops.window import FiredWindows, WindowOperator, WindowPlan


def _side_agg(fields: Sequence[str], prefix: str) -> aggregates.LaneAggregate:
    """A count and a max lane a selected field (a field with one value a
    (key, window) carries it; with several, the max is a deterministic
    representative)."""
    aggs = [aggregates.count(f"{prefix}count")]
    for f in fields:
        aggs.append(aggregates.max_of(f, f"{prefix}{f}"))
    return aggregates.multi(*aggs)


class _SideBuffer:
    """Host columnar row buffer of one join input: append-only chunks,
    consolidated lazily, purged at the lateness horizon."""

    def __init__(self, fields: Sequence[str]) -> None:
        self.fields = tuple(fields)
        self._chunks: List[Tuple[np.ndarray, np.ndarray,
                                 Dict[str, np.ndarray]]] = []
        self._flat: Optional[Tuple[np.ndarray, np.ndarray,
                                   Dict[str, np.ndarray]]] = None

    def absorb(self, panes: np.ndarray, keys: np.ndarray,
               data: Dict[str, np.ndarray]) -> None:
        if len(panes) == 0:
            return
        self._chunks.append(
            (panes.copy(), keys.copy(),
             {f: np.asarray(data[f]).copy() for f in self.fields}))
        self._flat = None

    def _consolidated(self):
        if self._flat is None:
            if not self._chunks:
                self._flat = (np.zeros(0, np.int64), np.zeros(0, np.int64),
                              {f: np.zeros(0) for f in self.fields})
            else:
                panes = np.concatenate([c[0] for c in self._chunks])
                keys = np.concatenate([c[1] for c in self._chunks])
                cols = {f: np.concatenate([c[2][f] for c in self._chunks])
                        for f in self.fields}
                self._flat = (panes, keys, cols)
                self._chunks = [self._flat]
        return self._flat

    def rows_in_window(self, end_pane: int, ppw: int):
        panes, keys, cols = self._consolidated()
        m = (panes >= end_pane - ppw) & (panes < end_pane)
        return keys[m], {f: v[m] for f, v in cols.items()}

    def purge_below(self, dead_pane: int) -> None:
        panes, keys, cols = self._consolidated()
        keep = panes >= dead_pane
        if not keep.all():
            self._chunks = [(panes[keep], keys[keep],
                             {f: v[keep] for f, v in cols.items()})]
            self._flat = self._chunks[0]

    def snapshot(self) -> Dict[str, Any]:
        panes, keys, cols = self._consolidated()
        return {"panes": panes.copy(), "keys": keys.copy(),
                "cols": {f: v.copy() for f, v in cols.items()}}

    def restore(self, snap: Dict[str, Any]) -> None:
        self._chunks = [(np.array(snap["panes"]), np.array(snap["keys"]),
                         {f: np.array(v) for f, v in snap["cols"].items()})]
        self._flat = self._chunks[0]


def _cross_join_per_key(lk, lcols, rk, rcols, lf, rf,
                        max_pairs: Optional[int] = None):
    """One row per matching left × right pair, grouped by key, by
    vectorized ragged expansion. The ``max_pairs`` budget is checked
    before any expansion array is allocated: a pair explosion dies with
    a RuntimeError, not an out-of-memory while building it."""
    lo = np.argsort(lk, kind="stable")
    ro = np.argsort(rk, kind="stable")
    lks, rks = lk[lo], rk[ro]
    ul, l_start, l_cnt = np.unique(lks, return_index=True, return_counts=True)
    ur, r_start, r_cnt = np.unique(rks, return_index=True, return_counts=True)
    common, li, ri = np.intersect1d(ul, ur, return_indices=True)
    if len(common) == 0:
        return (np.zeros(0, np.int64),
                {f: np.zeros(0) for f in lf}, {f: np.zeros(0) for f in rf})
    nl, nr = l_cnt[li].astype(np.int64), r_cnt[ri].astype(np.int64)
    pairs = nl * nr
    total = int(pairs.sum())
    if max_pairs is not None and total > max_pairs:
        raise RuntimeError(
            f"join pair explosion: {total} pairs in one window fire "
            f"exceed the {max_pairs} budget; aggregate first or use "
            "mode='aggregate'")
    g = np.repeat(np.arange(len(common)), pairs)
    off = np.repeat(np.concatenate(([0], np.cumsum(pairs)[:-1])), pairs)
    within = np.arange(total) - off
    a = within // nr[g]          # the left row within the key's group
    b = within % nr[g]           # the right row within the key's group
    lidx = lo[l_start[li][g] + a]
    ridx = ro[r_start[ri][g] + b]
    return (common[g],
            {f: np.asarray(lcols[f])[lidx] for f in lf},
            {f: np.asarray(rcols[f])[ridx] for f in rf})


class WindowJoinOperator:
    """Two keyed inputs joined per (key, window) when it fires. Both
    sides share one watermark: the driver hands it the min over its two
    inputs."""

    #: the guard against a cross-product explosion in one fire
    MAX_PAIRS_PER_FIRE = 10_000_000

    def __init__(
        self,
        assigner: WindowAssigner,
        *,
        left_fields: Sequence[str] = (),
        right_fields: Sequence[str] = (),
        num_shards: int = 128,
        slots_per_shard: int = 1024,
        max_out_of_orderness_ms: int = 0,
        allowed_lateness_ms: int = 0,
        mode: str = "pairs",
        device: "str | Any" = "cuda",
    ) -> None:
        if mode not in ("pairs", "aggregate"):
            raise ValueError(
                f"join mode must be 'pairs' or 'aggregate', got {mode!r}")
        self.mode = mode
        self.left_fields = tuple(left_fields)
        self.right_fields = tuple(right_fields)
        self.state_version = 0
        if mode == "aggregate":
            kw = dict(
                num_shards=num_shards, slots_per_shard=slots_per_shard,
                max_out_of_orderness_ms=max_out_of_orderness_ms,
                allowed_lateness_ms=allowed_lateness_ms, device=device)
            self.left = WindowOperator(
                assigner, _side_agg(left_fields, "left_"), **kw)
            self.right = WindowOperator(
                assigner, _side_agg(right_fields, "right_"), **kw)
            return
        self.plan = WindowPlan.plan(
            assigner, allowed_lateness_ms=allowed_lateness_ms,
            max_out_of_orderness_ms=max_out_of_orderness_ms)
        self._lbuf = _SideBuffer(left_fields)
        self._rbuf = _SideBuffer(right_fields)
        self.ctl = HostPaneControl(self.plan)
        self._empty_cache: Optional[Dict[str, np.ndarray]] = None

    @property
    def watermark(self) -> int:
        if self.mode == "aggregate":
            return min(self.left.watermark, self.right.watermark)
        return self.ctl.watermark

    @property
    def late_records(self) -> int:
        if self.mode == "aggregate":
            return self.left.late_records + self.right.late_records
        return self.ctl.late_records

    def sides(self) -> List[WindowOperator]:
        """The device window operators of aggregate mode (none in pairs
        mode)."""
        return [self.left, self.right] if self.mode == "aggregate" else []

    # -- ingest ----------------------------------------------------------

    def process_left(self, keys, ts, data, valid=None) -> None:
        self.state_version += 1
        if self.mode == "aggregate":
            self.left.process_batch(
                keys, ts, {f: data[f] for f in self.left_fields}, valid)
            return
        self._absorb(self._lbuf, keys, ts, data, valid)

    def process_right(self, keys, ts, data, valid=None) -> None:
        self.state_version += 1
        if self.mode == "aggregate":
            self.right.process_batch(
                keys, ts, {f: data[f] for f in self.right_fields}, valid)
            return
        self._absorb(self._rbuf, keys, ts, data, valid)

    def _absorb(self, buf: _SideBuffer, keys, ts, data, valid) -> None:
        keys = np.asarray(keys, np.int64)
        ts = np.asarray(ts, np.int64)
        valid = (np.ones(len(ts), bool) if valid is None
                 else np.asarray(valid, bool))
        # a late row within the lateness on either side re-fires the
        # joined window with the whole updated pair set
        panes, valid = self.ctl.absorb_panes(ts, valid)
        if not valid.any():
            return
        buf.absorb(panes[valid], keys[valid],
                   {f: np.asarray(data[f])[valid] for f in buf.fields})

    # -- time ------------------------------------------------------------

    def advance_watermark(self, wm: int) -> FiredWindows:
        if self.mode == "aggregate":
            return self._advance_aggregate(wm)
        ends = self.ctl.begin_advance(wm)
        if ends is None:
            return self._empty()
        self.state_version += 1
        ppw = self.plan.panes_per_window
        out_parts: List[Dict[str, np.ndarray]] = []
        total_pairs = 0
        for e in ends:
            lk, lcols = self._lbuf.rows_in_window(e, ppw)
            if len(lk) == 0:
                continue
            rk, rcols = self._rbuf.rows_in_window(e, ppw)
            if len(rk) == 0:
                continue
            keys, lvals, rvals = _cross_join_per_key(
                lk, lcols, rk, rcols, self.left_fields, self.right_fields,
                max_pairs=self.MAX_PAIRS_PER_FIRE - total_pairs)
            n = len(keys)
            if n == 0:
                continue
            total_pairs += n
            we = e * self.plan.pane_ms + self.plan.offset_ms
            part: Dict[str, np.ndarray] = {
                "key": keys,
                "window_start": np.full(n, we - self.plan.size_ms, np.int64),
                "window_end": np.full(n, we, np.int64),
            }
            for f in self.left_fields:
                part[f"left_{f}"] = lvals[f]
            for f in self.right_fields:
                part[f"right_{f}"] = rvals[f]
            out_parts.append(part)

        new_dead = self.ctl.purge_horizon(wm)
        if new_dead is not None:
            self._lbuf.purge_below(new_dead)
            self._rbuf.purge_below(new_dead)
        if not out_parts:
            return self._empty()
        out = {k: np.concatenate([p[k] for p in out_parts])
               for k in out_parts[0]}
        return FiredWindows(data=out)

    def _advance_aggregate(self, wm: int) -> FiredWindows:
        # a late record on one side re-emits the joined row, so both
        # sides re-fire the union of the affected windows
        union_refire = self.left._refire | self.right._refire
        self.left._refire = set(union_refire)
        self.right._refire = set(union_refire)
        fl = self.left.advance_watermark(wm)
        fr = self.right.advance_watermark(wm)

        def merge() -> Dict[str, np.ndarray]:
            l = fl.materialize()
            r = fr.materialize()
            # a vectorized (key, window_end) inner match
            lp = np.stack([l["key"], l["window_end"]], axis=1)
            rp = np.stack([r["key"], r["window_end"]], axis=1)
            uniq, inv = np.unique(np.concatenate([lp, rp]), axis=0,
                                  return_inverse=True)
            inv = inv.reshape(-1)
            linv, rinv = inv[: len(lp)], inv[len(lp):]
            pos = np.full(len(uniq), -1, dtype=np.int64)
            pos[linv] = np.arange(len(lp))
            match = pos[rinv] >= 0
            ri = np.nonzero(match)[0]
            li = pos[rinv[match]]
            empty = np.zeros(0, np.int64)
            out: Dict[str, np.ndarray] = {
                "key": l["key"][li] if len(li) else empty,
                "window_start": l["window_start"][li] if len(li) else empty,
                "window_end": l["window_end"][li] if len(li) else empty,
            }
            for f in ("left_count",) + tuple(
                    f"left_{x}" for x in self.left_fields):
                out[f] = l[f][li] if len(li) else np.zeros(0)
            for f in ("right_count",) + tuple(
                    f"right_{x}" for x in self.right_fields):
                out[f] = r[f][ri] if len(ri) else np.zeros(0)
            return out

        # both sides' copies are fetched in one pass
        return FiredWindows(fetch=merge, parts=[fl, fr])

    def final_watermark(self) -> int:
        if self.mode == "aggregate":
            return max(self.left.final_watermark(),
                       self.right.final_watermark())
        return self.ctl.final_watermark()

    def quiesce(self) -> None:
        for side in self.sides():
            side.quiesce()

    def _empty(self) -> FiredWindows:
        if self._empty_cache is None:
            cache: Dict[str, np.ndarray] = {
                "key": np.zeros(0, np.int64),
                "window_start": np.zeros(0, np.int64),
                "window_end": np.zeros(0, np.int64),
            }
            for f in self.left_fields:
                cache[f"left_{f}"] = np.zeros(0)
            for f in self.right_fields:
                cache[f"right_{f}"] = np.zeros(0)
            self._empty_cache = cache
        return FiredWindows(data=dict(self._empty_cache))

    # -- snapshot --------------------------------------------------------

    def snapshot_state(self) -> Dict[str, Any]:
        if self.mode == "aggregate":
            return {"mode": "aggregate",
                    "left": self.left.snapshot_state(),
                    "right": self.right.snapshot_state()}
        return {
            "mode": "pairs",
            "left": self._lbuf.snapshot(),
            "right": self._rbuf.snapshot(),
            **self.ctl.snapshot(),
        }

    def restore_state(self, snap: Dict[str, Any]) -> None:
        if snap.get("mode", "aggregate") != self.mode:
            raise ValueError(
                f"join snapshot mode {snap.get('mode')!r} != operator "
                f"mode {self.mode!r}")
        if self.mode == "aggregate":
            self.left.restore_state(snap["left"])
            self.right.restore_state(snap["right"])
            return
        self._lbuf.restore(snap["left"])
        self._rbuf.restore(snap["right"])
        self.ctl.restore(snap)
