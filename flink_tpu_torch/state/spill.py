"""Host spill store (``state.backend = spill``): exact windowed
aggregation for keys that get no slot in the device's key directory.

The device holds a fixed number of key slots. A record whose key's
shard is full aggregates here instead, per (key, pane), in host numpy
arrays; at each fire the store combines the fired windows' panes with
the same monoid operations as the device (sum, max, min, count) and the
aggregate's finalize, and its rows go out beside the device's. A key
lives in exactly one of the two stores (the directory is insert-only,
so a key refused once is refused for good): their rows simply
concatenate, and a top-n re-ranks the union per window.

The lift and the finalize are the aggregate's torch functions, run on
tensors of an explicit ``torch.device("cpu")``. That is this store's
design, as in the JAX package (which pins them to CPU JAX): the spilled
keys' records never cross to the card. It is not a fallback.

Fire, refire and purge follow the operator: it passes the same fired
ends (re-fires included) to both stores and purges both at the same
horizon.

Given the driver's ``HostPool`` (``parallel/hostpool.py``) at a
parallelism above 1, the store runs its independent units as pool
tasks: the per-pane merges of an absorb, the per-window combines of a
fire, and, from ``fold_chunk_records`` records a batch up, a chunked
tree fold (chunks grouped on the pool, each pane's chunk partials
combined in chunk order: windowAll's scaling shape, one global key).
A pane's table is guarded by a lock of its own. The chunk size does not
depend on the worker count, so the reduction tree, and the output bytes
of the exact lane monoids, do not change with ``host.parallelism``;
without a pool or at parallelism 1 the store takes the serial path.
"""
from __future__ import annotations

import threading
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from flink_tpu_torch.config import HostOptions
from flink_tpu_torch.records import device_cast

_NEG_INF = np.float32(-np.inf)
_POS_INF = np.float32(np.inf)
_CPU = torch.device("cpu")


class HostSpillStore:
    """Per-(key, pane) lane accumulators in host numpy arrays:
    ``panes[p] = (keys sorted (K,), sums (K, S), maxs (K, M), mins (K,
    m), counts (K,))``. A batch is absorbed by one lexsort and a segment
    reduce, then a sorted-union splice into each touched pane."""

    def __init__(self, agg, *, pool=None,
                 fold_chunk_records: Optional[int] = None) -> None:
        self.agg = agg
        self.panes: Dict[int, Tuple[np.ndarray, np.ndarray, np.ndarray,
                                    np.ndarray, np.ndarray]] = {}
        self.records_spilled = 0
        # None or parallelism 1: the serial path
        self._pool = (pool if pool is not None and pool.parallelism > 1
                      else None)
        if fold_chunk_records is None:
            fold_chunk_records = HostOptions.FOLD_CHUNK_RECORDS.default
        self.fold_chunk_records = int(fold_chunk_records)
        # one lock a pane entry, never a global one: within one
        # run_tasks batch each pane has at most one merge task, and the
        # locks guard the tables for any caller that overlaps absorbs
        self._pane_locks: Dict[int, threading.Lock] = {}
        self._locks_guard = threading.Lock()

    def _pane_lock(self, pane: int) -> threading.Lock:
        with self._locks_guard:
            return self._pane_locks.setdefault(pane, threading.Lock())

    # -- ingest ----------------------------------------------------------

    def _lift(self, data: Dict[str, np.ndarray], n: int
              ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """The aggregate's lane lift of ``n`` host rows, in torch on the
        CPU."""
        cols = {k: torch.from_numpy(np.ascontiguousarray(device_cast(v)))
                for k, v in data.items()}
        s, mx, mn = self.agg.lift_masked(
            cols, torch.ones(n, dtype=torch.bool, device=_CPU))
        return s.numpy(), mx.numpy(), mn.numpy()

    def absorb(self, keys: np.ndarray, panes: np.ndarray,
               data: Dict[str, np.ndarray]) -> None:
        """Fold overflow records into the per-(key, pane) accumulators."""
        n = len(keys)
        if n == 0:
            return
        self.records_spilled += n
        if self._pool is not None and n >= self.fold_chunk_records:
            self._absorb_tree(keys, panes, data)
            return
        self._splice_groups(*self._group_batch(keys, panes, data))

    def _group_batch(self, keys: np.ndarray, panes: np.ndarray,
                     data: Dict[str, np.ndarray]) -> Tuple[np.ndarray, ...]:
        """One (pane, key) grouping pass: lexsort, group boundaries and a
        segment reduce in record order. Returns pane-contiguous
        groups."""
        n = len(keys)
        sums, maxs, mins = self._lift(data, n)
        o = np.lexsort((keys, panes))
        pk, kk = panes[o], keys[o]
        new_grp = np.empty(n, bool)
        new_grp[0] = True
        new_grp[1:] = (pk[1:] != pk[:-1]) | (kk[1:] != kk[:-1])
        gid = np.cumsum(new_grp) - 1
        G = int(gid[-1]) + 1
        S, M, m = self.agg.sum_width, self.agg.max_width, self.agg.min_width
        g_sum = np.zeros((G, S), np.float32)
        np.add.at(g_sum, gid, sums[o])
        g_max = np.full((G, M), _NEG_INF, np.float32)
        np.maximum.at(g_max, gid, maxs[o])
        g_min = np.full((G, m), _POS_INF, np.float32)
        np.minimum.at(g_min, gid, mins[o])
        g_cnt = np.bincount(gid, minlength=G).astype(np.int64)
        return pk[new_grp], kk[new_grp], g_sum, g_max, g_min, g_cnt

    @staticmethod
    def _pane_spans(g_pane: np.ndarray) -> List[Tuple[int, int]]:
        bounds = np.flatnonzero(
            np.concatenate([[True], g_pane[1:] != g_pane[:-1], [True]]))
        return list(zip(bounds[:-1].tolist(), bounds[1:].tolist()))

    def _splice_groups(self, g_pane, g_key, g_sum, g_max, g_min,
                       g_cnt) -> None:
        """Merge each touched pane's groups into its table; the panes
        are independent, so with a pool they merge as parallel tasks
        under their locks."""
        spans = self._pane_spans(g_pane)

        def merge(a: int, b: int) -> None:
            pane = int(g_pane[a])
            with self._pane_lock(pane):
                self._merge_pane(pane, g_key[a:b], g_sum[a:b],
                                 g_max[a:b], g_min[a:b], g_cnt[a:b])

        if self._pool is not None and len(spans) > 1:
            self._pool.run_tasks(
                [lambda a=a, b=b: merge(a, b) for a, b in spans])
        else:
            for a, b in spans:
                merge(a, b)

    def _absorb_tree(self, keys: np.ndarray, panes: np.ndarray,
                     data: Dict[str, np.ndarray]) -> None:
        """The chunked tree fold: chunks of ``fold_chunk_records`` group
        on the pool, then each pane's chunk partials combine in chunk
        order (one task a pane). The chunk size never derives from the
        worker count, so the tree is the same at every parallelism
        above 1."""
        n = len(keys)
        chunk = self.fold_chunk_records
        data = {k: np.asarray(v) for k, v in data.items()}
        spans = [(lo, min(lo + chunk, n)) for lo in range(0, n, chunk)]
        parts = self._pool.run_tasks(
            [lambda lo=lo, hi=hi: self._group_batch(
                keys[lo:hi], panes[lo:hi],
                {k: v[lo:hi] for k, v in data.items()})
             for lo, hi in spans])
        # pane -> its chunk partials, in chunk order
        per_pane: Dict[int, List[Tuple[np.ndarray, ...]]] = {}
        for g_pane, g_key, g_sum, g_max, g_min, g_cnt in parts:
            for a, b in self._pane_spans(g_pane):
                per_pane.setdefault(int(g_pane[a]), []).append(
                    (g_key[a:b], g_sum[a:b], g_max[a:b], g_min[a:b],
                     g_cnt[a:b]))

        def combine(pane: int, pieces) -> None:
            with self._pane_lock(pane):
                for piece in pieces:
                    self._merge_pane(pane, *piece)

        self._pool.run_tasks(
            [lambda p=p, pcs=pcs: combine(p, pcs)
             for p, pcs in per_pane.items()])

    def _merge_pane(self, pane: int, keys, sums, maxs, mins, counts) -> None:
        cur = self.panes.get(pane)
        if cur is None:
            self.panes[pane] = (keys.copy(), sums.copy(), maxs.copy(),
                                mins.copy(), counts.copy())
            return
        ck, cs, cx, cn, cc = cur
        union = np.union1d(ck, keys)
        K = len(union)
        S, M, m = self.agg.sum_width, self.agg.max_width, self.agg.min_width
        us = np.zeros((K, S), np.float32)
        ux = np.full((K, M), _NEG_INF, np.float32)
        un = np.full((K, m), _POS_INF, np.float32)
        uc = np.zeros(K, np.int64)
        po = np.searchsorted(union, ck)
        pn = np.searchsorted(union, keys)
        us[po] = cs
        us[pn] += sums
        ux[po] = cx
        ux[pn] = np.maximum(ux[pn], maxs)
        un[po] = cn
        un[pn] = np.minimum(un[pn], mins)
        uc[po] = cc
        uc[pn] += counts
        self.panes[pane] = (union, us, ux, un, uc)

    # -- fire ------------------------------------------------------------

    def fire(self, ends: List[int], panes_per_window: int, pane_ms: int,
             offset_ms: int, size_ms: int) -> Optional[Dict[str, np.ndarray]]:
        """Fired rows of the given end panes, in end order (each window's
        keys ascending); None when no stored pane meets any window."""
        if not self.panes or not ends:
            return None
        ppw = panes_per_window
        lo_stored, hi_stored = min(self.panes), max(self.panes)
        live = [e for e in ends if e > lo_stored and e - ppw <= hi_stored]
        if not live:
            return None
        # windows only read their panes, so with a pool each window's
        # combine is a task; rows assemble in end order either way
        if self._pool is not None and len(live) > 1:
            fired = self._pool.run_tasks(
                [lambda e=e: self._fire_window(e, ppw) for e in live])
        else:
            fired = [self._fire_window(e, ppw) for e in live]
        keys_out: List[np.ndarray] = []
        ends_out: List[np.ndarray] = []
        cnt_out: List[np.ndarray] = []
        res_cols: Dict[str, List[np.ndarray]] = {}
        for e, hit in zip(live, fired):
            if hit is None:
                continue
            kk, wc_has, res = hit
            keys_out.append(kk)
            ends_out.append(np.full(len(kk), e, np.int64))
            cnt_out.append(wc_has)
            for f, v in res.items():
                if f == "count":
                    continue  # the exact element count wins
                res_cols.setdefault(f, []).append(v)
        if not keys_out:
            return None
        window_end = np.concatenate(ends_out) * pane_ms + offset_ms
        out: Dict[str, np.ndarray] = {
            "key": np.concatenate(keys_out),
            "window_start": window_end - size_ms,
            "window_end": window_end,
            "count": np.concatenate(cnt_out),
        }
        for f, cols in res_cols.items():
            out[f] = np.concatenate(cols)
        return out

    def _fire_window(self, e: int, ppw: int
                     ) -> Optional[Tuple[np.ndarray, np.ndarray, Dict]]:
        """One window's panes combined; (keys, counts, finalized fields)
        or None when it holds nothing. The finalize runs in torch on the
        CPU."""
        S, M, m = self.agg.sum_width, self.agg.max_width, self.agg.min_width
        span = [self.panes[p] for p in range(e - ppw, e) if p in self.panes]
        if not span:
            return None
        union = span[0][0] if len(span) == 1 else np.unique(
            np.concatenate([s[0] for s in span]))
        K = len(union)
        ws = np.zeros((K, S), np.float32)
        wx = np.full((K, M), _NEG_INF, np.float32)
        wn = np.full((K, m), _POS_INF, np.float32)
        wc = np.zeros(K, np.int64)
        for ck, cs, cx, cn, cc in span:
            pos = np.searchsorted(union, ck)
            ws[pos] += cs
            wx[pos] = np.maximum(wx[pos], cx)
            wn[pos] = np.minimum(wn[pos], cn)
            wc[pos] += cc
        has = wc > 0
        if not has.any():
            return None
        res = self.agg.finalize(
            torch.from_numpy(ws[has]), torch.from_numpy(wx[has]),
            torch.from_numpy(wn[has]),
            torch.from_numpy(wc[has].astype(np.int32)))
        return union[has], wc[has], {k: v.numpy() for k, v in res.items()}

    # -- lifecycle -------------------------------------------------------

    def purge_below(self, dead_pane: int) -> None:
        for p in [p for p in self.panes if p < dead_pane]:
            del self.panes[p]
        with self._locks_guard:  # the locks track live panes
            for p in [p for p in self._pane_locks if p < dead_pane]:
                del self._pane_locks[p]

    def bytes_used(self) -> int:
        """Host memory held by spilled panes; the LSM tier seals its
        delta past its budget by it. ``list()`` takes the values at once
        for a caller on another thread."""
        return sum(sum(a.nbytes for a in arrs)
                   for arrs in list(self.panes.values()))

    @property
    def key_count(self) -> int:
        if not self.panes:
            return 0
        return len(np.unique(np.concatenate(
            [t[0] for t in self.panes.values()])))

    def snapshot(self) -> Dict[str, Any]:
        """The JAX package's layout:``{"panes": {pane: (keys, sums,
        maxs, mins, counts)}, "records_spilled": n}``."""
        return {
            "panes": {int(p): tuple(a.copy() for a in t)
                      for p, t in self.panes.items()},
            "records_spilled": self.records_spilled,
        }

    def restore(self, snap: Dict[str, Any]) -> None:
        self.panes = {int(p): tuple(np.asarray(a) for a in t)
                      for p, t in snap["panes"].items()}
        self.records_spilled = int(snap["records_spilled"])
