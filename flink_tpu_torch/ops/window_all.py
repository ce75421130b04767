"""Non-keyed (global) windowed aggregation: the windowAll shape (Nexmark
Q7).

Flink runs ``windowAll`` as a window operator of parallelism 1: every
record goes to one subtask. The JAX package keeps no key and no device
state for it: a global lane aggregate a pane is a few floats, and
folding a batch into it is a segment reduce, so the fold runs on the
host per pane through the spill store's (key, pane) machinery with one
constant key, and no record crosses to the device. This port keeps that
placement (its lift and finalize are the aggregate's torch functions on
an explicit ``torch.device("cpu")``, in ``state/spill.py``). With the
driver's host pool the store folds large batches as a chunked tree
(``host.fold-chunk-records``) and fires windows as parallel tasks.

Fire, lateness and re-fire follow the device ``WindowOperator``: the
same ``WindowPlan`` pane math through ``HostPaneControl``.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np

from flink_tpu_torch.api.windowing import WindowAssigner
from flink_tpu_torch.ops.aggregates import LaneAggregate, probe_finalize
from flink_tpu_torch.ops.host_control import HostPaneControl
from flink_tpu_torch.ops.window import FiredWindows, WindowPlan, empty_fired
from flink_tpu_torch.state.spill import HostSpillStore


class WindowAllOperator:
    """Global tumbling or sliding window over all records (no key)."""

    def __init__(
        self,
        assigner: WindowAssigner,
        agg: LaneAggregate,
        *,
        allowed_lateness_ms: int = 0,
        max_out_of_orderness_ms: int = 0,
        host_pool: Optional[Any] = None,
        fold_chunk_records: Optional[int] = None,
    ) -> None:
        self.agg = agg
        self.plan = WindowPlan.plan(
            assigner,
            allowed_lateness_ms=allowed_lateness_ms,
            max_out_of_orderness_ms=max_out_of_orderness_ms)
        # one logical key, so key-sharding cannot apply: the store's
        # chunked tree fold and per-window fires are its parallel units
        self.store = HostSpillStore(agg, pool=host_pool,
                                    fold_chunk_records=fold_chunk_records)
        self.ctl = HostPaneControl(self.plan)
        self.state_version = 0
        self._empty_cache: Optional[Dict[str, np.ndarray]] = None

    @property
    def watermark(self) -> int:
        return self.ctl.watermark

    @property
    def late_records(self) -> int:
        return self.ctl.late_records

    # -- data plane ------------------------------------------------------

    def process_batch(self, ts: np.ndarray, data: Dict[str, np.ndarray],
                      valid: Optional[np.ndarray] = None) -> None:
        self.state_version += 1
        ts = np.asarray(ts, dtype=np.int64)
        valid = (np.ones(len(ts), bool) if valid is None
                 else np.asarray(valid, bool))
        panes, valid = self.ctl.absorb_panes(ts, valid)
        if not valid.any():
            return
        sub = {k: np.asarray(data[k])[valid] for k in
               (self.agg.fields if self.agg.fields is not None else data)}
        self.store.absorb(np.zeros(int(valid.sum()), np.int64),
                          panes[valid], sub)

    # -- time plane ------------------------------------------------------

    def advance_watermark(self, wm: int) -> FiredWindows:
        ends = self.ctl.begin_advance(wm)
        if ends is None:
            return self._empty()
        self.state_version += 1
        rows = self.store.fire(ends, self.plan.panes_per_window,
                               self.plan.pane_ms, self.plan.offset_ms,
                               self.plan.size_ms)
        new_dead = self.ctl.purge_horizon(wm)
        if new_dead is not None:
            self.store.purge_below(new_dead)
        if rows is None:
            return self._empty()
        rows.pop("key")  # a global window: no key column
        return FiredWindows(data=rows)

    def final_watermark(self) -> int:
        return self.ctl.final_watermark()

    def quiesce(self) -> None:
        pass

    def _empty(self) -> FiredWindows:
        if self._empty_cache is None:
            cache = dict(empty_fired({
                k: v.numpy() for k, v in probe_finalize(self.agg).items()
            }).materialize())
            cache.pop("key", None)
            self._empty_cache = cache
        return FiredWindows(data=dict(self._empty_cache))

    # -- snapshot --------------------------------------------------------

    def snapshot_state(self) -> Dict[str, Any]:
        return {
            "kind": "window_all",
            "store": self.store.snapshot(),
            **self.ctl.snapshot(),
        }

    def restore_state(self, snap: Dict[str, Any]) -> None:
        self.store.restore(snap["store"])
        self.ctl.restore(snap)
