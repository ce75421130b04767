"""The window control plane of the host-resident windowed operators (the
global ``WindowAllOperator`` and the pairs-mode ``WindowJoinOperator``):
the state machine the device ``WindowOperator`` runs around its panes —
beyond-lateness drops, the written pane range, re-fires of late records
within the lateness, the fired frontier and the purge horizon. The pane
math lives on ``WindowPlan`` (``ops/window.py``); this class holds the
mutable state around it, so the rules exist once for every host-side
operator. Its snapshot keys are the JAX package's."""
from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np

from flink_tpu_torch.ops.window import WindowPlan
from flink_tpu_torch.time.watermarks import LONG_MIN


class HostPaneControl:
    """Late / re-fire / frontier / purge bookkeeping of one operator."""

    def __init__(self, plan: WindowPlan) -> None:
        self.plan = plan
        self.watermark = LONG_MIN
        self.late_records = 0
        self.refire: set[int] = set()
        self.cleared_below = plan.first_dead_pane(LONG_MIN)
        self.fired_below_end: Optional[int] = None
        self.min_pane_seen: Optional[int] = None
        self.max_pane_seen: Optional[int] = None

    # -- ingest side -----------------------------------------------------

    def absorb_panes(self, ts: np.ndarray, valid: np.ndarray):
        """Classify a batch: drop and count the records beyond the
        lateness, track the written pane range, and mark re-fires for
        late records within it that land in fired windows. Returns the
        pane array and the surviving valid mask."""
        panes = self.plan.pane_of(ts)
        late = valid & (panes < self.cleared_below)
        self.late_records += int(late.sum())
        valid = valid & ~late
        if valid.any():
            mn, mx = int(panes[valid].min()), int(panes[valid].max())
            if self.min_pane_seen is None or mn < self.min_pane_seen:
                self.min_pane_seen = mn
            if self.max_pane_seen is None or mx > self.max_pane_seen:
                self.max_pane_seen = mx
            if self.fired_below_end is not None:
                late_ok = valid & (panes < self.fired_below_end)
                if late_ok.any():
                    self.refire.update(self.plan.late_refire_ends(
                        panes[late_ok], self.fired_below_end,
                        self.watermark))
        return panes, valid

    # -- time side -------------------------------------------------------

    def begin_advance(self, wm: int) -> Optional[List[int]]:
        """None when the advance does nothing; else the sorted end panes
        to fire (first firings and pending re-fires), with the
        watermark, the frontier and the re-fire set updated."""
        if wm < self.watermark or (wm == self.watermark and not self.refire):
            return None
        prev = self.watermark
        self.watermark = wm
        ends = sorted(set(self.plan.enumerate_fire_ends(
            prev, wm, self.min_pane_seen, self.max_pane_seen))
            | self.refire)
        frontier = self.plan.fire_frontier(wm)
        if self.fired_below_end is None or frontier > self.fired_below_end:
            self.fired_below_end = frontier
        self.refire.clear()
        return ends

    def purge_horizon(self, wm: int) -> Optional[int]:
        """The new first dead pane when the horizon moved, else None;
        the caller drops state below it."""
        new_dead = self.plan.first_dead_pane(wm)
        if new_dead > self.cleared_below:
            self.cleared_below = new_dead
            return new_dead
        return None

    def final_watermark(self) -> int:
        return self.plan.final_watermark_for(
            self.watermark, self.max_pane_seen)

    # -- snapshot --------------------------------------------------------

    def snapshot(self) -> Dict[str, Any]:
        return {
            "watermark": self.watermark,
            "late_records": self.late_records,
            "refire": sorted(self.refire),
            "cleared_below": self.cleared_below,
            "fired_below_end": self.fired_below_end,
            "min_pane_seen": self.min_pane_seen,
            "max_pane_seen": self.max_pane_seen,
        }

    def restore(self, snap: Dict[str, Any]) -> None:
        self.watermark = snap["watermark"]
        self.late_records = snap["late_records"]
        self.refire = set(snap["refire"])
        self.cleared_below = snap["cleared_below"]
        self.fired_below_end = snap["fired_below_end"]
        self.min_pane_seen = snap["min_pane_seen"]
        self.max_pane_seen = snap["max_pane_seen"]
