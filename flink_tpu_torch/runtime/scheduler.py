"""The wave scheduler of batch mode (``execution.runtime-mode: batch``),
the JAX package's ``BatchStage`` and ``BatchStageScheduler``: the
compiler's stage levels (``graph/compiler.py`` ``assign_stages``) become
a list of waves that the driver runs one after the other, each to
completion, its blocking outputs spooled (``exchange/blocking.py``)
before the next starts.

The rest of the JAX package's module (``Execution``, ``ExecutionVertex``,
``ExecutionGraph`` and ``SlotPool``) belongs to its job coordinator and
comes with it (ROADMAP.md queue 1 item 10).
"""
from __future__ import annotations

import dataclasses
import time
from typing import List, Tuple

__all__ = ["BatchStage", "BatchStageScheduler"]


@dataclasses.dataclass
class BatchStage:
    """One topological wave of a batch plan. ``heads`` pull the wave's
    input: the sources in wave 0, after it the stateful consumers of
    sealed partitions; ``in_edges`` are the blocking edges whose
    partition files the wave replays, complete before it starts."""

    index: int
    nodes: List[int]
    heads: List[int]
    in_edges: List[Tuple[int, int]]
    state: str = "CREATED"  # CREATED RUNNING FINISHED
    started_at: float = 0.0
    finished_at: float = 0.0


class BatchStageScheduler:
    """The waves of a batch-compiled plan in order, each wave's nodes in
    topological order."""

    def __init__(self, plan) -> None:
        if plan.runtime_mode != "batch" or not plan.stage_of:
            raise ValueError(
                "BatchStageScheduler needs a batch-compiled plan "
                "(execution.runtime-mode=batch)")
        self.plan = plan
        by_level: List[List[int]] = [
            [] for _ in range(max(plan.stage_of.values()) + 1)]
        for nid in plan.topo_order:
            by_level[plan.stage_of[nid]].append(nid)
        consumers = {v for _, v in plan.blocking_edges}
        self.waves: List[BatchStage] = []
        for level, nids in enumerate(by_level):
            if level == 0:
                heads = [nid for nid in nids
                         if plan.node(nid).kind == "source"]
            else:
                heads = [nid for nid in nids if nid in consumers]
            self.waves.append(BatchStage(
                index=level, nodes=nids, heads=heads,
                in_edges=[(u, v) for u, v in plan.blocking_edges
                          if plan.stage_of[v] == level]))

    def start(self, stage: BatchStage) -> None:
        stage.state = "RUNNING"
        stage.started_at = time.time()

    def finish(self, stage: BatchStage) -> None:
        stage.state = "FINISHED"
        stage.finished_at = time.time()

    def snapshot(self) -> dict:
        return {"waves": [
            {"index": s.index, "state": s.state, "heads": list(s.heads),
             "nodes": [f"{self.plan.node(n).kind}:"
                       f"{self.plan.node(n).name or n}" for n in s.nodes],
             "wall_s": (round(s.finished_at - s.started_at, 3)
                        if s.finished_at else None)}
            for s in self.waves]}
