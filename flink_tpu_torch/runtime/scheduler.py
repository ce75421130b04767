"""The coordinator's physical-plan layer and the wave scheduler of batch
mode, the JAX package's ``runtime/scheduler.py``.

- Streaming (the job coordinator, ``runtime/coordinator.py``):
  ``Execution`` / ``ExecutionVertex`` / ``ExecutionGraph`` track each
  (stage, subtask)'s attempts once the runner reports its compiled plan;
  ``SlotPool`` counts a runner's devices as its slots, and a job asking
  for ``cluster.mesh-devices`` lands on the runner with the fewest free
  devices that still fit (else it waits for resources). A job deploys as
  one program over its devices, so any failure restarts the whole
  region.
- Batch (``execution.runtime-mode: batch``): ``BatchStage`` and
  ``BatchStageScheduler``: the compiler's stage levels
  (``graph/compiler.py`` ``assign_stages``) become a list of waves that
  the driver runs one after the other, each to completion, its blocking
  outputs spooled (``exchange/blocking.py``) before the next starts.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Tuple

__all__ = ["Execution", "ExecutionVertex", "ExecutionGraph", "SlotPool",
           "BatchStage", "BatchStageScheduler"]


@dataclasses.dataclass
class Execution:
    """One attempt of one subtask (ref: Execution.java)."""
    attempt: int
    runner_id: str
    state: str = "DEPLOYING"  # DEPLOYING RUNNING FAILED FINISHED CANCELED
    created_at: float = dataclasses.field(default_factory=time.time)


@dataclasses.dataclass
class ExecutionVertex:
    """One subtask of one stage (ref: ExecutionVertex.java)."""
    stage: str
    subtask: int
    executions: List[Execution] = dataclasses.field(default_factory=list)

    @property
    def current(self) -> Optional[Execution]:
        return self.executions[-1] if self.executions else None


class ExecutionGraph:
    """Physical graph of one job. Stages arrive when the runner reports
    its compiled plan (the runner compiles — the coordinator never
    imports job code; ref: ExecutionGraph built from JobGraph, except
    the JobGraph here lives runner-side as the entry point's pipeline).
    Until then the graph tracks whole-job executions against a single
    placeholder stage."""

    def __init__(self, job_id: str, parallelism: int) -> None:
        self.job_id = job_id
        self.parallelism = max(1, parallelism)
        self.stages: List[str] = ["(pending plan)"]
        self.vertices: List[ExecutionVertex] = []
        self._materialize()

    def _materialize(self) -> None:
        self.vertices = [
            ExecutionVertex(s, i)
            for s in self.stages for i in range(self.parallelism)]

    def set_parallelism(self, parallelism: int) -> None:
        """Re-width the graph once a demand of 'all devices' resolves
        against the chosen runner; current attempt history carries over
        onto every vertex (one SPMD program is every subtask)."""
        history = self.vertices[0].executions if self.vertices else []
        self.parallelism = max(1, parallelism)
        self.vertices = [
            ExecutionVertex(s, i, [dataclasses.replace(e) for e in history])
            for s in self.stages for i in range(self.parallelism)]

    def set_stages(self, stages: List[str]) -> None:
        """Runner reported its compiled plan: re-key the placeholder
        vertices onto real stage names, preserving attempt history of
        the current deployment (copied onto every stage — one SPMD
        program IS every stage)."""
        if not stages or stages == self.stages:
            return
        history = self.vertices[0].executions if self.vertices else []
        self.stages = list(stages)
        self.vertices = [
            ExecutionVertex(s, i, [dataclasses.replace(e) for e in history])
            for s in self.stages for i in range(self.parallelism)]

    def start_attempt(self, attempt: int, runner_id: str) -> None:
        for v in self.vertices:
            v.executions.append(Execution(attempt, runner_id))

    def transition(self, state: str, attempt: Optional[int] = None) -> None:
        """Move every vertex's newest execution (optionally gated on the
        attempt number — a stale attempt's report must not repaint a
        newer deployment's states)."""
        for v in self.vertices:
            e = v.current
            if e is not None and (attempt is None or e.attempt == attempt):
                if e.state not in ("FAILED", "FINISHED", "CANCELED"):
                    e.state = state

    def snapshot(self) -> dict:
        return {
            "job_id": self.job_id,
            "parallelism": self.parallelism,
            "stages": list(self.stages),
            "vertices": [
                {"stage": v.stage, "subtask": v.subtask,
                 "attempts": [
                     {"attempt": e.attempt, "runner": e.runner_id,
                      "state": e.state} for e in v.executions]}
                for v in self.vertices],
        }


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


class SlotPool:
    """Device-slot accounting across runners (ref: SlotManager's slot
    inventory + DeclarativeSlotPool). Pure bookkeeping — callers hold
    the coordinator lock."""

    # sentinel demand: "every device of whichever runner is chosen"
    # (cluster.mesh-devices: all) — fits only a fully-free runner and
    # reserves its whole capacity
    ALL = -1

    def __init__(self) -> None:
        # job_id -> (runner_id, devices); a cross-host job additionally
        # holds one entry per extra process in _multi
        self._allocations: Dict[str, tuple] = {}
        self._multi: Dict[str, List[tuple]] = {}

    def used_devices(self, runner_id: str) -> int:
        used = sum(d for r, d in self._allocations.values()
                   if r == runner_id)
        used += sum(d for allocs in self._multi.values()
                    for r, d in allocs if r == runner_id)
        return used

    def free_devices(self, runner_id: str, total: int) -> int:
        return total - self.used_devices(runner_id)

    def allocate(self, job_id: str, runner_id: str, devices: int) -> None:
        self._allocations[job_id] = (runner_id, devices)

    def allocate_multi(self, job_id: str,
                       allocs: List[tuple]) -> None:
        """Cross-host job: one (runner, devices) entry per process.
        ``allocation`` reports the head entry for single-target
        callers; ``allocations`` reports them all."""
        self._allocations[job_id] = allocs[0]
        self._multi[job_id] = list(allocs[1:])

    def release(self, job_id: str) -> None:
        self._allocations.pop(job_id, None)
        self._multi.pop(job_id, None)

    def allocation(self, job_id: str) -> Optional[tuple]:
        return self._allocations.get(job_id)

    def allocations(self, job_id: str) -> List[tuple]:
        head = self._allocations.get(job_id)
        if head is None:
            return []
        return [head] + self._multi.get(job_id, [])

    def pick(self, job_id: str, devices: int, runners: List,
             exclude: Optional[List[str]] = None):
        """Choose the alive gateway runner with the FEWEST free devices
        that still fit (best-fit packing leaves big runners open for big
        jobs). Returns the runner or None (→ WAITING_FOR_RESOURCES)."""
        exclude = exclude or []
        fits = []
        for r in runners:
            if not (r.alive and r.port) or r.runner_id in exclude:
                continue
            need = r.n_devices if devices == self.ALL else devices
            if self.free_devices(r.runner_id, r.n_devices) >= need:
                fits.append(r)
        if not fits:
            return None
        return min(fits, key=lambda r: self.free_devices(
            r.runner_id, r.n_devices))
