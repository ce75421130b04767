"""Checkpoint coordination — trigger, collect, complete, restore.

ref: runtime/checkpoint/CheckpointCoordinator.java (triggerCheckpoint /
receiveAcknowledgeMessage / restoreLatestCheckpointedStateToAll) and the
task-side SubtaskCheckpointCoordinatorImpl.checkpointState.

A batch boundary of the driver loop is a global barrier: no in-band
barrier alignment, no channel state. A
checkpoint is: freeze (source positions, per-operator state snapshots,
watermarks), upload, mark complete, notify sinks to commit their staged
epoch. Exactly-once = replayable sources (positions) + state rollback +
transactional sinks.

Asynchrony (the HeapSnapshotStrategy async-part analogue, SURVEY §6.4):
the in-loop part of a checkpoint is only the FREEZE — sink staging plus
per-operator snapshots whose device leaves are clones enqueued on the
operator's CUDA stream (no device→host transfer, no synchronization,
no serialization). The expensive part — fetching the clones to the
host, encoding, writing, fsync — runs on a
background thread via ``trigger_async``; the 2PC commit happens only
after the manifest is durable, applied back on the loop thread when it
polls ``PendingCheckpoint`` (the asynchronous notifyCheckpointComplete
of the reference). Ingest never waits on storage.
"""
from __future__ import annotations

import dataclasses
import time
from concurrent.futures import Future
from typing import Any, Callable, Dict, List, Optional

import torch

from flink_tpu_torch.checkpoint.storage import (
    CheckpointHandle, FsCheckpointStorage, ReusedOpState)


def materialize_snapshot(obj: Any) -> Any:
    """Recursively fetch the tensor leaves of a frozen snapshot to host
    numpy arrays. Runs on the checkpoint executor's thread: the freeze
    left clones, enqueued on the operator's stream, in the tree, so this
    transfer leaves the loop. The copy goes on that thread's current
    stream, the device's default stream, which orders it after the
    clones; it blocks this thread only."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu().numpy()
    if isinstance(obj, dict):
        return {k: materialize_snapshot(v) for k, v in obj.items()}
    if isinstance(obj, tuple):
        return tuple(materialize_snapshot(v) for v in obj)
    if isinstance(obj, list):
        return [materialize_snapshot(v) for v in obj]
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return dataclasses.replace(obj, **{
            f.name: materialize_snapshot(getattr(obj, f.name))
            for f in dataclasses.fields(obj)})
    return obj


class PendingCheckpoint:
    """An in-flight async checkpoint: freeze done, persistence running.
    ``complete()`` (loop thread) blocks if needed, then commits the 2PC
    epoch and records stats; ``abandon()`` drops it without committing."""

    def __init__(self, coordinator: "CheckpointCoordinator", cid: int,
                 future: "Future[CheckpointHandle]",
                 commit_fns: List[Callable[[int], None]],
                 t0: float,
                 abort_fns: Optional[List[Callable[[int], None]]] = None,
                 ) -> None:
        self.coordinator = coordinator
        self.checkpoint_id = cid
        self.future = future
        self._commit_fns = commit_fns
        self._abort_fns = list(abort_fns or [])
        self._t0 = t0
        self._end_cell: List[Optional[float]] = [None]

    @property
    def persist_end(self) -> Optional[float]:
        return self._end_cell[0]

    def done(self) -> bool:
        return self.future.done()

    def complete(self) -> CheckpointHandle:
        handle = self.future.result()  # re-raises persistence errors
        for c in self._commit_fns:
            c(self.checkpoint_id)
        # size and persist duration were computed on the BACKGROUND
        # thread (handle fields); the loop-thread commit does no storage
        # I/O — that is the whole point of the async split
        self.coordinator.stats.append(CheckpointStats(
            self.checkpoint_id, int(self._t0 * 1000),
            (self.persist_end - self._t0) * 1000
            if self.persist_end else (time.time() - self._t0) * 1000,
            max(handle.size_bytes, 0)))
        return handle

    def abandon(self) -> None:
        """Drop the in-flight checkpoint without committing, and
        deliver ABORT notifications to the 2PC sinks (ref:
        CheckpointCoordinator.sendAbortedMessages →
        notifyCheckpointAborted): the epoch staged at this barrier
        replays from the previous checkpoint's source positions, so
        its staged transaction may be rolled back durably. Runs on the
        attempt's failure path — a broken abort hook must not mask the
        original failure, so errors are recorded, not raised."""
        self.future.cancel()
        from flink_tpu_torch.obs.tracing import tracer

        for a in self._abort_fns:
            try:
                a(self.checkpoint_id)
            except Exception as e:  # noqa: BLE001 — cleanup best-effort
                with tracer.span("checkpoint.abort-notify-failed",
                                 checkpoint_id=self.checkpoint_id,
                                 error=f"{type(e).__name__}: {e}"):
                    pass


@dataclasses.dataclass
class CheckpointStats:
    """ref: CheckpointStatsTracker — per-checkpoint visibility."""

    checkpoint_id: int
    trigger_ts_ms: int
    duration_ms: float
    size_bytes: int


class CheckpointCoordinator:
    def __init__(self, storage: FsCheckpointStorage) -> None:
        self.storage = storage
        self._next_id = 1
        self.stats: List[CheckpointStats] = []

    def trigger_async(
        self,
        snapshot_fn: Callable[[], Dict[str, Any]],
        commit_fns: List[Callable[[int], None]],
        prepare_fns: List[Callable[[int], None]],
        executor=None,
        savepoint: bool = False,
        abort_fns: Optional[List[Callable[[int], None]]] = None,
    ) -> PendingCheckpoint:
        """Freeze in the caller's thread, persist in the background:
        1. (loop) sinks stage their epoch (prepareCommit)
        2. (loop) freeze: snapshot tree with on-device cloned leaves
        3. (bg)   fetch leaves, serialize, write, manifest last
        4. (loop, via PendingCheckpoint.complete) sinks commit (2PC)
        """
        from flink_tpu_torch.obs.tracing import tracer

        cid = self._next_id
        self._next_id += 1
        t0 = time.time()
        # checkpoint spans (ref: CheckpointStatsTracker reporting
        # checkpointing spans through the trace reporters, SURVEY §6.1):
        # 'checkpoint.freeze' = the sync part stalling the loop,
        # 'checkpoint.persist' = the async upload — the two durations
        # that matter are separate spans, not one blended number
        with tracer.span("checkpoint.freeze", checkpoint_id=cid,
                         savepoint=savepoint):
            for p in prepare_fns:
                p(cid)
            payload = snapshot_fn()
        payload["checkpoint_id"] = cid
        end_cell: List[Optional[float]] = [None]

        def persist() -> CheckpointHandle:
            psp = tracer.span("checkpoint.persist", checkpoint_id=cid)
            try:
                with psp:
                    # the async-upload fault seam: a raise here fails the
                    # persistence future exactly like a dead background
                    # uploader — the loop thread sees it at complete()
                    from flink_tpu_torch import faults

                    faults.fire("checkpoint.upload", exc=OSError,
                                checkpoint_id=cid)
                    from flink_tpu_torch.fs import enospc_retry

                    mat = materialize_snapshot(payload)
                    ops = mat.pop("operators", None)
                    if ops is None:
                        # whole-save ENOSPC retry: each attempt writes a FRESH
                        # unique tmp dir, so a failed attempt leaves
                        # only sweepable debris — retention freeing
                        # space between attempts is the degrade path
                        h = enospc_retry(lambda: self.storage.save(
                            cid, mat, savepoint=savepoint))
                    else:
                        blobs: Dict[str, bytes] = {}
                        reuse: Dict[str, ReusedOpState] = {}
                        op_aux: Dict[str, Dict[str, str]] = {}
                        from flink_tpu_torch.checkpoint import blobformat

                        for nid, snap in ops.items():
                            if isinstance(snap, ReusedOpState):
                                reuse[str(nid)] = snap
                            else:
                                # the changelog plane (lsm runs): the
                                # files named here ride as hardlinks,
                                # never through the serializer
                                if isinstance(snap, dict):
                                    aux = snap.pop("__aux_files__", None)
                                    if aux:
                                        op_aux[str(nid)] = aux
                                # self-describing v3 blob, not pickle
                                blobs[str(nid)] = blobformat.encode(snap)
                        h = enospc_retry(lambda: self.storage.save_v2(
                            cid, mat, blobs, reuse, savepoint=savepoint,
                            op_aux=op_aux))
                    psp.set("bytes", getattr(h, "size_bytes", None))
                    return h
            finally:
                end_cell[0] = time.time()

        if executor is None:
            fut: Future = Future()
            try:
                fut.set_result(persist())
            except BaseException as e:  # sync fallback mirrors a bg error
                fut.set_exception(e)
        else:
            fut = executor.submit(persist)
        pend = PendingCheckpoint(self, cid, fut, commit_fns, t0,
                                 abort_fns=abort_fns)
        pend._end_cell = end_cell
        return pend

    def restore_latest(self) -> Optional[Dict[str, Any]]:
        from flink_tpu_torch.obs.tracing import tracer

        h = self.storage.latest()
        if h is None:
            return None
        with tracer.span("restore", path=getattr(h, "path", None)) as sp:
            payload = FsCheckpointStorage.load(h)
            sp.set("checkpoint_id", payload.get("checkpoint_id"))
        self.resume_numbering(payload)
        return payload

    def resume_numbering(self, payload: Dict[str, Any]) -> None:
        """Checkpoint ids must keep increasing across restores — id reuse
        would clobber retained checkpoints and replay 2PC epoch ids
        (ref: CheckpointIDCounter in HA services)."""
        self._next_id = max(self._next_id,
                            int(payload.get("checkpoint_id", 0)) + 1)
