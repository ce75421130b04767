"""Sinks consume fired/transformed batches on the host.

ref: Sink API v2 (flink-core/.../api/connector/sink2/{Sink,SinkWriter,
Committer}.java). The exactly-once contract: a transactional sink
buffers writes per checkpoint epoch, stages them at the checkpoint's
barrier (``prepare_commit``) and makes them visible only on
``notify_checkpoint_complete``, after the checkpoint is durable (the
two-phase-commit sink protocol); its staged epochs ride inside the
checkpoint, so a restore re-commits what the checkpoint proved and
drops the rest. ``CollectSink``, ``PrintSink``, ``FnSink`` and
``UpsertSink`` write through. The other 2PC sinks are the file
connector's ``FileSink`` (``connectors.py``) and the log tier's
``LogSink`` (``log/connectors.py``), both on ``TwoPhaseCommitSink``.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np


def rows_of(batch: Dict[str, np.ndarray]) -> List[Dict[str, Any]]:
    """Explode a columnar batch into per-record dicts (the row view
    every collecting/printing sink shares)."""
    if not batch:
        return []
    n = len(next(iter(batch.values())))
    return [{k: v[i] for k, v in batch.items()} for i in range(n)]


class Sink:
    # Whether this sink understands op-typed changelog rows
    # (records.OP_FIELD): folding -U/-D retractions instead of appending
    # them as if they were inserts. Append-only sinks fed a retract
    # stream silently double-count — the analyzer rule
    # CHANGELOG_SINK_MISMATCH keys on this attribute.
    changelog_capable = False

    def write(self, batch: Dict[str, np.ndarray]) -> None:
        raise NotImplementedError

    # -- exactly-once seam ------------------------------------------------
    def prepare_commit(self, checkpoint_id: int) -> None:
        """Stage everything written since the previous barrier under this
        checkpoint id (ref: SinkWriter.prepareCommit)."""

    def notify_checkpoint_complete(self, checkpoint_id: int) -> None:
        """Commit staged epochs <= checkpoint_id (ref: Committer.commit)."""

    def notify_checkpoint_abort(self, checkpoint_id: int) -> None:
        """The checkpoint covering this staged epoch failed before
        completing — the epoch's rows replay from source positions, so
        its staged transaction may be discarded (ref:
        CheckpointListener.notifyCheckpointAborted). Default no-op:
        non-transactional sinks have nothing staged."""

    def set_attempt_epoch(self, epoch: int) -> None:
        """The driver announces this attempt's fencing epoch before the
        run starts (``cluster.attempt``, the same counter that fences
        checkpoint storage as ``chk-<id>.e<epoch>``). Transactional
        sinks qualify in-progress artifacts with it so a deposed
        attempt restarting mid-commit can never clobber a successor's
        committed output. Default no-op."""

    # -- staged-transaction persistence seam ------------------------------
    # The reference's TwoPhaseCommitSinkFunction keeps pending transactions
    # IN STATE and re-commits them on restore — a crash between the
    # checkpoint write and the commit round must not lose the epoch.
    def snapshot_staged(self) -> Optional[Any]:
        """Staged-but-uncommitted transactions to persist in the
        checkpoint; None = sink is not transactional."""
        return None

    def restore_staged(self, staged: Any, checkpoint_id: int) -> None:
        """Re-commit staged epochs <= checkpoint_id (the checkpoint's
        completion proves they must become visible); abort the rest."""

    def close(self) -> None:
        pass


def sink_is_transactional(sink: "Sink") -> bool:
    """Whether a sink instance participates in exactly-once 2PC — it
    overrides the staging seam (``prepare_commit``) or the persistence
    seam (``snapshot_staged``). Single-sourced here so the driver and
    the plan analyzer (ROADMAP.md queue 1 item 11) never disagree about
    what "transactional" means."""
    cls = type(sink)
    return (cls.prepare_commit is not Sink.prepare_commit
            or cls.snapshot_staged is not Sink.snapshot_staged)


class TwoPhaseCommitSink(Sink):
    """Generalized pre-commit/commit transactional sink protocol (ref:
    TwoPhaseCommitSinkFunction + the FLIP-143 unified Sink's
    writer/committer split, generalized from SURVEY §3.9's
    rename-on-commit). The base owns the TRANSACTION bookkeeping; a
    subclass owns the in-memory buffer and the durable medium:

    - ``write()`` buffers rows in memory (subclass-owned shape);
    - ``prepare_commit(cid)`` (checkpoint barrier) calls
      ``stage_transaction(cid)``: the subclass makes everything
      buffered DURABLE under transaction ``cid`` — data plus a fsynced
      pre-commit marker — without making any of it visible;
    - ``notify_checkpoint_complete(cid)`` (checkpoint completion)
      commits every staged transaction with id <= cid in id order —
      ``commit_transaction`` is the atomic visibility point and must be
      idempotent (a restore replays commits);
    - ``notify_checkpoint_abort(cid)`` / ``abort_uncommitted()`` roll
      staged transactions back durably (their rows replay from source
      positions);
    - staged transactions additionally ride INSIDE the checkpoint
      payload (``snapshot_transaction``), so a crash that lands between
      the checkpoint's manifest write and the commit round — or a
      cleanup that deleted the staged artifacts — can always
      ``rebuild_transaction`` and re-commit on restore.
    """

    # -- subclass contract (durable-medium operations) --------------------
    def drop_pending(self) -> None:
        """Clear the in-memory (never-staged) buffer."""
        raise NotImplementedError

    def stage_transaction(self, cid: int) -> bool:
        """Durably stage everything buffered since the last barrier as
        transaction ``cid`` (data + pre-commit marker, fsynced) and
        clear the buffer. Return False when nothing was buffered (no
        empty transactions)."""
        raise NotImplementedError

    def staged_transaction_ids(self) -> List[int]:
        """Ids of transactions staged on the durable medium but not yet
        committed (sorted ascending)."""
        raise NotImplementedError

    def commit_transaction(self, cid: int) -> None:
        """Atomically publish transaction ``cid``. MUST be idempotent —
        restore replays commits — and a no-op for unknown ids (an empty
        epoch staged nothing)."""
        raise NotImplementedError

    def abort_transaction(self, cid: int) -> None:
        """Durably discard staged transaction ``cid`` (idempotent)."""
        raise NotImplementedError

    def snapshot_transaction(self, cid: int) -> Any:
        """Payload from which ``rebuild_transaction`` can reconstruct
        the staged transaction — rides inside the checkpoint."""
        raise NotImplementedError

    def rebuild_transaction(self, cid: int, payload: Any) -> None:
        """Re-create staged transaction ``cid`` from its checkpoint
        payload if it is no longer on the durable medium (idempotent;
        a commit_transaction call follows)."""
        raise NotImplementedError

    def cleanup_unreferenced(self) -> None:
        """Optional hook: sweep torn half-staged debris no marker
        references (a crash mid-stage). Default no-op."""

    # -- the protocol (driver-facing, final) ------------------------------
    def _live_staged(self) -> set:
        """Cids THIS instance staged rows for (stage_transaction
        returned True) and has not yet committed/aborted. The commit
        round walks the union of this set and the on-disk staged ids,
        so a staged transaction whose durable marker VANISHED before
        commit still reaches commit_transaction — where the medium can
        fail loudly instead of the epoch silently disappearing from
        the staged listing (lazy init: subclasses own __init__)."""
        s = getattr(self, "_live_staged_ids", None)
        if s is None:
            s = self._live_staged_ids = set()
        return s

    def prepare_commit(self, checkpoint_id: int) -> None:
        if self.stage_transaction(checkpoint_id):
            self._live_staged().add(int(checkpoint_id))

    def notify_checkpoint_complete(self, checkpoint_id: int) -> None:
        live = self._live_staged()
        for cid in sorted(set(self.staged_transaction_ids()) | live):
            if cid <= checkpoint_id:
                self.commit_transaction(cid)
                live.discard(cid)

    def notify_checkpoint_abort(self, checkpoint_id: int) -> None:
        if checkpoint_id in self.staged_transaction_ids():
            self.abort_transaction(checkpoint_id)
        self._live_staged().discard(int(checkpoint_id))

    def snapshot_staged(self) -> Any:
        return {"txn": {str(cid): self.snapshot_transaction(cid)
                        for cid in self.staged_transaction_ids()}}

    def restore_staged(self, staged: Any, checkpoint_id: int) -> None:
        self.drop_pending()
        self._live_staged().clear()  # staged knowledge now comes from
        # the checkpoint payload, not this instance's write history
        txns = {int(c): p
                for c, p in (staged or {}).get("txn", {}).items()}
        for cid in sorted(txns):
            if cid <= checkpoint_id:
                # the completed checkpoint proves this epoch must become
                # visible even though the commit round never ran; if an
                # abort deleted the staged artifacts in the meantime,
                # rebuild them from the payload first
                self.rebuild_transaction(cid, txns[cid])
                self.commit_transaction(cid)
        # anything still staged is either uncovered (replays from source
        # positions) or a dead attempt's leftovers — roll it back
        for cid in self.staged_transaction_ids():
            self.abort_transaction(cid)
        self.cleanup_unreferenced()

    def abort_uncommitted(self) -> None:
        self.drop_pending()
        for cid in self.staged_transaction_ids():
            self.abort_transaction(cid)
        self._live_staged().clear()
        self.cleanup_unreferenced()


@dataclasses.dataclass
class CollectSink(Sink):
    """Gather results in memory (ref: DataStream.executeAndCollect)."""

    rows: List[Dict[str, Any]] = dataclasses.field(default_factory=list)

    def write(self, batch: Dict[str, np.ndarray]) -> None:
        self.rows.extend(rows_of(batch))


@dataclasses.dataclass
class PrintSink(Sink):
    """ref: DataStream.print / PrintSinkFunction."""

    prefix: str = ""
    limit: Optional[int] = None
    _printed: int = 0

    def write(self, batch: Dict[str, np.ndarray]) -> None:
        for row in rows_of(batch):
            if self.limit is not None and self._printed >= self.limit:
                return
            print(f"{self.prefix}{row}")
            self._printed += 1


@dataclasses.dataclass
class FnSink(Sink):
    """Adapter for a plain callable(batch_dict). The callable receives
    raw batches — op columns included — so it is trusted to handle
    changelog streams (it sees records.OP_FIELD and can fold)."""

    fn: Callable[[Dict[str, np.ndarray]], None]
    changelog_capable = True

    def write(self, batch: Dict[str, np.ndarray]) -> None:
        self.fn(batch)


@dataclasses.dataclass
class UpsertSink(Sink):
    """Materialize an UPSERT stream as latest-row-by-key (ref: the
    upsert-kafka/table sink contract — each arriving row replaces the
    previous row with the same key tuple). Op-typed changelog rows
    (records.OP_FIELD) fold: +I/+U replace the key's row, -U/-D delete
    it (deleting on -U is safe AND necessary: in a full changelog the
    superseding +U follows in order and re-inserts, while after a
    HAVING-style filter a surviving -U with no +U partner IS the key
    leaving the view). ``view()`` returns the current table."""

    key_fields: Tuple[str, ...] = ("key",)
    state: Dict[Any, Dict[str, Any]] = dataclasses.field(
        default_factory=dict)
    changelog_capable = True

    def write(self, batch: Dict[str, np.ndarray]) -> None:
        from flink_tpu_torch.records import OP_DELETE, OP_FIELD, OP_UPDATE_BEFORE

        has_op = OP_FIELD in batch
        for row in rows_of(batch):
            op = int(row.pop(OP_FIELD)) if has_op else None
            k = tuple(row[f] for f in self.key_fields)
            if op in (OP_UPDATE_BEFORE, OP_DELETE):
                self.state.pop(k, None)
            else:
                self.state[k] = row

    def view(self) -> List[Dict[str, Any]]:
        return list(self.state.values())


@dataclasses.dataclass
class RetractSink(Sink):
    """Exactly-once changelog materialization: op-typed rows fold into a
    keyed table, and the table advances only when an epoch's checkpoint
    completes (ref: the table-runtime retract sink contract riding the
    TwoPhaseCommitSinkFunction protocol). -U/-D remove the key's row;
    +I/+U (re)place it; rows without an op column are upserts. Arrival
    order within an epoch is preserved, so a -U/+U pair nets to the
    update. Uncommitted epochs are discarded on restore — after
    recovery the table equals exactly what the restored checkpoint
    proved, then re-evolves from replayed input."""

    key_fields: Tuple[str, ...] = ("key",)
    table: Dict[Any, Dict[str, Any]] = dataclasses.field(
        default_factory=dict)
    changelog_capable = True

    def __post_init__(self) -> None:
        self._pending: List[Dict[str, Any]] = []
        self._staged: Dict[int, List[Dict[str, Any]]] = {}
        self._last_committed = 0

    def write(self, batch: Dict[str, np.ndarray]) -> None:
        self._pending.extend(rows_of(batch))

    def _apply(self, rows: List[Dict[str, Any]]) -> None:
        from flink_tpu_torch.records import OP_DELETE, OP_FIELD, OP_UPDATE_BEFORE

        for row in rows:
            row = dict(row)
            op = int(row.pop(OP_FIELD)) if OP_FIELD in row else None
            k = tuple(row[f] for f in self.key_fields)
            if op in (OP_UPDATE_BEFORE, OP_DELETE):
                self.table.pop(k, None)
            else:
                self.table[k] = row

    def view(self) -> List[Dict[str, Any]]:
        """The committed table, ordered by key tuple (deterministic
        across runs/restores — insertion order is an epoch artifact)."""
        return [self.table[k] for k in sorted(self.table)]

    # -- exactly-once protocol (TransactionalCollectSink's shape) ---------
    def prepare_commit(self, checkpoint_id: int) -> None:
        self._staged[checkpoint_id] = self._pending
        self._pending = []

    def notify_checkpoint_complete(self, checkpoint_id: int) -> None:
        for cid in sorted([c for c in self._staged if c <= checkpoint_id]):
            self._apply(self._staged.pop(cid))
            self._last_committed = max(self._last_committed, cid)

    def snapshot_staged(self) -> Any:
        # called AFTER prepare_commit(cid): the in-flight checkpoint's
        # own epoch rides inside its payload
        return {cid: list(rows) for cid, rows in self._staged.items()}

    def restore_staged(self, staged: Any, checkpoint_id: int) -> None:
        self._pending = []
        self._staged = {}
        for cid in sorted(staged):
            if cid <= checkpoint_id:
                # checkpoint N completing proves epoch N folds in;
                # the re-commit guard keeps the replay idempotent when
                # the same instance survives the restore
                if cid > self._last_committed:
                    self._apply(staged[cid])
                    self._last_committed = cid
            # epochs staged after the restored checkpoint replay from
            # source positions — drop them

    def abort_uncommitted(self) -> None:
        self._staged.clear()
        self._pending = []


@dataclasses.dataclass
class TransactionalCollectSink(Sink):
    """Exactly-once collect: rows become visible only when their epoch's
    checkpoint completes; uncommitted epochs are discarded on restore
    (the TwoPhaseCommitSinkFunction contract, ref: streaming/api/
    functions/sink/TwoPhaseCommitSinkFunction.java)."""

    committed: List[Dict[str, Any]] = dataclasses.field(default_factory=list)

    def __post_init__(self) -> None:
        self._pending: List[Dict[str, Any]] = []
        self._staged: Dict[int, List[Dict[str, Any]]] = {}
        self._last_committed = 0

    def write(self, batch: Dict[str, np.ndarray]) -> None:
        self._pending.extend(rows_of(batch))

    def prepare_commit(self, checkpoint_id: int) -> None:
        self._staged[checkpoint_id] = self._pending
        self._pending = []

    def notify_checkpoint_complete(self, checkpoint_id: int) -> None:
        for cid in sorted([c for c in self._staged if c <= checkpoint_id]):
            self.committed.extend(self._staged.pop(cid))
            self._last_committed = max(self._last_committed, cid)

    def snapshot_staged(self) -> Any:
        # called AFTER prepare_commit(cid) staged the current epoch, so the
        # epoch the in-flight checkpoint covers rides inside its own payload
        return {cid: list(rows) for cid, rows in self._staged.items()}

    def restore_staged(self, staged: Any, checkpoint_id: int) -> None:
        self._pending = []
        self._staged = {}
        for cid in sorted(staged):
            if cid <= checkpoint_id:
                # checkpoint N completing proves epoch N must be visible;
                # re-commit idempotently (a crash may have landed anywhere
                # between the manifest write and the commit round)
                if cid > self._last_committed:
                    self.committed.extend(staged[cid])
                    self._last_committed = cid
            # epochs staged after the restored checkpoint replay from
            # source positions — drop them

    def abort_uncommitted(self) -> None:
        """Fresh-start path (no checkpoint found): drop anything a prior
        attempt staged or buffered on this reused sink instance."""
        self._staged.clear()
        self._pending = []


class FileTransactionalSink(Sink):
    """Exactly-once FILE sink: epochs stage as ``staged/epoch-N.jsonl``
    at prepare time and become visible via atomic rename into
    ``committed/`` when their checkpoint completes — the classic
    write-ahead / rename-on-commit pattern (ref: FileSink +
    TwoPhaseCommitSinkFunction, flink-connectors/flink-connector-files).
    Because the staging ground is the filesystem, the transaction state
    survives PROCESS DEATH: a new attempt in a new process restores or
    aborts the crashed attempt's epochs from disk."""

    def __init__(self, directory: str) -> None:
        from flink_tpu_torch.fs import get_filesystem

        self.dir = directory
        self._fs = get_filesystem(directory)
        self._staged_dir = os.path.join(directory, "staged")
        self._committed_dir = os.path.join(directory, "committed")
        self._fs.mkdirs(self._staged_dir)
        self._fs.mkdirs(self._committed_dir)
        self._pending: List[Dict[str, Any]] = []

    @staticmethod
    def _jsonable(v: Any) -> Any:
        a = np.asarray(v)
        return int(v) if np.issubdtype(a.dtype, np.integer) else (
            float(v) if np.issubdtype(a.dtype, np.floating) else str(v))

    def _staged_path(self, cid: int) -> str:
        return os.path.join(self._staged_dir, f"epoch-{cid:010d}.jsonl")

    def _committed_path(self, cid: int) -> str:
        return os.path.join(self._committed_dir, f"epoch-{cid:010d}.jsonl")

    def write(self, batch: Dict[str, np.ndarray]) -> None:
        self._pending.extend(
            {k: self._jsonable(v) for k, v in row.items()}
            for row in rows_of(batch))

    def prepare_commit(self, checkpoint_id: int) -> None:
        from flink_tpu_torch.fs import write_atomic

        payload = "".join(
            json.dumps(row) + "\n" for row in self._pending)
        write_atomic(self._fs, self._staged_path(checkpoint_id),
                     payload.encode("utf-8"))
        self._pending = []

    def _commit_epoch(self, cid: int) -> None:
        sp, cp = self._staged_path(cid), self._committed_path(cid)
        if self._fs.exists(cp):
            # already committed (restore replays the commit idempotently)
            if self._fs.exists(sp):
                self._fs.delete(sp)
        elif self._fs.exists(sp):
            self._fs.rename(sp, cp)  # atomic: the commit point

    def _staged_cids(self) -> List[int]:
        return sorted(
            int(f[len("epoch-"):-len(".jsonl")])
            for f in self._fs.listdir(self._staged_dir)
            if f.startswith("epoch-") and f.endswith(".jsonl"))

    def notify_checkpoint_complete(self, checkpoint_id: int) -> None:
        for cid in self._staged_cids():
            if cid <= checkpoint_id:
                self._commit_epoch(cid)

    def snapshot_staged(self) -> Any:
        # staged ROWS ride inside the checkpoint payload, not just their
        # epoch ids: a cleanup between the manifest write and the commit
        # round may delete the staged FILES (abort_uncommitted on a
        # failed attempt), and the restore must then be able to
        # reconstruct the covered epoch from the payload — otherwise its
        # rows are gone (sources replay only post-checkpoint)
        epochs = {}
        for cid in self._staged_cids():
            with self._fs.open_read(self._staged_path(cid)) as f:
                raw = f.read()
            if isinstance(raw, bytes):
                raw = raw.decode("utf-8")
            epochs[str(cid)] = [
                json.loads(line) for line in raw.splitlines()
                if line.strip()]
        return {"epochs": epochs}

    def restore_staged(self, staged: Any, checkpoint_id: int) -> None:
        self._pending = []
        epochs = {int(c): rows for c, rows in staged.get("epochs", {}).items()}
        for cid, rows in sorted(epochs.items()):
            if cid > checkpoint_id:
                continue
            # the completed checkpoint proves this epoch must be
            # visible even though the commit round never ran; if the
            # staged file was deleted in the meantime, rebuild it from
            # the payload before committing
            if not self._fs.exists(self._committed_path(cid)):
                if not self._fs.exists(self._staged_path(cid)):
                    self._pending = rows
                    self.prepare_commit(cid)
                self._commit_epoch(cid)
        # anything still staged on disk is either uncovered (replays
        # from source positions) or a later attempt's leftovers — drop
        for cid in self._staged_cids():
            self._fs.delete(self._staged_path(cid))

    def abort_uncommitted(self) -> None:
        self._pending = []
        for cid in self._staged_cids():
            self._fs.delete(self._staged_path(cid))

    @classmethod
    def committed_rows(cls, directory: str) -> List[Dict[str, Any]]:
        """Read back every committed row (commit order) — the consumer
        view of the sink's output."""
        cdir = os.path.join(directory, "committed")
        rows: List[Dict[str, Any]] = []
        if not os.path.isdir(cdir):
            return rows
        for f in sorted(os.listdir(cdir)):
            if f.startswith("epoch-") and f.endswith(".jsonl"):
                with open(os.path.join(cdir, f)) as fh:
                    for line in fh:
                        if line.strip():
                            rows.append(json.loads(line))
        return rows
