"""Checkpoint storage: the durable snapshot layout and retention, the
JAX package's layout file for file, so either package loads the
other's checkpoints.

Layout:
    <root>/<job_id>/chk-<n>/state.pkl      operator + source snapshots
    <root>/<job_id>/chk-<n>/MANIFEST.json  metadata; written LAST —
                                           a checkpoint without a
                                           manifest is incomplete and
                                           ignored/garbage-collected
Savepoints are the same format under <root>/<job_id>/savepoint-<n>/
(ref: SavepointType — manually triggered, never auto-retired).

Format v2 (incremental, the RocksDB shared-SST analogue): operator
state splits into per-operator blob files
    <chk>/meta.pkl            everything except operator state
    <chk>/op-<nid>.pkl        one operator's snapshot
    <chk>/MANIFEST.json       format_version 2 + per-op file+version map
An operator UNCHANGED since the base checkpoint (same state_version) is
not re-serialized: its blob is HARDLINKED from the base checkpoint's
file (falling back to copy), so an idle operator costs zero bytes of
new serialization and the link survives the base's retirement (inode
refcount — exactly how RocksDB incremental checkpoints share SSTs).

Format v3 keeps v2's directory layout (files named *.blob) but every
payload is the SELF-DESCRIBING binary format of
``checkpoint/blobformat.py`` (JSON-schema'd tree + raw array section)
instead of pickle — restorable across code changes and readable from
non-Python tooling (ref: TypeSerializerSnapshot's schema-evolution
role, SURVEY §3.1). v1/v2 pickle checkpoints remain loadable, and a v3
incremental checkpoint may hardlink op blobs written by a v2 base —
the loader dispatches per blob on the magic bytes.

The changelog plane (the manifest's ``aux``): an LSM state tier's
sealed, immutable run files ride a checkpoint as hardlinks
(``<chk>/st-<nid>-<run name>``, fault point ``state.changelog.link``)
instead of being re-serialized, so checkpoint bytes scale with the
write rate, not the state size; ``load`` hands each operator the paths
of its files (``__aux_paths__``, and ``op_aux_paths`` for all).
"""
from __future__ import annotations

import dataclasses
import json
import os
import pickle
import time
import zlib
from typing import Any, Dict, List, Optional

from flink_tpu_torch import faults
from flink_tpu_torch.fs import FileSystem, get_filesystem, open_write_sync


@dataclasses.dataclass
class CheckpointHandle:
    checkpoint_id: int
    path: str
    timestamp_ms: int
    is_savepoint: bool = False
    # writer's leader epoch (manifest + dir-name qualified when > 0):
    # among same-id checkpoints the highest epoch is the live timeline
    epoch: int = 0
    size_bytes: int = -1  # filled by save/save_v2 (background thread)
    # op blob file names as written (save_v2 only): the incremental
    # reuse base must reference the ACTUAL names — a reused blob keeps
    # its lineage's extension across format upgrades
    op_files: Optional[Dict[str, str]] = None
    # per-op changelog aux files as written (save_v2 only): nid ->
    # {logical name -> file name under path}. The next checkpoint's
    # reuse base links THESE, not the store's live files, so aux
    # survives the base's retirement (inode refcount, as for op blobs)
    op_aux: Optional[Dict[str, Dict[str, str]]] = None


@dataclasses.dataclass
class ReusedOpState:
    """Marker in a snapshot's operators map: this operator's state is
    unchanged since the base checkpoint — reuse (hardlink) its blob
    instead of re-serializing. ``file`` is the absolute path of the base
    checkpoint's op blob; ``version`` the operator state_version it
    captured; ``aux`` the base's changelog aux files (logical name ->
    absolute path) to re-link alongside the blob."""

    file: str
    version: int
    aux: Optional[Dict[str, str]] = None


class StaleCheckpointWriter(RuntimeError):
    """A deposed leader's writer tried to persist after a successor
    (higher epoch) already wrote — the write was fenced off."""


class FsCheckpointStorage:
    """All storage I/O goes through the FileSystem seam (flink_tpu.fs)
    — the checkpoint dir may live on any registered scheme (ref:
    FsCheckpointStorage resolving its path via FileSystem.get)."""

    def __init__(self, root: str, job_id: str, retained: int = 3,
                 compression: str = "none", epoch: int = 0) -> None:
        if compression not in ("none", "zlib"):
            raise ValueError(
                f"compression must be 'none' or 'zlib', got {compression!r}")
        self.root = root
        self.job_id = job_id
        self.retained = max(1, retained)
        self.compression = compression
        # leader-epoch fence (ref: the HA fencing token on RPCs, applied
        # to STORAGE writes): a deposed leader's in-flight persist must
        # not clobber a successor's checkpoints. Manifests record the
        # writer's epoch; any write aborts when the store already holds
        # a manifest from a HIGHER epoch. 0 = unfenced single-writer
        # (local driver without HA).
        self.epoch = epoch
        self.fs: FileSystem = get_filesystem(root)
        self.job_dir = os.path.join(root, job_id)
        self.fs.mkdirs(self.job_dir)

    def _check_fence(self) -> None:
        """Abort the write when ANY completed manifest carries a higher
        epoch — this writer has been deposed and its snapshot belongs
        to a dead timeline. Check-then-rename is not atomic; the lease
        interval bounds the race the same way it bounds RPC fencing."""
        if self.epoch == 0:
            return
        for h in self.list_complete():
            # handles carry the manifest's epoch — no second read
            if h.epoch > self.epoch:
                raise StaleCheckpointWriter(
                    f"checkpoint write fenced: store holds epoch "
                    f"{h.epoch} > this writer's {self.epoch} "
                    f"(deposed leader finishing late)")

    def _dir(self, checkpoint_id: int, savepoint: bool) -> str:
        prefix = "savepoint" if savepoint else "chk"
        # epoch-QUALIFIED final name under HA fencing: a deposed leader
        # renaming late lands on chk-<id>.e<oldEpoch>, a DIFFERENT path
        # from the successor's chk-<id>.e<newEpoch> — a stale writer can
        # never delete-and-replace a higher-epoch directory, closing the
        # check-then-rename window _check_fence alone leaves open.
        # latest()/list_complete pick the highest (id, epoch). Unfenced
        # local runs (epoch 0) keep the plain layout.
        if self.epoch and not savepoint:
            return os.path.join(
                self.job_dir, f"{prefix}-{checkpoint_id}.e{self.epoch}")
        return os.path.join(self.job_dir, f"{prefix}-{checkpoint_id}")

    def _tmp_dir(self, d: str) -> str:
        """Fresh UNIQUE in-progress dir: an abandoned background persist
        from a failed attempt may still be writing when a restarted
        attempt reuses the checkpoint id — distinct tmp dirs mean each
        writer produces a self-consistent directory, and the final
        atomic rename makes whole-dir last-writer-wins (never an
        interleaved mix of two attempts' files)."""
        import uuid

        tmp = f"{d}.inprogress.{os.getpid()}.{uuid.uuid4().hex[:8]}"
        self.fs.mkdirs(tmp)
        return tmp

    def save(self, checkpoint_id: int, payload: Dict[str, Any],
             savepoint: bool = False) -> CheckpointHandle:
        """Write snapshot; manifest lands last so readers only ever see
        complete checkpoints (the atomic-rename pattern of
        FsCompletedCheckpointStorageLocation)."""
        from flink_tpu_torch.checkpoint import blobformat

        d = self._dir(checkpoint_id, savepoint)
        tmp = self._tmp_dir(d)
        faults.fire("checkpoint.storage.stall", exc=OSError,
                    checkpoint_id=checkpoint_id)
        faults.fire("checkpoint.storage.write", exc=OSError,
                    checkpoint_id=checkpoint_id)
        # sync-on-close (the fs seam's durability barrier): every byte
        # of the checkpoint is on stable storage BEFORE the rename
        # publishes the directory — a power cut can lose the rename
        # (the checkpoint never existed; restore takes the previous
        # one) but can never publish torn content at the final name
        with open_write_sync(self.fs, os.path.join(tmp, "state.blob"),
                             sync=True) as f:
            f.write(self._pack(blobformat.encode(payload)))
        ts = int(time.time() * 1000)
        faults.fire("checkpoint.storage.fsync", exc=OSError,
                    checkpoint_id=checkpoint_id)
        with open_write_sync(self.fs, os.path.join(tmp, "MANIFEST.json"),
                             sync=True) as f:
            f.write(json.dumps({
                "checkpoint_id": checkpoint_id,
                "timestamp_ms": ts,
                "job_id": self.job_id,
                "savepoint": savepoint,
                "format_version": 3,
                "layout": "single",
                "compression": self.compression,
                "epoch": self.epoch,
            }).encode())
        try:
            self._check_fence()
        except StaleCheckpointWriter:
            try:
                self.fs.delete(tmp, recursive=True)
            except OSError:
                pass  # the FENCE is the signal — a failed tmp sweep
                # (now loud at the fs layer) must not replace it with a
                # generic persist error the retry machinery would chase
            raise
        # a rename fault here is the TORN-manifest scenario: the tmp dir
        # is fully written (manifest included) but never reaches its
        # final name — list_complete must keep ignoring it
        faults.fire("checkpoint.storage.rename", exc=OSError,
                    checkpoint_id=checkpoint_id)
        if self.fs.exists(d):
            self.fs.delete(d, recursive=True)
        self.fs.rename(tmp, d)
        # entry durability: the rename that published the checkpoint is
        # a directory mutation — fsync the job dir so 'save returned'
        # implies 'restore will find it' across a power cut
        self.fs.fsync(self.job_dir)
        if not savepoint:
            self._retire_old()
        return CheckpointHandle(checkpoint_id, d, ts, savepoint,
                                epoch=self.epoch, size_bytes=_dir_size(d))

    def save_v2(self, checkpoint_id: int, meta_payload: Dict[str, Any],
                op_blobs: Dict[str, bytes],
                op_reuse: Dict[str, "ReusedOpState"],
                savepoint: bool = False,
                op_aux: Optional[Dict[str, Dict[str, str]]] = None
                ) -> CheckpointHandle:
        """Incremental format: per-operator blob files; unchanged
        operators hardlink the base checkpoint's blob. ``op_aux`` (nid
        -> {logical name -> source path}) is the changelog plane: each
        named file, an LSM tier's sealed, immutable, already durable
        run, is hardlinked into the checkpoint instead of re-serialized.
        Manifest lands last, exactly like v1."""
        from flink_tpu_torch.checkpoint import blobformat

        d = self._dir(checkpoint_id, savepoint)
        tmp = self._tmp_dir(d)
        faults.fire("checkpoint.storage.stall", exc=OSError,
                    checkpoint_id=checkpoint_id)
        faults.fire("checkpoint.storage.write", exc=OSError,
                    checkpoint_id=checkpoint_id)
        versions: Dict[str, int] = {}
        op_files: Dict[str, str] = {}
        for nid, blob in op_blobs.items():
            fn = f"op-{nid}.blob"
            with open_write_sync(self.fs, os.path.join(tmp, fn),
                                 sync=True) as f:
                f.write(self._pack(blob))
            op_files[nid] = fn
            versions[nid] = meta_payload.get(
                "op_versions", {}).get(nid, -1)
        aux_links: Dict[str, Dict[str, str]] = {}

        def _link_aux(nid: str, mapping: Dict[str, str]) -> None:
            for logical, src in sorted(mapping.items()):
                fn = f"st-{nid}-{logical}"
                faults.fire("state.changelog.link", exc=OSError,
                            checkpoint_id=checkpoint_id, file=logical)
                self.fs.link_or_copy(src, os.path.join(tmp, fn))
                aux_links.setdefault(nid, {})[logical] = fn

        for nid, mapping in (op_aux or {}).items():
            _link_aux(nid, mapping)
        for nid, ref in op_reuse.items():
            # reuse keeps the BASE's file name (it may be a v2 .pkl
            # pickle blob — the loader dispatches on magic bytes)
            fn = f"op-{nid}{os.path.splitext(ref.file)[1]}"
            self.fs.link_or_copy(ref.file, os.path.join(tmp, fn))
            op_files[nid] = fn
            versions[nid] = ref.version
            if ref.aux:
                # an idle operator's changelog is its base's aux set,
                # re-linked so this checkpoint stays self-locating
                _link_aux(nid, ref.aux)
        if op_reuse or aux_links:
            # entry durability for the REUSE links: a hardlink is a
            # directory mutation the blobs' content fsyncs never cover
            # — without this dir barrier a power cut after save_v2
            # returned could keep the (durable) manifest while the
            # linked op-blob entry vanished, leaving an acked
            # checkpoint that cannot load (the crash explorer's
            # CheckpointTier.check_image guards this)
            self.fs.fsync(tmp)
        with open_write_sync(self.fs, os.path.join(tmp, "meta.blob"),
                             sync=True) as f:
            f.write(self._pack(blobformat.encode(meta_payload)))
        ts = int(time.time() * 1000)
        faults.fire("checkpoint.storage.fsync", exc=OSError,
                    checkpoint_id=checkpoint_id)
        with open_write_sync(self.fs, os.path.join(tmp, "MANIFEST.json"),
                             sync=True) as f:
            f.write(json.dumps({
                "checkpoint_id": checkpoint_id,
                "timestamp_ms": ts,
                "job_id": self.job_id,
                "savepoint": savepoint,
                "format_version": 3,
                "compression": self.compression,
                "ops": {nid: {"file": fn, "version": versions[nid]}
                        for nid, fn in op_files.items()},
                "aux": aux_links,
                "epoch": self.epoch,
            }).encode())
        try:
            self._check_fence()
        except StaleCheckpointWriter:
            try:
                self.fs.delete(tmp, recursive=True)
            except OSError:
                pass  # keep the fence signal (see save())
            raise
        faults.fire("checkpoint.storage.rename", exc=OSError,
                    checkpoint_id=checkpoint_id)
        if self.fs.exists(d):
            self.fs.delete(d, recursive=True)
        self.fs.rename(tmp, d)
        self.fs.fsync(self.job_dir)  # entry durability (see save())
        if not savepoint:
            self._retire_old()
        return CheckpointHandle(checkpoint_id, d, ts, savepoint,
                                epoch=self.epoch, size_bytes=_dir_size(d),
                                op_files=dict(op_files),
                                op_aux={n: dict(m)
                                        for n, m in aux_links.items()})

    def list_complete(self) -> List[CheckpointHandle]:
        out = []
        for name in self.fs.listdir(self.job_dir):
            if ".inprogress." in name:
                # an unrenamed writer dir is NOT complete even though
                # its manifest file exists inside (manifest-last only
                # holds for the FINAL name; a fenced/abandoned writer
                # leaves its tmp behind)
                continue
            d = os.path.join(self.job_dir, name)
            mf = os.path.join(d, "MANIFEST.json")
            if not self.fs.exists(mf):
                continue
            try:
                with self.fs.open_read(mf) as f:
                    m = json.loads(f.read().decode())
                out.append(CheckpointHandle(
                    m["checkpoint_id"], d, m["timestamp_ms"],
                    m.get("savepoint", False),
                    epoch=int(m.get("epoch", 0))))
            except (json.JSONDecodeError, KeyError):
                continue
        # (epoch, id) order — EPOCH FIRST: the epoch is the leadership
        # fencing token, so the newest timeline outranks any id from a
        # dead one. A deposed leader's late chk-9.e1 must not eclipse
        # the successor's chk-6..8.e2 (restoring the dead timeline
        # would rewind sources past output the live timeline's 2PC
        # sinks already committed); it also sorts FIRST here, so
        # retention retires it before anything live.
        return sorted(out, key=lambda h: (h.epoch, h.checkpoint_id))

    def latest(self) -> Optional[CheckpointHandle]:
        hs = [h for h in self.list_complete() if not h.is_savepoint]
        return hs[-1] if hs else None

    @staticmethod
    def load(handle_or_path) -> Dict[str, Any]:
        path = getattr(handle_or_path, "path", handle_or_path)
        fs = get_filesystem(path)
        mf_path = os.path.join(path, "MANIFEST.json")
        fmt = 1
        manifest: Dict[str, Any] = {}
        if fs.exists(mf_path):
            with fs.open_read(mf_path) as f:
                manifest = json.loads(f.read().decode())
            fmt = manifest.get("format_version", 1)
        comp = manifest.get("compression", "none")
        if fmt == 1 or manifest.get("layout") == "single":
            name = "state.blob" if fmt >= 3 else "state.pkl"
            with fs.open_read(os.path.join(path, name)) as f:
                return _decode_blob(_unpack(f.read(), comp))
        meta_name = "meta.blob" if fmt >= 3 else "meta.pkl"
        with fs.open_read(os.path.join(path, meta_name)) as f:
            payload = _decode_blob(_unpack(f.read(), comp))
        ops: Dict[Any, Any] = {}
        versions: Dict[Any, int] = {}
        for nid, entry in manifest.get("ops", {}).items():
            with fs.open_read(os.path.join(path, entry["file"])) as f:
                # node ids are ints in the live plan; the manifest's JSON
                # keys are strings — restore the original type. Blob
                # contents dispatch on magic bytes: a v3 checkpoint may
                # hardlink a v2 base's pickle blob and vice versa.
                ops[int(nid)] = _decode_blob(_unpack(f.read(), comp))
            versions[int(nid)] = entry["version"]
        payload["operators"] = ops
        payload["op_file_versions"] = versions
        payload["op_file_compression"] = comp
        payload["op_files"] = {
            int(nid): os.path.join(path, e["file"])
            for nid, e in manifest.get("ops", {}).items()}
        # changelog aux (lsm runs): absolute paths, injected into each
        # operator's snapshot so its restore finds the run files
        aux_paths = {
            int(nid): {logical: os.path.join(path, fn)
                       for logical, fn in m.items()}
            for nid, m in manifest.get("aux", {}).items()}
        for nid, m in aux_paths.items():
            if isinstance(ops.get(nid), dict):
                ops[nid]["__aux_paths__"] = m
        payload["op_aux_paths"] = aux_paths
        return payload

    def _pack(self, raw: bytes) -> bytes:
        return zlib.compress(raw, 6) if self.compression == "zlib" else raw

    def _retire_old(self) -> None:
        """Best-effort retention: a retire/sweep failure must never fail
        the checkpoint that just committed (the old shutil path used
        ignore_errors=True; the seam re-establishes that contract for
        every backend, not just the local one)."""
        hs = [h for h in self.list_complete() if not h.is_savepoint]
        for h in hs[: -self.retained]:
            try:
                self.fs.delete(h.path, recursive=True)
            except OSError:
                pass
        # sweep orphaned in-progress dirs
        try:
            names = self.fs.listdir(self.job_dir)
        except OSError:
            names = []
        for name in names:
            if ".inprogress" in name:
                try:
                    self.fs.delete(os.path.join(self.job_dir, name),
                                   recursive=True)
                except OSError:
                    pass


def _dir_size(d: str) -> int:
    """Best-effort stats walk: a concurrently-retired directory (a
    restarted attempt's sweep) yields a partial size, never an error —
    size is telemetry, and the checkpoint already committed."""
    fs = get_filesystem(d)
    size = 0
    stack = [d]
    while stack:
        cur = stack.pop()
        try:
            names = fs.listdir(cur)
        except OSError:
            continue
        for name in names:
            p = os.path.join(cur, name)
            try:
                if fs.is_dir(p):
                    stack.append(p)
                else:
                    size += fs.size(p)
            except OSError:
                pass
    return size


def _unpack(raw: bytes, compression: str) -> bytes:
    return zlib.decompress(raw) if compression == "zlib" else raw


def _decode_blob(raw: bytes) -> Any:
    """Per-blob format dispatch on the magic bytes: v3 self-describing
    blobs decode via blobformat; anything else is a legacy v1/v2 pickle
    payload (still loadable — restore-across-upgrade)."""
    from flink_tpu_torch.checkpoint import blobformat

    if blobformat.is_v3(raw):
        return blobformat.decode(raw)
    return pickle.loads(raw)
