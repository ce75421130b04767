"""Embedded durable log — append-only segmented topics on the
FileSystem abstraction (the Kafka/KafkaSink role WITHOUT a broker
process: jobs chain through a shared filesystem instead of a network
service; ref: flink-connector-kafka's transactional sink + FLIP-27
consumer; rename-on-commit generalized to a
pre-commit/commit marker protocol).

A **topic** is a directory; a **partition** is an append-only sequence
of records addressed by OFFSET (record index within the partition); a
**segment** is one sealed file in the self-contained columnar format
(``formats_columnar.py``: schema header, CRC'd blocks, footer
tripwire, loud truncation errors) holding a contiguous offset range.
Every segment is written complete — footer included — at transaction
pre-commit time, so a reader never encounters a footerless active
file: partial writes surface as loud ``ColumnarError``s, never as
silently short reads.

Layout::

    <topic>/meta.json                  {"v":1, "partitions": N,
                                        "key_field": k?}
    <topic>/p<k>/seg-<base:012d>-c<cid:010d>-e<epoch>.colb
    <topic>/p<k>/cmp-<gen:06d>-<base:012d>.colb   compacted segment
    <topic>/txn/pre-<cid:010d>[-w.<writer>].json  pre-commit marker
    <topic>/txn/commit-<cid:010d>[-w.<writer>].json
    <topic>/manifest.json              compaction/retention generation
    <topic>/leases/p<k>.json           per-partition writer lease
    <topic>/groups/<name>/p<k>.json    consumer-group committed offset

The ``-w.<writer>`` marker suffix appears only for lease-fenced
multi-writer producers (log/bus.py): each producer's checkpoint-id
sequence is private, so markers are writer-scoped to keep two
producers' cid 7 from colliding. Suffixless markers are the legacy
single-writer form and stay readable forever.

A **compacted segment** (``cmp-…``) holds the latest committed row per
key for an offset range, sparse: its schema is the topic schema plus a
leading ``__offset`` i64 column carrying each surviving row's ORIGINAL
offset, so offset-addressed reads and replay positions survive
compaction (gaps where superseded rows were dropped). ``manifest.json``
(atomic-renamed, generation-numbered) is the single swap point: per
partition it records the retention floor (``start``), the compacted
range end (``compacted_end``) and the compacted segment list — readers
observe the old or the new generation whole, never a half-compacted
topic (log/bus.py owns the rewrite/swap/retention machinery).

Two-phase commit (the TwoPhaseCommitSink discipline, driven by
checkpoint barriers through ``log/connectors.py LogSink``):

1. **stage** (pre-commit, on the checkpoint barrier): the appender
   writes each partition's pending rows as sealed+fsynced segment
   files at the partition's next offsets, then durably publishes the
   pre-commit marker ``txn/pre-<cid>.json`` naming every segment and
   its offset range (tmp + fsync + atomic rename).
2. **commit** (on checkpoint completion): the commit marker
   ``txn/commit-<cid>.json`` — carrying the same segment list, the
   resulting end offsets, and the schema — lands by atomic rename.
   THAT rename is the visibility point: committed-offset readers
   enumerate commit markers only, so uncommitted segments are never
   observable, however long they sit on disk.
3. **abort** (attempt failure / restore of an uncovered epoch): the
   staged segments and the pre marker are deleted — recovery rolls
   uncommitted segments back; the epoch's rows replay from source
   positions.

Honest scope: single filesystem (any registered scheme), no broker
process. Concurrent producers are supported per PARTITION via fenced
writer leases (log/bus.py LeaseManager): M producers may own disjoint
partition sets of one topic; two writers on one partition remain
illegal and are fenced by lease epoch. Compaction/retention run as
explicit maintenance invocations (no background cleaner thread);
a reader holding a pre-swap snapshot whose files a later swap deleted
fails LOUDLY on open and retries with a fresh snapshot — it can never
read a half-compacted view.

Fault points (faults.py): ``log.segment.append`` /
``log.segment.fsync`` / ``log.segment.seal`` on the segment write
path, ``log.txn.marker`` at the pre-commit marker rename,
``log.txn.commit`` at the commit marker rename — the seams chaos
suites use to prove byte-identical committed output under crashes
between pre-commit and commit (tests/test_torch_log_chaos.py).
"""
from __future__ import annotations

import json
import os
import re
import threading
from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np

from flink_tpu_torch.formats_columnar import (
    ColumnarWriter,
    infer_schema,
    iter_blocks,
    map_file_image,
)
from flink_tpu_torch.fs import (FileSystem, get_filesystem,
                                open_write_sync, write_atomic)
from flink_tpu_torch.obs.metrics import MetricRegistry

__all__ = ["LogError", "TopicAppender", "TopicReader", "create_topic",
           "topic_partitions", "topic_key_field", "describe_topic",
           "load_manifest", "list_leases", "list_group_offsets",
           "registry", "OFFSET_COL"]

TXN_DIR = "txn"
LEASE_DIR = "leases"
GROUP_DIR = "groups"
MANIFEST = "manifest.json"
MAINT_LOCK = "maintenance.lock"
# a maintenance pass older than this is presumed crashed and its lock
# is broken (compaction of an embedded topic is seconds, not minutes)
MAINT_LOCK_STALE_MS = 15 * 60 * 1000
OFFSET_COL = "__offset"  # sparse-offset column of compacted segments
# {:010d}/{:012d} formatting PADS to the width; ids can exceed it (the
# bounded-run final epoch is a ms timestamp), so the patterns accept
# longer runs of digits too
_SEG_RE = re.compile(r"^seg-(\d{12,})-c(\d{10,})-e(\d+)\.colb$")
_CMP_RE = re.compile(r"^cmp-(\d{6,})-(\d{12,})\.colb$")
_WRITER_RE = re.compile(r"^[A-Za-z0-9_.\-]+$")

# process-global log metrics (the faults.py registry pattern): appended
# records / sealed segments / committed + aborted transactions per
# topic, so a chained-job deployment can watch its exchange plane
registry = MetricRegistry()
_counter_lock = threading.Lock()
_counters: Dict[Tuple[str, str], Any] = {}


def _count(topic: str, name: str, n: int = 1) -> None:
    key = (topic, name)
    c = _counters.get(key)
    if c is None:
        with _counter_lock:
            c = _counters.get(key)
            if c is None:
                c = registry.group("log", topic).counter(name)
                _counters[key] = c
    c.inc(n)


class LogError(ValueError):
    """Malformed or unusable topic state: missing topic, partition
    mismatch, overlapping/non-contiguous committed offset ranges,
    schema drift. Always loud — a log exchange must never silently
    skip or duplicate records (the same contract as ColumnarError)."""


def _seg_name(base: int, cid: int, epoch: int) -> str:
    return f"seg-{base:012d}-c{cid:010d}-e{epoch}.colb"


def compacted_seg_name(gen: int, base: int) -> str:
    return f"cmp-{gen:06d}-{base:012d}.colb"


def _marker_file(kind: str, cid: int, writer: str = "") -> str:
    """Writer-scoped for multi-writer producers (``-w.<writer>``),
    suffixless for the legacy single-writer form."""
    suffix = f"-w.{writer}" if writer else ""
    return f"{kind}-{cid:010d}{suffix}.json"


def _partition_dir(path: str, p: int) -> str:
    return os.path.join(path, f"p{p}")


def _txn_dir(path: str) -> str:
    return os.path.join(path, TXN_DIR)


def _local_path(path: str) -> Optional[str]:
    """The plain-OS path of a local/file:// location, or None for a
    non-local scheme (where O_EXCL lock files are unavailable)."""
    if path.startswith("file://"):
        return path[len("file://"):]
    return None if "://" in path else path


def _break_stale_lock(lock: str) -> None:
    """Break a crashed holder's stale lock WITHOUT the unlink race:
    rename it to a unique name first — the rename is atomic, so of two
    racing breakers exactly ONE wins and the loser's rename fails
    (it can never unlink a FRESH lock the winner creates a moment
    later)."""
    import uuid

    grave = f"{lock}.stale-{uuid.uuid4().hex[:8]}"
    try:
        os.rename(lock, grave)
    except OSError:
        return  # another breaker won the rename — its problem now
    try:
        os.unlink(grave)
    except OSError:
        pass


def _unlink_if_ours(lock: str, fd: int) -> None:
    """Release discipline: only unlink the lock if the path still IS
    our open file (inode compare) — if our stale lock was broken and
    replaced, a blind unlink would delete the new holder's lock."""
    try:
        ours = os.fstat(fd).st_ino == os.stat(lock).st_ino
    except OSError:
        ours = False
    os.close(fd)
    if ours:
        try:
            os.unlink(lock)
        except OSError:
            pass


def try_maintenance_lock(path: str) -> Optional[int]:
    """Non-blockingly take the topic's MAINTENANCE lock (O_EXCL on
    local filesystems): compaction/retention passes hold it across
    rewrite → manifest swap → delete, and the orphan sweep's
    compacted-file cleanup requires it — otherwise a producer-attempt
    recovery racing a live pass's pre-swap window would delete cmp
    files the imminent manifest is about to reference (permanent data
    loss). Returns an fd to pass to ``release_maintenance_lock``, or
    None when another pass holds it. A lock older than
    MAINT_LOCK_STALE_MS is a crashed pass's leftover and is broken.
    Non-local schemes with a conditional-put filesystem take a REAL
    CAS lock record (token = its nonce string); schemes with neither
    O_EXCL nor CAS return a sentinel fd (best-effort — the
    single-maintenance-invoker discipline is operational, honest
    scope)."""
    import time as _time

    lock = _local_path(os.path.join(path, MAINT_LOCK))
    if lock is None:
        from flink_tpu_torch.fs import cas_capable, get_filesystem

        if cas_capable(get_filesystem(path)):
            return _try_cas_maintenance_lock(path)
        return -1  # non-local, no CAS: best-effort (documented)
    for _ in range(2):
        try:
            return os.open(lock, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
        except FileExistsError:
            try:
                age_ms = (_time.time() - os.path.getmtime(lock)) * 1000
            except OSError:
                continue  # vanished under us — retry
            if age_ms > MAINT_LOCK_STALE_MS:
                _break_stale_lock(lock)
                continue
            return None
    return None


def _try_cas_maintenance_lock(path: str) -> Optional[str]:
    """The maintenance lock on a conditional-put scheme: a CAS-
    published lock RECORD instead of an O_EXCL file. The nonce is the
    release token — only the pass that published the record may delete
    it (the _unlink_if_ours inode compare, in CAS clothing). Staleness
    uses the record's own acquired_ms (object stores have no usable
    mtime); a crashed pass's record past MAINT_LOCK_STALE_MS is
    replaced via CAS on its etag, so two racing breakers elect exactly
    one winner."""
    import time as _time
    import uuid

    from flink_tpu_torch.fs import CASConflictError, get_filesystem

    fs = get_filesystem(path)
    lock = os.path.join(path, MAINT_LOCK)
    nonce = uuid.uuid4().hex
    rec = json.dumps({"owner": f"pid-{os.getpid()}", "nonce": nonce,
                      "acquired_ms": int(_time.time() * 1000)},
                     sort_keys=True).encode()
    for _ in range(2):
        try:
            cur_tag = fs.etag(lock)
        except OSError:
            return None
        if cur_tag is None:
            try:
                fs.put_if(lock, rec, None)
                return nonce
            except CASConflictError:
                continue  # lost the create race — re-read, maybe stale
        try:
            with fs.open_read(lock) as f:
                held = json.loads(f.read().decode("utf-8"))
            age_ms = (int(_time.time() * 1000)
                      - int(held.get("acquired_ms", 0)))
        except (OSError, ValueError):
            continue  # vanished or torn under us — retry
        if age_ms > MAINT_LOCK_STALE_MS:
            try:
                fs.put_if(lock, rec, cur_tag)  # break = replace-at-etag
                return nonce
            except CASConflictError:
                continue  # another breaker won
        return None
    return None


def release_maintenance_lock(path: str, fd) -> None:
    if fd is None:
        return
    if isinstance(fd, str):
        # CAS token: delete the lock record only if it is still OURS
        # (nonce compare — a broken-and-replaced stale record must not
        # take the new holder's lock with it)
        from flink_tpu_torch.fs import get_filesystem

        fs = get_filesystem(path)
        lock = os.path.join(path, MAINT_LOCK)
        try:
            with fs.open_read(lock) as f:
                held = json.loads(f.read().decode("utf-8"))
            if held.get("nonce") == fd:
                fs.delete(lock)
        except (OSError, ValueError):
            pass
        return
    if fd < 0:
        return
    lock = _local_path(os.path.join(path, MAINT_LOCK))
    if lock is None:
        return
    _unlink_if_ours(lock, fd)


def _read_json(fs, path: str, what: str) -> Dict[str, Any]:
    """Read+parse one JSON control file (meta/manifest/marker/lease/
    group-offset), loud on corruption — the single implementation all
    six control-file readers share."""
    with fs.open_read(path) as f:
        raw = f.read()
    try:
        return json.loads(raw if isinstance(raw, str)
                          else raw.decode("utf-8"))
    except ValueError as e:
        raise LogError(f"corrupt {what} at {path!r}: {e}") from e


def _write_atomic(fs, path: str, payload: bytes, fsync: bool = True) -> None:
    """Atomic durable publish — delegates to THE shared helper on the
    FileSystem seam (fs.write_atomic: tmp + fsync + rename, ENOSPC
    policy applied), kept under its historical name because every
    control-file writer in the log tier calls it."""
    write_atomic(fs, path, payload, durable=fsync)


def create_topic(path: str, partitions: int,
                 key_field: Optional[str] = None) -> None:
    """Create (or validate) a topic directory. Idempotent for matching
    partition counts; a mismatch is a loud error — offsets are
    per-partition, so silently changing the count would re-route
    keys. ``key_field`` (the sink's routing key) is recorded in
    meta.json as the default compaction key (log/bus.py Compactor)."""
    if partitions < 1:
        raise LogError(f"topic needs >= 1 partition, got {partitions}")
    fs = get_filesystem(path)
    meta_path = os.path.join(path, "meta.json")
    if fs.exists(meta_path):
        meta = _topic_meta(path)
        existing = int(meta.get("partitions", 0))
        if existing != partitions:
            raise LogError(
                f"topic {path!r} exists with {existing} partitions; "
                f"refusing to reopen with {partitions}")
        recorded = meta.get("key_field")
        if key_field and recorded and str(recorded) != str(key_field):
            # same loud-mismatch contract as the partition count: the
            # recorded key is the DEFAULT COMPACTION key — silently
            # keeping the old one would let a later compaction pass
            # dedup on the wrong column and drop live rows
            raise LogError(
                f"topic {path!r} exists with key_field {recorded!r}; "
                f"refusing to reopen with key_field {key_field!r} — "
                "compaction dedups on the recorded key")
        if key_field and not recorded:
            # upgrade path: an older topic that never recorded a key
            # adopts the first one declared (no conflict is possible —
            # compaction refuses to run without a key)
            meta["key_field"] = str(key_field)
            _write_atomic(fs, meta_path,
                          json.dumps(meta).encode("utf-8"))
        return
    fs.mkdirs(_txn_dir(path))
    for p in range(partitions):
        fs.mkdirs(_partition_dir(path, p))
    meta: Dict[str, Any] = {"v": 1, "partitions": int(partitions)}
    if key_field:
        meta["key_field"] = str(key_field)
    _write_atomic(fs, meta_path, json.dumps(meta).encode("utf-8"))


def _topic_meta(path: str) -> Dict[str, Any]:
    fs = get_filesystem(path)
    meta_path = os.path.join(path, "meta.json")
    if not fs.exists(meta_path):
        raise LogError(f"no such log topic: {path!r} (no meta.json)")
    return _read_json(fs, meta_path, "topic meta")


def topic_key_field(path: str) -> Optional[str]:
    """The compaction key recorded at topic creation, or None."""
    kf = _topic_meta(path).get("key_field")
    return str(kf) if kf else None


def load_manifest(fs, path: str) -> Optional[Dict[str, Any]]:
    """The compaction/retention generation file, normalized:
    ``{"gen": int, "partitions": {int p: {"start", "compacted_end",
    "segments": [{"name","base","end","rows"}]}}}`` — or None before
    the first compaction/retention pass."""
    mpath = os.path.join(path, MANIFEST)
    if not fs.exists(mpath):
        return None
    m = _read_json(fs, mpath, "compaction manifest")
    try:
        return {
            "gen": int(m["gen"]),
            "partitions": {
                int(p): {
                    "start": int(e.get("start", 0)),
                    "compacted_end": int(e.get("compacted_end", 0)),
                    "segments": [
                        {"name": str(s["name"]), "base": int(s["base"]),
                         "end": int(s["end"]), "rows": int(s["rows"])}
                        for s in e.get("segments", [])],
                }
                for p, e in m.get("partitions", {}).items()},
        }
    except (ValueError, KeyError, TypeError) as e:
        raise LogError(
            f"corrupt compaction manifest at {path!r}: {e}") from e


def topic_partitions(path: str) -> int:
    try:
        return int(_topic_meta(path)["partitions"])
    except (ValueError, KeyError) as e:
        raise LogError(f"corrupt topic meta at {path!r}: {e}") from e


def _marker_pat(kind: str):
    # group 1 = cid, group 2 = writer ("" for the legacy suffixless form)
    return re.compile(
        rf"^{kind}-(\d{{10,}})(?:-w\.([A-Za-z0-9_.\-]+))?\.json$")


def _marker_ids(fs, path: str, kind: str) -> set:
    """``kind`` in ('pre', 'commit') → {(cid, writer)}, from filenames
    ALONE — no marker is opened. The per-checkpoint hot path
    (staged_ids) runs on this, so its cost stays O(directory entries)
    even as commit markers accumulate over a topic's lifetime. writer
    is '' for legacy suffixless markers."""
    tdir = _txn_dir(path)
    if not fs.exists(tdir):
        return set()
    pat = _marker_pat(kind)
    return {(int(m.group(1)), m.group(2) or "")
            for m in map(pat.match, fs.listdir(tdir)) if m}


def _list_markers(fs, path: str,
                  kind: str) -> Dict[Tuple[int, str], Dict[str, Any]]:
    """``kind`` in ('pre', 'commit') → {(cid, writer): marker dict};
    writer is '' for legacy suffixless markers."""
    tdir = _txn_dir(path)
    out: Dict[Tuple[int, str], Dict[str, Any]] = {}
    if not fs.exists(tdir):
        return out
    pat = _marker_pat(kind)
    for name in fs.listdir(tdir):
        m = pat.match(name)
        if m is None:
            continue
        out[(int(m.group(1)), m.group(2) or "")] = _read_json(
            fs, os.path.join(tdir, name), f"{kind} marker")
    return out


class TopicAppender:
    """The append/2PC side of one topic (LogSink's engine) — one writer
    per PARTITION. Legacy single-writer form: no ``writer_id``, all
    partitions owned, suffixless markers. Lease-fenced multi-writer
    form (log/bus.py): ``writer_id`` scopes this producer's markers,
    ``owned_partitions`` restricts appends, and ``lease`` (a
    LeaseManager bound to this writer) is re-verified+renewed before
    every marker publication — a deposed leaseholder's late stage or
    commit raises instead of clobbering the successor's partition.

    Offset bookkeeping: ``_next[p]`` = committed end offset plus every
    staged (pre-committed, uncommitted) transaction's rows — staged
    transactions STACK, because checkpoint N+1's barrier can stage a
    new epoch while N's commit notification is still in flight."""

    def __init__(self, path: str, partitions: int,
                 segment_records: int = 65536, epoch: int = 0,
                 writer_id: Optional[str] = None,
                 owned_partitions: Optional[List[int]] = None,
                 lease: Any = None,
                 key_field: Optional[str] = None,
                 fsync_mode: str = "group",
                 host_pool: Any = None) -> None:
        if segment_records < 1:
            raise LogError(
                f"log segment-records must be >= 1, got {segment_records}")
        if fsync_mode not in ("group", "segment"):
            raise LogError(
                f"log fsync-mode must be 'group' or 'segment', "
                f"got {fsync_mode!r}")
        if (fsync_mode == "group"
                and type(get_filesystem(path)).fsync is FileSystem.fsync):
            # a backend that never overrode the fsync barrier (base
            # no-op) cannot run the group pass; 'segment' mode syncs
            # through the write handle at close, so it is the
            # durability-preserving degrade — silently SKIPPING the
            # syncs would weaken the 2PC chain on exactly the storage
            # least likely to forgive it. Local fs and CrashFS both
            # implement the barrier, so group stays the default there.
            fsync_mode = "segment"
        if writer_id is not None and not _WRITER_RE.match(writer_id):
            raise LogError(
                f"writer id {writer_id!r} must match [A-Za-z0-9_.-]+ "
                "(it becomes part of marker filenames)")
        if owned_partitions is not None and writer_id is None:
            raise LogError(
                "owned_partitions needs a writer_id: concurrent "
                "producers run private checkpoint-id sequences, so "
                "their transaction markers must be writer-scoped")
        create_topic(path, partitions, key_field=key_field)
        self.path = path
        self.topic = os.path.basename(os.path.normpath(path)) or "topic"
        self.partitions = partitions
        self.segment_records = segment_records
        self.epoch = int(epoch)
        self.writer_id = writer_id or ""
        self.owned = (sorted(int(p) for p in owned_partitions)
                      if owned_partitions is not None
                      else list(range(partitions)))
        if owned_partitions is not None and not self.owned:
            raise LogError(
                "owned_partitions must be non-empty: a writer owning "
                "no partitions can never route a row (the first write "
                "would die in a mod-by-zero far from this "
                "misconfiguration)")
        bad = [p for p in self.owned if p < 0 or p >= partitions]
        if bad:
            raise LogError(
                f"owned partitions {bad} outside topic range "
                f"[0, {partitions})")
        self.lease = lease
        # "group": segments are written WITHOUT per-file fsync and one
        # group-commit pass fsyncs every staged file just before the
        # pre-commit marker publishes — the 2PC crash-window semantics
        # are unchanged by construction (the marker rename is what
        # makes a transaction recoverable, and it still strictly
        # follows every fsync; a crash anywhere earlier leaves only
        # unreferenced debris the recovery sweep removes). "segment"
        # is the legacy fsync-per-file-at-write discipline.
        self.fsync_mode = fsync_mode
        # the driver's shared HostPool (set via LogSink.set_host_pool):
        # multi-partition stage() routes per-partition segment
        # encode/write — and the group fsync pass — through it, so
        # partition I/O scales with cores. None / parallelism 1 is the
        # exact serial path.
        self.host_pool = host_pool
        self._fs = get_filesystem(path)
        # cids THIS writer staged rows for: commit() uses it to tell a
        # genuinely-empty epoch (no marker was ever written — no-op by
        # contract) from a marker that VANISHED after stage() returned
        # True, which is data loss and must be loud
        self._staged_live: set = set()
        self._schema: Optional[Tuple[Tuple[str, str], ...]] = None
        # adopt the committed schema: a second producer run appending to
        # an existing topic must match it (readers enforce per segment)
        commits = _list_markers(self._fs, path, "commit")
        if commits:
            last = commits[max(commits)]
            if last.get("schema"):
                self._schema = tuple(
                    (str(n), str(t)) for n, t in last["schema"])
        self._refresh_offsets()

    # -- marker paths (writer-scoped for multi-writer producers) ----------
    def _marker_path(self, kind: str, cid: int) -> str:
        return os.path.join(_txn_dir(self.path),
                            _marker_file(kind, cid, self.writer_id))

    def _verify_lease(self) -> None:
        """Fencing gate before every marker publication: renew our
        per-partition leases and raise if any was taken over (a higher
        epoch on file means we are the DEPOSED holder — our late write
        must be rejected, the attempt-epoch discipline applied to
        partition ownership)."""
        if self.lease is not None:
            self.lease.verify(renew=True)

    # -- offsets ----------------------------------------------------------
    def _refresh_offsets(self) -> None:
        commits = _list_markers(self._fs, self.path, "commit")
        pres = _list_markers(self._fs, self.path, "pre")
        nxt = {p: 0 for p in range(self.partitions)}
        for marker in commits.values():
            for p_s, end in marker.get("offsets", {}).items():
                p = int(p_s)
                nxt[p] = max(nxt[p], int(end))
        # staged-but-uncommitted transactions (ANY writer's — disjoint
        # partitions make foreign entries no-ops on ours) extend the
        # chain
        for key in sorted(set(pres) - set(commits)):
            for p_s, segs in pres[key].get("segments", {}).items():
                p = int(p_s)
                for s in segs:
                    nxt[p] = max(nxt[p], int(s["base"]) + int(s["rows"]))
        self._next = nxt

    def next_offset(self, p: int) -> int:
        return self._next[p]

    # -- 2PC --------------------------------------------------------------
    def _check_schema(self, batch: Dict[str, np.ndarray]):
        schema = infer_schema(batch)
        if self._schema is None:
            self._schema = schema
        elif schema != self._schema:
            raise LogError(
                f"schema drift on topic {self.path!r}: appending "
                f"{schema}, topic carries {self._schema} — a log "
                "topic's schema is fixed at first append")
        return self._schema

    def _write_segment(self, p: int, base: int, cid: int,
                       batches: List[Dict[str, np.ndarray]]) -> Dict[str, Any]:
        from flink_tpu_torch.fs import enospc_retry

        # whole-segment ENOSPC retry (storage.enospc-policy=retry):
        # each attempt rewrites the tmp from scratch and the rename is
        # the only publish point, so a failed attempt leaves only
        # marker-less debris the recovery sweep removes
        return enospc_retry(
            lambda: self._write_segment_once(p, base, cid, batches))

    def _write_segment_once(self, p: int, base: int, cid: int,
                            batches: List[Dict[str, np.ndarray]]
                            ) -> Dict[str, Any]:
        from flink_tpu_torch import faults

        name = _seg_name(base, cid, self.epoch)
        pdir = _partition_dir(self.path, p)
        tmp = os.path.join(pdir, name + ".tmp")
        rows = 0
        # sync-on-close IS the per-segment fsync of 'segment' mode;
        # 'group' mode writes plain and the group pass syncs before
        # the pre-commit marker (fs.open_write seam, CrashFS-recorded)
        with open_write_sync(
                self._fs, tmp, sync=self.fsync_mode == "segment") as f:
            w = ColumnarWriter(f, self._schema)
            for b in batches:
                # torn-append seam: a raise here leaves a footerless
                # .tmp the recovery sweep removes — never a readable
                # partial segment
                faults.fire("log.segment.append", exc=OSError,
                            topic=self.topic, partition=p, cid=cid)
                w.write_batch(b)
                rows += len(np.asarray(b[self._schema[0][0]]))
            faults.fire("log.segment.seal", exc=OSError,
                        topic=self.topic, partition=p, cid=cid)
            w.close()  # footer — the completeness tripwire
            f.flush()
            if self.fsync_mode == "segment":
                faults.fire("log.segment.fsync", exc=OSError,
                            topic=self.topic, partition=p, cid=cid)
        self._fs.rename(tmp, os.path.join(pdir, name))
        _count(self.topic, "segments_sealed")
        _count(self.topic, "records_appended", rows)
        return {"name": name, "base": int(base), "rows": int(rows)}

    def _group_fsync(self, staged: List[Tuple[int, int, str]]) -> None:
        """The group-commit pass of ``fsync_mode='group'``: fsync every
        segment file this transaction staged, in one sweep, strictly
        BEFORE the pre-commit marker publishes — the marker rename (the
        point after which the transaction is recoverable) never lands
        over un-durable segment bytes, so the crash-window semantics
        equal the per-segment mode's. The ``log.segment.fsync`` fault
        point fires once per segment HERE (same count as per-segment
        mode, deterministic partition-then-offset order, on the caller
        thread); the fsyncs themselves route through the host pool when
        one is attached — fsync drops the GIL, so per-partition syncs
        overlap on real I/O."""
        from flink_tpu_torch import faults

        paths: List[str] = []
        for p, cid, name in staged:
            faults.fire("log.segment.fsync", exc=OSError,
                        topic=self.topic, partition=p, cid=cid)
            paths.append(os.path.join(_partition_dir(self.path, p), name))

        def _sync(path: str):
            def run() -> None:
                # the seam's durability barrier (fs.fsync): local fs
                # opens+fsyncs, CrashFS additionally journals it —
                # non-fsyncable mounts are tolerated inside
                self._fs.fsync(path)
            return run

        pool = self.host_pool
        if pool is not None and getattr(pool, "parallelism", 1) > 1 \
                and len(paths) > 1:
            scope = faults.current_scope()

            def _scoped(path):
                run = _sync(path)

                def wrapped() -> None:
                    # pool workers carry no fault scope of their own
                    # (the driver only scopes threads IT owns) — a
                    # session tenant's scoped plan must still govern
                    # work done on its behalf
                    with faults.job_scope(scope):
                        run()
                return wrapped

            pool.run_tasks([_scoped(path) for path in paths])
        else:
            for path in paths:
                _sync(path)()

    def stage(self, cid: int,
              pending: Dict[int, List[Dict[str, np.ndarray]]]) -> bool:
        """Pre-commit: write ``pending[p]`` (lists of column batches)
        as sealed segments at each partition's next offsets, then
        durably publish the pre-commit marker. Returns False when no
        partition had rows (no empty transactions)."""
        from flink_tpu_torch import faults

        if self._fs.exists(self._marker_path("commit", cid)):
            # a reused checkpoint id: this writer already COMMITTED cid
            # in an earlier run (a fresh checkpoint dir restarts ids at
            # 1). Staging under it would be SILENT data loss — commit()
            # would see the old marker and "succeed" without ever
            # publishing these rows.
            raise LogError(
                f"writer {self.writer_id or '<single>'!r} already "
                f"committed transaction {cid} to topic {self.path!r} "
                "in an earlier run — refusing to stage new rows under "
                "a reused checkpoint id (they could never become "
                "visible). Append bounded tails WITHOUT checkpointing "
                "(the terminal epoch is a unique ms timestamp), or "
                "resume the original checkpoint dir so ids continue")
        per_part: Dict[str, List[Dict[str, Any]]] = {}
        staged_next = dict(self._next)
        # plan first, write second: each partition's segment cuts and
        # base offsets are fixed here, so the writes are independent
        # per-partition jobs — routable through the host pool with
        # byte-identical files regardless of scheduling
        part_jobs: List[Tuple[int, List[Tuple[int, List[Dict[str, np.ndarray]]]]]] = []
        for p in sorted(pending):
            batches = [b for b in pending[p]
                       if len(next(iter(b.values()), ()))]
            if not batches:
                continue
            if p not in self.owned:
                raise LogError(
                    f"writer {self.writer_id or '<single>'!r} staging "
                    f"rows into partition {p} of topic {self.path!r} "
                    f"outside its owned set {self.owned} — partition "
                    "leases are the multi-writer contract")
            for b in batches:
                self._check_schema(b)
            base = staged_next[p]
            jobs: List[Tuple[int, List[Dict[str, np.ndarray]]]] = []
            chunks: List[Dict[str, np.ndarray]] = []
            n_chunk = 0
            for b in batches:
                n = len(next(iter(b.values())))
                lo = 0
                while lo < n:
                    take = min(self.segment_records - n_chunk, n - lo)
                    chunks.append({k: np.asarray(v)[lo:lo + take]
                                   for k, v in b.items()})
                    n_chunk += take
                    lo += take
                    if n_chunk == self.segment_records:
                        jobs.append((base, chunks))
                        base += n_chunk
                        chunks, n_chunk = [], 0
            if chunks:
                jobs.append((base, chunks))
                base += n_chunk
            part_jobs.append((p, jobs))
            staged_next[p] = base
        if not part_jobs:
            return False

        def _writer(p: int, jobs):
            def run() -> List[Dict[str, Any]]:
                return [self._write_segment(p, b, cid, ch)
                        for b, ch in jobs]
            return run

        pool = self.host_pool
        if pool is not None and getattr(pool, "parallelism", 1) > 1 \
                and len(part_jobs) > 1:
            # parallel partition I/O: one pool task per partition, in
            # submission (partition) order. Encode+write of different
            # partitions overlap; a task failure drains its siblings
            # before raising (the pool's no-orphan contract), leaving
            # only marker-less debris the recovery sweep removes. The
            # log.segment.* fault points then fire on worker threads
            # UNDER THE CALLER'S FAULT SCOPE (pool workers carry none
            # of their own — a session tenant's scoped plan must still
            # govern its segment writes): per-partition order is
            # preserved, cross-partition interleave is scheduling-
            # dependent (the serial path — pool absent or parallelism
            # 1 — keeps the exact legacy deterministic order chaos
            # schedules were seeded on).
            from flink_tpu_torch import faults

            scope = faults.current_scope()

            def _scoped_writer(p, jobs):
                run = _writer(p, jobs)

                def wrapped():
                    with faults.job_scope(scope):
                        return run()
                return wrapped

            results = pool.run_tasks(
                [_scoped_writer(p, jobs) for p, jobs in part_jobs])
        else:
            results = [_writer(p, jobs)() for p, jobs in part_jobs]
        staged_files: List[Tuple[int, int, str]] = []
        for (p, _jobs), segs in zip(part_jobs, results):
            per_part[str(p)] = segs
            staged_files.extend((p, int(cid), s["name"]) for s in segs)
        marker = {
            "cid": int(cid), "epoch": self.epoch,
            "segments": per_part,
            "offsets": {p: int(staged_next[int(p)]) for p in per_part},
            "schema": [[n, t] for n, t in self._schema],
        }
        if self.writer_id:
            marker["writer"] = self.writer_id
        if self.lease is not None:
            marker["lease_epochs"] = {
                str(p): int(self.lease.epochs[int(p)]) for p in per_part}
        # group-commit durability: every staged segment is fsynced
        # BEFORE the marker rename below — the 2PC visibility chain
        # (durable segments -> pre marker -> commit marker) is
        # identical to per-segment mode, just batched
        if self.fsync_mode == "group":
            self._group_fsync(staged_files)
        # ENTRY durability: content fsyncs (above / sync-on-close) make
        # the segment BYTES durable, but the tmp->final renames are
        # directory mutations — fsync each touched partition dir so a
        # power cut after the marker publishes can never leave the
        # marker pointing at vanished segment entries
        for p in sorted({pp for pp, _, _ in staged_files}):
            self._fs.fsync(_partition_dir(self.path, p))
        # fencing gate, then the pre-commit marker: after this rename
        # the transaction is recoverable (re-commit or roll back),
        # before it the segments are unreferenced debris the cleanup
        # sweep removes. A deposed leaseholder raises HERE, before its
        # stale rows become recoverable state.
        self._verify_lease()
        faults.fire("log.txn.marker", exc=OSError,
                    topic=self.topic, cid=cid)
        _write_atomic(self._fs, self._marker_path("pre", cid),
                      json.dumps(marker).encode("utf-8"))
        self._next = staged_next
        self._staged_live.add(int(cid))
        return True

    def staged_ids(self) -> List[int]:
        """THIS writer's staged-but-uncommitted cids (another
        producer's staged transactions are its own to commit or roll
        back — fenced by its lease, not ours)."""
        staged = (_marker_ids(self._fs, self.path, "pre")
                  - _marker_ids(self._fs, self.path, "commit"))
        return sorted(cid for cid, w in staged if w == self.writer_id)

    def commit(self, cid: int) -> None:
        """THE visibility point: rename the commit marker into place.
        Idempotent; a no-op for ids that staged nothing."""
        from flink_tpu_torch import faults

        cpath = self._marker_path("commit", cid)
        if self._fs.exists(cpath):
            self._staged_live.discard(int(cid))
            return
        ppath = self._marker_path("pre", cid)
        if not self._fs.exists(ppath):
            if int(cid) in self._staged_live:
                # stage() durably published this marker and returned
                # True — a vanished marker at commit time means some
                # other actor rolled our live transaction back (e.g. a
                # second writer's recover() on a topic we still own).
                # Returning success here would silently drop the epoch.
                raise LogError(
                    f"pre-commit marker for staged transaction {cid} "
                    f"vanished from topic {self.path!r} before commit "
                    "— rolled back by another writer? (single-writer "
                    "discipline violated; refusing to silently drop "
                    "the epoch)")
            return  # empty epoch — nothing was staged
        with self._fs.open_read(ppath) as f:
            raw = f.read()
        pre = json.loads(raw if isinstance(raw, str)
                         else raw.decode("utf-8"))
        if int(pre.get("epoch", 0)) > self.epoch:
            # epoch fence, commit side (mirror of abort): this marker
            # was staged by a SUCCESSOR attempt — a deposed attempt's
            # lagging commit round must not publish an epoch whose
            # covering checkpoint (the successor's) hasn't completed;
            # committing it early would make uncovered rows visible
            # and duplicate them when the successor replays
            return
        commit = {"cid": int(cid), "epoch": pre.get("epoch", 0),
                  "segments": pre["segments"],
                  "offsets": pre["offsets"],
                  "schema": pre.get("schema")}
        for extra in ("writer", "lease_epochs"):
            if extra in pre:
                commit[extra] = pre[extra]
        # fencing gate: the commit rename is THE visibility point — a
        # deposed leaseholder must raise here, never publish
        self._verify_lease()
        faults.fire("log.txn.commit", exc=OSError,
                    topic=self.topic, cid=cid)
        _write_atomic(self._fs, cpath,
                      json.dumps(commit).encode("utf-8"))
        self._staged_live.discard(int(cid))
        _count(self.topic, "txns_committed")

    def abort(self, cid: int) -> None:
        """Roll staged transaction ``cid`` back: delete its segments,
        then its pre marker (in that order — a crash mid-abort leaves
        the marker, so the next sweep finishes the job). EPOCH-FENCED:
        a marker staged by a HIGHER attempt epoch belongs to a
        successor that now owns the topic — a deposed attempt's
        late-running cleanup must skip it, never delete a live
        successor's staged epoch (the same fence the part/segment
        names carry)."""
        ppath = self._marker_path("pre", cid)
        cpath = self._marker_path("commit", cid)
        if self._fs.exists(cpath):
            raise LogError(
                f"refusing to abort committed transaction {cid} on "
                f"topic {self.path!r}")
        if not self._fs.exists(ppath):
            self._staged_live.discard(int(cid))
            return
        with self._fs.open_read(ppath) as f:
            raw = f.read()
        pre = json.loads(raw if isinstance(raw, str)
                         else raw.decode("utf-8"))
        if int(pre.get("epoch", 0)) > self.epoch:
            return  # a successor attempt's staged epoch — not ours
        self._staged_live.discard(int(cid))
        for p_s, segs in pre.get("segments", {}).items():
            pdir = _partition_dir(self.path, int(p_s))
            for s in segs:
                seg = os.path.join(pdir, s["name"])
                if self._fs.exists(seg):
                    self._fs.delete(seg)
        self._fs.delete(ppath)
        _count(self.topic, "txns_aborted")
        self._refresh_offsets()

    def snapshot(self, cid: int) -> Dict[str, Any]:
        """Checkpoint payload: the pre marker plus every staged segment's
        bytes — enough to rebuild the transaction after an abort swept
        the staged files (the FileSink staged-bytes rationale)."""
        ppath = self._marker_path("pre", cid)
        with self._fs.open_read(ppath) as f:
            raw = f.read()
        pre = json.loads(raw if isinstance(raw, str)
                         else raw.decode("utf-8"))
        segments: Dict[str, bytes] = {}
        for p_s, segs in pre.get("segments", {}).items():
            pdir = _partition_dir(self.path, int(p_s))
            for s in segs:
                with self._fs.open_read(os.path.join(pdir, s["name"])) as f:
                    b = f.read()
                segments[f"{p_s}/{s['name']}"] = (
                    b if isinstance(b, bytes) else b.encode())
        return {"pre": pre, "segments": segments}

    def rebuild(self, cid: int, payload: Dict[str, Any]) -> None:
        """Re-create staged transaction ``cid`` from its checkpoint
        payload (idempotent; a commit follows). Segment files are
        rewritten UNCONDITIONALLY: under ``fsync_mode='group'`` a
        power cut can leave a TORN segment at its final name (the
        rename applied, the content fsync never ran — possible only
        before the pre-commit marker, so the 2PC chain is intact, but
        an exists-check here would adopt the torn file and the
        committed range would read back corrupt). The payload is the
        authoritative bytes; rewriting identical content is free."""
        cpath = self._marker_path("commit", cid)
        if self._fs.exists(cpath):
            return  # already committed — nothing to rebuild
        # fencing gate: restore republishes the pre marker below — a
        # DEPOSED leaseholder's recovery must raise here, not re-stage
        # rows a successor already owns (same discipline as stage()/
        # commit(); a no-op for lease-less appenders)
        self._verify_lease()
        for key, data in payload.get("segments", {}).items():
            p_s, _, name = key.partition("/")
            dst = os.path.join(_partition_dir(self.path, int(p_s)), name)
            _write_atomic(self._fs, dst, data)
        ppath = self._marker_path("pre", cid)
        if not self._fs.exists(ppath):
            _write_atomic(self._fs, ppath,
                          json.dumps(payload["pre"]).encode("utf-8"))
        self._refresh_offsets()

    def sweep_orphans(self) -> int:
        """Delete partition-file debris, restricted to OWNED partitions
        (a co-resident producer's crash window between segment write
        and marker rename must never be swept by its neighbor):

        - stray ``.tmp`` leftovers and raw segments no pre/commit
          marker references (torn prepare);
        - raw segments wholly below the manifest's compacted/retention
          floor that the manifest does not list (superseded by a
          compaction swap, or retention-dropped — a crash between the
          manifest rename and the file deletes leaves them);
        - compacted (``cmp-``) files the current manifest does not
          reference (a crash between compaction rewrite and manifest
          swap, or a superseded generation).

        Returns the number removed."""
        pres = _list_markers(self._fs, self.path, "pre")
        commits = _list_markers(self._fs, self.path, "commit")
        referenced: Dict[Tuple[int, str], int] = {}
        for marker in list(pres.values()) + list(commits.values()):
            for p_s, segs in marker.get("segments", {}).items():
                for s in segs:
                    referenced[(int(p_s), s["name"])] = (
                        int(s["base"]) + int(s["rows"]))
        # cmp-file cleanup needs the MAINTENANCE lock: an unreferenced
        # cmp file may be a LIVE pass's pre-swap output that the
        # imminent manifest rename is about to reference — deleting it
        # would make the new generation permanently unreadable. Lock
        # busy → keep cmp files this sweep (a later sweep, or the pass
        # itself, removes real debris).
        maint_fd = try_maintenance_lock(self.path)
        try:
            manifest = load_manifest(self._fs, self.path)
            mparts = (manifest or {}).get("partitions", {})
            removed = 0
            for p in self.owned:
                pdir = _partition_dir(self.path, p)
                if not self._fs.exists(pdir):
                    continue
                pm = mparts.get(p) or {}
                floor = max(int(pm.get("start", 0)),
                            int(pm.get("compacted_end", 0)))
                live_cmp = {s["name"] for s in pm.get("segments", [])}
                for name in self._fs.listdir(pdir):
                    drop = False
                    if name.endswith(".tmp"):
                        drop = True
                    elif _CMP_RE.match(name):
                        drop = (maint_fd is not None
                                and name not in live_cmp)
                    elif _SEG_RE.match(name):
                        end = referenced.get((p, name))
                        drop = (end is None
                                or (end <= floor
                                    and name not in live_cmp))
                    if drop:
                        self._fs.delete(os.path.join(pdir, name))
                        removed += 1
        finally:
            release_maintenance_lock(self.path, maint_fd)
        if removed:
            self._refresh_offsets()
        return removed

    def recover(self) -> None:
        """Fresh-start recovery on partitions this writer now owns:
        roll OUR uncommitted (staged) transactions back and sweep torn
        debris — a dead producer attempt's pre-committed epochs must
        never linger as phantom stageable state (restore_staged
        rebuilds covered epochs from the checkpoint payload
        afterwards). With a lease, additionally roll back staged
        transactions a DEPOSED previous holder of our partitions left
        behind (its lease epoch on file is below ours — takeover
        completes the dead writer's abort). A LEGACY (unleased) writer
        claims the WHOLE topic — the pre-lease single-writer
        semantics — so its recovery also rolls back any foreign
        writer-scoped staged transaction: left in place, a dead leased
        producer's staged rows would hold their offsets in ``_next``
        forever and the never-committed range would read as a
        permanent contiguity gap (a still-LIVE leased producer mixed
        with a legacy writer is a misuse either way; its next commit
        fails loudly on the vanished marker, never silently)."""
        for cid in self.staged_ids():
            self.abort(cid)
        if self.lease is not None:
            self._abort_deposed_staged()
        elif self.writer_id == "":
            self._abort_foreign_staged()
        self.sweep_orphans()
        self._refresh_offsets()

    def _abort_foreign_staged(self) -> None:
        """Legacy whole-topic claim: roll back every OTHER writer's
        staged-but-uncommitted transaction (segments, then marker)."""
        pres = _list_markers(self._fs, self.path, "pre")
        commits = _marker_ids(self._fs, self.path, "commit")
        for (cid, writer), pre in sorted(pres.items()):
            if writer == self.writer_id or (cid, writer) in commits:
                continue
            for p_s, segs in pre.get("segments", {}).items():
                pdir = _partition_dir(self.path, int(p_s))
                for s in segs:
                    seg = os.path.join(pdir, s["name"])
                    if self._fs.exists(seg):
                        self._fs.delete(seg)
            self._fs.delete(os.path.join(
                _txn_dir(self.path), _marker_file("pre", cid, writer)))
            _count(self.topic, "txns_aborted")

    def _abort_deposed_staged(self) -> None:
        """Takeover sweep: any OTHER writer's staged-but-uncommitted
        transaction touching one of our leased partitions with a lease
        epoch below ours was staged by the partition's previous holder,
        now deposed — roll the whole transaction back (2PC aborts are
        all-or-nothing; if that writer is somehow still alive its next
        commit fails loudly on the vanished marker)."""
        pres = _list_markers(self._fs, self.path, "pre")
        commits = _marker_ids(self._fs, self.path, "commit")
        for (cid, writer), pre in sorted(pres.items()):
            if writer == self.writer_id or (cid, writer) in commits:
                continue
            epochs = {int(p): int(e) for p, e in
                      pre.get("lease_epochs", {}).items()}
            ours = [int(p) for p in pre.get("segments", {})
                    if int(p) in self.owned]
            if not ours:
                continue
            if all(epochs.get(p, -1) < self.lease.epochs.get(p, 0)
                   for p in ours):
                for p_s, segs in pre.get("segments", {}).items():
                    pdir = _partition_dir(self.path, int(p_s))
                    for s in segs:
                        seg = os.path.join(pdir, s["name"])
                        if self._fs.exists(seg):
                            self._fs.delete(seg)
                self._fs.delete(os.path.join(
                    _txn_dir(self.path),
                    _marker_file("pre", cid, writer)))
                _count(self.topic, "txns_aborted")


class _Segment:
    __slots__ = ("p", "base", "end", "name", "cid", "sparse", "rows")

    def __init__(self, p: int, base: int, end: int, name: str, cid: int,
                 sparse: bool = False, rows: Optional[int] = None):
        self.p, self.base, self.end = p, base, end
        self.name, self.cid = name, cid
        self.sparse = sparse  # compacted: rows < end-base, offsets in
        self.rows = (end - base) if rows is None else rows  # __offset


class TopicReader:
    """Committed-offset reads: only segments a COMMIT marker or the
    compaction manifest names are observable, in offset order,
    validated contiguous above the compaction floor (an overlap or gap
    in the committed ranges is corruption and fails loudly). Below the
    floor, COMPACTED segments are sparse — each surviving row carries
    its original offset in the ``__offset`` column, so offsets are
    stable across compaction (gaps where superseded rows were dropped)
    and below the retention ``start`` nothing is readable at all.
    Offset-addressed: ``read(p, start_offset)`` resumes mid-partition —
    whole segments before the offset are skipped without opening,
    already-consumed leading rows of the boundary block are sliced
    off.

    ``zero_copy=True`` (the perf-grade read mode): sealed local-fs
    segments are MMAPPED and every fixed-width column comes back as a
    read-only ``np.frombuffer`` view into the mapping — one page-cache
    walk, no read() image copy, no per-column decode copy. Every
    block's CRC is still verified before its views are yielded, and
    truncation/corruption raise exactly the same loud errors as the
    copying mode. Non-local schemes keep a single contiguous read per
    segment and return views into that image."""

    def __init__(self, path: str, zero_copy: bool = False) -> None:
        self.path = path
        self.zero_copy = bool(zero_copy)
        self._fs = get_filesystem(path)
        self.partitions = topic_partitions(path)
        manifest = load_manifest(self._fs, path)
        self.generation = int((manifest or {}).get("gen", 0))
        mparts = (manifest or {}).get("partitions", {})
        commits = _list_markers(self._fs, path, "commit")
        self._schema = None
        raw: Dict[int, List[_Segment]] = {
            p: [] for p in range(self.partitions)}
        for key in sorted(commits):
            marker = commits[key]
            if self._schema is None and marker.get("schema"):
                self._schema = tuple(
                    (str(n), str(t)) for n, t in marker["schema"])
            for p_s, segs in marker.get("segments", {}).items():
                p = int(p_s)
                for s in segs:
                    raw[p].append(_Segment(
                        p, int(s["base"]), int(s["base"]) + int(s["rows"]),
                        s["name"], key[0]))
        per_part: Dict[int, List[_Segment]] = {}
        self._starts: Dict[int, int] = {}
        self._compacted_end: Dict[int, int] = {}
        for p, segs in raw.items():
            pm = mparts.get(p) or {}
            start = int(pm.get("start", 0))
            cend = int(pm.get("compacted_end", 0))
            floor = max(start, cend)
            self._starts[p] = start
            self._compacted_end[p] = cend
            live = [_Segment(p, s["base"], s["end"], s["name"], -1,
                             sparse=True, rows=s["rows"])
                    for s in pm.get("segments", [])]
            at = start
            for s in live:
                if s.base < at or s.end > cend:
                    raise LogError(
                        f"topic {path!r} p{p}: compacted segment "
                        f"{s.name!r} covers [{s.base}, {s.end}) outside "
                        f"the manifest's [{at}, {cend}) (corrupt "
                        "manifest)")
                at = s.end
            segs.sort(key=lambda s: s.base)
            tail = [s for s in segs if s.end > floor]
            at = floor
            for s in tail:
                if s.base != at:
                    raise LogError(
                        f"topic {path!r} p{p}: committed segment "
                        f"{s.name!r} starts at offset {s.base}, expected "
                        f"{at} — overlapping or missing commit ranges "
                        "(corrupt transaction log)")
                at = s.end
            per_part[p] = live + tail
        self._segments = per_part
        self._floors = {p: max(self._starts[p], self._compacted_end[p])
                        for p in per_part}

    def committed_offsets(self) -> Dict[int, int]:
        """Per-partition committed END (the original high-water mark —
        compaction/retention never move it backwards)."""
        return {p: (segs[-1].end if segs else self._floors[p])
                for p, segs in self._segments.items()}

    def start_offsets(self) -> Dict[int, int]:
        """Per-partition retention floor: offsets below this were
        dropped by retention and are gone (0 before any retention)."""
        return dict(self._starts)

    def compacted_ends(self) -> Dict[int, int]:
        """Per-partition end of the key-compacted range (0 before any
        compaction): reads below this see only the latest committed
        row per key."""
        return dict(self._compacted_end)

    def _sparse_schema(self):
        if self._schema is None:
            return None
        return ((OFFSET_COL, "i64"),) + tuple(self._schema)

    def read(self, p: int, start_offset: int = 0
             ) -> Iterator[Tuple[int, Dict[str, np.ndarray]]]:
        """Yield ``(offset_of_first_row, batch)`` per stored block from
        ``start_offset`` to the committed end (see ``read3`` for the
        replay-position variant). Truncated or corrupt segments raise
        ColumnarError — a committed range that cannot be read back
        whole is data loss, never a silent skip."""
        for offset, _nxt, block in self.read3(p, start_offset):
            yield offset, block

    def read3(self, p: int, start_offset: int = 0
              ) -> Iterator[Tuple[int, int, Dict[str, np.ndarray]]]:
        """Yield ``(offset_of_first_row, next_position, batch)`` per
        stored block: ``next_position`` is the replay position AFTER
        consuming the block — ``last row's offset + 1``, which for
        sparse (compacted) blocks jumps the gaps a naive
        ``offset + len`` would land in (and re-deliver rows from) on
        restore."""
        if p not in self._segments:
            raise LogError(
                f"topic {self.path!r} has no partition {p} "
                f"(partitions: {self.partitions})")
        if 0 < start_offset < self._starts[p]:
            # a POSITIVE replay position below the retention floor is a
            # checkpointed promise this topic can no longer keep — the
            # rows were expired. Silently yielding from the floor would
            # skip records a restore expects to re-deliver (the same
            # loud-failure contract as a truncated committed range).
            # start_offset == 0 stays legal: a fresh consumer reading
            # "from earliest available" starts at the floor by design.
            raise LogError(
                f"topic {self.path!r} p{p}: replay position "
                f"{start_offset} is below the retention floor "
                f"{self._starts[p]} — the checkpointed range was "
                "expired by retention (an anonymous reader's positions "
                "are not part of the safety floor; use a consumer "
                "group to pin history)")
        for seg in self._segments[p]:
            if seg.end <= start_offset:
                continue
            path = os.path.join(_partition_dir(self.path, p), seg.name)
            zc = self.zero_copy
            local = _local_path(path) if zc else None
            if local is not None:
                # sealed segment on a local filesystem: decode straight
                # out of the page cache (segments are renamed into
                # place complete, so the mapping never sees a growing
                # file; a view outliving a retention delete keeps its
                # pages via the mapping — POSIX unlink semantics)
                data = map_file_image(local)
            else:
                with self._fs.open_read(path) as f:
                    data = f.read()
                if isinstance(data, str):
                    data = data.encode("utf-8")
            rows_seen = 0
            if seg.sparse:
                for block in iter_blocks(
                        data, expect_schema=self._sparse_schema(),
                        zero_copy=zc):
                    offs = np.asarray(block[OFFSET_COL], np.int64)
                    rows_seen += len(offs)
                    if not len(offs) or int(offs[-1]) < start_offset:
                        continue
                    cut = int(np.searchsorted(offs, start_offset))
                    payload = {k: v[cut:] for k, v in block.items()
                               if k != OFFSET_COL}
                    yield (int(offs[cut]), int(offs[-1]) + 1, payload)
            else:
                offset = seg.base
                for block in iter_blocks(data,
                                         expect_schema=self._schema,
                                         zero_copy=zc):
                    n = len(next(iter(block.values()), ()))
                    rows_seen += n
                    if offset + n <= start_offset:
                        offset += n
                        continue
                    if offset < start_offset:
                        cut = start_offset - offset
                        block = {k: v[cut:] for k, v in block.items()}
                        offset = start_offset
                    n_out = len(next(iter(block.values()), ()))
                    yield offset, offset + n_out, block
                    offset += n_out
            if rows_seen != seg.rows:
                raise LogError(
                    f"topic {self.path!r} p{p}: segment {seg.name!r} "
                    f"holds {rows_seen} rows, its "
                    f"{'manifest entry' if seg.sparse else 'commit marker'}"
                    f" promised {seg.rows} (corrupt segment)")


def list_leases(path: str) -> Dict[int, Dict[str, Any]]:
    """Per-partition writer leases on file: {p: {"owner", "epoch",
    "deadline_ms", ...}} — the read side of log/bus.py LeaseManager
    (inspection + fencing checks share it)."""
    fs = get_filesystem(path)
    ldir = os.path.join(path, LEASE_DIR)
    out: Dict[int, Dict[str, Any]] = {}
    if not fs.exists(ldir):
        return out
    pat = re.compile(r"^p(\d+)\.json$")
    for name in fs.listdir(ldir):
        m = pat.match(name)
        if m is None:
            continue
        out[int(m.group(1))] = _read_json(
            fs, os.path.join(ldir, name), "lease file")
    return out


def list_group_offsets(path: str,
                       group: Optional[str] = None
                       ) -> Dict[str, Dict[int, int]]:
    """Committed consumer-group offsets: {group: {p: offset}} — the
    read side of log/bus.py ConsumerGroups (the compaction/retention
    safety floor and the CLI's per-group view). ``group`` restricts
    the scan to ONE group's directory — the per-checkpoint commit
    round and split bootstrap use it so their cost is O(own
    partitions), not O(all groups x partitions)."""
    fs = get_filesystem(path)
    gdir = os.path.join(path, GROUP_DIR)
    out: Dict[str, Dict[int, int]] = {}
    if not fs.exists(gdir):
        return out
    pat = re.compile(r"^p(\d+)\.json$")
    names = [group] if group is not None else fs.listdir(gdir)
    for gname in names:
        sub = os.path.join(gdir, gname)
        if not fs.exists(sub) or not fs.is_dir(sub):
            continue
        offsets: Dict[int, int] = {}
        for name in fs.listdir(sub):
            m = pat.match(name)
            if m is None:
                continue
            rec = _read_json(fs, os.path.join(sub, name),
                             "group-offset file")
            try:
                offsets[int(m.group(1))] = int(rec["offset"])
            except (ValueError, KeyError, TypeError) as e:
                raise LogError(
                    f"corrupt group-offset file {gname}/{name!r} in "
                    f"topic {path!r}: {e}") from e
        out[gname] = offsets
    return out


def describe_topic(path: str) -> Dict[str, Any]:
    """Inspection view (the CLI ``log`` subcommand): partitions,
    committed offsets, staged (pre-committed, uncommitted)
    transactions, per-partition segment counts — plus the message-bus
    tier's state: compaction generation, retention floor, active
    writer leases with fencing epochs, per-consumer-group committed
    offsets + membership generations (dynamic groups), and the
    background cleaner's lease/status (log/cleaner.py)."""
    # deferred: cleaner.py imports this module at load time
    from flink_tpu_torch.log.cleaner import (
        cleaner_status,
        live_cleaner_owner,
        read_cleaner_lease,
    )
    fs = get_filesystem(path)
    reader = TopicReader(path)
    pres = _list_markers(fs, path, "pre")
    commits = _list_markers(fs, path, "commit")
    committed = reader.committed_offsets()
    starts = reader.start_offsets()
    cends = reader.compacted_ends()

    def _txn_view(keys):
        # legacy shape for single-writer topics (a sorted cid list —
        # tests and operators key on it); writer-scoped markers are
        # reported per writer alongside
        return sorted(cid for cid, w in keys if not w)

    def _writer_view(keys):
        by_w: Dict[str, List[int]] = {}
        for cid, w in keys:
            if w:
                by_w.setdefault(w, []).append(cid)
        return {w: sorted(c) for w, c in sorted(by_w.items())}

    staged = set(pres) - set(commits)
    return {
        "topic": path,
        "partitions": reader.partitions,
        "committed_offsets": {str(p): committed[p] for p in committed},
        "committed_records": int(sum(committed.values())),
        "committed_transactions": _txn_view(commits),
        "staged_transactions": _txn_view(staged),
        "writer_transactions": {
            "committed": _writer_view(commits),
            "staged": _writer_view(staged)},
        "segments": {str(p): len(reader._segments[p])
                     for p in reader._segments},
        "schema": ([[n, t] for n, t in reader._schema]
                   if reader._schema else None),
        "compaction_generation": reader.generation,
        "retention_floor": {str(p): starts[p] for p in sorted(starts)},
        "compacted_end": {str(p): cends[p] for p in sorted(cends)},
        "key_field": topic_key_field(path),
        "leases": {str(p): lease
                   for p, lease in sorted(list_leases(path).items())},
        "groups": {g: {str(p): off for p, off in sorted(offs.items())}
                   for g, offs in sorted(list_group_offsets(path).items())},
        "group_generations": _group_generations(fs, path),
        "cleaner": {
            "status": cleaner_status(path),
            "lease": read_cleaner_lease(path),
            "live_owner": live_cleaner_owner(path),
        },
    }


def _group_generations(fs, path: str) -> Dict[str, int]:
    """Per-group membership generation (dynamic groups only — a
    static group has no manifest and is simply absent here)."""
    gdir = os.path.join(path, GROUP_DIR)
    out: Dict[str, int] = {}
    if not fs.exists(gdir):
        return out
    for gname in sorted(fs.listdir(gdir)):
        mpath = os.path.join(gdir, gname, "membership.json")
        sub = os.path.join(gdir, gname)
        if not fs.is_dir(sub) or not fs.exists(mpath):
            continue
        try:
            out[gname] = int(_read_json(
                fs, mpath, "group membership").get("generation", 0))
        except (OSError, ValueError, LogError):
            continue
    return out
