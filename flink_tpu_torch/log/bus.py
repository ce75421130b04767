"""Embedded message-bus tier over the durable log — key compaction,
time/size retention, fenced per-partition writer leases, consumer
groups (ref: the Kafka broker's log cleaner + retention +
producer-epoch fencing + consumer-group offset commit, rebuilt
WITHOUT a broker process on the shared-filesystem topics of
``log/topic.py``).

What each plane does and where the state lives:

**Key compaction** (``Compactor``): rewrites sealed committed segments
below the safety floor into sparse COMPACTED segments keeping only the
latest committed row per key (original offsets preserved in a
``__offset`` column), then swaps the new generation in atomically via
``manifest.json`` — readers observe the old or the new generation
whole, never a half-compacted topic. The safety floor per partition is
``min(lowest consumer-group committed offset, lowest open pre-commit
marker base, committed end)``: compaction can never outrun a consumer
group or an in-flight transaction.

**Retention** (``Retention``): advances the manifest's per-partition
``start`` over whole sealed segments that are older than
``retention_ms`` (by the topic's ts column) or that overflow
``retention_bytes``, under the same safety floor. Manifest swap first,
file deletes after — a crash in between leaves droppable debris the
orphan sweep (``TopicAppender.sweep_orphans``) removes.

**Writer leases** (``LeaseManager``): one JSON lease file per
partition (``leases/p<k>.json``) carrying owner + fencing EPOCH +
deadline. M producers may own disjoint partition sets of one topic
concurrently; a lease is re-verified and renewed before every marker
publication, so a deposed holder (another producer took the expired
partition over, bumping the epoch) raises instead of publishing — the
attempt-epoch fencing discipline applied to partition ownership.
Acquisition is serialized by an O_EXCL lock file on local filesystems;
on a conditional-put scheme (``fs.cas_capable`` — the objstore
driver) every lease write is a compare-and-swap at the etag the
decision read, so the race is PREVENTED, not bounded; on any other
remote scheme it degrades to read-check-write (the epoch fence still
rejects the loser's writes at the next verify — honest scope).

**Consumer groups** (``ConsumerGroups``): per-group, per-partition
committed-offset files (``groups/<name>/p<k>.json``), max-merged
atomically so they never regress. ``LogSource`` members publish their
checkpointed positions here at checkpoint complete (the driver's
commit round), making the group floor the compaction/retention safety
bound and the cross-generation resume point: a NEW job joining group G
bootstraps from G's committed offsets — reading compacted history
first, then the live tail (the backfill-then-live shape).

**Dynamic membership + rebalance**: a durable group manifest
(``groups/<name>/membership.json``) carrying the sorted member list +
a GENERATION that bumps on every join/leave; assignment is
``partition % len(members)`` over the sorted list, and offset commits
may be KEYED by the generation the member joined at — a commit at a
stale generation is rejected at the fence (a deposed member's late
offsets can never interleave with the new generation's), the
writer-lease epoch discipline applied to group membership.

Fault points (registered in ``faults.KNOWN_FAULT_POINTS``):
``log.compact.rewrite`` / ``log.compact.swap`` /
``log.retention.drop`` / ``log.lease.acquire`` / ``log.lease.renew`` /
``log.group.commit`` / ``log.group.rebalance`` / ``log.group.fence``
— chaos gates in tests/test_torch_log_chaos.py.

Honest scope: no broker process — all participants share one
filesystem (or one fake object store); background maintenance exists
(``log/cleaner.py``'s leased cleaner, driver-owned) but is a thread in
a participant process, not a broker; a reader holding a pre-swap
snapshot whose files a later swap deleted fails loudly and retries
with a fresh snapshot; dynamic-group members are never auto-evicted —
a crashed member stays in the manifest until it re-joins or an
operator removes it.
"""
from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from flink_tpu_torch.formats_columnar import ColumnarWriter, iter_blocks
from flink_tpu_torch.fs import (CASConflictError, cas_capable,
                                get_filesystem, open_write_sync)
from flink_tpu_torch.log.topic import (
    GROUP_DIR,
    LEASE_DIR,
    MAINT_LOCK,
    MAINT_LOCK_STALE_MS,
    MANIFEST,
    OFFSET_COL,
    LogError,
    TopicReader,
    _WRITER_RE,
    _list_markers,
    _marker_ids,
    _partition_dir,
    _read_json,
    _write_atomic,
    _break_stale_lock,
    _local_path,
    _unlink_if_ours,
    compacted_seg_name,
    list_group_offsets,
    release_maintenance_lock,
    topic_key_field,
    try_maintenance_lock,
)

__all__ = ["LeaseError", "LeaseManager", "ConsumerGroups", "Compactor",
           "Retention", "TopicMaintenance", "maintenance_pass",
           "try_maintenance_lock", "release_maintenance_lock", "LogError",
           "MAINT_LOCK", "MAINT_LOCK_STALE_MS"]


class LeaseError(LogError):
    """A fencing rejection: the partition is leased by another live
    producer, or THIS producer was deposed (its epoch is stale). Always
    loud — a deposed writer's late publication would corrupt the
    successor's partition."""


def _now_ms() -> int:
    return int(time.time() * 1000)


# a join/leave is sub-second; a membership lock older than this is a
# crashed member's leftover and is broken (rename-first, racing-safe)
_MEMBERSHIP_LOCK_STALE_MS = 15_000


@contextlib.contextmanager
def _membership_lock(local_manifest: str):
    """O_EXCL serialization of membership read-mutate-publish on local
    filesystems (conditional-put schemes use the CAS loop instead)."""
    lock = local_manifest + ".lock"
    fd = None
    for _ in range(3):
        try:
            fd = os.open(lock, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
            break
        except FileExistsError:
            try:
                age_ms = (time.time() - os.path.getmtime(lock)) * 1000
            except OSError:
                continue  # vanished under us — retry
            if age_ms > _MEMBERSHIP_LOCK_STALE_MS:
                _break_stale_lock(lock)
                continue
            raise LogError(
                f"another member is rebalancing right now "
                f"({lock} held) — retry the join/leave")
    if fd is None:
        raise LogError(
            f"could not take the membership lock at {lock}")
    try:
        yield
    finally:
        _unlink_if_ours(lock, fd)


class LeaseManager:
    """Fenced per-partition writer leases for one producer.

    ``acquire()`` takes every partition in ``partitions`` or raises
    (all-or-nothing — a producer half-holding its set could stage
    transactions it can never commit). Epoch discipline: a fresh
    partition starts at epoch 1; the SAME owner re-acquiring (attempt
    restart) keeps its epoch; taking over another owner's expired
    lease bumps it — the bumped epoch is what rejects the deposed
    holder's late writes at its next ``verify``.
    """

    def __init__(self, path: str, owner: str, partitions: List[int],
                 ttl_ms: int = 30_000, now_fn=None) -> None:
        if not _WRITER_RE.match(owner or ""):
            raise LeaseError(
                f"lease owner {owner!r} must match [A-Za-z0-9_.-]+")
        if ttl_ms < 1:
            raise LeaseError(f"lease ttl must be >= 1ms, got {ttl_ms}")
        self.path = path
        self.topic = os.path.basename(os.path.normpath(path)) or "topic"
        self.owner = owner
        self.partitions = sorted(int(p) for p in partitions)
        self.ttl_ms = int(ttl_ms)
        self._now = now_fn or _now_ms
        self._fs = get_filesystem(path)
        # conditional-put schemes serialize the read-decide-write via
        # CAS on the lease file itself (etag captured at read, checked
        # at publish) — no O_EXCL lock file, no fence degradation
        self._cas = (_local_path(path) is None
                     and cas_capable(self._fs))
        self._etags: Dict[int, Optional[str]] = {}
        self.epochs: Dict[int, int] = {}

    def _lease_path(self, p: int) -> str:
        return os.path.join(self.path, LEASE_DIR, f"p{p}.json")

    def _read(self, p: int) -> Optional[Dict[str, Any]]:
        lp = self._lease_path(p)
        if self._cas:
            # etag-consistent read: the captured etag must describe the
            # exact bytes the decision is made on, or the later put_if
            # could succeed against a record we never saw
            for _ in range(3):
                tag = self._fs.etag(lp)
                if tag is None:
                    self._etags[p] = None
                    return None
                try:
                    rec = _read_json(self._fs, lp, "lease file")
                except OSError:
                    continue  # replaced under us — retry
                if self._fs.etag(lp) == tag:
                    self._etags[p] = tag
                    return rec
            raise LeaseError(
                f"partition p{p} of topic {self.path!r}: lease file "
                "churning under concurrent writers — retry")
        if not self._fs.exists(lp):
            return None
        return _read_json(self._fs, lp, "lease file")

    def _publish(self, p: int, payload: bytes) -> None:
        """Publish one lease record: conditional put against the etag
        the decision was read at (CAS schemes — a conflict means we
        lost the race and the acquire/renew must die loudly), plain
        atomic write elsewhere (serialized by ``_acquire_lock``)."""
        if self._cas:
            try:
                self._etags[p] = self._fs.put_if(
                    self._lease_path(p), payload, self._etags.get(p))
            except CASConflictError as e:
                raise LeaseError(
                    f"partition p{p} of topic {self.path!r}: lost the "
                    f"conditional-write race ({e}) — another producer "
                    "published the lease first") from e
            return
        _write_atomic(self._fs, self._lease_path(p), payload)

    def _write(self, p: int, epoch: int, now: int) -> None:
        self._publish(p, json.dumps({
            "owner": self.owner, "epoch": int(epoch),
            "acquired_ms": int(now),
            "deadline_ms": int(now + self.ttl_ms),
        }).encode("utf-8"))

    @contextlib.contextmanager
    def _acquire_lock(self, p: int):
        """O_EXCL serialization of the read-decide-write acquire on
        local filesystems; a crashed acquirer's stale lock (older than
        the ttl) is broken. Conditional-put schemes need no lock file:
        ``_publish`` CAS-checks the etag captured at read, so of two
        racing acquirers exactly one lands and the loser raises.
        Non-local schemes WITHOUT conditional put skip the lock — the
        epoch fence still rejects a race loser's writes at its next
        verify (documented degradation, not silent corruption)."""
        lock = self._lease_path(p) + ".lock"
        local = _local_path(lock)
        if local is None:
            yield
            return
        fd = None
        for _ in range(3):
            try:
                fd = os.open(local,
                             os.O_CREAT | os.O_EXCL | os.O_WRONLY)
                break
            except FileExistsError:
                try:
                    age_ms = (time.time()
                              - os.path.getmtime(local)) * 1000
                except OSError:
                    continue  # vanished under us — retry
                if age_ms > max(self.ttl_ms, 1_000):
                    # rename-first break: of two racing breakers
                    # exactly one wins the atomic rename — the loser
                    # can never unlink the winner's FRESH lock
                    _break_stale_lock(local)
                    continue
                raise LeaseError(
                    f"partition p{p} of topic {self.path!r}: another "
                    "producer is acquiring the lease right now (lock "
                    "held)")
        if fd is None:
            raise LeaseError(
                f"partition p{p} of topic {self.path!r}: could not "
                "take the acquisition lock")
        try:
            yield
        finally:
            # inode-checked: if OUR stale lock was broken and replaced
            # mid-hold, a blind unlink would delete the new holder's
            _unlink_if_ours(local, fd)

    def acquire(self) -> Dict[int, int]:
        """Take (or re-take) every partition; returns {p: epoch}.
        All-or-nothing: when a later partition's acquisition fails,
        the leases already written are rolled back (released) before
        the error escapes — a half-holding producer must not lock
        partitions it can never use out for a full ttl."""
        from flink_tpu_torch import faults

        self._fs.mkdirs(os.path.join(self.path, LEASE_DIR))
        got: Dict[int, int] = {}
        try:
            for p in self.partitions:
                with self._acquire_lock(p):
                    faults.fire("log.lease.acquire", exc=OSError,
                                topic=self.topic, partition=p,
                                owner=self.owner)
                    cur = self._read(p)
                    now = self._now()
                    if cur is None:
                        epoch = 1
                    elif cur.get("owner") == self.owner:
                        epoch = int(cur.get("epoch", 1))  # ours: renew
                    elif now >= int(cur.get("deadline_ms", 0)):
                        epoch = int(cur.get("epoch", 0)) + 1  # takeover
                    else:
                        raise LeaseError(
                            f"partition p{p} of topic {self.path!r} is "
                            f"leased by {cur.get('owner')!r} (epoch "
                            f"{cur.get('epoch')}) until "
                            f"{cur.get('deadline_ms')} — two writers "
                            "on one partition are illegal; lease "
                            "disjoint sets")
                    self._write(p, epoch, now)
                    got[p] = epoch
        except BaseException:
            self.epochs = got
            with contextlib.suppress(Exception):
                self.release()  # roll the partial hold back
            raise
        self.epochs = got
        return dict(got)

    def verify(self, renew: bool = True) -> None:
        """The fencing gate (TopicAppender calls it before every
        marker publication): every owned partition's lease file must
        still show OUR owner at OUR epoch — anything else means we
        were deposed and the late write must die here. ``renew``
        extends the deadline — but only once LESS THAN HALF the ttl
        remains: the read-only epoch check is the fence and runs every
        call; rewriting P fsynced lease files twice per checkpoint
        would tax the 2PC hot path for a deadline that is almost
        always nowhere near expiry."""
        from flink_tpu_torch import faults

        if not self.epochs:
            raise LeaseError(
                f"lease for topic {self.path!r} was never acquired "
                "(call acquire() before staging)")
        faults.fire("log.lease.renew", exc=OSError, topic=self.topic,
                    owner=self.owner)
        now = self._now()
        for p in self.partitions:
            cur = self._read(p)
            if (cur is None or cur.get("owner") != self.owner
                    or int(cur.get("epoch", -1)) != self.epochs[p]):
                raise LeaseError(
                    f"writer {self.owner!r} DEPOSED from partition "
                    f"p{p} of topic {self.path!r}: lease now held by "
                    f"{(cur or {}).get('owner')!r} at epoch "
                    f"{(cur or {}).get('epoch')} (ours: "
                    f"{self.epochs[p]}) — rejecting the late write")
            if renew and (int(cur.get("deadline_ms", 0)) - now
                          < self.ttl_ms / 2):
                self._write(p, self.epochs[p], now)

    def release(self) -> None:
        """Drop our leases (clean shutdown). The file is kept with a
        ``released`` flag and a zeroed deadline rather than deleted, so
        the fencing EPOCH stays monotone across owners — a successor
        always acquires at epoch+1, and the takeover sweep can still
        order any marker this owner left behind. Only files still
        showing our owner+epoch are touched — never a successor's."""
        now = self._now()
        for p in list(self.epochs):
            cur = self._read(p)
            if (cur is not None and cur.get("owner") == self.owner
                    and int(cur.get("epoch", -1)) == self.epochs[p]):
                with contextlib.suppress(LeaseError):
                    # a release racing our own deposition is moot —
                    # the successor's record stands either way
                    self._publish(p, json.dumps({
                        "owner": self.owner, "epoch": self.epochs[p],
                        "acquired_ms": int(cur.get("acquired_ms", now)),
                        "deadline_ms": 0, "released": True,
                    }).encode("utf-8"))
        self.epochs = {}


class ConsumerGroups:
    """Per-group, per-partition committed offsets — one atomic JSON
    file per (group, partition) so concurrent members (disjoint
    partitions) never read-modify-write each other's commits. Offsets
    MAX-MERGE: a replayed commit (restore re-runs the commit round)
    can never regress the group floor.

    DYNAMIC MEMBERSHIP (the rebalance protocol): a group may keep a
    durable manifest (``groups/<g>/membership.json`` — sorted member
    ids + a monotone GENERATION). ``join``/``leave`` bump the
    generation and re-partition ``p % len(members)`` by sorted index;
    a commit keyed by a deposed generation is REJECTED at the fence
    (the writer-lease epoch discipline applied to membership), so a member
    that missed a rebalance can never move the floor with offsets it
    no longer owns. Groups without a manifest stay static — the
    legacy ``log.group.member/members`` config path, unchanged."""

    MEMBERSHIP = "membership.json"

    @staticmethod
    def _validate(group: str) -> None:
        if not _WRITER_RE.match(group or ""):
            raise LogError(
                f"consumer-group name {group!r} must match "
                "[A-Za-z0-9_.-]+ (it becomes a directory name)")

    @staticmethod
    def _membership_path(path: str, group: str) -> str:
        return os.path.join(path, GROUP_DIR, group,
                            ConsumerGroups.MEMBERSHIP)

    @staticmethod
    def read_membership(path: str,
                        group: str) -> Optional[Dict[str, Any]]:
        """{"generation", "members"} of a dynamic group, or None for
        a static group (no manifest on file)."""
        fs = get_filesystem(path)
        mp = ConsumerGroups._membership_path(path, group)
        if not fs.exists(mp):
            return None
        rec = _read_json(fs, mp, "group membership manifest")
        return {"generation": int(rec.get("generation", 0)),
                "members": [str(m) for m in rec.get("members", [])]}

    @staticmethod
    def _update_membership(path: str, group: str, mutate):
        """Serialized read-mutate-publish of the membership manifest:
        CAS loop on conditional-put schemes, O_EXCL + stale-break on
        local filesystems (the LeaseManager discipline). ``mutate``
        returns the new record or None for a no-op; the caller's
        record is returned either way."""
        from flink_tpu_torch import faults

        ConsumerGroups._validate(group)
        fs = get_filesystem(path)
        gdir = os.path.join(path, GROUP_DIR, group)
        fs.mkdirs(gdir)
        mp = os.path.join(gdir, ConsumerGroups.MEMBERSHIP)
        topic = os.path.basename(os.path.normpath(path))

        def _norm(cur):
            if cur is None:
                return {"generation": 0, "members": []}
            return {"generation": int(cur.get("generation", 0)),
                    "members": [str(m) for m in cur.get("members", [])]}

        if _local_path(path) is None and cas_capable(fs):
            for _ in range(5):
                tag = fs.etag(mp)
                cur = (_read_json(fs, mp, "group membership manifest")
                       if tag is not None else None)
                rec = mutate(_norm(cur))
                if rec is None:
                    return _norm(cur)
                faults.fire("log.group.rebalance", exc=OSError,
                            topic=topic, group=group,
                            generation=rec["generation"])
                try:
                    fs.put_if(mp, json.dumps(
                        rec, sort_keys=True).encode("utf-8"), tag)
                    return rec
                except CASConflictError:
                    continue  # lost the rebalance race — re-read
            raise LogError(
                f"group {group!r} membership manifest churning under "
                f"concurrent join/leave on topic {path!r} — retry")
        local = _local_path(mp)
        with (_membership_lock(local) if local is not None
              else contextlib.nullcontext()):
            cur = (_read_json(fs, mp, "group membership manifest")
                   if fs.exists(mp) else None)
            rec = mutate(_norm(cur))
            if rec is None:
                return _norm(cur)
            faults.fire("log.group.rebalance", exc=OSError,
                        topic=topic, group=group,
                        generation=rec["generation"])
            _write_atomic(fs, mp, json.dumps(
                rec, sort_keys=True).encode("utf-8"))
            return rec

    @staticmethod
    def join(path: str, group: str,
             member: str) -> Tuple[int, int, int]:
        """Add ``member`` to the group's durable manifest (bumping the
        generation; idempotent re-join keeps it) and return
        (generation, member index, member count). Every live member
        re-derives its assignment from the bumped generation at its
        next fence check — that is the whole rebalance."""
        if not _WRITER_RE.match(member or ""):
            raise LogError(
                f"group member id {member!r} must match [A-Za-z0-9_.-]+")

        def mutate(cur):
            if member in cur["members"]:
                return None  # idempotent re-join: same generation
            return {"generation": cur["generation"] + 1,
                    "members": sorted(cur["members"] + [member])}

        rec = ConsumerGroups._update_membership(path, group, mutate)
        members = rec["members"]
        return (rec["generation"], members.index(member), len(members))

    @staticmethod
    def leave(path: str, group: str, member: str) -> int:
        """Remove ``member`` (bumping the generation; unknown member
        is a no-op) and return the resulting generation. The departed
        member's own late commits die at the fence from here on."""

        def mutate(cur):
            if member not in cur["members"]:
                return None
            return {"generation": cur["generation"] + 1,
                    "members": [m for m in cur["members"]
                                if m != member]}

        return ConsumerGroups._update_membership(
            path, group, mutate)["generation"]

    @staticmethod
    def assignment_for(path: str, group: str, member: str,
                       partitions: int) -> Tuple[int, List[int]]:
        """A dynamic member's current (generation, partitions): the
        sorted-index ``p % len(members)`` re-partition of the
        manifest's CURRENT generation. A member not in the manifest
        (deposed by leave, or never joined) fails loudly."""
        m = ConsumerGroups.read_membership(path, group)
        if m is None or member not in m["members"]:
            raise LogError(
                f"member {member!r} is not in consumer-group "
                f"{group!r} of topic {path!r} (members: "
                f"{(m or {}).get('members', [])}) — join() first")
        ix = m["members"].index(member)
        n = len(m["members"])
        return (m["generation"],
                [p for p in range(partitions) if p % n == ix])

    @staticmethod
    def commit(path: str, group: str, offsets: Dict[int, int],
               generation: Optional[int] = None) -> None:
        from flink_tpu_torch import faults

        ConsumerGroups._validate(group)
        fs = get_filesystem(path)
        gdir = os.path.join(path, GROUP_DIR, group)
        fs.mkdirs(gdir)
        topic = os.path.basename(os.path.normpath(path))
        faults.fire("log.group.commit", exc=OSError,
                    topic=topic, group=group)
        if generation is not None:
            # THE FENCE: a generation-keyed commit must match the
            # manifest's current generation — a deposed member (a
            # rebalance it missed bumped past it) no longer owns the
            # partitions it is trying to commit, and letting the
            # write through would double-count its rows against the
            # new owner's. Loud rejection; the member re-derives its
            # assignment and replays from committed offsets.
            faults.fire("log.group.fence", exc=OSError,
                        topic=topic, group=group, generation=generation)
            m = ConsumerGroups.read_membership(path, group)
            current_gen = 0 if m is None else m["generation"]
            if generation != current_gen:
                raise LogError(
                    f"consumer-group {group!r} commit at DEPOSED "
                    f"generation {generation} (current "
                    f"{current_gen}) on topic {path!r} — rejected at "
                    "the fence; re-derive the assignment and retry")
        cas = _local_path(path) is None and cas_capable(fs)
        # targeted read: the per-checkpoint commit round must cost
        # O(this group's partitions), not O(all groups x partitions)
        current = list_group_offsets(path, group=group).get(group, {})
        for p, off in sorted(offsets.items()):
            p, off = int(p), int(off)
            if off <= current.get(p, 0) and p in current:
                continue  # never regress, skip no-op rewrites
            opath = os.path.join(gdir, f"p{p}.json")
            rec = {"offset": max(off, current.get(p, 0))}
            if generation is not None:
                rec["generation"] = int(generation)
            if cas:
                ConsumerGroups._cas_commit_one(fs, opath, rec)
            else:
                _write_atomic(fs, opath,
                              json.dumps(rec).encode("utf-8"))

    @staticmethod
    def _cas_commit_one(fs, opath: str, rec: Dict[str, Any]) -> None:
        """One offset file's max-merge publish as a CAS loop: re-read
        at the current etag, merge, conditional put — two members
        handing a partition over mid-rebalance can race this file and
        neither's progress may be lost."""
        for _ in range(4):
            tag = fs.etag(opath)
            if tag is not None:
                cur = _read_json(fs, opath, "group-offset file")
                merged = dict(rec)
                merged["offset"] = max(int(rec["offset"]),
                                       int(cur.get("offset", 0)))
                if "generation" not in merged and "generation" in cur:
                    merged["generation"] = cur["generation"]
            else:
                merged = rec
            try:
                fs.put_if(opath, json.dumps(merged).encode("utf-8"),
                          tag)
                return
            except CASConflictError:
                continue
        raise LogError(
            f"group-offset file {opath!r} churning under concurrent "
            "committers — retry the commit round")

    @staticmethod
    def committed(path: str, group: str) -> Dict[int, int]:
        return list_group_offsets(path, group=group).get(group, {})

    @staticmethod
    def assignment(partitions: int, member: int,
                   members: int) -> List[int]:
        """Static partition assignment: ``p % members == member`` —
        deterministic and disjoint, no broker to rebalance."""
        if members < 1:
            raise LogError(f"group needs >= 1 members, got {members}")
        if not 0 <= member < members:
            raise LogError(
                f"member index {member} outside [0, {members})")
        return [p for p in range(partitions) if p % members == member]

    @staticmethod
    def floor(path: str, partitions: int) -> Dict[int, Optional[int]]:
        """Per-partition lowest committed offset across ALL groups —
        the consumer half of the compaction/retention safety floor.
        None = no group has registered (no consumer constraint); a
        group that exists but has not committed a partition pins that
        partition's floor at 0."""
        groups = list_group_offsets(path)
        if not groups:
            return {p: None for p in range(partitions)}
        return {p: min(offs.get(p, 0) for offs in groups.values())
                for p in range(partitions)}


@contextlib.contextmanager
def maintenance_pass(path: str):
    """Serialize maintenance: one compaction/retention pass at a time
    per store directory (last-rename-wins on manifest.json would
    otherwise let two concurrent passes delete each other's referenced
    files), and the lock's presence tells a racing recovery sweep that
    unreferenced cmp files may be a live pass's PRE-swap output —
    sweep_orphans skips cmp cleanup while it is held. Public seam: the
    LSM state tier (state/lsm.py) runs its leveled run
    compaction under the same discipline, one lock file per store."""
    fd = try_maintenance_lock(path)
    if fd is None:
        raise LogError(
            f"another maintenance pass is running on {path!r} "
            "(maintenance.lock held) — compaction/retention passes "
            "are one-at-a-time per directory; retry when it finishes")
    try:
        yield
    finally:
        release_maintenance_lock(path, fd)



def _staged_floor(fs, path: str, partitions: int) -> Dict[int, int]:
    """Per-partition lowest base offset of any OPEN (staged,
    uncommitted) transaction — compaction/retention must never touch
    rows an in-flight 2PC could still roll back or re-commit."""
    pres = _list_markers(fs, path, "pre")
    commits = _marker_ids(fs, path, "commit")
    out = {p: None for p in range(partitions)}
    for key, pre in pres.items():
        if key in commits:
            continue
        for p_s, segs in pre.get("segments", {}).items():
            p = int(p_s)
            for s in segs:
                base = int(s["base"])
                if out.get(p) is None or base < out[p]:
                    out[p] = base
    return out


def _safety_floor(path: str, reader: TopicReader) -> Dict[int, int]:
    """min(consumer-group floor, open-transaction floor, committed
    end) per partition — the highest offset compaction/retention may
    touch rows strictly below."""
    fs = get_filesystem(path)
    committed = reader.committed_offsets()
    groups = ConsumerGroups.floor(path, reader.partitions)
    staged = _staged_floor(fs, path, reader.partitions)
    floor: Dict[int, int] = {}
    for p in range(reader.partitions):
        f = committed[p]
        if groups[p] is not None:
            f = min(f, groups[p])
        if staged[p] is not None:
            f = min(f, staged[p])
        floor[p] = f
    return floor


def _swap_manifest(fs, path: str, topic: str, gen: int,
                   partitions: Dict[int, Dict[str, Any]]) -> None:
    """THE atomic visibility point of compaction/retention: the
    manifest rename. A raise at the fault point IS the crash between
    rewrite and swap — the new generation's files sit unreferenced
    (orphan-sweepable) and every reader still observes the old
    generation whole."""
    from flink_tpu_torch import faults

    payload = {
        "v": 1, "gen": int(gen),
        "partitions": {
            str(p): {"start": int(e["start"]),
                     "compacted_end": int(e["compacted_end"]),
                     "segments": e["segments"]}
            for p, e in sorted(partitions.items())},
    }
    faults.fire("log.compact.swap", exc=OSError, topic=topic, gen=gen)
    mpath = os.path.join(path, MANIFEST)
    if _local_path(path) is None and cas_capable(fs):
        # conditional-put swap: published against the manifest's etag
        # as read under the (CAS-held) maintenance lock — a conflict
        # means a pass raced us despite the lock (a broken-stale edge)
        # and MUST die loudly rather than last-rename-wins
        try:
            fs.put_if(mpath, json.dumps(payload).encode("utf-8"),
                      fs.etag(mpath))
        except CASConflictError as e:
            raise LogError(
                f"manifest swap of topic {path!r} lost the "
                f"conditional-write race at gen {gen} ({e}) — "
                "another maintenance pass published first") from e
        return
    _write_atomic(fs, mpath, json.dumps(payload).encode("utf-8"))


def _manifest_entries(reader: TopicReader) -> Dict[int, Dict[str, Any]]:
    """The current manifest state as mutable per-partition entries
    (empty defaults before the first generation)."""
    out: Dict[int, Dict[str, Any]] = {}
    for p in range(reader.partitions):
        segs = [{"name": s.name, "base": s.base, "end": s.end,
                 "rows": s.rows}
                for s in reader._segments[p] if s.sparse]
        out[p] = {"start": reader.start_offsets()[p],
                  "compacted_end": reader.compacted_ends()[p],
                  "segments": segs}
    return out


def _read_segment_rows(fs, path: str, reader: TopicReader,
                       seg) -> Tuple[np.ndarray, Dict[str, np.ndarray]]:
    """One sealed segment's (offsets, columns): sparse segments carry
    their offsets in the __offset column, dense ones are base+arange."""
    spath = os.path.join(_partition_dir(path, seg.p), seg.name)
    with fs.open_read(spath) as f:
        data = f.read()
    if isinstance(data, str):
        data = data.encode("utf-8")
    schema = (reader._sparse_schema() if seg.sparse else reader._schema)
    blocks = list(iter_blocks(data, expect_schema=schema))
    if not blocks:
        return (np.zeros(0, np.int64),
                {n: np.zeros(0) for n, _ in (reader._schema or ())})
    cols = {k: np.concatenate([b[k] for b in blocks])
            for k in blocks[0]}
    if seg.sparse:
        offs = np.asarray(cols.pop(OFFSET_COL), np.int64)
    else:
        n = len(next(iter(cols.values())))
        offs = seg.base + np.arange(n, dtype=np.int64)
    return offs, cols


class Compactor:
    """Latest-row-per-key rewrite of the history below the safety
    floor. Offsets are PRESERVED: each surviving row keeps its
    original offset in the sparse ``__offset`` column, so replay
    positions and committed ends are stable across compaction — a
    consumer group's committed offset means the same thing before and
    after the swap.

    Cost (honest scope): each pass re-reads and rewrites the ENTIRE
    retained prefix — the prior sparse generation folds with the newly
    eligible raw segments into one fresh generation, so a pass is
    O(retained history), not O(new segments). At embedded scale (an
    explicit maintenance invocation, not a broker's cleaner thread)
    that trade buys single-generation reads; an incremental cleaner
    that carries untouched sparse segments forward would need per-
    segment key indexes and is future work. Raise ``min_segments`` to
    amortize passes over more input."""

    def __init__(self, path: str, key_field: Optional[str] = None,
                 min_segments: int = 2,
                 segment_records: int = 65536) -> None:
        self.path = path
        self.topic = os.path.basename(os.path.normpath(path)) or "topic"
        self.key_field = key_field or topic_key_field(path)
        if not self.key_field:
            raise LogError(
                f"topic {path!r} records no key_field in meta.json and "
                "none was passed — key compaction needs the latest-wins "
                "key column (log.compaction.key-field)")
        if min_segments < 1:
            raise LogError(
                f"compaction min-segments must be >= 1, "
                f"got {min_segments}")
        self.min_segments = int(min_segments)
        self.segment_records = int(segment_records)
        self._fs = get_filesystem(path)

    def _latest_per_key(self, offs: np.ndarray,
                        cols: Dict[str, np.ndarray]
                        ) -> Tuple[np.ndarray, Dict[str, np.ndarray]]:
        keys = cols[self.key_field]
        # last occurrence per key in offset order: np.unique on the
        # REVERSED array returns first occurrences = forward lasts
        _, ridx = np.unique(keys[::-1], return_index=True)
        keep = np.sort(len(keys) - 1 - ridx)
        return offs[keep], {k: v[keep] for k, v in cols.items()}

    def _write_compacted(self, p: int, gen: int, offs: np.ndarray,
                         cols: Dict[str, np.ndarray], schema,
                         start: int, end: int) -> List[Dict[str, Any]]:
        """Write the survivors as sparse compacted segment files
        (chunked at segment_records); returns manifest entries
        covering [start, end) exactly."""
        from flink_tpu_torch import faults

        segs: List[Dict[str, Any]] = []
        n = len(offs)
        sparse_schema = ((OFFSET_COL, "i64"),) + tuple(schema)
        cover = start
        for lo in range(0, n, self.segment_records):
            hi = min(lo + self.segment_records, n)
            name = compacted_seg_name(gen, int(offs[lo]))
            pdir = _partition_dir(self.path, p)
            tmp = os.path.join(pdir, name + ".tmp")
            # sync-on-close: the compacted segment is durable before
            # the rename publishes it to the (imminent) manifest swap
            with open_write_sync(self._fs, tmp, sync=True) as f:
                w = ColumnarWriter(f, sparse_schema)
                faults.fire("log.compact.rewrite", exc=OSError,
                            topic=self.topic, partition=p, gen=gen)
                w.write_batch({OFFSET_COL: offs[lo:hi],
                               **{k: v[lo:hi] for k, v in cols.items()}})
                w.close()
                f.flush()
            self._fs.rename(tmp, os.path.join(pdir, name))
            seg_end = int(offs[hi - 1]) + 1 if hi < n else end
            segs.append({"name": name, "base": cover, "end": seg_end,
                         "rows": hi - lo})
            cover = seg_end
        if n:
            # ENTRY durability before the manifest swap references
            # these files: without the dir fsync a power cut could
            # lose the cmp renames AFTER the (durable) manifest swap
            # and post-swap deletes land — the new generation would
            # point at vanished files with the raw history already
            # gone, PERMANENT loss (found by the crash explorer,
            # CompactionTier of the crash-consistency tests)
            self._fs.fsync(_partition_dir(self.path, p))
        return segs

    def compact(self) -> Dict[str, Any]:
        """One compaction pass over every partition; returns a summary
        {"gen", "partitions": {p: {"floor", "rows_in", "rows_out"}}}.
        No-ops (gen unchanged) when no partition clears min_segments.
        Serialized per topic by the maintenance lock."""
        with maintenance_pass(self.path):
            return self._compact_locked()

    def _compact_locked(self) -> Dict[str, Any]:
        reader = TopicReader(self.path)
        floor = _safety_floor(self.path, reader)
        entries = _manifest_entries(reader)
        gen = reader.generation + 1
        summary: Dict[int, Dict[str, int]] = {}
        replaced: List[Tuple[int, str]] = []
        for p in range(reader.partitions):
            # the floor aligns DOWN to a sealed-segment boundary:
            # compaction rewrites whole segments only, so a group
            # offset mid-segment pins that segment's tail raw
            eligible = [s for s in reader._segments[p]
                        if s.end <= floor[p]]
            raw_eligible = [s for s in eligible if not s.sparse]
            if len(raw_eligible) < self.min_segments:
                continue
            cover_end = eligible[-1].end
            offs_parts, col_parts = [], []
            for s in eligible:
                o, c = _read_segment_rows(self._fs, self.path, reader, s)
                offs_parts.append(o)
                col_parts.append(c)
            offs = np.concatenate(offs_parts)
            cols = {k: np.concatenate([cp[k] for cp in col_parts])
                    for k in col_parts[0]}
            if self.key_field not in cols:
                raise LogError(
                    f"compaction key {self.key_field!r} missing from "
                    f"topic columns {sorted(cols)}")
            k_offs, k_cols = self._latest_per_key(offs, cols)
            start = entries[p]["start"]
            entries[p]["segments"] = self._write_compacted(
                p, gen, k_offs, k_cols, reader._schema, start,
                cover_end)
            entries[p]["compacted_end"] = cover_end
            replaced.extend((p, s.name) for s in eligible)
            summary[p] = {"floor": cover_end, "rows_in": len(offs),
                          "rows_out": len(k_offs)}
        if not summary:
            return {"gen": reader.generation, "partitions": {}}
        _swap_manifest(self._fs, self.path, self.topic, gen, entries)
        # post-swap cleanup: the replaced files are now unreferenced
        # debris; a crash from here on is recovered by sweep_orphans
        for p, name in replaced:
            seg = os.path.join(_partition_dir(self.path, p), name)
            if self._fs.exists(seg):
                self._fs.delete(seg)
        return {"gen": gen, "partitions": summary}


class Retention:
    """Whole-segment expiry below the safety floor: advance the
    manifest ``start`` over leading segments that violate the age or
    size budget, swap, then delete. Never splits a segment, never
    touches offsets at or above the floor."""

    def __init__(self, path: str, retention_ms: int = 0,
                 retention_bytes: int = 0,
                 ts_field: Optional[str] = None, now_fn=None) -> None:
        if retention_ms and not ts_field:
            raise LogError(
                "time retention needs ts_field: the age of a segment "
                "is its newest row's event time "
                "(log.retention.ts-field)")
        self.path = path
        self.topic = os.path.basename(os.path.normpath(path)) or "topic"
        self.retention_ms = int(retention_ms)
        self.retention_bytes = int(retention_bytes)
        self.ts_field = ts_field
        self._now = now_fn or _now_ms
        self._fs = get_filesystem(path)
        # sealed segments are immutable: their max ts never changes, so
        # one read per (partition, name) per Retention instance covers
        # every pass this instance runs
        self._max_ts_memo: Dict[Tuple[int, str], int] = {}

    def _seg_max_ts(self, reader: TopicReader, seg) -> int:
        memo_key = (seg.p, seg.name)
        if memo_key in self._max_ts_memo:
            return self._max_ts_memo[memo_key]
        _, cols = _read_segment_rows(self._fs, self.path, reader, seg)
        if self.ts_field not in cols:
            raise LogError(
                f"retention ts_field {self.ts_field!r} missing from "
                f"topic columns {sorted(cols)}")
        ts = np.asarray(cols[self.ts_field], np.int64)
        out = int(ts.max()) if len(ts) else 0
        self._max_ts_memo[memo_key] = out
        return out

    def apply(self) -> Dict[str, Any]:
        """One retention pass; returns {"gen", "dropped": {p: [seg
        names]}, "start": {p: new floor}}. No-ops when nothing is
        droppable. Serialized per topic by the maintenance lock.

        Cost (honest scope): the time criterion reads each candidate
        segment in full to find its newest event time (memoized per
        Retention instance — sealed segments are immutable; a fresh
        CLI invocation re-reads). Recording max-ts at seal time would
        need the appender to know the ts column; future work."""
        if self.retention_ms <= 0 and self.retention_bytes <= 0:
            return {"gen": TopicReader(self.path).generation,
                    "dropped": {}, "start": {}}
        with maintenance_pass(self.path):
            return self._apply_locked()

    def _apply_locked(self) -> Dict[str, Any]:
        from flink_tpu_torch import faults

        reader = TopicReader(self.path)
        floor = _safety_floor(self.path, reader)
        entries = _manifest_entries(reader)
        now = self._now()
        dropped: Dict[int, List[str]] = {}
        for p in range(reader.partitions):
            segs = reader._segments[p]
            # the size criterion is the only consumer of the stat pass
            sizes = ({s.name: self._fs.size(os.path.join(
                _partition_dir(self.path, p), s.name)) for s in segs}
                if self.retention_bytes > 0 else {})
            total = sum(sizes.values())
            drop: List[Any] = []
            for s in segs:  # leading-prefix only: offsets stay dense
                if s.end > floor[p]:
                    break
                expired = (self.retention_ms > 0
                           and now - self._seg_max_ts(reader, s)
                           > self.retention_ms)
                over_budget = (self.retention_bytes > 0
                               and total > self.retention_bytes)
                if not (expired or over_budget):
                    break
                drop.append(s)
                total -= sizes.get(s.name, 0)
            if not drop:
                continue
            new_start = drop[-1].end
            entries[p]["start"] = new_start
            entries[p]["compacted_end"] = max(
                entries[p]["compacted_end"], new_start)
            entries[p]["segments"] = [
                e for e in entries[p]["segments"]
                if e["end"] > new_start]
            dropped[p] = [s.name for s in drop]
        if not dropped:
            return {"gen": reader.generation, "dropped": {}, "start": {}}
        gen = reader.generation + 1
        _swap_manifest(self._fs, self.path, self.topic, gen, entries)
        # deletes AFTER the swap — log.retention.drop fires HERE, in
        # the post-swap window faults.py documents: a crash between
        # the manifest rename and the deletes leaves droppable debris
        # below the new start that sweep_orphans removes (the pre-swap
        # abort window is the shared log.compact.swap seam)
        for p, names in dropped.items():
            for name in names:
                faults.fire("log.retention.drop", exc=OSError,
                            topic=self.topic, partition=p,
                            segment=name)
                seg = os.path.join(_partition_dir(self.path, p), name)
                if self._fs.exists(seg):
                    self._fs.delete(seg)
        return {"gen": gen, "dropped": dropped,
                "start": {p: entries[p]["start"] for p in dropped}}


class TopicMaintenance:
    """The config-grammar face of the maintenance planes (the CLI's
    ``log TOPIC --compact/--retain`` and embedded schedulers): resolve
    ``log.compaction.*`` / ``log.retention.*`` into one pass each."""

    @staticmethod
    def compact_from_config(config, path: str) -> Dict[str, Any]:
        from flink_tpu_torch.config import LogOptions

        key = str(config.get(LogOptions.COMPACTION_KEY_FIELD)).strip()
        return Compactor(
            path, key_field=key or None,
            min_segments=int(config.get(
                LogOptions.COMPACTION_MIN_SEGMENTS)),
            segment_records=int(config.get(
                LogOptions.SEGMENT_RECORDS))).compact()

    @staticmethod
    def retain_from_config(config, path: str) -> Dict[str, Any]:
        from flink_tpu_torch.config import LogOptions

        ts = str(config.get(LogOptions.RETENTION_TS_FIELD)).strip()
        return Retention(
            path,
            retention_ms=int(config.get(LogOptions.RETENTION_MS)),
            retention_bytes=int(config.get(
                LogOptions.RETENTION_BYTES)),
            ts_field=ts or None).apply()
