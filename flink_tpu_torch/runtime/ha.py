"""High-availability services: leader election + persistent job store
(the JAX package's ``runtime/ha.py``). The lease record, the epoch
high-water mark, the takeover counter and the job store's files keep
the reference's names and formats, so an HA dir written by either
package is read by the other.

ref: runtime/highavailability/{HighAvailabilityServices,
zookeeper/ZooKeeperLeaderElectionHaServices}.java,
runtime/leaderelection/DefaultLeaderElectionService.java,
runtime/jobmanager/JobGraphStore (persistent submitted-job metadata),
runtime/checkpoint/DefaultCompletedCheckpointStore.java.

TPU-first shape: no ZooKeeper/etcd in the image, and the deployment
already requires a shared filesystem for checkpoints — so the same
substrate carries consensus: leadership is a lease FILE claimed with
O_CREAT|O_EXCL (atomic on POSIX) and renewed by mtime; a contender
steals a lease older than the timeout by rename-replacing it. The job
store is one JSON file per job, written atomically (tmp + rename) —
exactly the manifest-last discipline the checkpoint storage uses.
Completed-checkpoint state needs no separate store: checkpoint
manifests already live durably under the job's checkpoint dir and
``restore: latest`` resolves them; the job store only has to carry the
jobs themselves.
"""
from __future__ import annotations

import dataclasses
import json
import os
import threading
import time
import uuid
from typing import Callable, Dict, List, Optional

__all__ = ["LeaderElection", "JobStore", "leader_address",
           "takeover_count"]


@dataclasses.dataclass
class LeaderRecord:
    leader_id: str
    address: str          # host:port of the leader's RPC gateway
    epoch: int            # fencing token: increases on every takeover
    claimed_at: float
    # CAS-mode renewal stamp: object stores have no usable mtime, so
    # the lease's age lives IN the record (rewritten on every renew);
    # 0.0 on local filesystems where os.utime + mtime carry the age
    renewed_at: float = 0.0


class LeaderElection:
    """File-lease leader election on a shared directory.

    ``start()`` spawns the contender thread; ``on_grant(epoch)`` fires
    when leadership is won, ``on_revoke()`` if the lease is lost (e.g.
    the renewal thread finds another leader's record — clock skew or a
    partition where a contender stole the lease). The epoch is the
    fencing token (ref: FencedRpcEndpoint / leader session id): every
    takeover increments it, so stale leaders' writes are detectable.
    """

    def __init__(self, ha_dir: str, address: str,
                 lease_timeout_s: float = 10.0,
                 leader_id: Optional[str] = None) -> None:
        # normalize a file:// spelling up front: the election mixes the
        # FileSystem seam (hwm/counter writes) with raw O_EXCL lock
        # primitives (os.open has no scheme stripping) — one plain OS
        # path keeps both sides in ONE directory tree. Non-file schemes
        # are accepted ONLY when their filesystem advertises
        # conditional put (objstore-class CAS replaces every O_EXCL /
        # rename-first primitive below); anything else is rejected
        # loudly.
        if ha_dir.startswith("file://"):
            ha_dir = ha_dir[len("file://"):]
        self._cas = False
        self._fs = None
        if "://" in ha_dir:
            from flink_tpu_torch.fs import cas_capable, get_filesystem

            fs = get_filesystem(ha_dir)
            if not cas_capable(fs):
                raise ValueError(
                    f"high-availability.dir {ha_dir!r}: leader-election "
                    "leases use O_CREAT|O_EXCL, a local-filesystem "
                    "primitive, and this scheme's filesystem offers no "
                    "conditional-put replacement — point the HA dir at "
                    "a shared LOCAL path or a CAS-capable store")
            self._cas = True
            self._fs = fs
        self.ha_dir = ha_dir
        self.address = address
        self.leader_id = leader_id or f"coord-{uuid.uuid4().hex[:8]}"
        self.lease_timeout_s = lease_timeout_s
        self.is_leader = False
        self.epoch = 0
        self.on_grant: Optional[Callable[[int], None]] = None
        self.on_revoke: Optional[Callable[[], None]] = None
        self._closed = False
        self._thread: Optional[threading.Thread] = None
        if self._cas:
            self._fs.mkdirs(ha_dir)
        else:
            os.makedirs(ha_dir, exist_ok=True)

    @property
    def _lease(self) -> str:
        return os.path.join(self.ha_dir, "leader.lease")

    # -- lease file primitives ------------------------------------------
    def _read(self) -> Optional[LeaderRecord]:
        if self._cas:
            rec, _ = self._read_cas()
            return rec
        return self._read_path(self._lease)

    def _read_cas(self):
        """(record, etag) with etag-consistent capture — the etag must
        describe the exact bytes the decision is made on (the bus-tier
        LeaseManager discipline)."""
        for _ in range(3):
            try:
                tag = self._fs.etag(self._lease)
            except OSError:
                return None, None
            if tag is None:
                return None, None
            try:
                with self._fs.open_read(self._lease) as f:
                    raw = f.read()
                d = json.loads(raw.decode("utf-8")
                               if isinstance(raw, bytes) else raw)
                rec = LeaderRecord(
                    d["leader_id"], d["address"], int(d["epoch"]),
                    float(d["claimed_at"]),
                    float(d.get("renewed_at", d["claimed_at"])))
            except (OSError, ValueError, KeyError):
                continue  # replaced/torn under us — retry
            try:
                if self._fs.etag(self._lease) == tag:
                    return rec, tag
            except OSError:
                return None, None
        return None, None

    @staticmethod
    def _read_path(path: str) -> Optional[LeaderRecord]:
        try:
            with open(path) as f:
                d = json.load(f)
            return LeaderRecord(
                d["leader_id"], d["address"], int(d["epoch"]),
                float(d["claimed_at"]),
                float(d.get("renewed_at", d["claimed_at"])))
        except (OSError, ValueError, KeyError):
            return None

    def _claim_exclusive(self, rec: LeaderRecord) -> bool:
        """Claim an ABSENT lease with O_CREAT|O_EXCL (atomic on POSIX)
        or a create-only conditional put (CAS mode — the same
        exactly-one-winner guarantee, server-side): of N racing
        claimers exactly one wins. The written record (leader_id +
        epoch) is the claim's identity — release and revoke checks
        compare content, never inodes (which local filesystems recycle
        instantly)."""
        rec.renewed_at = rec.claimed_at
        payload = json.dumps(dataclasses.asdict(rec)).encode()
        if self._cas:
            from flink_tpu_torch.fs import CASConflictError

            try:
                self._fs.put_if(self._lease, payload, None)
                return True
            except CASConflictError:
                return False
        try:
            fd = os.open(self._lease,
                         os.O_CREAT | os.O_EXCL | os.O_WRONLY)
        except FileExistsError:
            return False
        with os.fdopen(fd, "wb") as f:
            f.write(payload)
        return True

    def _steal_stale_cas(self, cur: LeaderRecord) -> None:
        """CAS-mode steal: replace the stale record AT ITS ETAG — the
        conditional put is the whole rename-grave/identity-check/
        link-restore dance in one primitive. Of two racing breakers
        exactly one's put lands; the loser's 412 means a peer already
        broke + re-claimed, and it simply stands down."""
        from flink_tpu_torch.fs import CASConflictError

        self._record_hwm(cur.epoch)
        took, tag = self._read_cas()
        if (took is None or took.leader_id != cur.leader_id
                or took.epoch != cur.epoch
                or took.claimed_at != cur.claimed_at):
            return  # already broken/re-claimed by a faster breaker
        now = time.time()
        epoch = max(cur.epoch, self._epoch_hwm()) + 1
        rec = LeaderRecord(self.leader_id, self.address, epoch,
                           now, now)
        try:
            self._fs.put_if(
                self._lease,
                json.dumps(dataclasses.asdict(rec)).encode(), tag)
        except CASConflictError:
            return  # lost the steal race — the winner's claim stands
        self._bump_takeovers()
        self._granted(epoch)

    def _steal_stale(self, cur: LeaderRecord) -> None:
        """Break a stale incumbent's lease with the rename-first
        discipline (the bus writer-lease rule, log/topic.py
        _break_stale_lock): rename the stale file to a unique grave
        name FIRST — the rename is atomic, so of two racing breakers
        exactly one wins and the loser can never unlink the fresh
        lease the winner claims a moment later. The renamed file is
        identity-checked: if it is NOT the stale record this breaker
        observed (a peer already broke + re-claimed), it is restored
        via link() — which cannot clobber an even newer claim — and
        the steal aborts."""
        if self._cas:
            return self._steal_stale_cas(cur)
        # floor the fencing token BEFORE the lease disappears: a third
        # contender claiming the now-absent lease continues from the
        # high-water mark, never below the stale incumbent's epoch
        self._record_hwm(cur.epoch)
        grave = f"{self._lease}.stale-{uuid.uuid4().hex[:8]}"
        try:
            os.rename(self._lease, grave)
        except OSError:
            return  # another breaker won the rename
        took = self._read_path(grave)
        if (took is None or took.leader_id != cur.leader_id
                or took.epoch != cur.epoch
                or took.claimed_at != cur.claimed_at):
            # we renamed a FRESH lease a faster breaker just claimed:
            # put it back (link-first: if yet another claim landed in
            # the window, the restore fails instead of clobbering it —
            # the hwm keeps epochs monotone either way)
            try:
                os.link(grave, self._lease)
            except OSError:
                pass
            try:
                os.unlink(grave)
            except OSError:
                pass
            return
        os.unlink(grave)
        epoch = max(cur.epoch, self._epoch_hwm()) + 1
        if self._claim_exclusive(LeaderRecord(
                self.leader_id, self.address, epoch, time.time())):
            # a successful STEAL is a takeover; a fresh claim after a
            # clean handover is not (the epoch advances in both cases,
            # so epoch arithmetic cannot tell them apart — this
            # durable counter can)
            self._bump_takeovers()
            self._granted(epoch)

    def _bump_takeovers(self) -> None:
        path = os.path.join(self.ha_dir, "takeovers.count")
        tmp = path + f".{self.leader_id}.tmp"
        try:
            # writer-unique tmp then atomic rename (two racing stealers
            # must never interleave into one tmp); through the seam so
            # the counter is fsynced — entry fsync included — like
            # every other durable write
            from flink_tpu_torch.fs import get_filesystem, open_write_sync

            fs = get_filesystem(self.ha_dir)
            with open_write_sync(fs, tmp, sync=True) as f:
                f.write(str(takeover_count(self.ha_dir) + 1).encode())
            fs.rename(tmp, path)
            fs.fsync(self.ha_dir)
        except OSError:
            pass  # observability counter: never fail a takeover over it

    def _lease_age(self) -> float:
        if self._cas:
            rec = self._read()
            if rec is None:
                return float("inf")
            return time.time() - (rec.renewed_at or rec.claimed_at)
        try:
            return time.time() - os.path.getmtime(self._lease)
        except OSError:
            return float("inf")

    def _renew(self) -> None:
        """Extend our lease: mtime touch on local filesystems; in CAS
        mode a conditional rewrite of the record's renewed_at stamp at
        the etag we just read it under — a 412 means we were deposed
        between read and renew, surfaced as OSError so the next
        contention pass observes the thief's record and revokes."""
        if not self._cas:
            os.utime(self._lease)
            return
        from flink_tpu_torch.fs import CASConflictError

        rec, tag = self._read_cas()
        if (rec is None or rec.leader_id != self.leader_id
                or rec.epoch != self.epoch):
            return  # deposed — _contend_once's next read revokes
        rec.renewed_at = time.time()
        try:
            self._fs.put_if(
                self._lease,
                json.dumps(dataclasses.asdict(rec)).encode(), tag)
        except CASConflictError as e:
            raise OSError(f"lease renewal lost a CAS race: {e}") from e

    @property
    def _hwm_path(self) -> str:
        return os.path.join(self.ha_dir, "epoch.hwm")

    def _epoch_hwm(self) -> int:
        try:
            if self._cas:
                if not self._fs.exists(self._hwm_path):
                    return 0
                with self._fs.open_read(self._hwm_path) as f:
                    raw = f.read()
                return int((raw.decode("utf-8") if isinstance(raw, bytes)
                            else raw).strip() or 0)
            with open(self._hwm_path) as f:
                return int(f.read().strip() or 0)
        except FileNotFoundError:
            return 0  # genuinely never recorded
        except ValueError:
            return 0  # torn/garbage content: best effort
        # any OTHER OSError (shared-fs ESTALE/EIO) propagates: claiming
        # with a guessed epoch of 0 could REGRESS the fencing token —
        # _run's guard retries the whole contention pass instead

    def _record_hwm(self, epoch: int) -> None:
        if epoch <= self._epoch_hwm():
            return
        from flink_tpu_torch.fs import get_filesystem, open_write_sync

        fs = get_filesystem(self.ha_dir)
        tmp = self._hwm_path + f".{self.leader_id}.tmp"
        # the fencing-token floor MUST survive a power cut — a lost hwm
        # could let a fresh claim REGRESS epochs below a dead leader's.
        # Leader-id-unique tmp (racing contenders must not interleave
        # into one tmp — write_atomic's shared-name tmp would), then
        # the full durable-publish discipline INCLUDING the parent-dir
        # fsync: content fsync alone never persists the rename's
        # directory entry (the write_atomic rule, applied by hand)
        with open_write_sync(fs, tmp, sync=True) as f:
            f.write(str(epoch).encode())
        fs.rename(tmp, self._hwm_path)
        fs.fsync(self.ha_dir)

    # -- contender loop -------------------------------------------------
    def start(self) -> None:
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self) -> None:
        poll = max(self.lease_timeout_s / 4, 0.05)
        while not self._closed:
            try:
                self._contend_once()
            except OSError:
                # the HA dir is shared storage (NFS-class): transient
                # ESTALE/EIO must not kill the contender thread — a dead
                # thread never renews (undetected split-brain) and never
                # contends again
                pass
            time.sleep(poll)

    def _contend_once(self) -> None:
        if self.is_leader:
            cur = self._read()
            if cur is None or cur.leader_id != self.leader_id:
                # someone stole the lease (we stalled past timeout)
                self.is_leader = False
                if self.on_revoke:
                    self.on_revoke()
            else:
                from flink_tpu_torch import faults

                # the renewal seam: an injected OSError here is a
                # leader stalling past its lease (NFS blip, frozen
                # process) — the contender thread survives (the _run
                # guard) but the lease ages toward a standby's steal
                faults.fire("ha.lease.renew", exc=OSError,
                            leader=self.leader_id)
                self._renew()
        else:
            cur = self._read()
            if cur is None:
                # the fencing token must never regress: a fresh claim
                # after a clean handover continues from the recorded
                # high-water mark, not from 1
                epoch = self._epoch_hwm() + 1
                if self._claim_exclusive(LeaderRecord(
                        self.leader_id, self.address, epoch,
                        time.time())):
                    self._granted(epoch)
            elif (cur.leader_id != self.leader_id
                  and self._lease_age() > self.lease_timeout_s):
                # stale incumbent: rename-first break, then exclusive
                # re-claim with a higher epoch (see _steal_stale)
                self._steal_stale(cur)

    def _granted(self, epoch: int) -> None:
        self.is_leader = True
        self.epoch = epoch
        self._record_hwm(epoch)
        if self.on_grant:
            self.on_grant(epoch)

    def close(self) -> None:
        self._closed = True
        if self._thread is not None:
            self._thread.join(timeout=2.0)
        if self.is_leader:
            self._release_if_ours()

    def _release_if_ours(self) -> None:
        """Clean handover, identity-checked: the lease is removed ONLY
        if it still carries THIS incumbency's record (leader_id +
        epoch — inode numbers recycle instantly on local filesystems,
        so content is the identity; a blind remove could unlink the
        fresh lease of a contender that stole ours while we stalled).
        Rename-first like the steal, with a post-rename re-check that
        restores a raced replacement. CAS mode deletes after an
        etag-consistent identity check — a thief's replacement between
        check and delete is the same razor-thin window the local path
        closes with link-restore; the epoch high-water mark keeps the
        fencing token monotone even if that window fires, so the thief
        re-claims at hwm+1 rather than regressing."""
        if self._cas:
            try:
                rec, _ = self._read_cas()
                if (rec is not None
                        and rec.leader_id == self.leader_id
                        and rec.epoch == self.epoch):
                    self._fs.delete(self._lease)
            except OSError:
                pass
            return
        try:
            rec = self._read()
            if (rec is None or rec.leader_id != self.leader_id
                    or rec.epoch != self.epoch):
                return  # replaced: it is someone else's lease now
            grave = f"{self._lease}.rel-{uuid.uuid4().hex[:8]}"
            os.rename(self._lease, grave)
            took = self._read_path(grave)
            if (took is not None and took.leader_id == self.leader_id
                    and took.epoch == self.epoch):
                os.unlink(grave)
            else:
                # raced between read and rename: restore the thief's
                # lease (link-first — cannot clobber a newer claim)
                try:
                    os.link(grave, self._lease)
                except OSError:
                    pass
                os.unlink(grave)
        except OSError:
            pass


def takeover_count(ha_dir: str) -> int:
    """How many times leadership in ``ha_dir`` was TAKEN OVER (a
    contender stealing a lapsed lease). Clean stop/restart cycles do
    not count — the fencing epoch advances on those too, so epoch
    arithmetic over-reports; this durable counter is what `session
    info`/`list` surface as ``takeovers``."""
    try:
        raw = _read_ha_file(ha_dir, "takeovers.count")
        return int(raw.strip() or 0) if raw is not None else 0
    except (OSError, ValueError):
        return 0


def _read_ha_file(ha_dir: str, name: str) -> Optional[str]:
    """One HA-dir control file's text, through the fs seam for
    scheme'd dirs (objstore HA) and raw open() for local ones."""
    path = os.path.join(ha_dir, name)
    if "://" in ha_dir:
        from flink_tpu_torch.fs import get_filesystem

        fs = get_filesystem(ha_dir)
        if not fs.exists(path):
            return None
        with fs.open_read(path) as f:
            raw = f.read()
        return raw.decode("utf-8") if isinstance(raw, bytes) else raw
    with open(path) as f:
        return f.read()


def leader_address(ha_dir: str) -> Optional[str]:
    """Resolve the current leader's RPC address from the lease file
    (what CLI/clients use instead of a fixed --coordinator)."""
    try:
        raw = _read_ha_file(ha_dir, "leader.lease")
        if raw is None:
            return None
        return json.loads(raw)["address"]
    except (OSError, ValueError, KeyError):
        return None


class JobStore:
    """Durable submitted-job metadata, one JSON per job, atomic writes
    (ref: JobGraphStore — the job graphs a recovered Dispatcher
    re-runs). Stored: entry point, config, state, attempts — enough for
    a new leader to re-deploy with ``restore: latest``."""

    TERMINAL = ("FINISHED", "FAILED", "CANCELED")

    def __init__(self, ha_dir: str) -> None:
        from flink_tpu_torch.fs import get_filesystem

        self.dir = os.path.join(ha_dir, "jobs")
        self.archive_dir = os.path.join(ha_dir, "jobs-archive")
        self._fs = get_filesystem(ha_dir)
        self._fs.mkdirs(self.dir)
        self._fs.mkdirs(self.archive_dir)

    def _path(self, job_id: str) -> str:
        return os.path.join(self.dir, f"{job_id}.json")

    def _archive_path(self, job_id: str) -> str:
        return os.path.join(self.archive_dir, f"{job_id}.json")

    def put(self, job_id: str, *, entry: Optional[str], config: Dict,
            state: str, attempts: int,
            py_blobs: Optional[List[Dict]] = None,
            submitted_at: Optional[float] = None,
            assigned_runners: Optional[List[str]] = None,
            rescale: Optional[Dict] = None) -> None:
        """Active jobs live in jobs/; a terminal write MOVES the record
        to jobs-archive/ so leader recovery never scans or parses
        finished history (ref: JobGraphStore removes terminal graphs;
        ExecutionGraphInfoStore keeps the archived view).

        ``submitted_at`` makes the FIFO submission-queue position
        durable (a new leader re-queues undeployed jobs in original
        order); ``assigned_runners`` records WHERE a RUNNING job lives
        so the new leader can wait for that runner to re-attach it
        instead of redeploying blind (tmp + rename keeps every write
        atomic — readers see the old or new record whole).

        ``rescale`` carries an in-flight rescale's armed intent
        ({devices, processes, token, phase, ...}) so a dispatcher
        takeover can resume or cleanly disarm the handshake instead of
        forgetting it with the dead leader's memory."""
        from flink_tpu_torch import faults

        faults.fire("ha.store.write", exc=OSError, job=job_id,
                    state=state)
        terminal = state in self.TERMINAL
        dst = self._archive_path(job_id) if terminal else self._path(job_id)
        rec = {"job_id": job_id, "entry": entry, "config": config,
               "state": state, "attempts": attempts,
               "py_blobs": list(py_blobs or []),
               "submitted_at": submitted_at,
               "assigned_runners": list(assigned_runners or []),
               "rescale": rescale}
        # through the seam (tmp + FSYNC + rename): a power cut right
        # after admission acked must not leave a torn registry record
        # a recovering leader silently skips — write_atomic makes the
        # record durable-whole or absent, never garbage
        from flink_tpu_torch.fs import write_atomic

        write_atomic(self._fs, dst, json.dumps(rec).encode("utf-8"))
        if terminal:
            self.remove(job_id)

    def get(self, job_id: str) -> Optional[Dict]:
        for path in (self._path(job_id), self._archive_path(job_id)):
            try:
                with self._fs.open_read(path) as f:
                    raw = f.read()
                return json.loads(
                    raw.decode("utf-8") if isinstance(raw, bytes)
                    else raw)
            except (OSError, ValueError):
                continue
        return None

    def remove(self, job_id: str) -> None:
        try:
            self._fs.delete(self._path(job_id))
        except OSError:
            pass

    def recoverable(self) -> List[Dict]:
        """Non-terminal deployable jobs a new leader must resume."""
        out = []
        for name in sorted(self._fs.listdir(self.dir)):
            if not name.endswith(".json"):
                continue
            try:
                with self._fs.open_read(
                        os.path.join(self.dir, name)) as f:
                    raw = f.read()
                rec = json.loads(
                    raw.decode("utf-8") if isinstance(raw, bytes)
                    else raw)
            except (OSError, ValueError):
                continue
            if (rec.get("entry")
                    and rec.get("state") not in (
                        "FINISHED", "FAILED", "CANCELED")):
                out.append(rec)
        return out
