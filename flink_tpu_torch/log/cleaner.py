"""Leased background cleaner — the broker's log-cleaner thread for the
embedded bus tier (ref: kafka.log.LogCleaner + the retention scheduler
of LogManager, scoped to this stack's maintenance planes).

Until now compaction/retention were EXPLICIT invocations (`log TOPIC
--compact/--retain` or embedded calls); the cleaner makes the bus tier
self-maintaining: a driver/dispatcher-owned service thread runs one
maintenance pass per topic at ``log.cleaner.interval-ms`` cadence —
compaction then retention, each under the existing per-topic
MAINTENANCE lock — while live leased producers and consumers race it
freely (the manifest-swap discipline keeps their reads byte-identical,
the property tests/test_torch_log_cleaner.py proves against a never-cleaned
golden).

Fencing: exactly one cleaner service owns a topic at a time via the
``cleaner.lease`` record (owner + epoch + deadline — the writer-lease
discipline on one file): a second service fails to acquire, a
crashed service's lease expires after ``log.cleaner.lease-ttl-ms`` and
the successor takes over at epoch+1, and a deposed cleaner's late pass
dies at its pre-pass verify. On conditional-put schemes the lease is
CAS-published (no O_EXCL); on local filesystems it is an atomic-write
record serialized by the same O_EXCL+stale-break lock the bus leases
use.

Observability: ``log.cleaner.passes`` / ``last_pass_ms`` /
``bytes_reclaimed`` metrics per topic, plus a durable
``cleaner-status.json`` in the topic dir surfaced by ``describe_topic``
and the ``log`` CLI (last pass, next deadline, bytes reclaimed).

Fault point: ``log.cleaner.pass`` fires at the top of every held-lease
pass — inject ``raise`` for a cleaner dying mid-cadence, or combine
with ``log.compact.swap`` for the crash-between-rewrite-and-swap
schedule on ``objstore://`` (tests/test_torch_log_chaos.py).
"""
from __future__ import annotations

import json
import os
import threading
import time
import uuid
from typing import Any, Dict, Optional

from flink_tpu_torch.fs import CASConflictError, cas_capable, get_filesystem
from flink_tpu_torch.log.topic import (
    LogError,
    _local_path,
    _partition_dir,
    _read_json,
    _write_atomic,
    topic_partitions,
)
from flink_tpu_torch.obs.metrics import MetricRegistry

__all__ = ["LogCleaner", "CleanerLease", "cleaner_status",
           "live_cleaner_owner", "check_manual_maintenance",
           "CLEANER_LEASE", "CLEANER_STATUS", "registry"]

CLEANER_LEASE = "cleaner.lease"
CLEANER_STATUS = "cleaner-status.json"

# process-global cleaner metrics (the log/topic.py registry pattern)
registry = MetricRegistry()


def _now_ms() -> int:
    return int(time.time() * 1000)


class CleanerLease:
    """The fenced single-owner lease on a topic's background
    maintenance: one ``cleaner.lease`` record, epoch-monotone across
    owners (fresh=1, same-owner renew keeps, expired takeover bumps).
    CAS-published on conditional-put schemes; atomic-write + the lock
    file's absence-of-contention on local ones (two cleaner services
    on one LOCAL topic dir is an operational error the acquire's
    read-decide-write window narrows but — honest scope — cannot
    fully exclude without O_EXCL serialization, which the expiry +
    epoch fence backstops)."""

    def __init__(self, path: str, owner: str, ttl_ms: int,
                 now_fn=None) -> None:
        self.path = path
        self.owner = owner
        self.ttl_ms = max(1, int(ttl_ms))
        self.epoch = 0
        self._now = now_fn or _now_ms
        self._fs = get_filesystem(path)
        self._cas = (_local_path(path) is None
                     and cas_capable(self._fs))
        self._etag: Optional[str] = None

    @property
    def lease_path(self) -> str:
        return os.path.join(self.path, CLEANER_LEASE)

    def _read(self) -> Optional[Dict[str, Any]]:
        lp = self.lease_path
        if self._cas:
            for _ in range(3):
                tag = self._fs.etag(lp)
                if tag is None:
                    self._etag = None
                    return None
                try:
                    rec = _read_json(self._fs, lp, "cleaner lease")
                except OSError:
                    continue
                if self._fs.etag(lp) == tag:
                    self._etag = tag
                    return rec
            raise LogError(
                f"cleaner lease of {self.path!r} churning — retry")
        if not self._fs.exists(lp):
            return None
        return _read_json(self._fs, lp, "cleaner lease")

    def _publish(self, rec: Dict[str, Any]) -> None:
        payload = json.dumps(rec, sort_keys=True).encode("utf-8")
        if self._cas:
            try:
                self._etag = self._fs.put_if(
                    self.lease_path, payload, self._etag)
            except CASConflictError as e:
                raise LogError(
                    f"cleaner lease of {self.path!r}: lost the "
                    f"conditional-write race ({e}) — another cleaner "
                    "service owns this topic") from e
            return
        _write_atomic(self._fs, self.lease_path, payload)

    def acquire(self) -> int:
        """Take (or re-take) the cleaner lease; returns the epoch.
        Raises when a DIFFERENT live service holds it."""
        cur = self._read()
        now = self._now()
        if cur is None or cur.get("released"):
            epoch = int((cur or {}).get("epoch", 0)) + 1
        elif cur.get("owner") == self.owner:
            epoch = int(cur.get("epoch", 1))
        elif now >= int(cur.get("deadline_ms", 0)):
            epoch = int(cur.get("epoch", 0)) + 1  # takeover
        else:
            raise LogError(
                f"topic {self.path!r} is owned by cleaner "
                f"{cur.get('owner')!r} (epoch {cur.get('epoch')}) "
                f"until {cur.get('deadline_ms')} — one cleaner "
                "service per topic")
        self._publish({
            "owner": self.owner, "epoch": epoch, "pid": os.getpid(),
            "acquired_ms": now, "deadline_ms": now + self.ttl_ms})
        self.epoch = epoch
        return epoch

    def verify(self, renew: bool = True) -> None:
        """The pre-pass fence: the record must still show OUR owner at
        OUR epoch, else this service was deposed and the pass dies
        here (a deposed cleaner's swap would race the successor's)."""
        if not self.epoch:
            raise LogError("cleaner lease was never acquired")
        cur = self._read()
        if (cur is None or cur.get("released")
                or cur.get("owner") != self.owner
                or int(cur.get("epoch", -1)) != self.epoch):
            raise LogError(
                f"cleaner {self.owner!r} DEPOSED from topic "
                f"{self.path!r}: lease now "
                f"{(cur or {}).get('owner')!r} at epoch "
                f"{(cur or {}).get('epoch')} (ours {self.epoch}) — "
                "rejecting the late pass")
        if renew:
            now = self._now()
            if int(cur.get("deadline_ms", 0)) - now < self.ttl_ms / 2:
                self._publish({
                    "owner": self.owner, "epoch": self.epoch,
                    "pid": os.getpid(),
                    "acquired_ms": int(cur.get("acquired_ms", now)),
                    "deadline_ms": now + self.ttl_ms})

    def release(self) -> None:
        """Keep the record with a ``released`` flag (epoch stays
        monotone across owners — the writer-lease rule)."""
        if not self.epoch:
            return
        cur = self._read()
        if (cur is not None and cur.get("owner") == self.owner
                and int(cur.get("epoch", -1)) == self.epoch):
            try:
                self._publish({
                    "owner": self.owner, "epoch": self.epoch,
                    "pid": os.getpid(),
                    "acquired_ms": int(cur.get("acquired_ms", 0)),
                    "deadline_ms": 0, "released": True})
            except LogError:
                pass  # deposed mid-release: successor's record stands
        self.epoch = 0


class LogCleaner:
    """One topic's background maintenance service: a daemon thread
    running ``run_pass()`` every ``interval_ms`` under the fenced
    cleaner lease. Owned by the driver (``log.cleaner.enabled``) or
    driven manually by tests/tools; ``stop()`` releases the lease."""

    def __init__(self, path: str, config, owner: Optional[str] = None,
                 now_fn=None) -> None:
        from flink_tpu_torch.config import LogOptions

        self.path = path
        self.topic = os.path.basename(os.path.normpath(path)) or "topic"
        self.owner = owner or f"cleaner-{os.getpid()}-{uuid.uuid4().hex[:6]}"
        self.config = config
        self.interval_ms = max(1, int(config.get(
            LogOptions.CLEANER_INTERVAL_MS)))
        self.lease = CleanerLease(
            path, self.owner,
            int(config.get(LogOptions.CLEANER_LEASE_TTL_MS)),
            now_fn=now_fn)
        self._fs = get_filesystem(path)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.passes = 0
        self.bytes_reclaimed_total = 0
        self.last_pass_ms = 0.0
        grp = registry.group("log.cleaner", self.topic)
        self._m_passes = grp.counter("passes")
        self._m_bytes = grp.counter("bytes_reclaimed")
        grp.gauge("last_pass_ms", lambda: self.last_pass_ms)

    # -- service lifecycle ----------------------------------------------

    def start(self) -> None:
        self.lease.acquire()
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._run, name=f"log-cleaner-{self.topic}",
            daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
        self.lease.release()

    def _run(self) -> None:
        while not self._stop.is_set():
            try:
                self.run_pass()
            except LogError:
                # lock busy (a manual pass, fsck --repair) or a
                # deposed lease: skip this cadence — a deposition
                # surfaces again next pass and the thread exits if
                # the lease is truly gone (verify keeps raising,
                # passes keep skipping: bounded, observable via the
                # status file's stale next_deadline)
                pass
            except OSError:
                pass  # injected/transient storage fault: next cadence
            self._stop.wait(self.interval_ms / 1000.0)

    # -- one maintenance pass ---------------------------------------------

    def _file_sizes(self) -> Dict[str, int]:
        """Per-partition data files with sizes (the reclaim ledger)."""
        out: Dict[str, int] = {}
        try:
            partitions = topic_partitions(self.path)
        except (LogError, OSError):
            return out
        for p in range(partitions):
            pdir = _partition_dir(self.path, p)
            if not self._fs.exists(pdir):
                continue
            for name in self._fs.listdir(pdir):
                fp = os.path.join(pdir, name)
                try:
                    if not self._fs.is_dir(fp):
                        out[fp] = self._fs.size(fp)
                except OSError:
                    continue
        return out

    def run_pass(self) -> Dict[str, Any]:
        """One fenced maintenance pass: verify the cleaner lease, run
        compaction then retention (each under the per-topic
        maintenance lock), account reclaimed bytes, publish the
        status record."""
        from flink_tpu_torch import faults
        from flink_tpu_torch.log.bus import TopicMaintenance

        if not self.lease.epoch:
            self.lease.acquire()
        self.lease.verify()
        faults.fire("log.cleaner.pass", exc=OSError,
                    topic=self.topic, owner=self.owner)
        t0 = time.perf_counter()
        before = self._file_sizes()
        compacted = TopicMaintenance.compact_from_config(
            self.config, self.path)
        retained = TopicMaintenance.retain_from_config(
            self.config, self.path)
        after = self._file_sizes()
        reclaimed = sum(sz for fp, sz in before.items()
                        if fp not in after)
        self.last_pass_ms = (time.perf_counter() - t0) * 1000.0
        self.passes += 1
        self.bytes_reclaimed_total += reclaimed
        self._m_passes.inc()
        if reclaimed:
            self._m_bytes.inc(reclaimed)
        status = {
            "owner": self.owner, "epoch": self.lease.epoch,
            "passes": self.passes,
            "last_pass_ms": round(self.last_pass_ms, 3),
            "last_pass_at_ms": _now_ms(),
            "next_deadline_ms": _now_ms() + self.interval_ms,
            "bytes_reclaimed": self.bytes_reclaimed_total,
            "compacted": compacted, "retained": retained,
        }
        _write_atomic(self._fs, os.path.join(self.path, CLEANER_STATUS),
                      json.dumps(status, sort_keys=True).encode("utf-8"))
        return status


# -- read-side helpers (describe_topic / CLI / fsck) ----------------------

def cleaner_status(path: str) -> Optional[Dict[str, Any]]:
    """The last published cleaner status record, or None when no
    cleaner has ever run on this topic."""
    fs = get_filesystem(path)
    sp = os.path.join(path, CLEANER_STATUS)
    if not fs.exists(sp):
        return None
    return _read_json(fs, sp, "cleaner status")


def read_cleaner_lease(path: str) -> Optional[Dict[str, Any]]:
    fs = get_filesystem(path)
    lp = os.path.join(path, CLEANER_LEASE)
    if not fs.exists(lp):
        return None
    return _read_json(fs, lp, "cleaner lease")


def live_cleaner_owner(path: str) -> Optional[str]:
    """The owner of a LIVE (unreleased, unexpired) cleaner lease on
    this topic, else None."""
    rec = read_cleaner_lease(path)
    if (rec is None or rec.get("released")
            or _now_ms() >= int(rec.get("deadline_ms", 0))):
        return None
    return str(rec.get("owner"))


def check_manual_maintenance(path: str) -> None:
    """Gate for EXPLICIT maintenance invocations (the `log TOPIC
    --compact/--retain` CLI): while a live cleaner service owns the
    topic, a manual pass must refuse loudly instead of fighting the
    service for the maintenance lock mid-cadence (exit 1 at the
    CLI)."""
    owner = live_cleaner_owner(path)
    if owner is not None:
        raise LogError(
            f"topic {path!r} is owned by live cleaner service "
            f"{owner!r} (cleaner.lease) — background maintenance is "
            "running; stop the cleaner (or let the lease expire) "
            "before invoking a manual pass")
