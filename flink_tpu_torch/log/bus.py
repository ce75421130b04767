"""The log tier's maintenance lock, the part of the JAX package's
``log/bus.py`` (and the ``log/topic.py`` functions it calls) that the
LSM state tier runs its compaction under: one maintenance pass at a
time a store directory, held across rewrite, manifest swap and the
queueing of replaced files.

The lock is an ``O_EXCL`` file, ``maintenance.lock``, in the directory;
a lock older than ``MAINT_LOCK_STALE_MS`` is a crashed pass's leftover
and is broken by an atomic rename, so of two racing breakers exactly
one wins. On a path with a URL scheme there is no ``O_EXCL`` file, and
the lock is best effort (the conditional-put lock of the object store
comes with ROADMAP.md queue 1 item 6).

The rest of the log tier (topics, compaction and retention of topics,
writer leases, consumer groups) comes with ROADMAP.md queue 1 item 8.
"""
from __future__ import annotations

import contextlib
import os
import time
import uuid
from typing import Optional

MAINT_LOCK = "maintenance.lock"
# a pass holding the lock longer than this is presumed dead
MAINT_LOCK_STALE_MS = 15 * 60 * 1000


class LogError(ValueError):
    """Malformed or unusable log-tier state, or a maintenance pass that
    cannot run now. Always loud."""


def _local_path(path: str) -> Optional[str]:
    """The plain OS path of a local or ``file://`` location, or None for
    another scheme (where ``O_EXCL`` lock files are unavailable)."""
    if path.startswith("file://"):
        return path[len("file://"):]
    return None if "://" in path else path


def _break_stale_lock(lock: str) -> None:
    """Break a crashed holder's lock without the unlink race: rename it
    to a unique name first, so of two racing breakers only one wins and
    the loser can never unlink a fresh lock taken a moment later."""
    grave = f"{lock}.stale-{uuid.uuid4().hex[:8]}"
    try:
        os.rename(lock, grave)
    except OSError:
        return  # another breaker won the rename
    try:
        os.unlink(grave)
    except OSError:
        pass


def _unlink_if_ours(lock: str, fd: int) -> None:
    """Unlink the lock only while the path still is our open file (an
    inode compare): if our stale lock was broken and replaced, a blind
    unlink would delete the new holder's lock."""
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
    """Take the directory's maintenance lock without blocking: an fd to
    hand to ``release_maintenance_lock``, or None when another pass
    holds it. A stale lock is broken first. On a path with a URL scheme
    the lock is best effort: a sentinel -1."""
    lock = _local_path(os.path.join(path, MAINT_LOCK))
    if lock is None:
        return -1
    for _ in range(2):
        try:
            return os.open(lock, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
        except FileExistsError:
            try:
                age_ms = (time.time() - os.path.getmtime(lock)) * 1000
            except OSError:
                continue  # vanished under us: retry
            if age_ms > MAINT_LOCK_STALE_MS:
                _break_stale_lock(lock)
                continue
            return None
    return None


def release_maintenance_lock(path: str, fd) -> None:
    if fd is None or fd < 0:
        return
    lock = _local_path(os.path.join(path, MAINT_LOCK))
    if lock is None:
        return
    _unlink_if_ours(lock, fd)


@contextlib.contextmanager
def maintenance_pass(path: str):
    """One maintenance pass at a time a directory: raises ``LogError``
    when another pass holds the lock (the caller skips and retries
    later), releases it however the pass ends."""
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
