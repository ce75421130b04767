"""The log tier's maintenance lock, the part of the JAX package's
``log/bus.py`` (and the ``log/topic.py`` functions it calls) that the
LSM state tier runs its compaction under: one maintenance pass at a
time a store directory, held across rewrite, manifest swap and the
queueing of replaced files.

On a local path the lock is an ``O_EXCL`` file, ``maintenance.lock``,
in the directory; a lock older than ``MAINT_LOCK_STALE_MS`` is a
crashed pass's leftover and is broken by an atomic rename, so of two
racing breakers exactly one wins. On a scheme whose filesystem has the
conditional put (``fs.cas_capable``, the object store) the lock is a
record published with ``put_if``: its nonce is the release token, its
own ``acquired_ms`` says how old it is, and a stale record is broken by
replacing it at its ETag, so again exactly one breaker wins. On any
other scheme the lock is best effort.

The rest of the log tier (topics, compaction and retention of topics,
writer leases, consumer groups) comes with ROADMAP.md queue 1 item 8.
"""
from __future__ import annotations

import contextlib
import json
import os
import time
import uuid
from typing import Optional, Union

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


def try_maintenance_lock(path: str) -> Union[int, str, None]:
    """Take the directory's maintenance lock without blocking: a token
    to hand to ``release_maintenance_lock`` (an fd, or on a
    conditional-put scheme the lock record's nonce), or None when
    another pass holds it. A stale lock is broken first. On a scheme
    with neither ``O_EXCL`` files nor the conditional put the lock is
    best effort: a sentinel -1."""
    lock = _local_path(os.path.join(path, MAINT_LOCK))
    if lock is None:
        from flink_tpu_torch.fs import cas_capable, get_filesystem

        if cas_capable(get_filesystem(path)):
            return _try_cas_maintenance_lock(path)
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


def _try_cas_maintenance_lock(path: str) -> Optional[str]:
    """The maintenance lock on a conditional-put scheme: a lock record
    published with ``put_if`` instead of an ``O_EXCL`` file. The nonce
    is the release token — only the pass that published the record may
    delete it. Staleness uses the record's own ``acquired_ms`` (object
    stores have no usable mtime); a crashed pass's record past
    ``MAINT_LOCK_STALE_MS`` is replaced at its ETag, so of two racing
    breakers exactly one wins."""
    from flink_tpu_torch.fs import CASConflictError, get_filesystem

    fs = get_filesystem(path)
    lock = os.path.join(path, MAINT_LOCK)
    nonce = uuid.uuid4().hex
    rec = json.dumps({"owner": f"pid-{os.getpid()}", "nonce": nonce,
                      "acquired_ms": int(time.time() * 1000)},
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
                continue  # lost the create race: re-read, maybe stale
        try:
            with fs.open_read(lock) as f:
                held = json.loads(f.read().decode("utf-8"))
            age_ms = int(time.time() * 1000) - int(held.get("acquired_ms", 0))
        except (OSError, ValueError):
            continue  # vanished or torn under us: retry
        if age_ms > MAINT_LOCK_STALE_MS:
            try:
                fs.put_if(lock, rec, cur_tag)  # break = replace at the ETag
                return nonce
            except CASConflictError:
                continue  # another breaker won
        return None
    return None


def release_maintenance_lock(path: str, fd) -> None:
    if fd is None:
        return
    if isinstance(fd, str):
        # a CAS token: delete the lock record only while it is still
        # ours (a broken-and-replaced stale record must not take the
        # new holder's lock with it)
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
