"""Fake conditional-put object store (``objstore://``).

The in-tree stand-in for S3/GCS-class storage: whole-object PUTs that
are durable when they return, list-after-write consistency, a per-
object ETag, and — the part the lock tiers care about — an atomic
``put_if(path, data, expected_etag)`` compare-and-swap (the
If-Match/x-goog-if-generation-match conditional write, HTTP 412 on
mismatch surfaced as :class:`~flink_tpu_torch.fs.CASConflictError`).
The maintenance lock of a store directory (``log/bus.py``) takes a CAS
lock record through this primitive when the scheme advertises
``conditional_put``; the local-fs path is unchanged.

Layout: ``objstore://<abs-path>`` stores the object at ``<abs-path>``
on a BACKING filesystem resolved through the ordinary registry, so the
store composes with CrashFS — ``install(inner_prefix="crash://")``
routes every mutation through the power-cut journal and the crash
explorer samples POSIX-legal images of the CAS paths. The ETag is the
content MD5 (exactly S3's simple-PUT ETag), so there is no sidecar
metadata to tear: any readable object has a well-defined generation.

Server-side atomicity: a real store serializes conditional writes in
the service; this fake emulates that with a short-lived local lock
file (``*.lock~``, never visible through ``listdir``) around the
read-compare-publish sequence. The lock is emulation scratch, not a
durability structure — a crashed process leaves at most one, broken
after a short grace.

Residuals: this is a fake — no real S3/GCS client, no network, no
multi-host consistency beyond the shared backing filesystem; ``rename``
stays atomic (a real object store would copy+delete).

Fault point: ``fs.cas.put`` fires inside ``put_if`` (inject
``raise`` to synthesize 412 contention mid-takeover).
"""
from __future__ import annotations

import hashlib
import io
import os
import threading
import time
from typing import List, Optional

from flink_tpu_torch.fs import (
    CASConflictError,
    FileSystem,
    get_filesystem,
    register_filesystem,
    write_atomic,
)

SCHEME = "objstore"
_LOCK_SUFFIX = ".lock~"
_LOCK_STALE_S = 5.0


class ObjectStoreFileSystem(FileSystem):
    """``objstore://`` — conditional-put object semantics over a
    backing filesystem (local by default, CrashFS under the
    crash-state explorer)."""

    conditional_put = True

    def __init__(self, inner_prefix: str = "") -> None:
        self._prefix = inner_prefix
        self._mu = threading.Lock()

    # -- path plumbing ----------------------------------------------------

    def _backing(self, path: str) -> str:
        _, sep, rest = path.partition("://")
        return self._prefix + (rest if sep else path)

    def _inner(self, path: str):
        return get_filesystem(self._backing(path))

    @staticmethod
    def _real(backing: str) -> str:
        # local scratch-lock location: the path component under any
        # scheme prefix (crash:// backing journals objects, but the
        # serialization lock is server emulation and stays raw-local)
        _, sep, rest = backing.partition("://")
        return rest if sep else backing

    # -- plain delegation (mapped onto the backing filesystem) ------------

    def open_read(self, path: str):
        return self._inner(path).open_read(self._backing(path))

    def open_write(self, path: str, sync: bool = False):
        # PUT semantics: buffer whole, publish at close — and a PUT
        # that returned IS durable, so the backing write always syncs
        return _BufferedPut(self._inner(path), self._backing(path))

    def fsync(self, path: str) -> None:
        self._inner(path).fsync(self._backing(path))

    def mkdirs(self, path: str) -> None:
        self._inner(path).mkdirs(self._backing(path))

    def exists(self, path: str) -> bool:
        return self._inner(path).exists(self._backing(path))

    def listdir(self, path: str) -> List[str]:
        # list-after-write consistent; serialization-lock scratch is
        # server internals, never a listed object
        return [n for n in self._inner(path).listdir(self._backing(path))
                if not n.endswith(_LOCK_SUFFIX)]

    def delete(self, path: str, recursive: bool = False) -> None:
        self._inner(path).delete(self._backing(path), recursive=recursive)

    def rename(self, src: str, dst: str) -> None:
        # fake simplification: delegated (atomic on the local backing).
        # A real object store renames by copy+delete — documented as an
        # honest residual, not relied on by the CAS lock tiers.
        self._inner(src).rename(self._backing(src), self._backing(dst))

    def link_or_copy(self, src: str, dst: str) -> None:
        self._inner(src).link_or_copy(self._backing(src),
                                      self._backing(dst))

    def size(self, path: str) -> int:
        return self._inner(path).size(self._backing(path))

    def is_dir(self, path: str) -> bool:
        return self._inner(path).is_dir(self._backing(path))

    # -- the conditional-write extension ----------------------------------

    def etag(self, path: str) -> Optional[str]:
        inner, backing = self._inner(path), self._backing(path)
        if not inner.exists(backing) or inner.is_dir(backing):
            return None
        with inner.open_read(backing) as f:
            return hashlib.md5(f.read()).hexdigest()

    def put_if(self, path: str, data: bytes,
               expected_etag: Optional[str] = None) -> str:
        from flink_tpu_torch import faults

        faults.fire("fs.cas.put", exc=CASConflictError, path=path)
        backing = self._backing(path)
        with self._mu, _server_lock(self._real(backing)):
            current = self.etag(path)
            if current != expected_etag:
                raise CASConflictError(
                    f"conditional put of {path}: expected etag "
                    f"{expected_etag!r}, current {current!r}")
            write_atomic(self._inner(path), backing, bytes(data))
            return hashlib.md5(bytes(data)).hexdigest()


class _BufferedPut:
    """Whole-object PUT handle: bytes accumulate in memory and publish
    atomically (tmp + fsync + rename on the backing fs) when close()
    returns — no reader ever observes a torn object."""

    def __init__(self, inner, backing: str) -> None:
        self._inner = inner
        self._backing = backing
        self._buf = io.BytesIO()
        self._closed = False

    def write(self, data) -> int:
        return self._buf.write(bytes(data))

    def flush(self) -> None:
        pass

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        write_atomic(self._inner, self._backing, self._buf.getvalue())

    def __enter__(self) -> "_BufferedPut":
        return self

    def __exit__(self, *exc) -> None:
        if exc and exc[0] is not None:
            self._closed = True  # failed PUT publishes nothing
        else:
            self.close()


class _server_lock:
    """O_EXCL scratch lock emulating the store's server-side CAS
    serialization (cross-process — the CLI smoke chains jobs in
    separate processes). Stale locks from a crashed put_if break after
    a short grace; the file never outlives the operation on the happy
    path."""

    def __init__(self, real_path: str) -> None:
        self._path = real_path + _LOCK_SUFFIX

    def __enter__(self) -> None:
        parent = os.path.dirname(self._path)
        if parent:
            os.makedirs(parent, exist_ok=True)
        deadline = time.monotonic() + _LOCK_STALE_S * 2
        while True:
            try:
                os.close(os.open(self._path,
                                 os.O_CREAT | os.O_EXCL | os.O_WRONLY))
                return
            except FileExistsError:
                try:
                    if (time.monotonic() - os.path.getmtime(self._path)
                            > _LOCK_STALE_S):
                        os.unlink(self._path)
                        continue
                except OSError:
                    continue  # holder released between stat and unlink
                if time.monotonic() > deadline:
                    raise CASConflictError(
                        f"objstore serialization lock stuck: {self._path}")
                time.sleep(0.005)

    def __exit__(self, *exc) -> None:
        try:
            os.unlink(self._path)
        except OSError:
            pass


def install(inner_prefix: str = "") -> ObjectStoreFileSystem:
    """Register ``objstore://`` over the given backing prefix and
    return the instance. ``install(inner_prefix="crash://")`` after
    ``fs_crash.install(root)`` journals every object mutation for the
    power-cut explorer."""
    fs = ObjectStoreFileSystem(inner_prefix)
    register_filesystem(SCHEME, lambda: fs)
    return fs


def register(registry) -> None:
    """plugins.modules hook (ref: FileSystemFactory SPI)."""
    registry.register(SCHEME, ObjectStoreFileSystem)
