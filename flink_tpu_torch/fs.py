"""The FileSystem seam, its local implementation and the durable-write
helpers every checkpoint and transactional sink write goes through.

- ``FileSystem`` is the small interface checkpoint storage and the file
  sinks use; ``get_filesystem(path)`` resolves a path's scheme through a
  registry (``register_filesystem``). Bare paths and ``file://`` are
  ``LocalFileSystem``.
- ``open_write(path, sync=True)`` returns a handle whose close is a
  durability barrier (flush + fsync); ``fsync(path)`` is the barrier on
  a closed file or a directory; ``write_atomic`` publishes a whole file
  as tmp + fsync + rename + parent-directory fsync.
- A full disk (``OSError(ENOSPC)``) under ``enospc_retry`` retries the
  whole-file write with bounded backoff (4 retries, 50 ms doubling: the
  reference's default ``storage.enospc-policy``; the keys that change it
  come with ROADMAP.md queue 1 item 8), counted on the
  ``storage.enospc_retries`` metric.

The object store (``fs_objstore.py``, its conditional put) and
``plugins.modules`` come with ROADMAP.md queue 1 item 6.
"""
from __future__ import annotations

import errno
import os
import shutil
import threading
import time
from typing import Any, Callable, Dict, List

from flink_tpu_torch.obs.metrics import MetricRegistry


class FileSystem:
    """Minimal filesystem contract (ref: core/fs/FileSystem.java —
    subset actually used by checkpoint storage and file sinks)."""

    def open_read(self, path: str):
        raise NotImplementedError

    def open_write(self, path: str, sync: bool = False):
        """Write handle; ``sync=True`` makes close() a durability
        barrier (flush + fsync before it returns) — the segment/blob
        write discipline of every transactional tier."""
        raise NotImplementedError

    def fsync(self, path: str) -> None:
        """Durability barrier on an already-closed file (the group-
        commit fsync pass). Default no-op: non-local backends own their
        durability (a PUT that returned IS durable on object stores)."""

    def mkdirs(self, path: str) -> None:
        raise NotImplementedError

    def exists(self, path: str) -> bool:
        raise NotImplementedError

    def listdir(self, path: str) -> List[str]:
        raise NotImplementedError

    def delete(self, path: str, recursive: bool = False) -> None:
        raise NotImplementedError

    def rename(self, src: str, dst: str) -> None:
        """Atomic within one filesystem — the manifest-last commit
        primitive checkpoint storage builds on."""
        raise NotImplementedError

    def link_or_copy(self, src: str, dst: str) -> None:
        """Hardlink when the backend supports it (incremental checkpoint
        blob reuse), else copy."""
        raise NotImplementedError

    def size(self, path: str) -> int:
        raise NotImplementedError

    def is_dir(self, path: str) -> bool:
        raise NotImplementedError


class LocalFileSystem(FileSystem):
    """``file://`` / bare paths (ref: core/fs/local/LocalFileSystem)."""

    @staticmethod
    def _strip(path: str) -> str:
        return path[len("file://"):] if path.startswith("file://") else path

    def open_read(self, path: str):
        return open(self._strip(path), "rb")

    def open_write(self, path: str, sync: bool = False):
        from flink_tpu_torch import faults

        # the disk-full seam: an ENOSPC here is the write dying at
        # open/allocate time — the enospc_retry policy wraps callers
        faults.fire("fs.write.enospc", exc=OSError, path=path)
        f = open(self._strip(path), "wb")
        return _SyncOnClose(f) if sync else f

    def fsync(self, path: str) -> None:
        from flink_tpu_torch import faults

        faults.fire("fs.fsync", exc=OSError, path=path)
        fd = os.open(self._strip(path), os.O_RDONLY)
        try:
            os.fsync(fd)
        except OSError:
            pass  # non-fsyncable mount (proc/overlay): the write
            # handle's own close-time sync already did what it could
        finally:
            os.close(fd)

    def mkdirs(self, path: str) -> None:
        os.makedirs(self._strip(path), exist_ok=True)

    def exists(self, path: str) -> bool:
        return os.path.exists(self._strip(path))

    def listdir(self, path: str) -> List[str]:
        return os.listdir(self._strip(path))

    def delete(self, path: str, recursive: bool = False) -> None:
        p = self._strip(path)
        if os.path.isdir(p) and not os.path.islink(p):
            if not recursive:
                raise IsADirectoryError(p)
            # NOT ignore_errors: a retention/abort pass that silently
            # fails to delete violates the loud-failure convention —
            # callers that genuinely tolerate sweep failures (retention,
            # best-effort cleanup) catch OSError themselves
            shutil.rmtree(p)
        elif os.path.exists(p):
            os.remove(p)

    def rename(self, src: str, dst: str) -> None:
        from flink_tpu_torch import faults

        faults.fire("fs.rename", exc=OSError, src=src, dst=dst)
        os.rename(self._strip(src), self._strip(dst))

    def link_or_copy(self, src: str, dst: str) -> None:
        try:
            os.link(self._strip(src), self._strip(dst))
        except OSError:
            shutil.copyfile(self._strip(src), self._strip(dst))
            # the COPY branch writes fresh bytes (a hardlink shares the
            # source's already-durable content; a copy does not) —
            # fsync them so callers may treat link_or_copy results as
            # content-durable either way
            self.fsync(dst)

    def size(self, path: str) -> int:
        return os.path.getsize(self._strip(path))

    def is_dir(self, path: str) -> bool:
        return os.path.isdir(self._strip(path))


class _SyncOnClose:
    """Write handle whose close() is a durability barrier: flush +
    fsync strictly before close returns (``open_write(sync=True)``).
    Wraps rather than subclasses — ``open()`` returns a C-implemented
    BufferedWriter."""

    def __init__(self, f) -> None:
        self._f = f

    def write(self, data) -> int:
        return self._f.write(data)

    def flush(self) -> None:
        self._f.flush()

    def fileno(self) -> int:
        return self._f.fileno()

    def close(self) -> None:
        if self._f.closed:
            return
        self._f.flush()
        from flink_tpu_torch import faults

        faults.fire("fs.fsync", exc=OSError)
        try:
            os.fsync(self._f.fileno())
        except OSError:
            pass  # non-fsyncable mount — same tolerance as fsync()
        self._f.close()

    def __enter__(self) -> "_SyncOnClose":
        return self

    def __exit__(self, *exc) -> None:
        # an erroring with-block must not fsync garbage it already
        # knows is partial — plain close, the tmp never renames
        if exc and exc[0] is not None:
            self._f.close()
        else:
            self.close()


# -- ENOSPC degradation: the reference's default storage.enospc-policy ---

_ENOSPC_ERRNOS = (errno.ENOSPC, getattr(errno, "EDQUOT", errno.ENOSPC))

# process-global storage metrics (the faults.py registry pattern):
# storage.enospc_retries counts every backed-off re-attempt so a
# degrading disk is visible before it becomes a failed job
registry = MetricRegistry()
_counter_lock = threading.Lock()
ENOSPC_RETRIES = 4
ENOSPC_BACKOFF_MS = 50.0


def is_enospc(exc: BaseException) -> bool:
    """Disk-full classification: real ``OSError(ENOSPC/EDQUOT)`` plus
    injected faults at the ``fs.write.enospc`` point (the message names
    the point — faults.fire cannot carry an errno)."""
    if not isinstance(exc, OSError):
        return False
    return exc.errno in _ENOSPC_ERRNOS or "enospc" in str(exc).lower()


_enospc_counter = None


def _count_enospc_retry() -> None:
    # MetricGroup.counter() REGISTERS A FRESH Counter per call — cache
    # one instance or every retry would reset the count (the faults.py
    # counter-cache discipline)
    global _enospc_counter
    if _enospc_counter is None:
        with _counter_lock:
            if _enospc_counter is None:
                _enospc_counter = registry.group(
                    "storage").counter("enospc_retries")
    _enospc_counter.inc()


def enospc_retry(fn: Callable[[], Any], what: str = "") -> Any:
    """Run a WHOLE-FILE write attempt, re-running it with bounded
    backoff on an ENOSPC-classed OSError (a retention pass may free
    space between attempts); an exhausted budget propagates. Retry is
    safe exactly because every caller is an idempotent tmp-write
    (write_atomic, segment writes, checkpoint persists): a failed
    attempt leaves only an unreferenced tmp the recovery sweep
    removes."""
    attempts = ENOSPC_RETRIES + 1
    delay = ENOSPC_BACKOFF_MS / 1000.0
    for i in range(attempts):
        try:
            return fn()
        except OSError as e:
            if not is_enospc(e) or i >= attempts - 1:
                raise
            _count_enospc_retry()
            time.sleep(delay)
            delay *= 2


# per-class capability memo for open_write_sync (one signature
# inspection per FileSystem implementation, ever)
_SYNC_CAPABLE: Dict[type, bool] = {}


def open_write_sync(fs: "FileSystem", path: str, sync: bool = False):
    """Open a write handle through the seam, tolerating LEGACY plugin
    filesystems whose ``open_write(self, path)`` predates the ``sync``
    keyword: those get a plain handle and the durability barrier falls
    back to ``fs.fsync(path)`` after close (base-class no-op — such
    backends own their durability, the tolerance the old log-tier
    ``_write_atomic`` extended to them). Every sync=True call site
    routes through here so a third-party plugin keeps working instead
    of dying on a TypeError mid-write."""
    if sync_capable(fs):
        return fs.open_write(path, sync=sync)
    return fs.open_write(path)


def sync_capable(fs: "FileSystem") -> bool:
    """Whether this backend's ``open_write`` takes the ``sync``
    keyword (memoized per class)."""
    cls = type(fs)
    cap = _SYNC_CAPABLE.get(cls)
    if cap is None:
        import inspect

        try:
            cap = "sync" in inspect.signature(cls.open_write).parameters
        except (TypeError, ValueError):
            cap = True
        _SYNC_CAPABLE[cls] = cap
    return cap


def write_atomic(fs: "FileSystem", path: str, payload,
                 durable: bool = True) -> None:
    """THE shared atomic-publish helper every durable tier uses:
    tmp + write + fsync + atomic rename + PARENT-DIR fsync (when
    ``durable``) — readers observe the old or the new file whole, never
    a torn write at the final name, and the rename itself survives a
    power cut (fsyncing the file alone does NOT persist its directory
    entry; the dir fsync is what makes 'it returned, so it is durable'
    true — the classic fsync-the-file-forget-the-dir hole, closed).
    ENOSPC mid-write retries whole-file (``enospc_retry``)
    (the tmp is rewritten from scratch each attempt)."""

    def attempt() -> None:
        tmp = path + ".tmp"
        with open_write_sync(fs, tmp, sync=durable) as f:
            f.write(payload)
        if durable and not sync_capable(fs):
            fs.fsync(tmp)  # legacy-plugin fallback barrier (base-class
            # no-op where the backend owns its durability)
        fs.rename(tmp, path)
        if durable:
            fs.fsync(os.path.dirname(path) or ".")

    enospc_retry(attempt, what=path)


class FileSystemRegistry:
    """Scheme → FileSystem factory (ref: FileSystem.FS_FACTORIES +
    getUnguardedFileSystem). ``get`` resolves a path's scheme; bare
    paths resolve to the local filesystem."""

    def __init__(self) -> None:
        self._factories: Dict[str, Callable[[], FileSystem]] = {}
        self._instances: Dict[str, FileSystem] = {}
        self.register("file", LocalFileSystem)

    def register(self, scheme: str,
                 factory: Callable[[], FileSystem]) -> None:
        self._factories[scheme] = factory
        self._instances.pop(scheme, None)

    def get(self, path: str) -> FileSystem:
        scheme, sep, _ = path.partition("://")
        key = scheme if sep else "file"
        if key not in self._factories:
            raise ValueError(
                f"no filesystem registered for scheme {key!r} "
                f"(known: {sorted(self._factories)}); register one with "
                "register_filesystem()")
        if key not in self._instances:
            self._instances[key] = self._factories[key]()
        return self._instances[key]


_REGISTRY = FileSystemRegistry()


def register_filesystem(scheme: str,
                        factory: Callable[[], FileSystem]) -> None:
    """Programmatic plugin registration (ref: FileSystemFactory SPI)."""
    _REGISTRY.register(scheme, factory)


def get_filesystem(path: str) -> FileSystem:
    return _REGISTRY.get(path)
