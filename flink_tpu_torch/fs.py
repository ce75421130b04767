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
- A full disk (``OSError(ENOSPC)``) under ``enospc_retry`` follows the
  process's ``storage.enospc-policy``: ``retry`` (the default: 4
  retries, 50 ms doubling) re-runs the whole-file write with bounded
  backoff, each retry counted on the ``storage.enospc_retries`` metric;
  ``fail`` propagates at once. The driver installs a job's policy at run
  start (``install_enospc_policy_from_config``), and only when the job
  sets a ``storage.enospc-*`` key.

- The conditional-write extension: a backend that sets
  ``conditional_put`` (``cas_capable``) has ``etag(path)`` and
  ``put_if(path, data, expected_etag)``, an atomic compare-and-swap
  publish that raises ``CASConflictError`` when it loses the race. The
  in-tree object store (``fs_objstore.py``) is registered under
  ``objstore`` by default, so ``objstore://`` paths resolve everywhere.
- ``plugins.modules`` names modules whose ``register(registry)`` hook
  extends the scheme registry (``load_plugins``, run when a
  ``StreamExecutionEnvironment`` is made).

Every durable write goes through this seam, so a recording wrapper
(``fs_crash.CrashFS``) sees the whole order of mutations and barriers.
"""
from __future__ import annotations

import errno
import importlib
import os
import shutil
import threading
import time
from typing import Any, Callable, Dict, Iterable, List, Optional

from flink_tpu_torch.obs.metrics import MetricRegistry


class CASConflictError(OSError):
    """Conditional put lost the race: the object's current ETag no
    longer matches the expected one (the 412 Precondition Failed of
    real object stores). Callers treat it like any other lock-
    acquisition failure — re-read, re-decide, retry or give up."""


class FileSystem:
    """Minimal filesystem contract (ref: core/fs/FileSystem.java —
    subset actually used by checkpoint storage and file sinks)."""

    #: True when this backend implements ``put_if``/``etag`` — the
    #: conditional-write capability the lock tiers probe via
    #: ``cas_capable`` to pick CAS records over O_EXCL lock files.
    conditional_put = False

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

    # -- conditional-write extension (object-store CAS) ------------------

    def etag(self, path: str) -> Optional[str]:
        """Current ETag/generation of the object, ``None`` when absent.
        Only meaningful on backends advertising ``conditional_put``."""
        raise NotImplementedError(
            f"{type(self).__name__} does not support conditional put")

    def put_if(self, path: str, data: bytes,
               expected_etag: Optional[str] = None) -> str:
        """Atomic compare-and-swap publish: write ``data`` whole iff the
        object's current ETag equals ``expected_etag`` (``None`` =
        create-only, the object must not exist). Returns the new ETag;
        raises :class:`CASConflictError` when the precondition fails."""
        raise NotImplementedError(
            f"{type(self).__name__} does not support conditional put")


def cas_capable(fs: "FileSystem") -> bool:
    """Whether this backend advertises the conditional-put extension
    (the lock tiers' capability probe)."""
    return bool(getattr(fs, "conditional_put", False))


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


# -- ENOSPC degradation policy (storage.enospc-policy) -------------------

_ENOSPC_ERRNOS = (errno.ENOSPC, getattr(errno, "EDQUOT", errno.ENOSPC))

# process-global storage metrics (the faults.py registry pattern):
# storage.enospc_retries counts every backed-off re-attempt so a
# degrading disk is visible before it becomes a failed job
registry = MetricRegistry()
_policy_lock = threading.Lock()
_enospc_policy: Dict[str, Any] = {
    "mode": "retry", "retries": 4, "backoff_ms": 50.0}


def is_enospc(exc: BaseException) -> bool:
    """Disk-full classification: real ``OSError(ENOSPC/EDQUOT)`` plus
    injected faults at the ``fs.write.enospc`` point (the message names
    the point — faults.fire cannot carry an errno)."""
    if not isinstance(exc, OSError):
        return False
    return exc.errno in _ENOSPC_ERRNOS or "enospc" in str(exc).lower()


def install_enospc_policy(mode: str = "retry", retries: int = 4,
                          backoff_ms: float = 50.0) -> None:
    if mode not in ("retry", "fail"):
        raise ValueError(
            f"storage.enospc-policy must be 'retry' or 'fail', "
            f"got {mode!r}")
    with _policy_lock:
        _enospc_policy.update(mode=mode, retries=max(0, int(retries)),
                              backoff_ms=float(backoff_ms))


def install_enospc_policy_from_config(config) -> None:
    """The driver's deploy-time install (the faults.install_from_config
    shape). The policy is PROCESS-global — like the faults plan and for
    the same reason: the disk filling up is a property of the machine,
    not attributable to one tenant from inside the write seam. So a
    config that does not EXPLICITLY set any ``storage.enospc*`` key is
    a no-op here (the installed policy — the declared default, or a
    co-resident job's explicit choice — stays), and co-scheduling two
    jobs with CONFLICTING explicit policies on one runner process is
    last-writer-wins, the documented faults-plane discipline: give
    policy-sensitive jobs their own runner."""
    from flink_tpu_torch.config import StorageOptions

    keys = set(config.to_dict())
    if not any(opt.key in keys for opt in (
            StorageOptions.ENOSPC_POLICY, StorageOptions.ENOSPC_RETRIES,
            StorageOptions.ENOSPC_BACKOFF_MS)):
        return
    install_enospc_policy(
        str(config.get(StorageOptions.ENOSPC_POLICY)).strip().lower(),
        int(config.get(StorageOptions.ENOSPC_RETRIES)),
        float(config.get(StorageOptions.ENOSPC_BACKOFF_MS)))


def enospc_policy() -> Dict[str, Any]:
    with _policy_lock:
        return dict(_enospc_policy)


_enospc_counter = None


def _count_enospc_retry() -> None:
    # MetricGroup.counter() REGISTERS A FRESH Counter per call — cache
    # one instance or every retry would reset the count (the faults.py
    # counter-cache discipline)
    global _enospc_counter
    if _enospc_counter is None:
        with _policy_lock:
            if _enospc_counter is None:
                _enospc_counter = registry.group(
                    "storage").counter("enospc_retries")
    _enospc_counter.inc()


def enospc_retry(fn: Callable[[], Any], what: str = "") -> Any:
    """Run a WHOLE-FILE write attempt under the installed policy:
    ``retry`` re-runs it with bounded backoff on an ENOSPC-classed
    OSError (a retention pass or log rotation may free space between
    attempts); ``fail`` — or an exhausted budget — propagates. Retry is
    safe exactly because every caller is an idempotent tmp-write
    (write_atomic, segment writes, checkpoint persists): a failed
    attempt leaves only an unreferenced tmp the recovery sweep
    removes."""
    pol = enospc_policy()
    attempts = pol["retries"] + 1 if pol["mode"] == "retry" else 1
    delay = pol["backoff_ms"] / 1000.0
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


def _objstore_factory() -> "FileSystem":
    # the in-tree conditional-put store (fs_objstore.py), registered by
    # default like "file" so objstore:// paths resolve without
    # plugins.modules; the deferred import breaks the module cycle
    from flink_tpu_torch.fs_objstore import ObjectStoreFileSystem

    return ObjectStoreFileSystem()


class FileSystemRegistry:
    """Scheme → FileSystem factory (ref: FileSystem.FS_FACTORIES +
    getUnguardedFileSystem). ``get`` resolves a path's scheme; bare
    paths resolve to the local filesystem."""

    def __init__(self) -> None:
        self._factories: Dict[str, Callable[[], FileSystem]] = {}
        self._instances: Dict[str, FileSystem] = {}
        self.register("file", LocalFileSystem)
        self.register("objstore", _objstore_factory)

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
                f"(known: {sorted(self._factories)}); load a plugin via "
                "plugins.modules or register_filesystem()")
        if key not in self._instances:
            self._instances[key] = self._factories[key]()
        return self._instances[key]

    def schemes(self) -> List[str]:
        return sorted(self._factories)


_REGISTRY = FileSystemRegistry()


def register_filesystem(scheme: str,
                        factory: Callable[[], FileSystem]) -> None:
    """Programmatic plugin registration (ref: FileSystemFactory SPI)."""
    _REGISTRY.register(scheme, factory)


def get_filesystem(path: str) -> FileSystem:
    return _REGISTRY.get(path)


def schemes() -> List[str]:
    return _REGISTRY.schemes()


def load_plugins(modules: Iterable[str]) -> List[str]:
    """Import each named module and run its ``register(registry)`` hook
    (ref: PluginManager discovering FileSystemFactory services). Returns
    the loaded module names; a missing module, or one without the hook,
    raises at load time — a silently absent plugin would surface later
    as an unknown scheme."""
    loaded = []
    for name in modules:
        name = name.strip()
        if not name:
            continue
        mod = importlib.import_module(name)
        hook = getattr(mod, "register", None)
        if hook is None:
            raise ValueError(
                f"plugin module {name!r} has no register(registry) hook")
        hook(_REGISTRY)
        loaded.append(name)
    return loaded
