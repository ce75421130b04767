"""CrashFS — a recording FileSystem that materializes power-cut images.

The crash-consistency verification plane (ref: the role of ALICE /
CrashMonkey for POSIX applications, and Flink's own
FsStateBackend-on-crash ITCases, rebuilt for this stack): every
durable tier here ultimately rests on unverified POSIX crash
semantics — WHICH of our writes and renames survive a power cut given
what was fsynced, and in what order. The ``faults.*`` plane injects
*exception-shaped* failures at named seams; CrashFS instead verifies
the *disk* contract itself.

How it works
------------
``CrashFS(root)`` wraps the local filesystem (register it under the
``crash`` scheme via :func:`install`, then hand tiers
``crash://<root>/...`` paths). Every mutation routed through the
FileSystem seam — write handles (with their ``sync`` discipline),
explicit ``fsync`` barriers, renames, deletes, links, mkdirs — is
applied live (the process under test behaves normally) AND journaled
with its durability state. This observes the complete order because
every durable tier writes through the seam (fs.py's durability
contract).

``crash(dst, at=seed, rng=...)`` then materializes a POSIX-LEGAL
post-crash image of the tree into ``dst``:

- a crash point cuts the journal at a sampled index;
- writes covered by an fsync (explicit ``fsync(path)`` or a
  ``sync=True`` handle) before the cut are durable IN FULL;
- unsynced writes may be dropped entirely, applied, prefix-truncated
  at BLOCK granularity, or torn (the final partial block zeroed) —
  the page cache never promised more;
- renames, deletes and links are directory-entry mutations: durable
  only when a DIRECTORY fsync of the affected parent follows (what
  ``write_atomic``'s post-rename dir fsync provides); an uncovered
  one may be un-applied — which also REORDERS it against later synced
  writes (a durable write whose tmp-file rename vanished shows up
  under the tmp name), exactly the reordering window ext4 ordered
  mode leaves open;
- mkdirs always apply (losing an empty directory finds nothing).

Every choice draws from a seeded RNG and is recorded in
``decisions`` — a failing crash image prints (seed, cut, decisions)
and replays exactly.

Injectable device errors: ``fail(kind, err, count, after)`` arms an
``OSError(err)`` (ENOSPC, EIO, ...) at the next matching seam call —
the disk-full/bit-rot half of the plane.

The explorer contract (tests/test_torch_crash_consistency.py): for every
materialized image, the tier's recovery must produce committed output
byte-identical to the fault-free golden OR fail loudly — zero silent
loss, zero silent corruption.
"""
from __future__ import annotations

import dataclasses
import os
import random
import shutil
from typing import Any, Dict, List, Optional, Set, Tuple

from flink_tpu_torch.fs import (
    FileSystem,
    LocalFileSystem,
    register_filesystem,
)

__all__ = ["CrashFS", "CrashOp", "install", "BLOCK"]

#: torn-write granularity: the page-cache/device sector unit at which
#: an unsynced write may survive partially
BLOCK = 4096

SCHEME = "crash"
_PREFIX = SCHEME + "://"


@dataclasses.dataclass
class CrashOp:
    """One journaled mutation. ``fid`` is the file identity a write
    creates (fsyncs attach to it so durability follows the file across
    renames); ``sync`` marks a write whose handle fsynced at close."""

    kind: str               # write | rename | delete | mkdir | link | fsync
    path: str = ""
    dst: str = ""
    data: bytes = b""
    fid: int = -1
    sync: bool = False
    recursive: bool = False
    dir: bool = False       # fsync of a DIRECTORY (entry durability)


def _local(path: str) -> str:
    """``crash://<abs>`` (or a bare path) → the backing local path."""
    return path[len(_PREFIX):] if path.startswith(_PREFIX) else path


class _RecordingWriter:
    """Write handle that writes through AND keeps the byte image for
    the journal; ``sync=True`` fsyncs before close returns (the
    _SyncOnClose discipline) and journals the write as durable."""

    def __init__(self, crashfs: "CrashFS", path: str, sync: bool) -> None:
        self._crashfs = crashfs
        self._path = path
        self._sync = sync
        self._chunks: List[bytes] = []
        self._f = open(_local(path), "wb")
        self._failed = False

    def write(self, data) -> int:
        self._crashfs._check_fail("write")
        self._chunks.append(bytes(data))
        return self._f.write(data)

    def flush(self) -> None:
        self._f.flush()

    def fileno(self) -> int:
        return self._f.fileno()

    def close(self) -> None:
        if self._f.closed:
            return
        self._f.flush()
        if self._sync:
            try:
                self._crashfs._check_fail("fsync")
            except OSError:
                self._f.close()
                raise
            os.fsync(self._f.fileno())
        self._f.close()
        self._crashfs._journal_write(
            self._path, b"".join(self._chunks), self._sync)

    def __enter__(self) -> "_RecordingWriter":
        return self

    def __exit__(self, *exc) -> None:
        if exc and exc[0] is not None:
            # an erroring with-block: the partial bytes DID reach the
            # live file — journal them unsynced so crash images can
            # expose the torn write; no sync even if requested
            if not self._f.closed:
                self._f.close()
                self._crashfs._journal_write(
                    self._path, b"".join(self._chunks), False)
        else:
            self.close()


class CrashFS(FileSystem):
    """Recording wrapper over the local filesystem (see module doc)."""

    def __init__(self, root: str) -> None:
        self.root = os.path.abspath(_local(root))
        os.makedirs(self.root, exist_ok=True)
        self._inner = LocalFileSystem()
        self.journal: List[CrashOp] = []
        self._next_fid = 0
        self._fids: Dict[str, int] = {}
        # armed device errors: [kind, errno, remaining, skip]
        self._fail_rules: List[List[Any]] = []
        # the pre-journal tree: materialization replays the journal on
        # top of a snapshot of the root taken NOW (files created before
        # recording are fully durable history)
        self._base = self.root + ".crashfs-base"
        if os.path.exists(self._base):
            shutil.rmtree(self._base)
        shutil.copytree(self.root, self._base)

    # -- path bookkeeping -------------------------------------------------
    def _rel(self, path: str) -> Optional[str]:
        """Root-relative key, or None for paths outside the recorded
        tree (delegated without journaling)."""
        p = os.path.abspath(_local(path))
        if p == self.root:
            return "."
        if p.startswith(self.root + os.sep):
            return os.path.relpath(p, self.root)
        return None

    def _fid_for(self, rel: str, fresh: bool) -> int:
        if fresh or rel not in self._fids:
            self._next_fid += 1
            self._fids[rel] = self._next_fid
        return self._fids[rel]

    # -- injectable device errors ----------------------------------------
    def fail(self, kind: str, err: int, count: int = 1,
             after: int = 0) -> None:
        """Arm an OSError(err) on the next ``count`` calls of ``kind``
        (write | fsync | rename | delete | mkdir | link), skipping the
        first ``after`` matching calls — the ENOSPC/EIO half of the
        plane."""
        self._fail_rules.append([kind, int(err), int(count), int(after)])

    def _check_fail(self, kind: str) -> None:
        for rule in self._fail_rules:
            if rule[0] != kind or rule[2] <= 0:
                continue
            if rule[3] > 0:
                rule[3] -= 1
                continue
            rule[2] -= 1
            raise OSError(rule[1], os.strerror(rule[1]),
                          f"crashfs injected {kind}")

    # -- FileSystem contract ----------------------------------------------
    def open_read(self, path: str):
        return open(_local(path), "rb")

    def open_write(self, path: str, sync: bool = False):
        self._check_fail("write")
        rel = self._rel(path)
        if rel is None:
            return self._inner.open_write(_local(path), sync=sync)
        return _RecordingWriter(self, path, sync)

    def _journal_write(self, path: str, data: bytes, sync: bool) -> None:
        rel = self._rel(path)
        if rel is None:
            return
        fid = self._fid_for(rel, fresh=True)  # "wb" truncates: new version
        self.journal.append(CrashOp("write", rel, data=data, fid=fid,
                                    sync=sync))

    def fsync(self, path: str) -> None:
        self._check_fail("fsync")
        rel = self._rel(path)
        is_dir = os.path.isdir(_local(path))
        self._inner.fsync(_local(path))
        if rel is not None:
            # a FILE fsync makes its content durable; a DIRECTORY fsync
            # makes the dir's ENTRY mutations (renames/deletes/links)
            # durable — the two halves of POSIX durability
            self.journal.append(CrashOp(
                "fsync", rel, fid=self._fids.get(rel, -1), dir=is_dir))

    def mkdirs(self, path: str) -> None:
        self._check_fail("mkdir")
        os.makedirs(_local(path), exist_ok=True)
        rel = self._rel(path)
        if rel is not None:
            self.journal.append(CrashOp("mkdir", rel))

    def exists(self, path: str) -> bool:
        return os.path.exists(_local(path))

    def listdir(self, path: str) -> List[str]:
        return os.listdir(_local(path))

    def delete(self, path: str, recursive: bool = False) -> None:
        self._check_fail("delete")
        rel = self._rel(path)
        self._inner.delete(_local(path), recursive=recursive)
        if rel is not None:
            self._fids.pop(rel, None)
            self.journal.append(CrashOp("delete", rel,
                                        recursive=recursive))

    def rename(self, src: str, dst: str) -> None:
        self._check_fail("rename")
        rels, reld = self._rel(src), self._rel(dst)
        os.rename(_local(src), _local(dst))
        if rels is None or reld is None:
            return
        # the file identity follows the rename (fsync-after-rename on
        # the new name covers bytes written under the old one); a DIR
        # rename moves every child's identity
        if rels in self._fids:
            self._fids[reld] = self._fids.pop(rels)
        prefix = rels + os.sep
        for k in [k for k in self._fids if k.startswith(prefix)]:
            self._fids[os.path.join(reld, k[len(prefix):])] = \
                self._fids.pop(k)
        self.journal.append(CrashOp("rename", rels, dst=reld))

    def link_or_copy(self, src: str, dst: str) -> None:
        self._check_fail("link")
        rels, reld = self._rel(src), self._rel(dst)
        self._inner.link_or_copy(_local(src), _local(dst))
        if rels is None or reld is None:
            return
        if rels in self._fids:
            self._fids[reld] = self._fids[rels]
        self.journal.append(CrashOp("link", rels, dst=reld))

    def size(self, path: str) -> int:
        return os.path.getsize(_local(path))

    def is_dir(self, path: str) -> bool:
        return os.path.isdir(_local(path))

    # -- crash-image materialization --------------------------------------
    def crash(self, dst: str, at: Optional[int] = None,
              rng: Optional[random.Random] = None,
              seed: int = 0) -> Dict[str, Any]:
        """Materialize one POSIX-legal post-crash image of the recorded
        tree into directory ``dst`` (created fresh). ``at`` cuts the
        journal before op index ``at`` (default: rng-sampled, including
        0 = crash before anything and len = crash after everything —
        where only DURABILITY choices differ). Returns the decision
        record {"cut", "seed", "decisions": [...]} a failing test
        prints for exact replay."""
        rng = rng or random.Random(seed)
        n = len(self.journal)
        cut = rng.randint(0, n) if at is None else max(0, min(int(at), n))
        model = _Materializer(self._base, self.journal[:cut],
                              self.journal, cut, rng)
        decisions = model.resolve()
        if os.path.exists(dst):
            shutil.rmtree(dst)
        model.emit(dst)
        return {"cut": cut, "seed": seed, "decisions": decisions}

    def close(self) -> None:
        """Drop the base snapshot (test teardown)."""
        shutil.rmtree(self._base, ignore_errors=True)


class _Materializer:
    """Replays a journal prefix over the base snapshot with seeded
    POSIX-legal durability choices (module doc has the model)."""

    def __init__(self, base: str, ops: List[CrashOp],
                 full_journal: List[CrashOp], cut: int,
                 rng: random.Random) -> None:
        self.base = base
        self.ops = ops
        self.rng = rng
        # durable write set: op index i (write, fid f) is durable iff
        # op.sync, or some FILE fsync of fid f lands at index in
        # (i, cut). Durable ENTRY set: a rename/delete/link at i is
        # durable iff a DIRECTORY fsync of the affected parent lands
        # after i (write_atomic's post-rename dir fsync) — fsyncing a
        # file never persists its directory entry.
        synced_after: Dict[int, List[int]] = {}
        dir_syncs: Dict[str, List[int]] = {}
        for j in range(cut):
            op = full_journal[j]
            if op.kind != "fsync":
                continue
            if op.dir:
                dir_syncs.setdefault(op.path, []).append(j)
            elif op.fid >= 0:
                synced_after.setdefault(op.fid, []).append(j)
        self.durable: Set[int] = set()
        for i, op in enumerate(ops):
            if op.kind == "write":
                if op.sync or any(j > i
                                  for j in synced_after.get(op.fid, ())):
                    self.durable.add(i)
            elif op.kind in ("rename", "delete", "link"):
                target = op.dst if op.kind in ("rename", "link") else op.path
                parent = os.path.dirname(target) or "."
                if any(j > i for j in dir_syncs.get(parent, ())):
                    self.durable.add(i)

    # -- in-memory tree ----------------------------------------------------
    def _load_base(self) -> None:
        self.files: Dict[str, bytes] = {}
        self.dirs: Set[str] = {"."}
        for root, dirnames, filenames in os.walk(self.base):
            rel = os.path.relpath(root, self.base)
            for d in dirnames:
                self.dirs.add(os.path.normpath(os.path.join(rel, d)))
            for f in filenames:
                p = os.path.join(root, f)
                with open(p, "rb") as fh:
                    self.files[os.path.normpath(
                        os.path.join(rel, f))] = fh.read()

    def _move(self, src: str, dst: str) -> None:
        if src in self.files:
            # rename over an existing dst replaces it (POSIX)
            self.files[dst] = self.files.pop(src)
            return
        if src in self.dirs:
            self.dirs.discard(src)
            self.dirs.add(dst)
            prefix = src + os.sep
            for k in [k for k in self.files if k.startswith(prefix)]:
                self.files[os.path.join(dst, k[len(prefix):])] = \
                    self.files.pop(k)
            for k in [k for k in self.dirs if k.startswith(prefix)]:
                self.dirs.discard(k)
                self.dirs.add(os.path.join(dst, k[len(prefix):]))

    def _remove(self, path: str, recursive: bool) -> None:
        if path in self.files:
            del self.files[path]
            return
        if path in self.dirs and recursive:
            self.dirs.discard(path)
            prefix = path + os.sep
            for k in [k for k in self.files if k.startswith(prefix)]:
                del self.files[k]
            for k in [k for k in self.dirs if k.startswith(prefix)]:
                self.dirs.discard(k)

    def _torn_content(self, data: bytes, choice: str) -> Optional[bytes]:
        """The legal survivals of an UNSYNCED write's bytes."""
        if choice == "full":
            return data
        if choice == "drop":
            return None  # the creation itself never reached disk
        if choice == "empty":
            return b""
        nblocks = len(data) // BLOCK
        if choice == "prefix":
            keep = self.rng.randint(0, nblocks) * BLOCK
            return data[:keep]
        # torn: a block-aligned prefix plus the next partial/garbage
        # block zeroed — bytes the device claimed but never persisted
        keep = self.rng.randint(0, nblocks) * BLOCK
        tail = min(len(data) - keep, BLOCK)
        return data[:keep] + b"\x00" * tail

    def resolve(self) -> List[Tuple[int, str, str]]:
        """Replay with choices; returns the decision log
        [(op_index, op_kind+path, choice)]."""
        self._load_base()
        decisions: List[Tuple[int, str, str]] = []
        for i, op in enumerate(self.ops):
            if op.kind == "mkdir":
                parts = op.path.split(os.sep)
                for d in range(1, len(parts) + 1):
                    self.dirs.add(os.path.join(*parts[:d]))
            elif op.kind == "fsync":
                continue
            elif op.kind == "write":
                if i in self.durable:
                    self.files[op.path] = op.data
                    continue
                choice = self.rng.choice(
                    ("full", "drop", "empty", "prefix", "torn"))
                decisions.append((i, f"write {op.path}", choice))
                content = self._torn_content(op.data, choice)
                if content is None:
                    self.files.pop(op.path, None)
                else:
                    self.files[op.path] = content
            elif op.kind == "rename":
                # a directory-entry mutation: durable only under a
                # later dir fsync of the parent; otherwise it may be
                # un-applied — which also reorders it against later
                # synced writes (the ext4 ordered-mode window)
                applied = (i in self.durable
                           or self.rng.random() < 0.5)
                if i not in self.durable:
                    decisions.append((
                        i, f"rename {op.path} -> {op.dst}",
                        "applied" if applied else "dropped"))
                if applied:
                    self._move(op.path, op.dst)
            elif op.kind == "delete":
                applied = (i in self.durable
                           or self.rng.random() < 0.5)
                if i not in self.durable:
                    decisions.append((
                        i, f"delete {op.path}",
                        "applied" if applied else "dropped"))
                if applied:
                    self._remove(op.path, op.recursive)
            elif op.kind == "link":
                applied = (i in self.durable
                           or self.rng.random() < 0.5)
                if i not in self.durable:
                    decisions.append((
                        i, f"link {op.path} -> {op.dst}",
                        "applied" if applied else "dropped"))
                if applied and op.path in self.files:
                    self.files[op.dst] = self.files[op.path]
        return decisions

    def emit(self, dst: str) -> None:
        os.makedirs(dst, exist_ok=True)
        for d in sorted(self.dirs):
            os.makedirs(os.path.join(dst, d), exist_ok=True)
        for path, data in self.files.items():
            full = os.path.join(dst, path)
            os.makedirs(os.path.dirname(full), exist_ok=True)
            with open(full, "wb") as f:
                f.write(data)


def install(root: str) -> CrashFS:
    """Create a CrashFS over ``root`` and register it as THE ``crash``
    scheme filesystem; hand tiers ``crash://<root>/...`` paths.
    Re-registering replaces any previous instance (tests run scenarios
    sequentially)."""
    crashfs = CrashFS(root)
    register_filesystem(SCHEME, lambda: crashfs)
    return crashfs
