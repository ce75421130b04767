"""File connectors and the socket source, the JAX package's
``connectors``: ``FileSource`` (one split a file, replayable by batch
index), ``FileSink`` (exactly-once part files on the two-phase-commit
protocol of ``api/sinks.py``, rolling a staged epoch into numbered
parts) and ``SocketSource`` (line-framed TCP ingest). Formats come from
``formats.py`` and ``formats_columnar.py``; every path goes through the
filesystem seam (``fs.py``), so any registered scheme works, and a part
written by either package reads in the other.
"""
from __future__ import annotations

import dataclasses
import fnmatch
import os
import time
from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np

from flink_tpu_torch.api.sinks import TwoPhaseCommitSink
from flink_tpu_torch.api.sources import Source
from flink_tpu_torch.formats import Format
from flink_tpu_torch.fs import get_filesystem, write_atomic

__all__ = ["FileSource", "FileSink", "SocketSource"]

Batch = Tuple[Dict[str, np.ndarray], np.ndarray]


def _stamps(data: Dict[str, np.ndarray], ts_field: Optional[str],
            required: bool = True) -> np.ndarray:
    """A batch's event times from ``ts_field``, else its ingest time; a
    ``required`` field the batch lacks raises."""
    if ts_field is not None and (required or ts_field in data):
        return np.asarray(data[ts_field], np.int64)
    n = len(next(iter(data.values()), []))
    return np.full(n, np.int64(time.time() * 1000), np.int64)


def _read_all(fs, path: str) -> bytes:
    with fs.open_read(path) as f:
        raw = f.read()
    return raw.encode("utf-8") if isinstance(raw, str) else raw


@dataclasses.dataclass
class FileSource(Source):
    """One split a matching file, in sorted order: ``path`` names a file,
    a directory (its files but dot-files) or a glob. A split's batches
    are ``batch_size`` lines of a text format, or the stored blocks of a
    binary one; a position counts batches, so a replay reopens the file
    and skips the consumed ones (a binary format validates them without
    decoding). ``ts_field`` is the event-time column in ms; without it a
    batch is stamped with its ingest time."""

    path: str
    format: Format
    ts_field: Optional[str] = None
    batch_size: int = 65536

    def splits(self) -> List[str]:
        fs = get_filesystem(self.path)
        base = self.path
        if fs.exists(base) and fs.is_dir(base):
            return sorted(os.path.join(base, f) for f in fs.listdir(base)
                          if not f.startswith("."))
        if any(ch in base for ch in "*?["):
            d, pat = os.path.split(base)
            if not fs.exists(d):
                return []
            return sorted(os.path.join(d, f) for f in fs.listdir(d)
                          if fnmatch.fnmatch(f, pat))
        return [base] if fs.exists(base) else []

    def open_split(self, split: str, start_pos: int = 0) -> Iterator[Batch]:
        raw = _read_all(get_filesystem(split), split)
        if getattr(self.format, "binary", False):
            for data in self.format.iter_batches(raw, skip=start_pos):
                yield data, _stamps(data, self.ts_field)
            return
        lines = raw.split(b"\n")
        if lines and lines[-1] == b"":
            lines.pop()
        for index, lo in enumerate(range(0, len(lines), self.batch_size)):
            if index < start_pos:
                continue
            data = self.format.deserialize(
                b"\n".join(lines[lo:lo + self.batch_size]) + b"\n")
            yield data, _stamps(data, self.ts_field)


class FileSink(TwoPhaseCommitSink):
    """Exactly-once part files: rows buffer in memory a checkpoint epoch,
    the barrier stages them as fsynced files under ``staged/`` (a new
    numbered part every ``rolling_records`` rows), and the checkpoint's
    completion renames them into ``committed/``. A staged part's bytes
    ride the checkpoint, so a restore rebuilds a part an abort deleted.

    Part names carry the attempt's fencing epoch,
    ``part-<cid>-<part>.e<epoch>``: a deposed attempt that wakes mid-
    commit renames to its own epoch's name and never over a successor's
    part, a (cid, part) that is committed under any epoch is never
    published again, an abort skips parts a higher epoch staged, and a
    reader takes the highest epoch of a (cid, part). Names without an
    epoch (older directories) read as epoch 0."""

    def __init__(self, directory: str, format: Format,
                 rolling_records: int = 1_000_000) -> None:
        self.dir = directory
        self.format = format
        self.rolling_records = max(1, rolling_records)
        self._fs = get_filesystem(directory)
        self._staged_dir = os.path.join(directory, "staged")
        self._committed_dir = os.path.join(directory, "committed")
        self._fs.mkdirs(self._staged_dir)
        self._fs.mkdirs(self._committed_dir)
        self._pending: List[Dict[str, np.ndarray]] = []
        self._epoch = 0

    def set_attempt_epoch(self, epoch: int) -> None:
        self._epoch = int(epoch)

    def write(self, batch: Dict[str, np.ndarray]) -> None:
        cols = {k: np.asarray(v) for k, v in batch.items()
                if k in self.format.fields}
        if cols and len(next(iter(cols.values()))):
            self._pending.append(cols)

    def _part_name(self, cid: int, part: int) -> str:
        return f"part-{cid:010d}-{part:04d}.e{self._epoch}"

    @staticmethod
    def _parse_part(name: str) -> Optional[Tuple[int, int, int]]:
        """``part-<cid>-<part>[.e<epoch>]`` as (cid, part, epoch); None
        for a tmp file or a foreign name."""
        if not name.startswith("part-") or name.endswith(".tmp"):
            return None
        core, _, esuf = name.partition(".e")
        bits = core.split("-")
        try:
            return int(bits[1]), int(bits[2]), int(esuf) if esuf else 0
        except (IndexError, ValueError):
            return None

    def _parts(self, directory: str) -> List[Tuple[Tuple[int, int, int], str]]:
        out = []
        for name in self._fs.listdir(directory):
            parsed = self._parse_part(name)
            if parsed is not None:
                out.append((parsed, name))
        return sorted(out)

    # -- the two-phase-commit contract ----------------------------------------
    def drop_pending(self) -> None:
        self._pending = []

    def stage_transaction(self, cid: int) -> bool:
        if not self._pending:
            return False
        data = {k: np.concatenate([b[k] for b in self._pending])
                for k in self._pending[0]}
        self._pending = []
        n = len(next(iter(data.values())))
        for part, lo in enumerate(range(0, n, self.rolling_records)):
            chunk = {k: v[lo:lo + self.rolling_records]
                     for k, v in data.items()}
            # tmp + fsync + rename: durable before the pre-commit state
            # names it
            write_atomic(self._fs, os.path.join(
                self._staged_dir, self._part_name(cid, part)),
                self.format.serialize(chunk))
        return True

    def staged_transaction_ids(self) -> List[int]:
        return sorted({p[0] for p, _ in self._parts(self._staged_dir)})

    def commit_transaction(self, cid: int) -> None:
        committed = {p[:2] for p, _ in self._parts(self._committed_dir)}
        staged = [(p, name) for p, name in self._parts(self._staged_dir)
                  if p[0] == cid]
        # one winner a (cid, part): the highest staged epoch
        winners: Dict[int, str] = {}
        for (_, part, _epoch), name in staged:
            winners[part] = name  # sorted: the highest epoch comes last
        for (_, part, _epoch), name in staged:
            src = os.path.join(self._staged_dir, name)
            if name != winners[part] or (cid, part) in committed:
                # a deposed duplicate, or a replayed commit of a part
                # some attempt already published: never clobber
                self._fs.delete(src)
            else:
                self._fs.rename(src, os.path.join(self._committed_dir, name))

    def abort_transaction(self, cid: int) -> None:
        for (c, _part, epoch), name in self._parts(self._staged_dir):
            # a part a higher epoch staged is a successor's live work
            if c == cid and epoch <= self._epoch:
                self._fs.delete(os.path.join(self._staged_dir, name))

    def snapshot_transaction(self, cid: int) -> Any:
        return {"parts": {
            name: _read_all(self._fs, os.path.join(self._staged_dir, name))
            for (c, _, _), name in self._parts(self._staged_dir)
            if c == cid}}

    def rebuild_transaction(self, cid: int, payload: Any) -> None:
        for name, data in (payload or {}).get("parts", {}).items():
            path = os.path.join(self._staged_dir, name)
            if not self._fs.exists(path):
                write_atomic(self._fs, path, data)

    # -- reading back ---------------------------------------------------------
    def committed_batches(self) -> List[Dict[str, np.ndarray]]:
        """The committed parts' batches in (cid, part) order, a (cid,
        part) at its highest epoch."""
        best: Dict[Tuple[int, int], str] = {}
        for (cid, part, _epoch), name in self._parts(self._committed_dir):
            best[(cid, part)] = name  # sorted: the highest epoch wins
        return [self.format.deserialize(_read_all(
            self._fs, os.path.join(self._committed_dir, best[key])))
            for key in sorted(best)]


class SocketSource(Source):
    """Line-framed TCP ingest: the source listens on loopback (``port`` 0
    picks a free one, read back from ``port``), one producer connects and
    streams newline-separated records, and the stream ends when it
    disconnects. Blocks of complete lines come from the host codec's C
    reader and parse through ``format`` (without one, each line is a
    ``line`` string). While nobody is connected, and on an idle socket,
    the split yields schema-typed empty batches every ``poll_ms`` so the
    driver's loop keeps turning. Not replayable: a restore cannot re-read
    a socket, so ``open_split`` ignores its start position."""

    def __init__(self, port: int = 0, format: Optional[Format] = None,
                 ts_field: Optional[str] = None, block_bytes: int = 1 << 20,
                 poll_ms: int = 100) -> None:
        from flink_tpu_torch.native_codec import NativeSocketReader

        self.format = format
        self.ts_field = ts_field
        self.block_bytes = block_bytes
        self.poll_ms = poll_ms
        self._reader = NativeSocketReader.create(port)
        self.port = self._reader.port

    def splits(self) -> List[str]:
        return ["socket"]

    def _empty_batch(self) -> Dict[str, np.ndarray]:
        if self.format is not None:
            return self.format.deserialize(b"")
        return {"line": np.array([], dtype=object)}

    def open_split(self, split: str, start_pos: int = 0) -> Iterator[Batch]:
        try:
            while self._reader.accept(self.poll_ms) == 0:
                yield self._empty_batch(), np.zeros(0, np.int64)
            while True:
                block = self._reader.read_block(self.block_bytes,
                                                self.poll_ms)
                if block is None:
                    return  # the producer disconnected
                if not block:
                    yield self._empty_batch(), np.zeros(0, np.int64)
                    continue
                if self.format is not None:
                    data = self.format.deserialize(block)
                else:
                    data = {"line": np.array(
                        block.decode("utf-8", "replace").splitlines(),
                        dtype=object)}
                yield data, _stamps(data, self.ts_field, required=False)
        finally:
            self._reader.close()


class _PySocketReader:
    """``NativeSocketReader``'s plain version in Python, with its
    contract: complete-line blocks, b"" on a timeout, None at the end,
    an error on a line longer than ``cap``."""

    def __init__(self, port: int = 0) -> None:
        import socket

        self._srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._srv.bind(("127.0.0.1", port))
        self._srv.listen(1)
        self._conn = None
        self._carry = b""

    @property
    def port(self) -> int:
        return self._srv.getsockname()[1]

    def accept(self, timeout_ms: int = 100) -> int:
        import socket

        if self._conn is not None:
            return 1
        self._srv.settimeout(timeout_ms / 1000)
        try:
            self._conn, _ = self._srv.accept()
        except socket.timeout:
            return 0
        return 1

    def read_block(self, cap: int = 1 << 20,
                   timeout_ms: int = 100) -> Optional[bytes]:
        import socket

        self._conn.settimeout(timeout_ms / 1000)
        buf = self._carry
        while True:
            nl = buf.rfind(b"\n")
            if nl >= 0 and (len(buf) >= cap or nl + 1 >= cap):
                self._carry = buf[nl + 1:]
                return buf[:nl + 1]
            if nl < 0 and len(buf) >= cap:
                raise IOError(
                    f"socket reader error (a line exceeded {cap} bytes)")
            try:
                chunk = self._conn.recv(max(cap - len(buf), 1))
            except socket.timeout:
                if nl >= 0:
                    self._carry = buf[nl + 1:]
                    return buf[:nl + 1]
                self._carry = buf
                return b""
            if not chunk:
                self._carry = b""
                return buf[:nl + 1] if nl >= 0 else None
            buf += chunk

    def close(self) -> None:
        if self._conn is not None:
            self._conn.close()
        self._srv.close()
