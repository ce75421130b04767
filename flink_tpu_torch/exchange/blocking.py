"""The blocking shuffle of batch mode (``execution.runtime-mode:
batch``): an exchange edge into a stateful operator is spooled in full
to node-local partition files before its consumer's wave starts, the
JAX package's ``exchange/blocking.py``. Producer and consumer never run
at the same time, so the "network" is files in the shared columnar
format (``formats_columnar.py``), byte for byte the JAX package's.

Layout: ``<root>/<job>-<hex8>/edge-<u>-<v>/part-<p>.colb``. A keyed edge
routes each row by its consumer's key column with the runtime's key hash
(``records.hash_keys_numpy``), so each partition holds a disjoint key
range and a key's rows keep their arrival order. Timestamps ride as the
reserved ``__ts__`` column. A truncated or corrupt partition fails the
read (``ColumnarError``): a blocking exchange never drops records.
"""
from __future__ import annotations

import os
import shutil
import uuid
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from flink_tpu_torch.formats_columnar import (
    ColumnarWriter, infer_schema, iter_file_blocks)
from flink_tpu_torch.records import hash_keys_numpy

__all__ = ["BlockingShuffle", "EdgeWriter", "TS_COLUMN"]

TS_COLUMN = "__ts__"


class EdgeWriter:
    """The spool of one blocking edge (u -> v): arriving batches append
    to its partition files, which are sealed (footers written) before
    the consumer's wave starts. The first non-empty batch fixes the
    schema; a later batch of another schema fails the write."""

    def __init__(self, directory: str, n_partitions: int,
                 key_field: Optional[str]) -> None:
        self.dir = directory
        self.key_field = key_field
        self.n_partitions = max(1, n_partitions) if key_field else 1
        self._files: List[Optional[object]] = [None] * self.n_partitions
        self._writers: List[Optional[ColumnarWriter]] = (
            [None] * self.n_partitions)
        self._schema = None
        self.rows = 0
        self.sealed = False
        os.makedirs(directory, exist_ok=True)

    def _path(self, p: int) -> str:
        return os.path.join(self.dir, f"part-{p:04d}.colb")

    def _writer(self, p: int) -> ColumnarWriter:
        if self._writers[p] is None:
            f = open(self._path(p), "wb")
            self._files[p] = f
            self._writers[p] = ColumnarWriter(f, self._schema)
        return self._writers[p]

    def write(self, data: Dict[str, np.ndarray], ts: np.ndarray,
              valid: np.ndarray) -> None:
        if self.sealed:
            raise RuntimeError("write into a sealed blocking edge")
        ts = np.asarray(ts, np.int64)
        valid = np.asarray(valid, bool)
        if not valid.all():
            data = {k: np.asarray(v)[valid] for k, v in data.items()}
            ts = ts[valid]
        if not len(ts):
            return
        row = dict(data)
        row[TS_COLUMN] = ts
        if self._schema is None:
            self._schema = infer_schema(row)
        if self.n_partitions == 1:
            self._writer(0).write_batch(row)
        else:
            dest = (hash_keys_numpy(np.asarray(data[self.key_field], np.int64))
                    % self.n_partitions)
            for p in np.unique(dest):
                m = dest == p
                self._writer(int(p)).write_batch(
                    {k: np.asarray(v)[m] for k, v in row.items()})
        self.rows += len(ts)

    def seal(self) -> None:
        """Footers written and files closed: the partitions are complete,
        self-validating files."""
        if self.sealed:
            return
        for w, f in zip(self._writers, self._files):
            if w is not None:
                w.close()
                f.close()
        self.sealed = True

    @property
    def bytes_written(self) -> int:
        return sum(w.bytes_written for w in self._writers if w is not None)

    def read(self) -> Iterator[Tuple[Dict[str, np.ndarray], np.ndarray]]:
        """The sealed partitions, partition by partition, a block at a
        time, as (data, timestamps)."""
        if not self.sealed:
            raise RuntimeError("read of an unsealed blocking edge")
        for p, w in enumerate(self._writers):
            if w is None:
                continue
            with open(self._path(p), "rb") as f:
                for block in iter_file_blocks(f, expect_schema=self._schema):
                    ts = block.pop(TS_COLUMN)
                    yield block, np.asarray(ts, np.int64)


class BlockingShuffle:
    """Every blocking edge of one batch run, spooled under a directory of
    its own below ``root``, removed at ``close`` when ``cleanup``."""

    def __init__(self, root: str, job_name: str, n_partitions: int = 1,
                 cleanup: bool = True) -> None:
        safe = "".join(c if c.isalnum() or c in "-_." else "_"
                       for c in job_name)[:64]
        self.dir = os.path.join(root, f"{safe}-{uuid.uuid4().hex[:8]}")
        self.n_partitions = n_partitions
        self._cleanup = cleanup
        self._edges: Dict[Tuple[int, int], EdgeWriter] = {}
        os.makedirs(self.dir, exist_ok=True)

    def open_edge(self, u: int, v: int,
                  key_field: Optional[str] = None) -> EdgeWriter:
        ew = EdgeWriter(os.path.join(self.dir, f"edge-{u}-{v}"),
                        self.n_partitions, key_field)
        self._edges[(u, v)] = ew
        return ew

    def edge(self, u: int, v: int) -> EdgeWriter:
        return self._edges[(u, v)]

    @property
    def bytes_written(self) -> int:
        return sum(e.bytes_written for e in self._edges.values())

    @property
    def rows_spooled(self) -> int:
        return sum(e.rows for e in self._edges.values())

    def close(self) -> None:
        for e in self._edges.values():
            e.seal()  # closes the files on a failed run too
        if self._cleanup:
            shutil.rmtree(self.dir, ignore_errors=True)
