"""The self-contained binary columnar file format, block codec only:
the JAX package's ``formats_columnar`` byte for byte, so a file written
by either package is read by the other. The LSM state tier
(``state/lsm.py``) writes its sealed runs in it.

Wire layout (all integers little-endian)::

    file   := magic "FTPC" | u8 version=1 | u8 flags=0 | u16 ncols
              | u32 header_len | header utf-8 JSON | u32 crc32(header)
              | block* | footer
    header := {"fields": [[name, type], ...]}   type in i64 f32 f64 str
    block  := "BLK\\0" | u32 nrows | u32 payload_len | payload
              | u32 crc32(payload)
    footer := "END\\0" | u32 nblocks | u64 total_rows

    payload: columns in schema order.
      i64/f32/f64 := nrows fixed-width little-endian values
      str         := u32 offsets[nrows+1] | utf-8 blob (offsets[-1] bytes)

Every failure is a ``ColumnarError``: an empty or truncated file, a bad
magic or version, a header or block CRC mismatch, a missing or
inconsistent footer, and a schema mismatch in either direction. The
checksum is ``zlib.crc32`` (the JAX package's native CRC is
bit-identical to it). ``write_batch`` writes fixed-width columns as
views of the caller's arrays, and ``iter_blocks(..., zero_copy=True)``
returns read-only views into the file image (an mmap from
``map_file_image``) on a little-endian host.

``infer_schema`` maps a batch's dtypes to the schema a log topic
fixes at its first append (``log/topic.py``). ``iter_file_blocks``
reads an open file a block at a time (the shuffle's consumer holds one
block, never the whole partition), and ``ColumnarFormat`` is the
connectors' ``Format`` face: one single-block file a serialized batch,
a file's blocks as the file source's replayable batches.
"""
from __future__ import annotations

import dataclasses
import json
import os
import struct
import sys
from typing import Any, Dict, Iterator, List, Tuple
from zlib import crc32 as _crc32

import numpy as np

from flink_tpu_torch.formats import Format

__all__ = ["ColumnarError", "ColumnarFormat", "ColumnarWriter",
           "infer_schema", "iter_blocks", "iter_file_blocks",
           "map_file_image", "read_schema"]

#: zero-copy views reinterpret little-endian file bytes in place —
#: only valid when the host IS little-endian (x86/arm64; the copying
#: path byte-swaps via astype on anything else)
_ZERO_COPY_HOST = sys.byteorder == "little"

Batch = Dict[str, np.ndarray]

_MAGIC = b"FTPC"
_BLOCK_MAGIC = b"BLK\x00"
_FOOTER_MAGIC = b"END\x00"
_VERSION = 1

_FIXED_DTYPES = {"i64": np.dtype("<i8"), "f32": np.dtype("<f4"),
                 "f64": np.dtype("<f8")}
_TYPES = ("i64", "f32", "f64", "str")


class ColumnarError(ValueError):
    """Any malformed columnar input: truncation, corruption (CRC), or
    schema mismatch. Always raised loudly — a batch pipeline must never
    silently skip a damaged shuffle partition (SURVEY §3.7: lost blocks
    mean lost records, which blocking exchanges may not drop)."""


def infer_schema(batch: Batch) -> Tuple[Tuple[str, str], ...]:
    """Schema from a concrete batch: integer/bool → i64, float32 → f32,
    other floats → f64, object/str → str. Columns keep dict order (the
    framework's struct-of-arrays convention is insertion-ordered)."""
    schema: List[Tuple[str, str]] = []
    for name, col in batch.items():
        a = np.asarray(col)
        if a.dtype.kind in ("i", "u", "b"):
            schema.append((name, "i64"))
        elif a.dtype == np.float32:
            schema.append((name, "f32"))
        elif a.dtype.kind == "f":
            schema.append((name, "f64"))
        elif a.dtype.kind in ("O", "U", "S"):
            schema.append((name, "str"))
        else:
            raise ColumnarError(
                f"column {name!r} has unsupported dtype {a.dtype} "
                f"(supported: int→i64, f32, f64, object/str)")
    return tuple(schema)


def _check_schema(schema) -> Tuple[Tuple[str, str], ...]:
    out = tuple((str(n), str(t)) for n, t in schema)
    if not out:
        raise ColumnarError("columnar schema must name at least one column")
    for n, t in out:
        if t not in _TYPES:
            raise ColumnarError(
                f"unknown column type {t!r} for {n!r} "
                f"(supported: {'/'.join(_TYPES)})")
    return out


def _encode_column_parts(name: str, typ: str, col: np.ndarray,
                         nrows: int) -> List[Any]:
    """One column → a list of write buffers (the scatter-write path:
    a fixed-width column that is already contiguous in the file dtype
    goes out as a MEMORYVIEW of the caller's array — no ``tobytes()``
    copy, no payload concatenation). The chained block CRC over these
    parts equals the CRC of their concatenation, so the file bytes are
    unchanged."""
    a = np.asarray(col)
    if len(a) != nrows:
        raise ColumnarError(
            f"ragged batch: column {name!r} has {len(a)} rows, "
            f"expected {nrows}")
    if typ == "str":
        # only actual text round-trips: bytes decode as utf-8 (str(b'x')
        # would bake the repr "b'x'" into the file), anything else is a
        # loud schema error — str(tuple) etc. would be silent corruption
        items = []
        for x in a:
            if isinstance(x, bytes):
                try:
                    x = x.decode("utf-8")
                except UnicodeDecodeError as e:
                    raise ColumnarError(
                        f"column {name!r}: non-UTF8 bytes value "
                        f"({e})") from e
            elif not isinstance(x, str):
                raise ColumnarError(
                    f"schema mismatch on write: column {name!r} is "
                    f"declared str but holds a {type(x).__name__} "
                    f"value")
            items.append(x.encode("utf-8"))
        ends = np.cumsum([len(b) for b in items], dtype=np.int64)
        if nrows and int(ends[-1]) > 0xFFFFFFFF:
            raise ColumnarError(
                f"column {name!r}: block string data is "
                f"{int(ends[-1])} bytes — the u32 offset frame caps a "
                "block at 4 GiB; write smaller batches")
        offsets = np.zeros(nrows + 1, np.uint32)
        if nrows:
            offsets[1:] = ends
        return [offsets.astype("<u4").data.cast("B"), b"".join(items)]
    if typ in ("i64",) and a.dtype.kind not in ("i", "u", "b"):
        raise ColumnarError(
            f"schema mismatch on write: column {name!r} is declared "
            f"{typ} but the batch carries dtype {a.dtype}")
    if typ in ("f32", "f64") and a.dtype.kind not in ("f", "i", "u"):
        raise ColumnarError(
            f"schema mismatch on write: column {name!r} is declared "
            f"{typ} but the batch carries dtype {a.dtype}")
    # no-op when the array is already contiguous in the file dtype —
    # the common hot path hands its bytes straight to the file; the
    # cast('B') byte view is what write()/crc32 accept without copying
    fixed = np.ascontiguousarray(a, _FIXED_DTYPES[typ])
    return [fixed.data.cast("B") if fixed.nbytes else b""]


class ColumnarWriter:
    """Streaming writer: header at open, one block per ``write_batch``,
    footer at ``close``. The footer is the durability tripwire — a
    reader treats its absence as truncation, so a crashed writer can
    never pass off a partial partition file as complete."""

    def __init__(self, f, schema) -> None:
        self._f = f
        self.schema = _check_schema(schema)
        self._nblocks = 0
        self._nrows = 0
        self.bytes_written = 0
        header = json.dumps(
            {"fields": [[n, t] for n, t in self.schema]},
            separators=(",", ":")).encode("utf-8")
        head = (_MAGIC + struct.pack("<BBH", _VERSION, 0, len(self.schema))
                + struct.pack("<I", len(header)) + header
                + struct.pack("<I", _crc32(header)))
        f.write(head)
        self.bytes_written += len(head)

    def write_batch(self, batch: Batch) -> None:
        missing = [n for n, _ in self.schema if n not in batch]
        extra = [n for n in batch if n not in {s for s, _ in self.schema}]
        if missing or extra:
            raise ColumnarError(
                f"schema mismatch on write: missing columns {missing}, "
                f"unexpected columns {extra} "
                f"(schema: {[n for n, _ in self.schema]})")
        nrows = len(np.asarray(batch[self.schema[0][0]]))
        # scatter write: column buffers go to the file one by one (the
        # sendmsg discipline of exchange/frames.py applied to a file) —
        # no b"".join payload image, no per-column tobytes. The CRC
        # chains across the parts, which for CRC-32 equals the CRC of
        # the concatenation: the on-disk bytes are IDENTICAL to the
        # copying writer's.
        parts: List[Any] = []
        for n, t in self.schema:
            parts.extend(_encode_column_parts(n, t, batch[n], nrows))
        payload_len = sum(
            p.nbytes if isinstance(p, memoryview) else len(p)
            for p in parts)
        crc = 0
        for p in parts:
            crc = _crc32(p, crc)
        self._f.write(_BLOCK_MAGIC + struct.pack("<II", nrows,
                                                 payload_len))
        for p in parts:
            self._f.write(p)
        self._f.write(struct.pack("<I", crc))
        self.bytes_written += 12 + payload_len + 4
        self._nblocks += 1
        self._nrows += nrows

    def close(self) -> None:
        foot = _FOOTER_MAGIC + struct.pack("<IQ", self._nblocks, self._nrows)
        self._f.write(foot)
        self.bytes_written += len(foot)


class _Cursor:
    """Bounds-checked byte reader: every overrun is a loud truncation
    error naming the structure that was cut short. Accepts bytes OR a
    memoryview (the zero-copy path slices VIEWS out of one contiguous
    file image — an mmap or a single read — instead of copying)."""

    def __init__(self, data) -> None:
        self.data = memoryview(data) if not isinstance(data, bytes) \
            else data
        self.pos = 0

    def take(self, n: int, what: str):
        if self.pos + n > len(self.data):
            if self.pos == 0 and not len(self.data):
                raise ColumnarError("empty columnar file (0 bytes)")
            raise ColumnarError(
                f"truncated columnar file: needed {n} bytes for {what} "
                f"at offset {self.pos}, only "
                f"{len(self.data) - self.pos} remain")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def trailing(self) -> bool:
        return self.pos != len(self.data)


class _FileCursor:
    """``_Cursor``'s contract over an open binary file: one block is
    resident at a time, never the whole file image."""

    def __init__(self, f) -> None:
        self.f = f
        self.pos = 0

    def take(self, n: int, what: str) -> bytes:
        out = self.f.read(n)
        if len(out) != n:
            if self.pos == 0 and not out:
                raise ColumnarError("empty columnar file (0 bytes)")
            raise ColumnarError(
                f"truncated columnar file: needed {n} bytes for {what} "
                f"at offset {self.pos}, only {len(out)} remain")
        self.pos += n
        return out

    def trailing(self) -> bool:
        return bool(self.f.read(1))


def _read_header(cur) -> Tuple[Tuple[str, str], ...]:
    magic = bytes(cur.take(4, "magic"))
    if magic != _MAGIC:
        raise ColumnarError(
            f"not a flink-tpu columnar file (magic {magic!r}, "
            f"expected {_MAGIC!r})")
    version, _flags, ncols = struct.unpack("<BBH", cur.take(4, "version"))
    if version != _VERSION:
        raise ColumnarError(f"unsupported columnar version {version}")
    (hlen,) = struct.unpack("<I", cur.take(4, "header length"))
    header = bytes(cur.take(hlen, "schema header"))
    (crc,) = struct.unpack("<I", cur.take(4, "header crc"))
    if _crc32(header) != crc:
        raise ColumnarError("schema header CRC mismatch (corrupt file)")
    try:
        fields = json.loads(header.decode("utf-8"))["fields"]
    except (ValueError, KeyError) as e:
        raise ColumnarError(f"malformed schema header: {e}") from e
    schema = _check_schema([(n, t) for n, t in fields])
    if len(schema) != ncols:
        raise ColumnarError(
            f"schema header lists {len(schema)} columns but the file "
            f"frame declares {ncols}")
    return schema


def _decode_block(schema, nrows: int, payload,
                  zero_copy: bool = False) -> Batch:
    """``zero_copy`` (little-endian hosts only): fixed-width columns
    come back as READ-ONLY ``np.frombuffer`` views into ``payload`` —
    no per-column copy; the view keeps the underlying file image (or
    mmap) alive through its ``.base`` chain. String columns always
    materialize object arrays (utf-8 decode is inherently a copy)."""
    zero_copy = zero_copy and _ZERO_COPY_HOST
    cur = _Cursor(payload)
    out: Batch = {}
    for name, typ in schema:
        if typ == "str":
            raw = cur.take(4 * (nrows + 1), f"column {name!r} offsets")
            offsets = np.frombuffer(raw, "<u4")
            blob = cur.take(int(offsets[-1]), f"column {name!r} bytes")
            if not isinstance(blob, bytes):
                blob = bytes(blob)
            out[name] = np.array(
                [blob[offsets[i]:offsets[i + 1]].decode("utf-8")
                 for i in range(nrows)], dtype=object)
        else:
            dt = _FIXED_DTYPES[typ]
            raw = cur.take(dt.itemsize * nrows, f"column {name!r}")
            if zero_copy:
                out[name] = np.frombuffer(raw, dt)
            else:
                out[name] = np.frombuffer(raw, dt).astype(
                    dt.newbyteorder("="), copy=True)
    if cur.pos != len(payload):
        raise ColumnarError(
            f"block payload has {len(payload) - cur.pos} trailing bytes "
            "(corrupt block)")
    return out


def _iter_cursor(cur, expect_schema, skip: int = 0,
                 zero_copy: bool = False) -> Iterator[Batch]:
    schema = _read_header(cur)
    if expect_schema is not None:
        want = _check_schema(expect_schema)
        if want != schema:
            raise ColumnarError(
                f"schema mismatch: file carries {schema}, reader "
                f"expects {want}")
    nblocks = 0
    nrows_total = 0
    while True:
        magic = bytes(cur.take(4, "block or footer magic"))
        if magic == _FOOTER_MAGIC:
            fblocks, frows = struct.unpack("<IQ", cur.take(12, "footer"))
            if fblocks != nblocks or frows != nrows_total:
                raise ColumnarError(
                    f"footer mismatch: footer says {fblocks} blocks/"
                    f"{frows} rows, file contains {nblocks}/"
                    f"{nrows_total} (truncated or corrupt)")
            if cur.trailing():
                raise ColumnarError("trailing bytes after footer")
            return
        if magic != _BLOCK_MAGIC:
            raise ColumnarError(
                f"expected block or footer magic at offset "
                f"{cur.pos - 4}, got {magic!r} (corrupt file)")
        nrows, plen = struct.unpack("<II", cur.take(8, "block frame"))
        payload = cur.take(plen, f"block {nblocks} payload")
        (crc,) = struct.unpack("<I", cur.take(4, f"block {nblocks} crc"))
        if _crc32(payload) != crc:
            raise ColumnarError(
                f"block {nblocks} CRC mismatch (corrupt file)")
        idx = nblocks
        nblocks += 1
        nrows_total += nrows
        if idx >= skip:
            # already-consumed blocks (checkpoint replay) skip the
            # expensive numpy/utf-8 materialization; the frame walk +
            # CRC still validate the file end to end
            yield _decode_block(schema, nrows, payload,
                                zero_copy=zero_copy)


def iter_blocks(data, expect_schema=None, skip: int = 0,
                zero_copy: bool = False) -> Iterator[Batch]:
    """Validated block-at-a-time read of a complete file image. The
    footer is checked after the last block — consuming the iterator to
    exhaustion proves the file was complete and uncorrupted. ``skip``
    elides decoding (not validation) of the first N blocks — the
    replay-position fast path. ``zero_copy`` returns fixed-width
    columns as read-only views into ``data`` (pass the image as a
    memoryview/mmap to avoid even the initial read copy); truncation,
    CRC, footer and schema failures are EXACTLY as loud either way —
    every block's checksum is verified before its views are handed
    out."""
    return _iter_cursor(_Cursor(data), expect_schema, skip,
                        zero_copy=zero_copy)


def iter_file_blocks(f, expect_schema=None,
                     skip: int = 0) -> Iterator[Batch]:
    """``iter_blocks`` over an open binary file, one block's bytes
    resident at a time (a shuffle partition may be far larger than the
    batches that built it)."""
    return _iter_cursor(_FileCursor(f), expect_schema, skip)


def read_schema(data: bytes) -> Tuple[Tuple[str, str], ...]:
    """Schema of a file image (header only — no block validation)."""
    return _read_header(_Cursor(data))


def map_file_image(path: str) -> memoryview:
    """Read-only memoryview over a SEALED local columnar file via
    mmap — the zero-copy read path's input: ``iter_blocks(view,
    zero_copy=True)`` then decodes straight out of the page cache
    (no read() image copy at all). The returned view keeps the mmap
    alive through every array sliced from it (numpy ``.base`` chain);
    the mapping closes when the last view is garbage-collected. Only
    for sealed files (segments are written complete + renamed —
    the mmap never observes a growing file)."""
    import mmap

    with open(path, "rb") as f:
        if os.fstat(f.fileno()).st_size == 0:
            # 0-byte files can't mmap; the empty-file error must be
            # the ordinary loud ColumnarError, not a ValueError
            return memoryview(b"")
        mm = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)
    return memoryview(mm)


@dataclasses.dataclass(frozen=True)
class ColumnarFormat(Format):
    """The columnar file as a connector ``Format``: ``serialize`` renders
    a batch as one complete single-block file, ``deserialize`` validates
    a complete file and concatenates its blocks, ``iter_batches`` yields
    them one at a time. Both directions refuse a schema mismatch."""

    schema: Tuple[Tuple[str, str], ...]
    binary = True  # a file source must not cut it on newlines

    def __init__(self, schema) -> None:
        object.__setattr__(self, "schema", _check_schema(schema))

    @property
    def fields(self) -> Tuple[str, ...]:
        return tuple(n for n, _ in self.schema)

    @classmethod
    def infer(cls, batch: Batch) -> "ColumnarFormat":
        return cls(infer_schema(batch))

    def serialize(self, batch: Batch) -> bytes:
        import io

        buf = io.BytesIO()
        w = ColumnarWriter(buf, self.schema)
        if self.fields and len(np.asarray(batch[self.fields[0]])):
            w.write_batch(batch)
        w.close()
        return buf.getvalue()

    def deserialize(self, data: bytes) -> Batch:
        parts = list(iter_blocks(data, expect_schema=self.schema))
        if not parts:
            return self.empty_batch()
        return {n: np.concatenate([p[n] for p in parts])
                for n, _ in self.schema}

    def iter_batches(self, data: bytes, skip: int = 0) -> Iterator[Batch]:
        """The file's blocks, the file source's replayable batches;
        ``skip`` validates but does not decode the first ``skip``."""
        return iter_blocks(data, expect_schema=self.schema, skip=skip)

    def empty_batch(self) -> Batch:
        """Zero rows in schema-typed columns."""
        return {n: (np.array([], dtype=object) if t == "str"
                    else np.array([], _FIXED_DTYPES[t]))
                for n, t in self.schema}
