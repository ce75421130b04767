"""Binary frame codec of the cross-process exchange (wire version 1).

The byte format is the JAX package's (``flink_tpu/exchange/frames.py``),
so a frame one package encodes decodes in the other and a fleet may mix
them. A frame is a fixed header plus raw CRC'd array sections, built for
the exchange's payload (numeric record columns plus a few watermark and
consensus scalars):

    [HEADER 46B]
      magic      4s   b"DCNB"
      version    u16  1
      sender     u16  process id
      flags      u16  presence/value bits (done/ckpt/payload/...)
      step       u64  per-connection frame sequence (desync tripwire)
      wm         i64  sender's source watermark  (meta["wm"])
      persisted  i64  newest durable checkpoint  (meta["persisted"])
      n_arrays   u32
      body_len   u64  bytes that follow the header
    [extras_len u32][extras JSON]      — meta keys other than the four
                                         above; zero bytes on the hot
                                         path
    [array descriptors]                — path (length-prefixed segments,
                                         so any column name round-trips),
                                         dtype, shape, nbytes, crc32
    [array sections]                   — raw C-order bytes, 64-aligned
                                         offsets within the body

Encode returns a list of buffers (the header and descriptors, then each
array's own memoryview) so the socket layer ships payload bytes with
``sendmsg`` and no concatenation copy. Decode builds ``np.frombuffer``
views into the one received body buffer.

Safety: the format has no pickle escape. Object-dtype arrays encode as
tagged utf-8 string sections when every element is text, and are
refused at encode otherwise. Every array section carries a crc32
(``zlib.crc32``, which releases the GIL on large buffers, so the
exchange's I/O threads checksum in parallel); a flipped byte fails the
decode with ``FrameError``. Truncation anywhere is loud.
"""
from __future__ import annotations

import json
import struct
from typing import Any, Dict, List, Tuple
from zlib import crc32 as _crc32

import numpy as np

from flink_tpu_torch import faults

MAGIC = b"DCNB"
VERSION = 1

#: >4s H H H Q q q I Q  — see module docstring
HEADER = struct.Struct(">4sHHHQqqIQ")
HEADER_LEN = HEADER.size  # 46

# flags bits: low bits are VALUES, high bits are PRESENCE (so a meta
# dict round-trips with exactly the keys the sender set)
_F_DONE = 1 << 0
_F_CKPT = 1 << 1
_F_PAYLOAD = 1 << 2        # payload is not None
_F_BARE_ARRAY = 1 << 3     # payload is a single bare ndarray
_F_HAS_WM = 1 << 4
_F_HAS_PERSISTED = 1 << 5
_F_HAS_DONE = 1 << 6
_F_HAS_CKPT = 1 << 7

_ALIGN = 64

# descriptor: name_len u16, dtype_len u8, kind u8, ndim u8, nbytes u64,
# crc u32 — then name bytes, dtype bytes, shape dims (u32 each)
_DESC = struct.Struct(">HBBBQI")
_KIND_RAW = 0   # native numpy dtype, raw bytes
_KIND_STR = 1   # all-string object array: u32 offsets + utf-8 blob

# tripwires against hostile / corrupt headers driving huge allocations
MAX_BODY_BYTES = 1 << 38
MAX_ARRAYS = 1 << 20


class FrameError(ValueError):
    """A DCN frame failed to encode or decode: always loud, never a
    silent partial decode."""


# -- encode -----------------------------------------------------------------

def _flatten(payload: Any) -> Tuple[int,
                                    List[Tuple[Tuple[str, ...],
                                               np.ndarray]]]:
    """Payload → (flags bits, [(path segments, array), ...]).
    Supported shapes: None, a bare ndarray, or a (nested) dict of
    str → ndarray. Paths stay SEGMENTED (each segment length-prefixed
    on the wire) so no character is reserved — a column literally
    named "a/b" round-trips, like it did on the legacy wire."""
    if payload is None:
        return 0, []
    if isinstance(payload, np.ndarray) or not isinstance(payload, dict):
        return (_F_PAYLOAD | _F_BARE_ARRAY,
                [((), np.asarray(payload))])
    out: List[Tuple[Tuple[str, ...], np.ndarray]] = []

    def walk(prefix: Tuple[str, ...], d: Dict[str, Any]) -> None:
        for k, v in d.items():
            if not isinstance(k, str):
                raise FrameError(
                    f"frame payload keys must be str, got {type(k).__name__}")
            path = prefix + (k,)
            if isinstance(v, dict):
                walk(path, v)
            else:
                out.append((path, np.asarray(v)))

    walk((), payload)
    return _F_PAYLOAD, out


def _pack_path(path: Tuple[str, ...]) -> bytes:
    """Path segments → one length-prefixed byte string (the
    descriptor's name field): [n_segments u8][len u16 + utf8]*"""
    if len(path) > 255:
        raise FrameError(f"payload nesting depth {len(path)} > 255")
    out = bytearray([len(path)])
    for seg in path:
        b = seg.encode("utf-8")
        if len(b) > 0xFFFF:
            raise FrameError(f"payload key longer than 64KiB: {seg[:40]!r}…")
        out += struct.pack(">H", len(b))
        out += b
    return bytes(out)


def _unpack_path(raw: memoryview) -> Tuple[str, ...]:
    n = raw[0]
    segs = []
    pos = 1
    for _ in range(n):
        if len(raw) < pos + 2:
            raise FrameError("truncated DCN frame (mid-path)")
        (ln,) = struct.unpack_from(">H", raw, pos)
        pos += 2
        if len(raw) < pos + ln:
            raise FrameError("truncated DCN frame (mid-path)")
        segs.append(bytes(raw[pos:pos + ln]).decode("utf-8"))
        pos += ln
    return tuple(segs)


def _encode_array(arr: np.ndarray,
                  path: Tuple[str, ...] = ()) -> Tuple[int, str, bytes]:
    """→ (kind, dtype string, raw section bytes). Object arrays must be
    all-string (text columns); anything else is rejected — this format
    has no pickle escape to fall back to, by design. bytes elements
    must be valid UTF-8 and round-trip as decoded text; non-UTF8 bytes
    fail here, at encode on the sender — an attributable error, never a
    poison-pill UnicodeDecodeError in the peer's receive loop that every
    recovery attempt re-triggers."""
    if arr.dtype.hasobject:
        flat = arr.ravel()
        if not all(isinstance(x, (str, bytes, np.str_, np.bytes_))
                   for x in flat):
            raise FrameError(
                "object-dtype array with non-string elements cannot "
                "cross the DCN exchange (no pickle escape exists in the "
                "binary frame format — encode it as numeric columns)")
        blobs = []
        for x in flat:
            if isinstance(x, str):
                blobs.append(x.encode("utf-8"))
                continue
            b = bytes(x)
            try:
                b.decode("utf-8")
            except UnicodeDecodeError as e:
                raise FrameError(
                    f"text column {'/'.join(path)!r} carries non-UTF8 "
                    f"bytes ({b[:24]!r}): string sections are utf-8 "
                    "text (bytes decode as text, the columnar-format "
                    "rule) — encode raw binary as a numeric column"
                ) from e
            blobs.append(b)
        offsets = np.zeros(len(blobs) + 1, dtype=">u4")
        np.cumsum([len(b) for b in blobs], out=offsets[1:])
        return _KIND_STR, "str", offsets.tobytes() + b"".join(blobs)
    a = np.ascontiguousarray(arr)
    # cast('B') gives a BYTE view (len == nbytes) sendmsg/crc32 accept
    # without copying the section
    return _KIND_RAW, str(a.dtype), (a.data.cast("B") if a.nbytes
                                     else b"")


def encode(sender: int, step: int, meta: Dict[str, Any],
           payload: Any) -> List[Any]:
    """One frame → a list of send buffers (header/descriptor blob
    first, then the raw array sections with their alignment pads).
    ``sum(len(b) for b in buffers)`` is the full wire size."""
    faults.fire("dcn.frame.encode", exc=ValueError, step=step)
    flags, arrays = _flatten(payload)
    wm = meta.get("wm")
    persisted = meta.get("persisted")
    if wm is not None:
        flags |= _F_HAS_WM
    if persisted is not None:
        flags |= _F_HAS_PERSISTED
    if "done" in meta:
        flags |= _F_HAS_DONE | (_F_DONE if meta["done"] else 0)
    if "ckpt" in meta:
        flags |= _F_HAS_CKPT | (_F_CKPT if meta["ckpt"] else 0)
    extras = {k: v for k, v in meta.items()
              if k not in ("wm", "persisted", "done", "ckpt")}
    extras_blob = json.dumps(extras).encode() if extras else b""

    descs = bytearray()
    sections: List[Tuple[Any, int]] = []  # (buffer, nbytes)
    for path, arr in arrays:
        kind, dtype_s, raw = _encode_array(arr, path)
        nb = len(raw)
        crc = _crc32(raw)
        nbuf = _pack_path(path)
        dbuf = dtype_s.encode("ascii")
        descs += _DESC.pack(len(nbuf), len(dbuf), kind, arr.ndim, nb, crc)
        descs += nbuf
        descs += dbuf
        descs += struct.pack(f">{arr.ndim}I", *arr.shape)
        sections.append((raw, nb))

    head_var = 4 + len(extras_blob) + len(descs)
    buffers: List[Any] = []
    pos = head_var
    for raw, nb in sections:
        aligned = (pos + _ALIGN - 1) // _ALIGN * _ALIGN
        if aligned != pos:
            buffers.append(b"\0" * (aligned - pos))
        buffers.append(raw)
        pos = aligned + nb
    header = HEADER.pack(MAGIC, VERSION, sender, flags, step,
                         -(2 ** 63) if wm is None else int(wm),
                         -1 if persisted is None else int(persisted),
                         len(arrays), pos)
    buffers.insert(0, b"".join((
        header, struct.pack(">I", len(extras_blob)), extras_blob,
        bytes(descs))))
    return buffers


def encode_bytes(sender: int, step: int, meta: Dict[str, Any],
                 payload: Any) -> bytes:
    """Whole-frame bytes (tests / non-socket callers)."""
    return b"".join(bytes(b) for b in encode(sender, step, meta, payload))


# -- decode -----------------------------------------------------------------

def decode_header(raw: bytes) -> Tuple[int, int, int, int, int, int, int]:
    """Fixed header → (sender, flags, step, wm, persisted, n_arrays,
    body_len). Loud on short input, bad magic, or a foreign version —
    the mixed-version-fleet tripwire for anything that got past the
    hello."""
    if len(raw) < HEADER_LEN:
        raise FrameError(
            f"truncated DCN frame header ({len(raw)} of {HEADER_LEN} "
            "bytes)")
    magic, ver, sender, flags, step, wm, persisted, n_arrays, body_len = (
        HEADER.unpack_from(raw))
    if magic != MAGIC:
        raise FrameError(
            f"not a DCN binary frame (magic {magic!r}; a peer speaking "
            "the legacy blobformat wire, or garbage on the port)")
    if ver != VERSION:
        raise FrameError(
            f"DCN frame version {ver} != {VERSION} — mixed-version "
            "fleet; upgrade every process together")
    if body_len > MAX_BODY_BYTES or n_arrays > MAX_ARRAYS:
        raise FrameError(
            f"DCN frame header claims body_len={body_len} "
            f"n_arrays={n_arrays} — corrupt or hostile header")
    return sender, flags, step, wm, persisted, n_arrays, body_len


def _unflatten(items: List[Tuple[Tuple[str, ...], np.ndarray]],
               flags: int) -> Any:
    if not flags & _F_PAYLOAD:
        return None
    if flags & _F_BARE_ARRAY:
        return items[0][1]
    out: Dict[str, Any] = {}
    for path, arr in items:
        d = out
        for p in path[:-1]:
            d = d.setdefault(p, {})
        d[path[-1]] = arr
    return out


def decode_body(flags: int, wm: int, persisted: int, n_arrays: int,
                body: memoryview) -> Tuple[Dict[str, Any], Any]:
    """(meta, payload) from the body buffer; array leaves are ZERO-COPY
    ``np.frombuffer`` views into ``body`` (callers must not recycle the
    buffer while the payload is live — the exchange hands each frame
    its own buffer). Every section's crc32 is verified."""
    body = memoryview(body)
    if len(body) < 4:
        raise FrameError("truncated DCN frame body (no extras length)")
    (extras_len,) = struct.unpack_from(">I", body)
    pos = 4 + extras_len
    if len(body) < pos:
        raise FrameError("truncated DCN frame body (mid-extras)")
    meta: Dict[str, Any] = {}
    if extras_len:
        meta.update(json.loads(bytes(body[4:pos]).decode()))
    if flags & _F_HAS_WM:
        meta["wm"] = wm
    if flags & _F_HAS_PERSISTED:
        meta["persisted"] = persisted
    if flags & _F_HAS_DONE:
        meta["done"] = bool(flags & _F_DONE)
    if flags & _F_HAS_CKPT:
        meta["ckpt"] = bool(flags & _F_CKPT)

    descs = []
    for _ in range(n_arrays):
        if len(body) < pos + _DESC.size:
            raise FrameError("truncated DCN frame (mid-descriptor)")
        name_len, dtype_len, kind, ndim, nbytes, crc = _DESC.unpack_from(
            body, pos)
        pos += _DESC.size
        end = pos + name_len + dtype_len + 4 * ndim
        if len(body) < end:
            raise FrameError("truncated DCN frame (mid-descriptor)")
        if name_len < 1:
            raise FrameError("truncated DCN frame (empty path field)")
        path = _unpack_path(body[pos:pos + name_len])
        dtype_s = bytes(
            body[pos + name_len:pos + name_len + dtype_len]).decode()
        shape = struct.unpack_from(f">{ndim}I", body,
                                   pos + name_len + dtype_len)
        descs.append((path, dtype_s, kind, shape, nbytes, crc))
        pos = end

    items: List[Tuple[Tuple[str, ...], np.ndarray]] = []
    for path, dtype_s, kind, shape, nbytes, crc in descs:
        pos = (pos + _ALIGN - 1) // _ALIGN * _ALIGN
        if len(body) < pos + nbytes:
            raise FrameError(
                f"truncated DCN frame (array {path!r}: {len(body) - pos}"
                f" of {nbytes} bytes)")
        section = body[pos:pos + nbytes]
        if _crc32(section) != crc:
            raise FrameError(
                f"CRC mismatch on DCN frame array {path!r} — corrupt "
                "bytes on the wire")
        items.append((path, _decode_array(dtype_s, kind, shape, section)))
        pos += nbytes
    return meta, _unflatten(items, flags)


def _decode_array(dtype_s: str, kind: int, shape: Tuple[int, ...],
                  section: memoryview) -> np.ndarray:
    if kind == _KIND_STR:
        n = int(np.prod(shape, dtype=np.int64)) if shape else 1
        offs = np.frombuffer(section, dtype=">u4", count=n + 1)
        blob = section[4 * (n + 1):]
        out = np.empty(n, dtype=object)
        for i in range(n):
            out[i] = bytes(blob[offs[i]:offs[i + 1]]).decode("utf-8")
        return out.reshape(shape)
    if kind != _KIND_RAW:
        raise FrameError(f"unknown DCN frame array kind {kind}")
    try:
        dt = np.dtype(dtype_s)
    except TypeError as e:
        raise FrameError(f"bad dtype {dtype_s!r} in DCN frame: {e}") from e
    count = int(np.prod(shape, dtype=np.int64)) if shape else 1
    if dt.itemsize * count != len(section):
        raise FrameError(
            f"DCN frame array section is {len(section)} bytes but "
            f"dtype {dtype_s} x shape {shape} needs "
            f"{dt.itemsize * count}")
    return np.frombuffer(section, dtype=dt, count=count).reshape(shape)


def decode(raw: bytes) -> Tuple[int, int, Dict[str, Any], Any]:
    """Whole-frame bytes → (sender, step, meta, payload). The socket
    path splits this into ``decode_header`` (fixed read) +
    ``decode_body`` (one body read); this form serves tests and
    non-socket callers."""
    sender, flags, step, wm, persisted, n_arrays, body_len = (
        decode_header(raw))
    body = memoryview(raw)[HEADER_LEN:]
    if len(body) < body_len:
        raise FrameError(
            f"truncated DCN frame ({len(body)} of {body_len} body bytes)")
    meta, payload = decode_body(flags, wm, persisted, n_arrays,
                                body[:body_len])
    return sender, step, meta, payload
