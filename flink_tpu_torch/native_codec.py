"""The port's host codec: ``native/codec.cc`` built with ``g++`` at first
use and bound with ctypes.

It holds what the window operator's native lane runs on the host: the
C key table (``NativeHashTable``, the ``KeyDirectory`` probe), the host
pre-combine (``preagg_combine_native``) and the fused count-only ingest
scan (``ingest_fused_scan_native``) with its three finalizes; and the
text plane of the file formats and the socket source: the whitespace
tokenizer and string hashes (``tokenize_hash``, ``hash_strings``, bit for
bit ``records.hash_string_key``), the delimited-table parsers
(``parse_i64_table``, ``parse_f32_table``), the row encoder
(``encode_i64_rows``) and the line-framed TCP reader
(``NativeSocketReader``). ``_tokenize_hash_numpy`` is the tokenizer's
plain version, which tests hold the C one to. The library
is built from ``flink_tpu_torch/native/codec.cc`` alone into
``flink_tpu_torch/_build/`` under a name carrying a hash of the source
and the flags, so an edited source never loads a stale build. A build
or load that fails raises with the compiler's output: nothing here
turns into numpy in its place. Tests reach the numpy key table by
making ``NativeHashTable.create`` return None.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import List, Optional, Tuple

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(_HERE, "native", "codec.cc")
BUILD_DIR = os.path.join(_HERE, "_build")
CXX = "g++"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def library_path() -> str:
    digest = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    with open(SOURCE, "rb") as f:
        digest.update(f.read())
    return os.path.join(BUILD_DIR, f"libftcodec-{digest.hexdigest()[:12]}.so")


def build() -> str:
    """Compile the codec unless a current build exists; the path of the
    library. Raises RuntimeError with the compiler's output on failure."""
    out = library_path()
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [CXX, *CXX_FLAGS, SOURCE, "-o", tmp]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
    except OSError as e:
        raise RuntimeError(f"host codec build failed: {' '.join(cmd)}: {e}") from e
    if proc.returncode != 0:
        raise RuntimeError(f"host codec build failed: {' '.join(cmd)}\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return out


def load() -> ctypes.CDLL:
    """The loaded codec library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            _bind(lib)
            _lib = lib
        return _lib


def _bind(lib: ctypes.CDLL) -> None:
    i64 = ctypes.c_int64
    vp = ctypes.c_void_p
    i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
    sigs = {
        "ht_new": (vp, [i64]),
        "ht_free": (None, [vp]),
        "ht_count": (i64, [vp]),
        "ht_lookup": (None, [vp, i64p, i64, i64p, u8p]),
        "ht_insert": (None, [vp, i64p, i64p, i64]),
        "hash_keys": (None, [i64p, i64, i64p]),
        "preagg_combine": (i64, [i64, i64p, i64p, u8p, i64, i64, i64, f64p,
                                 i32p, f64p, i32p, i32p, f32p, i64]),
        "ingest_fused_scan": (i64, [i64, i64p, i64p, vp, i64, i64, i64, i64,
                                    i64, i32p, i32p, i64, i64, i64p, u8p,
                                    i64, i64, i64p, i64]),
        "ingest_fused_finalize_u32": (None, [i64, i32p, i32p, i32p, i64, i64]),
        "ingest_fused_finalize_u16": (None, [i64, i32p, i32p, i32p, i64]),
        "ingest_fused_finalize_pairs": (None, [i64, i32p, i32p, i32p]),
        "tokenize_hash": (i64, [ctypes.c_char_p, i64, i64p, i64, i64p,
                                i64p, i64]),
        "hash_strings": (None, [ctypes.c_char_p, i64p, i64, i64p]),
        "parse_i64_table": (i64, [ctypes.c_char_p, i64, ctypes.c_char,
                                  i64, i64p, i64]),
        "parse_f32_table": (i64, [ctypes.c_char_p, i64, ctypes.c_char,
                                  i64, f32p, i64]),
        "encode_i64_rows": (i64, [i64p, i64, i64, ctypes.c_char,
                                  ctypes.c_char_p, i64]),
        "sr_listen": (vp, [ctypes.c_int]),
        "sr_port": (ctypes.c_int, [vp]),
        "sr_accept": (ctypes.c_int, [vp, ctypes.c_int]),
        "sr_read_block": (i64, [vp, ctypes.c_char_p, i64, ctypes.c_int]),
        "sr_close": (None, [vp]),
    }
    for name, (res, args) in sigs.items():
        fn = getattr(lib, name)
        fn.restype = res
        fn.argtypes = args


def hash_keys_native(keys: np.ndarray) -> np.ndarray:
    """splitmix64 finalizer of a key batch in C (bit-equal to
    ``records.hash_keys_numpy``)."""
    keys = np.ascontiguousarray(keys, np.int64)
    out = np.empty(len(keys), np.int64)
    load().hash_keys(keys, len(keys), out)
    return out


class NativeHashTable:
    """int64 → int64 open-addressing table in C: the ``KeyDirectory``
    probe loop, with ``state.keyed._NumpyHashTable``'s interface."""

    def __init__(self, lib: ctypes.CDLL, capacity_hint: int) -> None:
        self._lib = lib
        self._h = lib.ht_new(capacity_hint)

    @classmethod
    def create(cls, capacity_hint: int = 1024) -> Optional["NativeHashTable"]:
        """A new table (the codec is built on first use; a failed build
        raises). Tests make this return None to run the numpy table."""
        return cls(load(), capacity_hint)

    def __del__(self):
        h, self._h = getattr(self, "_h", None), None
        if h:
            self._lib.ht_free(h)

    @property
    def _count(self) -> int:
        return int(self._lib.ht_count(self._h))

    def lookup_keys(self, keys: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """(values, found); hashes computed inline in C."""
        keys = np.ascontiguousarray(keys, np.int64)
        vals = np.empty(len(keys), np.int64)
        found = np.empty(len(keys), np.uint8)
        self._lib.ht_lookup(self._h, keys, len(keys), vals, found)
        return vals, found.astype(bool)

    def insert_batch(self, keys: np.ndarray, key_hashes, vals: np.ndarray) -> None:
        """Insert or update; ``key_hashes`` is accepted for the numpy
        table's interface (C hashes inline)."""
        keys = np.ascontiguousarray(keys, np.int64)
        vals = np.ascontiguousarray(vals, np.int64)
        self._lib.ht_insert(self._h, keys, vals, len(keys))


class PreaggWorkspace:
    """Zeroed per-pair workspaces of the C combine and scan, kept across
    batches: the C side resets only the entries it touched."""

    def __init__(self, domain: int, nlanes: int) -> None:
        self.domain = domain
        self.nlanes = nlanes
        self.hist = np.zeros(domain, np.int32)
        self.lane_acc = np.zeros(max(domain * nlanes, 1), np.float64)

    def rezero(self) -> None:
        self.hist[:] = 0
        self.lane_acc[:] = 0.0


def preagg_combine_native(
    slots: np.ndarray, panes: np.ndarray, valid: np.ndarray,
    lane_data: List[np.ndarray], ring: int, ws: PreaggWorkspace, cap: int,
) -> Optional[Tuple[np.ndarray, np.ndarray, List[np.ndarray]]]:
    """The host combine per (slot, ring column) pair in C: (pairs in
    first-seen order, counts, per sum lane the pair's f64-accumulated
    sum rounded to f32), or None when more than ``cap`` pairs occur (the
    workspace is re-zeroed; the caller combines in numpy)."""
    n = len(slots)
    nl = ws.nlanes
    out_pairs = np.empty(cap, np.int32)
    out_counts = np.empty(cap, np.int32)
    out_lanes = np.empty((cap, nl) if nl else (1, 1), np.float32)
    if nl:
        lanes = np.ascontiguousarray(
            np.stack([np.asarray(a, np.float64) for a in lane_data]))
    else:
        lanes = np.zeros(1, np.float64)
    npairs = load().preagg_combine(
        n, np.ascontiguousarray(slots, np.int64),
        np.ascontiguousarray(panes, np.int64),
        np.ascontiguousarray(valid, bool).view(np.uint8), ring, ws.domain,
        nl, lanes.reshape(-1), ws.hist, ws.lane_acc, out_pairs, out_counts,
        out_lanes.reshape(-1), cap)
    if npairs < 0:
        ws.rezero()
        return None
    return (out_pairs[:npairs], out_counts[:npairs],
            [out_lanes[:npairs, i].copy() for i in range(nl)])


class IngestFusedResult:
    """One fused ingest scan's running pair list and stats; the finalize
    is deferred so a second scan over the missed records can continue
    them. ``stats``: [n_valid, n_late, n_bad, pane_min, pane_max,
    n_refire, n_miss, count_max]."""

    __slots__ = ("npairs", "out_pairs", "stats", "bitmap")

    def __init__(self, npairs, out_pairs, stats, bitmap):
        self.npairs = npairs
        self.out_pairs = out_pairs
        self.stats = stats
        self.bitmap = bitmap


def ingest_fused_scan_native(
    keys: np.ndarray, ts: np.ndarray, table: NativeHashTable,
    pane_ms: int, offset_ms: int, ring: int, ws: PreaggWorkspace,
    cap: int, dead_below: int, refire_below: int, bitmap_bits: int,
    *, cont: Optional[IngestFusedResult] = None, miss_cap: int = 0,
) -> Optional[Tuple[IngestFusedResult, np.ndarray]]:
    """One fused probe + ingest scan (``ingest_fused_scan``): (result,
    indices of the records whose key the table lacks), or None when the
    pairs outgrow ``cap`` or the misses ``miss_cap`` (the workspace is
    re-zeroed; the caller declines the lane). ``cont`` continues an
    earlier scan's pairs and stats (the pass over the missed records
    once their keys are registered)."""
    n = len(ts)
    if cont is None:
        out_pairs = np.empty(cap, np.int32)
        stats = np.zeros(8, np.int64)
        stats[3] = np.iinfo(np.int64).max   # pane_min seed
        stats[4] = np.iinfo(np.int64).min   # pane_max seed
        bitmap = np.zeros(max((bitmap_bits + 7) // 8, 1), np.uint8)
        np_in = 0
    else:
        out_pairs, stats, bitmap = cont.out_pairs, cont.stats, cont.bitmap
        np_in = cont.npairs
    miss_cap = max(miss_cap, 1)
    out_miss = np.empty(miss_cap, np.int64)
    stats[6] = 0  # the miss list restarts each scan
    npairs = load().ingest_fused_scan(
        n, np.ascontiguousarray(keys, np.int64),
        np.ascontiguousarray(ts, np.int64), table._h,
        pane_ms, offset_ms, ring, dead_below, refire_below,
        ws.hist, out_pairs, np_in, cap, stats, bitmap,
        dead_below, len(bitmap), out_miss, miss_cap)
    if npairs < 0:
        ws.rezero()
        return None
    return (IngestFusedResult(int(npairs), out_pairs, stats, bitmap),
            out_miss[:int(stats[6])])


def ingest_fused_finalize_u32_native(
    res: IngestFusedResult, ws: PreaggWorkspace, hdr: int, cap_out: int,
    out: Optional[np.ndarray] = None) -> np.ndarray:
    """The u32 upload buffer written by C: ``hdr`` words of -1 (the fused
    step's header, filled at the advance), then ``pair << 12 | count``
    per pair and -1 padding up to ``hdr + cap_out`` words; the workspace
    is reset. ``out`` (int32, at least that long) is written in place —
    a view of a reused pinned buffer — else a new array is made. Every
    count must be below 0xFFF (stats[7])."""
    need = hdr + cap_out
    if out is None:
        out = np.empty(need, np.int32)
    elif out.dtype != np.int32 or not out.flags.c_contiguous or len(out) < need:
        raise ValueError(f"finalize buffer must be contiguous int32 of at "
                         f"least {need} words")
    load().ingest_fused_finalize_u32(
        res.npairs, ws.hist, res.out_pairs, out, hdr, cap_out)
    return out[:need]


def ingest_fused_finalize_u16_native(
    res: IngestFusedResult, ws: PreaggWorkspace, hdr: int,
    out: Optional[np.ndarray] = None) -> np.ndarray:
    """The fused step's triple form written by C: ``hdr`` words of -1
    (the header, filled at the advance), then ``[pair lo16, pair hi16,
    count]`` uint16 per pair, the real pairs only, as int32 words (the
    last one half 0xFFFF when the pair count is odd); the workspace is
    reset. ``out`` (int32, long enough) is written in place — a view of
    a reused pinned buffer — else a new array is made. Every count must
    be at most 0xFFFF (stats[7])."""
    need = hdr + (6 * res.npairs + 3) // 4
    if out is None:
        out = np.empty(need, np.int32)
    elif out.dtype != np.int32 or not out.flags.c_contiguous or len(out) < need:
        raise ValueError(f"finalize buffer must be contiguous int32 of at "
                         f"least {need} words")
    load().ingest_fused_finalize_u16(
        res.npairs, ws.hist, res.out_pairs, out, hdr)
    return out[:need]


def ingest_fused_finalize_pairs_native(
    res: IngestFusedResult, ws: PreaggWorkspace,
) -> Tuple[np.ndarray, np.ndarray]:
    """(pairs, counts) of a fused scan, resetting the workspace: the form
    for counts too large for the triples' 16-bit field."""
    counts = np.empty(max(res.npairs, 1), np.int32)
    load().ingest_fused_finalize_pairs(
        res.npairs, ws.hist, res.out_pairs, counts)
    return res.out_pairs[:res.npairs], counts[:res.npairs]


# -- the text plane ----------------------------------------------------------

def tokenize_hash(lines: List[str]) -> Tuple[np.ndarray, np.ndarray]:
    """The whitespace-separated tokens of ``lines`` as (63-bit FNV-1a
    hashes, line index of each): WordCount's tokenize and dictionary
    encode in one C pass."""
    enc = [s.encode("utf-8") for s in lines]
    offs = np.zeros(len(enc) + 1, np.int64)
    np.cumsum([len(b) + 1 for b in enc], out=offs[1:])
    buf = b"\n".join(enc) + b"\n"
    cap = max(len(buf), 16)
    ids = np.empty(cap, np.int64)
    line_ix = np.empty(cap, np.int64)
    n = load().tokenize_hash(buf, len(buf), offs, len(enc), ids, line_ix, cap)
    if n < 0:
        raise RuntimeError("tokenize_hash overflowed its output")
    return ids[:n].copy(), line_ix[:n].copy()


def _tokenize_hash_numpy(lines: List[str]) -> Tuple[np.ndarray, np.ndarray]:
    """``tokenize_hash``'s plain version."""
    from flink_tpu_torch.records import hash_string_key

    ids, lix = [], []
    for i, line in enumerate(lines):
        for w in line.split():
            ids.append(hash_string_key(w))
            lix.append(i)
    return np.asarray(ids, np.int64), np.asarray(lix, np.int64)


def hash_strings(strings: List[str]) -> np.ndarray:
    """A string column as stable 63-bit ids (``records.hash_string_key``
    of each)."""
    enc = [s.encode("utf-8") for s in strings]
    offs = np.zeros(len(enc) + 1, np.int64)
    np.cumsum([len(b) for b in enc], out=offs[1:])
    out = np.empty(len(enc), np.int64)
    load().hash_strings(b"".join(enc), offs, len(enc), out)
    return out


def _row_cap(data: bytes, max_rows: Optional[int]) -> int:
    return max_rows if max_rows is not None else data.count(b"\n") + 1


def parse_i64_table(data: bytes, n_cols: int, delim: str = ",",
                    max_rows: Optional[int] = None) -> np.ndarray:
    """Delimited text as a (rows, n_cols) int64 table; an unparseable or
    missing cell reads 0."""
    cap = _row_cap(data, max_rows)
    out = np.zeros((cap, n_cols), np.int64)
    n = load().parse_i64_table(data, len(data), delim.encode(), n_cols,
                               out.reshape(-1), cap)
    return out[:n]


def parse_f32_table(data: bytes, n_cols: int, delim: str = ",",
                    max_rows: Optional[int] = None) -> np.ndarray:
    """Delimited text as a (rows, n_cols) float32 table."""
    cap = _row_cap(data, max_rows)
    out = np.zeros((cap, n_cols), np.float32)
    n = load().parse_f32_table(data, len(data), delim.encode(), n_cols,
                               out.reshape(-1), cap)
    return out[:n]


def encode_i64_rows(vals: np.ndarray, delim: str = ",") -> bytes:
    """A (rows, cols) int64 table as delimited text, one line a row."""
    vals = np.ascontiguousarray(vals, np.int64)
    cap = vals.size * 22 + vals.shape[0] + 16
    buf = ctypes.create_string_buffer(cap)
    n = load().encode_i64_rows(vals.reshape(-1), vals.shape[0],
                               vals.shape[1] if vals.ndim > 1 else 1,
                               delim.encode(), buf, cap)
    if n < 0:
        raise RuntimeError("encode_i64_rows overflowed its buffer")
    return buf.raw[:n]


class NativeSocketReader:
    """The socket source's line-framed TCP reader in C: one loopback
    listener, one connection; ``read_block`` returns blocks that end at
    a newline, ready for the table parsers. ``create`` raises when the
    listener cannot bind."""

    def __init__(self, lib: ctypes.CDLL, handle) -> None:
        self._lib = lib
        self._h = handle
        self._buf = None

    @classmethod
    def create(cls, port: int = 0) -> "NativeSocketReader":
        lib = load()
        h = lib.sr_listen(port)
        if not h:
            raise OSError(f"socket reader could not listen on port {port}")
        return cls(lib, h)

    @property
    def port(self) -> int:
        return int(self._lib.sr_port(self._h))

    def accept(self, timeout_ms: int = 100) -> int:
        """1 = connected, 0 = timeout, -1 = error."""
        return int(self._lib.sr_accept(self._h, timeout_ms))

    def read_block(self, cap: int = 1 << 20,
                   timeout_ms: int = 100) -> Optional[bytes]:
        """A block of complete lines, b"" on a timeout, None once the
        peer closed. Raises on a transport error or a line longer than
        ``cap``. The scratch buffer is kept across calls, so idle polls
        allocate nothing."""
        if self._buf is None or len(self._buf) < cap:
            self._buf = ctypes.create_string_buffer(cap)
        n = int(self._lib.sr_read_block(self._h, self._buf, cap, timeout_ms))
        if n > 0:
            return self._buf.raw[:n]
        if n == 0:
            return b""
        if n == -1:
            return None
        raise IOError("socket reader error (closed early or a line "
                      f"exceeded {cap} bytes)")

    def close(self) -> None:
        h, self._h = self._h, None
        if h:
            self._lib.sr_close(h)

    def __del__(self):
        self.close()
