"""The window operator's count-lane device functions and the split
upload's decode: a CUDA kernel each (``csrc/window_kernels.cu``) and a
plain PyTorch version each, with the same signature (``ring_columns``
also moves the f32 sum/max/min lanes, and ``ring_columns_block`` every
lane of a state block in one launch).

A wrapper takes the plain version only when its tensors lie on the CPU;
for CUDA tensors it launches the kernel or raises. ``LAUNCHES`` counts
kernel launches per wrapper (one per wrapper call that reached the
card), so a run can show that its main path went through the kernels.

``scatter_counts`` and ``ring_columns`` index with host-built entries.
An entry outside the tensor makes the plain version raise at once; the
kernel skips it and sets a bit in the device's error word, which
``check_errors`` (or a caller's own copy of ``error_word``, decoded by
``raise_for_error_bits``) turns into the same kind of exception.

All of them are integer work or pure copies, so every result is exact:
the kernel, the plain version and the JAX reference agree bit for bit.

The launch counts, the error word, the library loader and the argument
checks here serve every kernel module of the port
(``devgen_kernels.py``, ``lane_kernels.py``, ``fused_kernels.py``,
``count_window_kernels.py``, ``topn_lanes_kernels.py``,
``element_kernels.py`` and ``exchange_kernels.py`` too).
"""
from __future__ import annotations

import ctypes
import math
import struct
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from flink_tpu_torch.kernels import build

LAUNCHES: Dict[str, int] = {
    "scatter_counts": 0,
    "window_counts": 0,
    "topn_select_append": 0,
    "ring_columns": 0,
    "nexmark_bids": 0,
    "devgen_ingest": 0,
    "fire_pack": 0,
    "scatter_lanes": 0,
    "scatter_pair_lanes": 0,
    "apply_pairs_u32": 0,
    "apply_pairs_u16": 0,
    "fused_step": 0,
    "split_cells": 0,
    "scatter_split_counts": 0,
    "count_fire": 0,
    "window_lanes": 0,
    "topn_select_lanes": 0,
    "segment_lanes": 0,
    "topn_candidates": 0,
    "topn_global_threshold": 0,
    "topn_select_given": 0,
    "topn_candidates_lanes": 0,
    "topn_select_lanes_given": 0,
    "bucket_records": 0,
    "hash_keys": 0,
}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# bits of the device error word (kErr* in csrc/*.cu)
ERROR_BITS = {1: "scatter_counts: cell index outside counts",
              2: "ring_columns: kept src_col outside the source ring",
              4: "devgen_ingest: cell index outside counts",
              8: "scatter_lanes: cell index outside the pane state",
              16: "scatter_pair_lanes: pair index outside the pane state",
              32: "fire_pack: more selected rows than the buffer holds",
              64: "split_cells: slot or ring column outside the state",
              128: "count_fire: more fired rows than the buffer holds",
              256: "segment_lanes: offsets outside the lifted lanes"}
_error_words: Dict[torch.device, torch.Tensor] = {}


def error_word(device: torch.device) -> torch.Tensor:
    """The (1,) int32 word on ``device`` that the kernels OR their error
    bits into; it stays set until ``check_errors`` reads it."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    word = _error_words.get(device)
    if word is None:
        word = _error_words[device] = torch.zeros(1, dtype=torch.int32,
                                                  device=device)
    return word


def raise_for_error_bits(bits: int) -> None:
    if bits:
        raise IndexError("window kernel got out-of-range entries: " + "; ".join(
            msg for bit, msg in ERROR_BITS.items() if bits & bit))


def check_errors(device: torch.device) -> None:
    """Wait for ``device``'s stream, then raise if a kernel reported an
    out-of-range entry since the last check (and clear the word)."""
    word = error_word(device)
    bits = int(word.item())
    word.zero_()
    raise_for_error_bits(bits)


_SIGNATURES = {
    "fk_ring_columns": [ctypes.c_char_p, ctypes.c_void_p],
    "fk_error_string": [ctypes.c_int],
}
_libs: Dict[str, ctypes.CDLL] = {}
# words of a lane one ring_columns launch addresses (its offsets are
# 32-bit): a larger state goes through in blocks of rows
RING_BLOCK_WORDS = 2 ** 31


def load_library(name: str, signatures: Dict[str, list],
                 error_string: str) -> ctypes.CDLL:
    """``csrc/<name>.cu`` built and loaded (once), with every entry
    point's argument types declared. Each entry point returns an int
    CUDA error code; ``error_string`` names the one that decodes it."""
    lib = _libs.get(name)
    if lib is None:
        lib = build.load(name)
        for fn, args in signatures.items():
            getattr(lib, fn).argtypes = args
            getattr(lib, fn).restype = ctypes.c_int
        getattr(lib, error_string).restype = ctypes.c_char_p
        _libs[name] = lib
    return lib


def _lib() -> ctypes.CDLL:
    return load_library("window_kernels", _SIGNATURES, "fk_error_string")


def on_cuda(name: str, *tensors: Optional[torch.Tensor]) -> bool:
    """True for CUDA tensors (launch the kernel), False for CPU tensors
    (plain version); raises on a mix or any other device."""
    devs = {t.device for t in tensors if t is not None}
    if len(devs) != 1:
        raise ValueError(f"{name}: tensors on different devices: {devs}")
    dev = devs.pop()
    if dev.type == "cpu":
        return False
    if dev.type != "cuda":
        raise ValueError(f"{name}: unsupported device {dev}")
    return True


def check_tensor(t: torch.Tensor, what: str, dtype: torch.dtype, ndim: int) -> None:
    if t.dtype != dtype:
        raise TypeError(f"{what}: expected {dtype}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{what}: expected {ndim}-d, got shape {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{what}: must be contiguous")


# the current stream's handle of a CUDA device index, by one C call where
# this PyTorch has it
_raw_stream = getattr(torch._C, "_cuda_getCurrentRawStream", None)
_error_ptrs: Dict[int, int] = {}


def launch_context(index: int) -> Tuple[int, int]:
    """The lean launch path's ``(error word address, stream handle)`` on
    CUDA device ``index``. The address is cached once a device; the
    stream is read at every call, so a launch under ``torch.cuda.stream``
    and on each device of a mesh goes to that device's current stream."""
    err = _error_ptrs.get(index)
    if err is None:
        err = _error_ptrs[index] = error_word(
            torch.device("cuda", index)).data_ptr()
    if _raw_stream is not None:
        return err, _raw_stream(index)
    return err, torch.cuda.current_stream(index).cuda_stream


def fast_index(*specs) -> Optional[int]:
    """The lean launch path's one pass of checks: ``specs`` are
    ``(tensor or None, dtype, ndim)``. Returns the CUDA device index when
    every tensor given has its dtype and rank, is contiguous and lies on
    that one CUDA device; else None, and the wrapper runs its checks one
    by one (which raise on bad input) or takes the plain version on the
    CPU."""
    index = -1
    for t, dtype, ndim in specs:
        if t is None:
            continue
        if t.dtype is not dtype or t.dim() != ndim or not t.is_contiguous():
            return None
        d = t.get_device()
        if d < 0 or (index >= 0 and d != index):
            return None
        index = d
    return index if index >= 0 else None


class LeanEntry:
    """A kernel entry point on the lean launch path: the C adapter
    ``<fn>_packed(const int64_t* words, void* stream)``, resolved at its
    first launch, called with one packed block of 64-bit words (pointers
    as ints, 0 for none) and a stream handle from ``launch_context``.
    A non-zero CUDA error code raises; each launch counts one of
    ``name`` in ``LAUNCHES``."""

    __slots__ = ("_lib", "_fn_name", "name", "_struct", "_fn", "_decode")

    def __init__(self, lib, fn_name: str, name: str, n_words: int,
                 error_string: str) -> None:
        self._lib = lib
        self._fn_name = fn_name + "_packed"
        self.name = name
        self._struct = struct.Struct(f"<{n_words}q")
        self._fn = None
        self._decode = error_string

    def __call__(self, stream: int, *words: int) -> None:
        fn = self._fn
        if fn is None:
            lib = self._lib()
            fn = getattr(lib, self._fn_name)
            fn.argtypes = [ctypes.c_char_p, ctypes.c_void_p]
            fn.restype = ctypes.c_int
            self._fn = fn
        rc = fn(self._struct.pack(*words), stream)
        if rc != 0:
            msg = getattr(self._lib(), self._decode)(rc).decode()
            raise RuntimeError(f"{self.name}: CUDA launch failed ({rc}: {msg})")
        LAUNCHES[self.name] += 1


def scratch(device: torch.device, words: int) -> Tuple[torch.Tensor, int]:
    """``words`` int32 words of device scratch in one allocation (8-byte
    aligned) and its address, for a launch queued while the caller holds
    the tensor: once it is dropped the caching allocator hands the block
    out again only to work queued later on the same stream."""
    t = torch.empty(words, dtype=torch.int32, device=device)
    return t, t.data_ptr()


class _Workspace:
    """One stream's clean workspace: the tensor, its address, the sizes
    its layout is cut for, and the calls it has served."""
    __slots__ = ("tensor", "ptr", "dims", "calls")

    def __init__(self, tensor: torch.Tensor, dims: Tuple[int, ...]) -> None:
        self.tensor, self.ptr, self.dims, self.calls = (
            tensor, tensor.data_ptr(), dims, 0)


_workspaces: Dict[Tuple[str, int, int], _Workspace] = {}
# calls a workspace serves before a zeroed one replaces it: well inside
# csrc/lookback.cuh's 24-bit epoch, so no descriptor of an older call can
# pass for the current one's
WORKSPACE_CALLS = 1 << 22


def clean_workspace(name: str, index: int, stream: int, dims: Tuple[int, ...],
                    words_of) -> Tuple[int, Tuple[int, ...]]:
    """``name``'s device scratch on CUDA device ``index`` and ``stream``
    for a call of sizes ``dims`` (one or two: tiles, or windows and
    tiles): its address and the sizes its layout is cut for (each at
    least the call's). It is zeroed when allocated (``words_of(*sizes)``
    int64 words), and the kernels leave it fit for the next call without
    clearing it (csrc/lookback.cuh's epoch); a call past its sizes, or
    its ``WORKSPACE_CALLS``-th call, gets a larger or fresh one, zeroed on
    that stream."""
    key = (name, index, stream)
    ws = _workspaces.get(key)
    # dims has one or two sizes: [0] and [-1] cover both
    if (ws is None or ws.calls >= WORKSPACE_CALLS or dims[0] > ws.dims[0]
            or dims[-1] > ws.dims[-1]):
        sizes = tuple(max(d, c) for d, c in zip(
            dims, ws.dims if ws is not None else dims))
        ws = _workspaces[key] = _Workspace(torch.zeros(
            words_of(*sizes), dtype=torch.int64,
            device=torch.device("cuda", index)), sizes)
    ws.calls += 1
    return ws.ptr, ws.dims


def drop_workspace(name: str, index: int, stream: int) -> None:
    """Forget a workspace whose launch failed part way (it may not be
    fit for another call): the next call allocates a zeroed one."""
    _workspaces.pop((name, index, stream), None)


# csrc/topn_select.cuh's launch constants (tests/test_torch_fire_plan.py
# and tests/test_torch_count_topn.py read them from the source): the cells
# of a selection tile and of a threshold block, the windows of a block's
# threshold table and of a radix block's histograms
SEL_CELLS = 1024
THR_CELLS = 2048
SEL_WIN_TABLE = 64
RADIX_WINDOWS = 32


class TopnPlan(NamedTuple):
    """csrc/topn_select.cuh ``launch_select``'s launches for one call."""
    tiles: int     # selection tiles (a look-back descriptor each)
    blocks: int    # threshold blocks
    kernels: int   # device kernels a call
    table: bool    # each block holds the thresholds in a table (W <= 64)


def topn_plan(rows: int, W: int, n: int, *, given: bool = False,
              fits: bool = True) -> TopnPlan:
    """The top-n selection's launches over a (rows, W) grid at top ``n``
    (k = min(n, rows)): one against the gathered candidates (``given``:
    ``topn_select_given``, W <= SEL_WIN_TABLE); two at k = 1 (the
    per-window maxima, then the selection); above, the radix select and
    the selection in one cooperative launch where W <= RADIX_WINDOWS and
    the threshold blocks fit on the card at once (``fits``, the card's
    occupancy), else a launch a radix pass and the selection."""
    K = rows * W
    tiles, blocks = max(1, -(-K // SEL_CELLS)), max(1, -(-K // THR_CELLS))
    if given:
        kernels = 1
    elif min(n, rows) == 1:
        kernels = 2
    elif W <= RADIX_WINDOWS and fits:
        kernels = 1
    else:
        kernels = 5
    return TopnPlan(tiles, blocks, kernels, W <= SEL_WIN_TABLE)


# csrc/lookback.cuh kLbLine: a look-back descriptor's 64-bit words (one
# 128-byte line each)
LB_LINE = 16


def select_work_words(W: int, tiles: int) -> int:
    """csrc/topn_select.cuh ``select_work_words``: the top-n workspace's
    int64 words cut for ``W`` windows and ``tiles`` selection tiles (the
    ring's old head; the done counter and the epoch; the grid barrier's
    words; a tagged threshold a window; a window's radix prefix, count
    still needed, non-candidate count and 256 bins, 32 bits each; then,
    from a 128-byte boundary, a descriptor a tile on its own 128-byte
    line)."""
    head = 3 + W + (W * (3 + 256) + 1) // 2
    return -(-head // LB_LINE) * LB_LINE + LB_LINE * tiles


def select_workspace(name: str, index: int, stream: int, rows: int,
                     W: int) -> Tuple[int, int, int]:
    """Top-n entry point ``name``'s clean workspace on CUDA device
    ``index`` and ``stream`` for a (rows, W) grid: its address and the
    windows and selection tiles its layout is cut for."""
    # topn_plan's tiles, worked out here: this runs at every call
    ptr, (cap_w, cap_tiles) = clean_workspace(
        name, index, stream, (max(W, 1), max(1, -(-rows * W // SEL_CELLS))),
        select_work_words)
    return ptr, cap_w, cap_tiles


def _entry(fn: str, name: str, n_words: int) -> LeanEntry:
    return LeanEntry(_lib, fn, name, n_words, "fk_error_string")


_SCATTER_COUNTS = _entry("fk_scatter_counts", "scatter_counts", 9)
_SCATTER_SPLIT_COUNTS = _entry("fk_scatter_split_counts",
                               "scatter_split_counts", 7)
_SPLIT_CELLS = _entry("fk_split_cells", "split_cells", 6)
_WINDOW_COUNTS = _entry("fk_window_counts", "window_counts", 10)
_TOPN_SELECT_APPEND = _entry("fk_topn_select_append", "topn_select_append", 15)
_TOPN_CANDIDATES = _entry("fk_topn_candidates", "topn_candidates", 13)
_TOPN_GLOBAL_THRESHOLD = _entry("fk_topn_global_threshold",
                                "topn_global_threshold", 5)
_TOPN_SELECT_GIVEN = _entry("fk_topn_select_given", "topn_select_given", 18)


# -- K1 ----------------------------------------------------------------------

def scatter_counts(counts: torch.Tensor, idx: torch.Tensor,
                   cnt: Optional[torch.Tensor] = None,
                   skip_negative: bool = False) -> torch.Tensor:
    """``counts.view(-1)[idx[i]] += cnt[i]`` (``+= 1`` without ``cnt``),
    in place. ``idx`` is the flat cell index ``row * ring + col``, int32,
    or int64 for a state of 2^31 cells or more; an entry outside the
    tensor raises (the kernel skips it and reports it through
    ``error_word``) — except, with ``skip_negative``, a negative entry,
    which is an invalid record and touches nothing. Returns ``counts``."""
    wide = idx.dtype is torch.int64
    index = fast_index((counts, torch.int32, 2),
                       (idx, torch.int64 if wide else torch.int32, 1),
                       (cnt, torch.int32, 1))
    if index is None:
        check_tensor(counts, "counts", torch.int32, 2)
        check_tensor(idx, "idx", torch.int64 if wide else torch.int32, 1)
        if cnt is not None:
            check_tensor(cnt, "cnt", torch.int32, 1)
    if cnt is not None and cnt.numel() != idx.numel():
        raise ValueError("cnt and idx differ in length")
    if index is None:
        if not on_cuda("scatter_counts", counts, idx, cnt):
            return scatter_counts_plain(counts, idx, cnt, skip_negative)
        index = counts.get_device()
    rows, ring = counts.shape
    err, stream = launch_context(index)
    _SCATTER_COUNTS(stream, counts.data_ptr(), rows, ring, idx.data_ptr(),
                    8 if wide else 4,
                    cnt.data_ptr() if cnt is not None else 0, idx.numel(),
                    int(bool(skip_negative)), err)
    return counts


def scatter_counts_plain(counts, idx, cnt=None, skip_negative=False):
    if skip_negative:
        ok = idx >= 0
        idx = idx[ok]
        cnt = cnt[ok] if cnt is not None else None
    if idx.numel() and (int(idx.min()) < 0 or int(idx.max()) >= counts.numel()):
        raise_for_error_bits(1)
    add = (cnt if cnt is not None
           else torch.ones(idx.numel(), dtype=torch.int32, device=idx.device))
    counts.view(-1).index_add_(0, idx.long(), add)
    return counts


def scatter_split_counts(counts: torch.Tensor, sc: torch.Tensor,
                         dump_row: int) -> torch.Tensor:
    """``scatter_counts`` per record from a ``(B, 3)`` uint8 split upload
    (``split_cells``' bytes), decoded in the same launch: ``counts[slot,
    col] += 1`` for each record, in place. Slot ``INVALID_SLOT_U16`` is
    an invalid record and adds nothing (the reference's 0 to the dump
    row); a slot past ``dump_row`` or a column past the ring raises
    (``split_cells``' rule; the kernel skips the record and reports it
    through ``error_word``). Returns ``counts``."""
    index = fast_index((counts, torch.int32, 2), (sc, torch.uint8, 2))
    if index is None:
        check_tensor(counts, "counts", torch.int32, 2)
        check_tensor(sc, "sc", torch.uint8, 2)
    rows, ring = counts.shape
    if sc.shape[1] != 3:
        raise ValueError(f"sc must be (B, 3), got {tuple(sc.shape)}")
    if not 1 <= ring <= 256 or not 0 <= dump_row < min(rows, INVALID_SLOT_U16):
        raise ValueError(f"split upload needs ring <= 256 and dump_row below "
                         f"the rows and 0xFFFF, got ring {ring}, dump_row "
                         f"{dump_row}, rows {rows}")
    if index is None:
        if not on_cuda("scatter_split_counts", counts, sc):
            return scatter_split_counts_plain(counts, sc, dump_row)
        index = counts.get_device()
    err, stream = launch_context(index)
    _SCATTER_SPLIT_COUNTS(stream, counts.data_ptr(), rows, ring, sc.data_ptr(),
                          sc.shape[0], int(dump_row), err)
    return counts


def scatter_split_counts_plain(counts, sc, dump_row):
    ring = counts.shape[1]
    b = sc.to(torch.int32)
    slot = b[:, 0] | (b[:, 1] << 8)
    col = b[:, 2]
    ok = slot != INVALID_SLOT_U16
    row = torch.where(ok, slot, torch.full_like(slot, dump_row))
    if row.numel() and (int(row.max()) > dump_row or int(col.max()) >= ring):
        raise_for_error_bits(64)
    cells = (row * ring + col)[ok]
    counts.view(-1).index_add_(0, cells.long(), torch.ones_like(cells))
    return counts


# csrc/window_kernels.cu's per-record launch constants (the tests read
# them from the source): threads a block, the longest chunk, the rows of
# the largest histogram and the blocks a plan aims at
COUNT_THREADS = 512
COUNT_MAX_CHUNK = 65535
HIST_MAX_ROWS = 100000
COUNT_BLOCKS = 132


class CountPlan(NamedTuple):
    """csrc/window_kernels.cu ``count_plan``: the per-record count's
    launch over ``n`` records into ``rows`` rows."""
    chunk: int    # records a block
    groups: int   # 16-byte groups of its histogram (8 rows each)
    chunks: int


def count_plan(n: int, rows: int) -> CountPlan:
    step = 4 * COUNT_THREADS
    want = -(-n // COUNT_BLOCKS)
    chunk = -(-want // step) * step
    if chunk > COUNT_MAX_CHUNK:
        chunk = COUNT_MAX_CHUNK // step * step
    return CountPlan(chunk, -(-rows // 8), -(-n // chunk))


# -- K7 ----------------------------------------------------------------------

INVALID_SLOT_U16 = 0xFFFF  # the slot id of an invalid record in a split upload


def split_cells(sc: torch.Tensor, ring: int, dump_row: int) -> torch.Tensor:
    """(B,) int32 flat cells ``row * ring + col`` of a ``(B, 3)`` uint8
    split upload: bytes 0-1 the little-endian slot id, byte 2 the ring
    column; slot ``INVALID_SLOT_U16`` goes to the dump row. A slot past
    ``dump_row`` or a column past the ring raises (the kernel writes
    cell -1 and reports it through ``error_word``)."""
    index = fast_index((sc, torch.uint8, 2))
    if index is None:
        check_tensor(sc, "sc", torch.uint8, 2)
    if sc.shape[1] != 3:
        raise ValueError(f"sc must be (B, 3), got {tuple(sc.shape)}")
    if not 1 <= ring <= 256 or not 0 <= dump_row < INVALID_SLOT_U16:
        raise ValueError(f"split upload needs ring <= 256 and dump_row < "
                         f"0xFFFF, got ring {ring}, dump_row {dump_row}")
    if index is None:
        if not on_cuda("split_cells", sc):
            return split_cells_plain(sc, ring, dump_row)
        index = sc.get_device()
    cells = torch.empty(sc.shape[0], dtype=torch.int32, device=sc.device)
    err, stream = launch_context(index)
    _SPLIT_CELLS(stream, sc.data_ptr(), sc.shape[0], int(ring), int(dump_row),
                 cells.data_ptr(), err)
    return cells


def split_cells_plain(sc, ring, dump_row):
    b = sc.to(torch.int32)
    slot = b[:, 0] | (b[:, 1] << 8)
    col = b[:, 2]
    row = torch.where(slot == INVALID_SLOT_U16,
                      torch.full_like(slot, dump_row), slot)
    if row.numel() and (int(row.max()) > dump_row or int(col.max()) >= ring):
        raise_for_error_bits(64)
    return row * ring + col


# -- K2 ----------------------------------------------------------------------

# csrc/window_fire.cuh's window_counts constants (the tests read them from
# the source): threads a block, the most rows of a tile (a prefix thread
# each), windows of a block's table, the most shared words of a block
WC_THREADS = 256
WC_ROWS = 128
WC_WINDOWS = 64
WC_SMEM_WORDS = 24576


class WindowCountsPlan(NamedTuple):
    """csrc/window_fire.cuh ``wc_plan``: ``window_counts``' launch over a
    (rows, ring) state and W windows."""
    tile_rows: int   # rows a block
    seg: int         # live panes a row stages at once
    pstride: int     # words of a staged prefix row (odd)
    wchunk: int      # windows a pass
    smem_bytes: int
    tiles: int


def window_counts_plan(rows: int, ring: int, W: int) -> WindowCountsPlan:
    wchunk = min(W, WC_WINDOWS)
    budget = WC_SMEM_WORDS - 3 * WC_WINDOWS - WC_ROWS
    t = WC_ROWS
    while t > 1 and t * (((ring + 1) | 1) + wchunk) > budget:
        t >>= 1
    room = budget // t - wchunk
    seg = min(ring, room - 1)
    if ((seg + 1) | 1) > room:
        seg -= 1
    pstride = (seg + 1) | 1
    return WindowCountsPlan(
        t, seg, pstride, wchunk,
        4 * (3 * WC_WINDOWS + WC_ROWS + t * (pstride + wchunk)),
        -(-rows // t))


def window_counts(counts: torch.Tensor, end_panes: torch.Tensor,
                  w_valid: torch.Tensor, pane_lo: int, pane_hi: int,
                  ppw: int, out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(rows, W) int32: the sum of ``counts[r, p % ring]`` over panes p in
    ``[end_w - ppw, end_w)`` ∩ ``[pane_lo, min(pane_hi, pane_lo + ring -
    1)]``, and 0 where ``w_valid[w]`` is False. Into ``out`` (a
    contiguous (rows, W) int32 tensor, returned) where given, else a new
    tensor: a caller that reuses one buffer for every call (the
    operator's fire) saves the allocation."""
    index = fast_index((counts, torch.int32, 2), (end_panes, torch.int64, 1),
                       (w_valid, torch.bool, 1), (out, torch.int32, 2))
    if index is None:
        check_tensor(counts, "counts", torch.int32, 2)
        check_tensor(end_panes, "end_panes", torch.int64, 1)
        check_tensor(w_valid, "w_valid", torch.bool, 1)
        if out is not None:
            check_tensor(out, "out", torch.int32, 2)
    rows, ring = counts.shape
    W = end_panes.numel()
    if w_valid.numel() != W:
        raise ValueError("w_valid and end_panes differ in length")
    if out is not None and out.shape != (rows, W):
        raise ValueError(f"out must be ({rows}, {W}), got {tuple(out.shape)}")
    if index is None:
        if not on_cuda("window_counts", counts, end_panes, w_valid, out):
            wc = window_counts_plain(counts, end_panes, w_valid, pane_lo,
                                     pane_hi, ppw)
            return wc if out is None else out.copy_(wc)
        index = counts.get_device()
    if out is None:
        out = torch.empty((rows, W), dtype=torch.int32, device=counts.device)
    _, stream = launch_context(index)
    _WINDOW_COUNTS(stream, counts.data_ptr(), rows, ring, end_panes.data_ptr(),
                   w_valid.data_ptr(), W, int(pane_lo), int(pane_hi), int(ppw),
                   out.data_ptr())
    return out


def window_counts_plain(counts, end_panes, w_valid, pane_lo, pane_hi, ppw):
    rows, ring = counts.shape
    W = end_panes.numel()
    panes = end_panes[:, None] - ppw + torch.arange(
        ppw, dtype=torch.int64, device=counts.device)[None, :]      # (W, ppw)
    hi = min(int(pane_hi), int(pane_lo) + ring - 1)
    live = (panes >= int(pane_lo)) & (panes <= hi) & w_valid[:, None]
    cols = torch.remainder(panes, ring).reshape(-1)
    vals = counts[:, cols].reshape(rows, W, ppw)
    return (vals * live[None].to(torch.int32)).sum(dim=2, dtype=torch.int32)


# -- K3 ----------------------------------------------------------------------

def topn_select_append(wcounts: torch.Tensor, used_mask: torch.Tensor,
                       end_panes: torch.Tensor, w_valid: torch.Tensor,
                       anchor: int, n: int, sel_cap: int,
                       emit_ring: torch.Tensor) -> torch.Tensor:
    """Select each window's top-``n`` cells (ties at the n-th value kept;
    every candidate when a window has fewer than n) and append them to
    ``emit_ring`` in row-major (row, window) order, in place.

    Candidates: ``wcounts > 0`` on a ``used_mask`` row of a valid window,
    ranked by the count as f32. Appended rows are ``[row, end_pane -
    anchor, count]`` at ``(total + i) % row_cap + 1`` for the first
    ``sel_cap`` selected cells; then head ``[0, 0] += written`` and
    ``[0, 1] += selected - written``. Rows ``1 .. row_cap`` are the data
    ring; the last row is reserved and never written."""
    index = fast_index((wcounts, torch.int32, 2), (used_mask, torch.bool, 1),
                       (end_panes, torch.int64, 1), (w_valid, torch.bool, 1),
                       (emit_ring, torch.int32, 2))
    if index is None:
        check_tensor(wcounts, "wcounts", torch.int32, 2)
        check_tensor(used_mask, "used_mask", torch.bool, 1)
        check_tensor(end_panes, "end_panes", torch.int64, 1)
        check_tensor(w_valid, "w_valid", torch.bool, 1)
        check_tensor(emit_ring, "emit_ring", torch.int32, 2)
    rows, W = wcounts.shape
    if used_mask.numel() != rows or end_panes.numel() != W \
            or w_valid.numel() != W:
        raise ValueError("used_mask/end_panes/w_valid do not match wcounts")
    if emit_ring.shape[1] != 3 or emit_ring.shape[0] < 3:
        raise ValueError(
            f"emit_ring must be (row_cap + 2, 3), got {tuple(emit_ring.shape)}")
    if n < 1 or sel_cap < 1:
        raise ValueError("n and sel_cap must be >= 1")
    if index is None:
        if not on_cuda("topn_select_append", wcounts, used_mask, end_panes,
                       w_valid, emit_ring):
            return topn_select_append_plain(wcounts, used_mask, end_panes,
                                            w_valid, anchor, n, sel_cap,
                                            emit_ring)
        index = wcounts.get_device()
    _, stream = launch_context(index)
    work = select_workspace("topn_select_append", index, stream, rows, W)
    try:
        _TOPN_SELECT_APPEND(stream, wcounts.data_ptr(), rows, W,
                            used_mask.data_ptr(), end_panes.data_ptr(),
                            w_valid.data_ptr(), int(anchor), int(n),
                            int(sel_cap), emit_ring.data_ptr(),
                            emit_ring.shape[0], emit_ring.shape[1], *work)
    except RuntimeError:
        drop_workspace("topn_select_append", index, stream)
        raise
    return emit_ring


def topn_select_append_plain(wcounts, used_mask, end_panes, w_valid, anchor,
                             n, sel_cap, emit_ring):
    rows, W = wcounts.shape
    cand = (wcounts > 0) & used_mask[:, None] & w_valid[None, :]
    v = torch.where(cand, wcounts.to(torch.float32),
                    torch.full((), -math.inf, device=wcounts.device))
    k = min(n, rows)
    thresh = torch.topk(v.T, k, dim=1).values[:, k - 1]           # (W,)
    _ring_append(wcounts, cand & (v >= thresh[None, :]), end_panes, anchor,
                 0, sel_cap, emit_ring)
    return emit_ring


# -- K3, distributed mode ------------------------------------------------------
# A key-sharded operator's top-n (the reference's topn_shard): each device
# block's top-k candidates per window (topn_candidates), gathered across
# the blocks into (W, n_blocks * k) (on one card each block writes its own
# columns), then each block's select against their global k-th with its
# first global row as the row offset (topn_select_given, which works the
# k-th out itself; topn_global_threshold is that k-th alone).

# csrc/topn_select.cuh's topn_candidates constants: cells a thread of the
# top-1 and merge launches, and the merge's largest k
CAND_ITEMS = 4
CAND_SMALL_K = 16


class CandidatesPlan(NamedTuple):
    """csrc/topn_select.cuh ``launch_candidates``' launches for one
    ``topn_candidates`` call."""
    blocks: int      # blocks of the top-1 and merge launches
    kernels: int     # device kernels a call
    list_words: int  # uint32 words of the call's scratch


def candidates_plan(rows: int, W: int, k: int, *,
                    fits: bool = True) -> CandidatesPlan:
    """One launch at top-1 (the per-window maxima, the last block
    writing the output) and up to top-CAND_SMALL_K where W <= 256 (each
    block's top k a window into a (blocks, W, k) scratch, the last
    block's merge); above, the radix select: one cooperative launch
    where W <= RADIX_WINDOWS and the threshold blocks fit on the card at
    once (``fits``), else four radix passes, the collect and the sort
    (a (W, k) scratch)."""
    k = min(k, rows)
    span = 256 // W * W if W <= 256 else 256
    blocks = -(-rows * W // (span * CAND_ITEMS))
    if k == 1:
        return CandidatesPlan(blocks, 1, 0)
    if k <= CAND_SMALL_K and W <= 256:
        return CandidatesPlan(blocks, 1, blocks * W * k)
    return CandidatesPlan(blocks, 1 if W <= RADIX_WINDOWS and fits else 6,
                          W * k)


def topn_candidates(wcounts: torch.Tensor, used_mask: torch.Tensor,
                    w_valid: torch.Tensor, k: int,
                    out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(W, k) f32: each window's top ``k`` candidate values (``wcounts >
    0`` on a ``used_mask`` row of a valid window, as f32), descending,
    each as often as it occurs; -inf past a window's candidates. The
    kernel reads the grid over the whole card (``candidates_plan``'s
    launches) with its own clean workspace. ``out``, when given, is a
    (W, k) f32 view on the same device whose rows may lie further apart
    than k (a block's columns of the gathered ``(W, M)`` buffer that
    ``topn_select_given`` reads); the values land there and it is
    returned."""
    index = fast_index((wcounts, torch.int32, 2), (used_mask, torch.bool, 1),
                       (w_valid, torch.bool, 1))
    if index is None:
        check_tensor(wcounts, "wcounts", torch.int32, 2)
        check_tensor(used_mask, "used_mask", torch.bool, 1)
        check_tensor(w_valid, "w_valid", torch.bool, 1)
    rows, W = wcounts.shape
    if used_mask.numel() != rows or w_valid.numel() != W:
        raise ValueError("used_mask/w_valid do not match wcounts")
    if not 1 <= k <= rows:
        raise ValueError(f"topn_candidates needs 1 <= k <= rows, got {k}")
    if out is not None and (out.dtype is not torch.float32
                            or tuple(out.shape) != (W, k)
                            or out.stride(1) != 1 or out.stride(0) < k
                            or out.device != wcounts.device):
        raise ValueError(
            f"out must be a (W, k) = ({W}, {k}) float32 view with unit "
            f"column stride on {wcounts.device}, got {tuple(out.shape)} "
            f"{out.dtype} strides {out.stride()} on {out.device}")
    if index is None:
        if not on_cuda("topn_candidates", wcounts, used_mask, w_valid):
            cand = topn_candidates_plain(wcounts, used_mask, w_valid, k)
            return cand if out is None else out.copy_(cand)
        index = wcounts.get_device()
    cand = (torch.empty((W, k), dtype=torch.float32, device=wcounts.device)
            if out is None else out)
    _, stream = launch_context(index)
    work = select_workspace("topn_candidates", index, stream, rows, W)
    # above top-1: the blocks' lists, or each window's keys above its k-th
    # (held until the launch is queued)
    words = candidates_plan(rows, W, k).list_words if k > 1 else 0
    _held, lst = scratch(wcounts.device, words) if words else (None, 0)
    try:
        _TOPN_CANDIDATES(stream, wcounts.data_ptr(), rows, W,
                         used_mask.data_ptr(), w_valid.data_ptr(), int(k),
                         cand.data_ptr(), cand.stride(0), lst, words, *work)
    except RuntimeError:
        drop_workspace("topn_candidates", index, stream)
        raise
    return cand


def topn_candidates_plain(wcounts, used_mask, w_valid, k):
    cand = (wcounts > 0) & used_mask[:, None] & w_valid[None, :]
    v = torch.where(cand, wcounts.to(torch.float32),
                    torch.full((), -math.inf, device=wcounts.device))
    return torch.topk(v.T, k, dim=1).values


def topn_global_threshold(cands: torch.Tensor, k: int) -> torch.Tensor:
    """(W,) f32: the ``k``-th largest of each row of the gathered ``(W,
    M)`` candidates, ties counted; -inf when a row has fewer than ``k``
    finite values. The reference's global threshold on its own (the
    key-sharded path folds it into ``topn_select_given``)."""
    index = fast_index((cands, torch.float32, 2))
    if index is None:
        check_tensor(cands, "cands", torch.float32, 2)
    W, M = cands.shape
    if not 1 <= k <= M:
        raise ValueError(f"topn_global_threshold needs 1 <= k <= {M}, got {k}")
    if index is None:
        if not on_cuda("topn_global_threshold", cands):
            return topn_global_threshold_plain(cands, k)
        index = cands.get_device()
    thresh = torch.empty(W, dtype=torch.float32, device=cands.device)
    _, stream = launch_context(index)
    _TOPN_GLOBAL_THRESHOLD(stream, cands.data_ptr(), W, M, int(k),
                           thresh.data_ptr())
    return thresh


def topn_global_threshold_plain(cands, k):
    return torch.topk(cands, k, dim=1).values[:, k - 1].contiguous()


def topn_select_given(wcounts: torch.Tensor, used_mask: torch.Tensor,
                      end_panes: torch.Tensor, w_valid: torch.Tensor,
                      anchor: int, cands: torch.Tensor, k: int,
                      row_offset: int, sel_cap: int,
                      emit_ring: torch.Tensor) -> torch.Tensor:
    """``topn_select_append`` against the key-sharded mode's global
    threshold: ``cands`` is the gathered ``(W, M)`` f32 candidates (every
    block's ``topn_candidates``), and window w's threshold is the ``k``-th
    largest of its row, ties counted (-inf with fewer than ``k`` finite;
    ``topn_global_threshold``), worked out in the kernel's own launch.
    Candidates with ``count >= threshold`` are appended in row-major
    (row, window) order as ``[row + row_offset, end_pane - anchor,
    count]``, the head moved the same way. At most SEL_WIN_TABLE windows
    (the sharded fire's chunks are at most MIN_FIRE_PAD). In place;
    returns ``emit_ring``."""
    index = fast_index((wcounts, torch.int32, 2), (used_mask, torch.bool, 1),
                       (end_panes, torch.int64, 1), (w_valid, torch.bool, 1),
                       (cands, torch.float32, 2), (emit_ring, torch.int32, 2))
    if index is None:
        check_tensor(wcounts, "wcounts", torch.int32, 2)
        check_tensor(used_mask, "used_mask", torch.bool, 1)
        check_tensor(end_panes, "end_panes", torch.int64, 1)
        check_tensor(w_valid, "w_valid", torch.bool, 1)
        check_tensor(cands, "cands", torch.float32, 2)
        check_tensor(emit_ring, "emit_ring", torch.int32, 2)
    rows, W = wcounts.shape
    if used_mask.numel() != rows or end_panes.numel() != W \
            or w_valid.numel() != W or cands.shape[0] != W:
        raise ValueError("used_mask/end_panes/w_valid/cands do not match "
                         "wcounts")
    if W > SEL_WIN_TABLE:
        raise ValueError(f"topn_select_given takes at most {SEL_WIN_TABLE} "
                         f"windows (one selection tile's table), got {W}")
    if not 1 <= k <= cands.shape[1]:
        raise ValueError(f"topn_select_given needs 1 <= k <= "
                         f"{cands.shape[1]}, got {k}")
    if emit_ring.shape[1] != 3 or emit_ring.shape[0] < 3:
        raise ValueError(
            f"emit_ring must be (row_cap + 2, 3), got {tuple(emit_ring.shape)}")
    if sel_cap < 1:
        raise ValueError("sel_cap must be >= 1")
    if index is None:
        if not on_cuda("topn_select_given", wcounts, used_mask, end_panes,
                       w_valid, cands, emit_ring):
            return topn_select_given_plain(wcounts, used_mask, end_panes,
                                           w_valid, anchor, cands, k,
                                           row_offset, sel_cap, emit_ring)
        index = wcounts.get_device()
    _, stream = launch_context(index)
    work = select_workspace("topn_select_given", index, stream, rows, W)
    try:
        _TOPN_SELECT_GIVEN(stream, wcounts.data_ptr(), rows, W,
                           used_mask.data_ptr(), end_panes.data_ptr(),
                           w_valid.data_ptr(), int(anchor), cands.data_ptr(),
                           cands.shape[1], int(k), int(row_offset),
                           int(sel_cap), emit_ring.data_ptr(),
                           emit_ring.shape[0], emit_ring.shape[1], *work)
    except RuntimeError:
        drop_workspace("topn_select_given", index, stream)
        raise
    return emit_ring


def topn_select_given_plain(wcounts, used_mask, end_panes, w_valid, anchor,
                            cands, k, row_offset, sel_cap, emit_ring):
    thresh = topn_global_threshold_plain(cands, k)
    cand = (wcounts > 0) & used_mask[:, None] & w_valid[None, :]
    sel = cand & (wcounts.to(torch.float32) >= thresh[None, :])
    _ring_append(wcounts, sel, end_panes, anchor, row_offset, sel_cap,
                 emit_ring)
    return emit_ring


def _ring_append(wcounts, sel, end_panes, anchor, row_offset, sel_cap,
                 emit_ring, cols=None):
    """Append the selected (row, window) cells in row-major order: the
    plain versions' half of csrc/topn_select.cuh's ``select_tile``; with
    ``cols`` ((rows, W, F) int32) each row carries its cell's F result
    columns."""
    W = wcounts.shape[1]
    flat = torch.nonzero(sel.reshape(-1)).reshape(-1)            # row-major
    total_sel = flat.numel()
    m = min(total_sel, sel_cap)
    r = flat[:m] // W
    w = flat[:m] % W
    row_cap = emit_ring.shape[0] - 2
    total = int(emit_ring[0, 0])
    pos = (total + torch.arange(m, device=wcounts.device)) % row_cap + 1
    head = torch.stack(
        [r.to(torch.int32) + int(row_offset),
         (end_panes[w] - int(anchor)).to(torch.int32), wcounts[r, w]], dim=1)
    emit_ring[pos] = (head if cols is None
                      else torch.cat([head, cols[r, w]], dim=1))
    emit_ring[0, 0] = total + m
    emit_ring[0, 1] += total_sel - m


# -- K4 ----------------------------------------------------------------------

# the identity fills of a state block's lanes, in PaneState order (sums,
# maxs, mins, counts)
LANE_FILLS = (0.0, -math.inf, math.inf, 0)
# fk_ring_columns' argument block (csrc/window_kernels.cu RingArgs):
# rows, src_ring, dst_ring, n_lanes, src_col, keep, err, then the source
# pointers, destination pointers, widths and fill bits of 4 lane slots
_RING_ARGS = struct.Struct("<23q")
_RING_SLOTS = 4
# the unused slots' zeros, by the number of lanes used
_RING_PAD = [(0,) * (_RING_SLOTS - n) for n in range(_RING_SLOTS + 1)]
_fill_bits: Dict[float, int] = {}
_ring_fn = None


def ring_columns(src: torch.Tensor, dst: torch.Tensor, src_col: torch.Tensor,
                 keep: torch.Tensor, fill: float = 0) -> torch.Tensor:
    """``dst[:, j] = src[:, src_col[j]] if keep[j] else fill``, over the
    int32 ``(rows, ring)`` count lane (fill 0) or an f32 ``(rows, ring,
    width)`` sum/max/min lane (fill 0, -inf or +inf). In place (``dst
    is src``) only with ``src_col[j] == j`` wherever ``keep[j]`` — the
    pane purge; a ring growth writes a new ``dst``. ``src_col`` entries
    where ``keep`` lie in ``[0, src ring)``; one that does not raises
    (the kernel writes the fill there and reports it through
    ``error_word``). Returns ``dst``. One lane of ``ring_columns_block``,
    in one launch."""
    _ring_lanes(((src, dst, fill),), src_col, keep)
    return dst


def ring_columns_block(src, dst, src_col: torch.Tensor,
                       keep: torch.Tensor):
    """``ring_columns`` over every lane of a state block in one launch:
    ``src`` and ``dst`` are ``(sums, maxs, mins, counts)`` in
    ``PaneState`` order, None where the block has no such lane, and each
    lane takes its identity (``LANE_FILLS``) as the fill. The purge
    passes ``dst = src`` (every lane in place), a growth new tensors at
    the new ring width (every lane out of place). Returns ``dst``."""
    lanes = []
    for s, d, fill in zip(src, dst, LANE_FILLS):
        if (s is None) != (d is None):
            raise ValueError("ring_columns_block: src and dst hold different "
                             "lanes")
        if s is not None:
            lanes.append((s, d, fill))
    _ring_lanes(lanes, src_col, keep)
    return dst


def _ring_lanes(lanes, src_col: torch.Tensor, keep: torch.Tensor) -> None:
    """Check ``(src, dst, fill)`` lanes in one pass, then the plain
    version (CPU tensors) or one launch (CUDA tensors). The checks read
    each tensor's shape, type, layout and device once: this path runs
    once a watermark advance, and its host time is most of the call."""
    n_lanes = len(lanes)
    if not 1 <= n_lanes <= _RING_SLOTS:
        raise ValueError(f"ring_columns: 1 to {_RING_SLOTS} lanes, got "
                         f"{n_lanes}")
    s0, d0, _ = lanes[0]
    in_place = d0 is s0
    shape0, dshape0 = s0.shape, d0.shape
    if len(shape0) < 2 or len(dshape0) < 2:
        raise ValueError("ring_columns: shapes do not line up")
    rows, src_ring, dst_ring = shape0[0], shape0[1], dshape0[1]
    index = s0.get_device()
    widths = []
    for s, d, fill in lanes:
        ss, dt = s.shape, s.dtype
        if dt is torch.float32:
            width = ss[2] if len(ss) == 3 else -1
        elif dt is torch.int32:
            width = 1 if len(ss) == 2 else -1
            if fill != 0:
                raise ValueError("ring_columns: the count lane's fill is 0")
        else:
            raise TypeError(f"ring_columns: a lane is {dt}, expected int32 "
                            "(counts) or float32")
        if width < 0 or ss[0] != rows or ss[1] != src_ring:
            raise ValueError("ring_columns: shapes do not line up")
        if not s.is_contiguous():
            raise ValueError("ring_columns: lanes must be contiguous")
        if s.get_device() != index:
            raise ValueError("ring_columns: tensors on different devices")
        if d is not s:
            if in_place:
                raise ValueError("ring_columns: every lane in place or none")
            if d.dtype is not dt:
                raise TypeError(f"ring_columns: dst is {d.dtype}, src {dt}")
            ds = d.shape
            if len(ds) != len(ss) or ds[0] != rows or ds[1] != dst_ring \
                    or (width != 1 or dt is torch.float32) and ds[2] != width:
                raise ValueError("ring_columns: shapes do not line up")
            if not d.is_contiguous():
                raise ValueError("ring_columns: lanes must be contiguous")
            if d.get_device() != index:
                raise ValueError("ring_columns: tensors on different devices")
        elif not in_place:
            raise ValueError("ring_columns: every lane in place or none")
        widths.append(width)
    if src_col.dtype is not torch.int32 or keep.dtype is not torch.bool:
        raise TypeError(f"ring_columns: src_col {src_col.dtype} and keep "
                        f"{keep.dtype}, expected int32 and bool")
    if src_col.dim() != 1 or keep.dim() != 1 \
            or src_col.shape[0] != dst_ring or keep.shape[0] != dst_ring \
            or not (src_col.is_contiguous() and keep.is_contiguous()):
        raise ValueError(f"ring_columns: src_col and keep must be "
                         f"contiguous ({dst_ring},) tensors")
    if src_col.get_device() != index or keep.get_device() != index:
        raise ValueError("ring_columns: tensors on different devices")
    if index < 0:
        if s0.device.type != "cpu":
            raise ValueError(f"ring_columns: unsupported device {s0.device}")
        for s, d, fill in lanes:
            ring_columns_plain(s, d, src_col, keep, fill)
        return
    if rows == 0 or dst_ring == 0:
        return
    pad = _RING_PAD[n_lanes]
    err, stream = launch_context(index)
    global _ring_fn
    if _ring_fn is None:
        _ring_fn = _lib().fk_ring_columns
    srcs = [s.data_ptr() for s, _, _ in lanes]
    dsts = [d.data_ptr() for _, d, _ in lanes]
    fills = [_f32_bits(f) for _, _, f in lanes]
    # the kernel's word offsets are 32-bit: a state of 2^31 words a lane
    # or more goes through in blocks of rows, one launch each
    per = max(1, (RING_BLOCK_WORDS - 1) // (max(src_ring, dst_ring)
                                            * max(widths)))
    for r0 in range(0, rows, per):
        rc = _ring_fn(_RING_ARGS.pack(
            min(per, rows - r0), src_ring, dst_ring, n_lanes,
            src_col.data_ptr(), keep.data_ptr(), err,
            *[p + 4 * r0 * src_ring * w for p, w in zip(srcs, widths)], *pad,
            *[p + 4 * r0 * dst_ring * w for p, w in zip(dsts, widths)], *pad,
            *widths, *pad, *fills, *pad), stream)
        if rc != 0:
            raise RuntimeError(f"ring_columns: CUDA launch failed ({rc}: "
                               f"{_lib().fk_error_string(rc).decode()})")
        LAUNCHES["ring_columns"] += 1


def _f32_bits(fill: float) -> int:
    """The f32 bit pattern of a fill (0 for the count lane's 0)."""
    if fill == 0:
        return 0x80000000 if math.copysign(1.0, fill) < 0 else 0
    bits = _fill_bits.get(fill)
    if bits is None:
        bits = _fill_bits[fill] = struct.unpack(
            "<I", struct.pack("<f", fill))[0]
    return bits


def ring_columns_plain(src, dst, src_col, keep, fill=0):
    kept = src_col[keep]
    if kept.numel() and (int(kept.min()) < 0 or int(kept.max()) >= src.shape[1]):
        raise_for_error_bits(2)
    cols = torch.where(keep, src_col, torch.zeros_like(src_col)).long()
    k = keep.reshape((1, -1) + (1,) * (src.dim() - 2))
    new = torch.where(k, src[:, cols],
                      torch.full((), fill, dtype=src.dtype, device=src.device))
    dst.copy_(new)
    return dst
