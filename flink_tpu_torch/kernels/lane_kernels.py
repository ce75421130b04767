"""The general window aggregates' three device functions: a CUDA kernel
each (``csrc/lane_kernels.cu``) and a plain PyTorch version each, with
the same signature.

- ``fire_pack`` (L1): fire a chunk of windows over every lane, select
  the non-empty cells of registered rows, compact them stably in
  row-major order and pack them for the host, with each selected
  cell's raw lane values beside.
- ``scatter_lanes`` (L2): fold a batch of records into the count lane
  and the f32 sum/max/min lanes, each cell's records in record order;
  the records come as flat cells or as the split upload's 3 bytes,
  decoded in the same launches by ``split_cells``' rule.
- ``scatter_pair_lanes`` (L3): fold host-combined ``[pair, count, sum
  lanes...]`` rows into the count and sum lanes.

As in ``window_kernels.py``: a wrapper takes the plain version only for
tensors on the CPU and launches the kernel (or raises) for CUDA
tensors; ``window_kernels.LAUNCHES`` counts the launches; an entry
outside the state makes the plain version raise and the kernel set a
bit in the device's error word.

Floats: every f32 sum adds in a fixed order, so kernel reruns agree bit
for bit. A scatter adds a cell's records in record order — the JAX
reference's order on XLA's CPU backend, so the plain version there
equals the reference bit for bit. The fire adds the ring columns in
column order, each times its 0/1 mask bit; the reference's jitted
column-mask product lets XLA's GEMM pick the association by shape, so
fired sums agree with it to a rounding or two. Max and min follow IEEE
754-2019 maximum / minimum as XLA does (NaN wins, -0 < +0); the plain
version gets that from an order-preserving integer key, since
``torch.amax`` does not order the zeros.
"""
from __future__ import annotations

import ctypes
import functools
import math
import struct
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from flink_tpu_torch.kernels import window_kernels as wk

_P = ctypes.c_void_p
_SIGNATURES = {
    "lk_scatter_pair_lanes": [ctypes.c_char_p, _P],
    "lk_error_string": [ctypes.c_int],
}

# scatter_pair_lanes' entry point, resolved at its first launch, and its
# argument block (csrc/lane_kernels.cu PairArgs): counts, sums, sum
# width, cells, rows, row count, columns, error word
_pair_fn = None
_PAIR_ARGS = struct.Struct("<8q")

_CANON_NAN = 0x7FC00000
_I32_MAX = 2 ** 31 - 1
_I32_MIN = -2 ** 31


def _lib() -> ctypes.CDLL:
    return wk.load_library("lane_kernels", _SIGNATURES, "lk_error_string")


def _entry(fn: str, name: str, n_words: int) -> wk.LeanEntry:
    return wk.LeanEntry(_lib, fn, name, n_words, "lk_error_string")


_FIRE_PACK = _entry("lk_fire_pack", "fire_pack", 29)
_SCATTER_LANES = _entry("lk_scatter_lanes", "scatter_lanes", 27)


def _ptr(t: Optional[torch.Tensor]) -> int:
    """A tensor's address for a packed argument block; 0 for none."""
    return t.data_ptr() if t is not None else 0


def _width(t: Optional[torch.Tensor]) -> int:
    return t.shape[-1] if t is not None else 0


def _check_lanes(counts: torch.Tensor, sums, maxs, mins,
                 checked: bool = False) -> None:
    """The state's lanes line up with ``counts``; each tensor's dtype,
    rank and layout too unless the lean path's pass ``checked`` them."""
    if not checked:
        wk.check_tensor(counts, "counts", torch.int32, 2)
    for name, t in (("sums", sums), ("maxs", maxs), ("mins", mins)):
        if t is None:
            continue
        if not checked:
            wk.check_tensor(t, name, torch.float32, 3)
        if t.shape[:2] != counts.shape:
            raise ValueError(f"{name} {tuple(t.shape)} does not match counts "
                             f"{tuple(counts.shape)}")


# -- IEEE 754-2019 maximum / minimum through order-preserving int32 keys ----

def ordered_key(x: torch.Tensor, nan_key: int) -> torch.Tensor:
    """int32 keys of f32 values whose integer order is the float order
    with -0 < +0; NaN takes ``nan_key``."""
    b = x.contiguous().view(torch.int32)
    key = torch.where(b >= 0, b, b ^ 0x7FFFFFFF)
    return torch.where(torch.isnan(x), torch.full_like(key, nan_key), key)


def from_ordered_key(key: torch.Tensor) -> torch.Tensor:
    """The f32 values of ``ordered_key`` keys; a NaN key gives the
    canonical NaN."""
    nan = (key == _I32_MAX) | (key == _I32_MIN)
    b = torch.where(key >= 0, key, key ^ 0x7FFFFFFF)
    b = torch.where(nan, torch.full_like(b, _CANON_NAN), b)
    return b.view(torch.float32)


def _ieee_reduce(x: torch.Tensor, dim: int, maximum: bool) -> torch.Tensor:
    key = ordered_key(x, _I32_MAX if maximum else _I32_MIN)
    red = key.amax(dim=dim) if maximum else key.amin(dim=dim)
    return from_ordered_key(red)


# -- L1 ------------------------------------------------------------------------

def fire_pack(counts: torch.Tensor, sums: Optional[torch.Tensor],
              maxs: Optional[torch.Tensor], mins: Optional[torch.Tensor],
              end_panes: torch.Tensor, w_valid: torch.Tensor,
              used_mask: torch.Tensor, pane_lo: int, pane_hi: int, ppw: int,
              out_cap: int, packed2: bool, row_offset: int = 0
              ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Fire windows ``end_panes`` over every lane and pack the selected
    cells.

    A cell (row r, window w) is selected when its window count — the
    count lane over panes ``[end_w - ppw, end_w)`` ∩ ``[pane_lo,
    min(pane_hi, pane_lo + ring - 1)]`` — is > 0, ``used_mask[r]`` and
    ``w_valid[w]``. Selected cells are compacted in row-major (r, w)
    order into ``buf`` (``(out_cap + 1, 2 if packed2 else 3)`` int32):
    row 0 = ``[n selected, 0, ...]``, rows 1..min(n, out_cap) = ``[r,
    end_w - pane_lo, count]`` or, packed2, ``[(r << 8) | delta, count]``.
    ``lanes`` (``(out_cap, S + M + m)`` f32, None when packed2 or the
    aggregate has no lanes) holds each selected cell's window sums (ring
    columns added in column order, each times its live bit), maxes and
    mins over the window's live panes ``[end_w - ppw, end_w)`` ∩
    ``[pane_lo, pane_hi]``. Rows past n hold no data. More than
    ``out_cap`` selected cells keep the first ``out_cap`` (the kernel
    also sets a bit in ``error_word``); the head still counts all.
    ``row_offset`` is added to each body row's ``r`` (a device block's
    first global row in a key-sharded operator); the packed2 layout
    takes none."""
    index = wk.fast_index((counts, torch.int32, 2), (sums, torch.float32, 3),
                          (maxs, torch.float32, 3), (mins, torch.float32, 3),
                          (end_panes, torch.int64, 1), (w_valid, torch.bool, 1),
                          (used_mask, torch.bool, 1))
    if index is None:
        wk.check_tensor(end_panes, "end_panes", torch.int64, 1)
        wk.check_tensor(w_valid, "w_valid", torch.bool, 1)
        wk.check_tensor(used_mask, "used_mask", torch.bool, 1)
    _check_lanes(counts, sums, maxs, mins, index is not None)
    rows, ring = counts.shape
    W = end_panes.numel()
    if w_valid.numel() != W or used_mask.numel() != rows:
        raise ValueError("w_valid/used_mask do not match end_panes/counts")
    if out_cap < 1:
        raise ValueError("out_cap must be >= 1")
    sw, mw, nw = _width(sums), _width(maxs), _width(mins)
    L = sw + mw + nw
    if packed2 and L:
        raise ValueError("the packed2 layout is for count-only aggregates")
    if packed2 and row_offset:
        raise ValueError("the packed2 layout takes no row offset")
    if index is None:
        if not wk.on_cuda("fire_pack", counts, sums, maxs, mins, end_panes,
                          w_valid, used_mask):
            return fire_pack_plain(counts, sums, maxs, mins, end_panes,
                                   w_valid, used_mask, pane_lo, pane_hi, ppw,
                                   out_cap, packed2, row_offset)
        index = counts.get_device()
    cols = 2 if packed2 else 3
    head = (out_cap + 1) * cols
    if L:
        # buf and lanes in one allocation
        mem = torch.empty(head + out_cap * L, dtype=torch.int32,
                          device=counts.device)
        buf = mem.as_strided((out_cap + 1, cols), (cols, 1), 0)
        lanes = mem.as_strided((out_cap, L), (L, 1), head).view(torch.float32)
    else:
        mem = buf = torch.empty((out_cap + 1, cols), dtype=torch.int32,
                                device=counts.device)
        lanes = None
    plan = _fire_plan(ring, max(W, 1), L, cols)
    tiles = -(-rows * W // plan.tile_cells)
    err, stream = wk.launch_context(index)
    work, (cap_tiles,) = wk.clean_workspace("fire_pack", index, stream,
                                            (tiles,), _fire_work_words)
    try:
        _FIRE_PACK(stream, counts.data_ptr(), rows, ring, _ptr(sums), sw,
                   _ptr(maxs), mw, _ptr(mins), nw, end_panes.data_ptr(),
                   w_valid.data_ptr(), W, int(pane_lo), int(pane_hi),
                   int(ppw), used_mask.data_ptr(),
                   mem.data_ptr(), cols, int(out_cap), int(bool(packed2)),
                   int(row_offset), mem.data_ptr() + 4 * head, err, work,
                   _fire_work_words(cap_tiles), *plan)
    except RuntimeError:
        wk.drop_workspace("fire_pack", index, stream)
        raise
    return buf, lanes


# csrc/lane_kernels.cu's fire_pack limits (tests/test_torch_fire_plan.py
# reads them from the source; the entry point rejects a plan past them):
# cells a tile, shared memory a block in bytes
_FIRE_CELLS = 1024
_FIRE_SMEM = 44 * 1024
# the fewest cells a tile that stages its rows; below, the rows are read
# where they lie
_FIRE_MIN_STAGED = 128


def _fire_work_words(tiles: int) -> int:
    """fire_pack's workspace in int64 words: the epoch, then a descriptor
    a tile (csrc/lookback.cuh)."""
    return 1 + tiles


class FirePlan(NamedTuple):
    """How ``fire_pack`` cuts the (row, window) grid into tiles: cells a
    tile, the rows a tile spans at most, and whether a tile's count rows
    and lane rows go into shared memory."""
    tile_cells: int
    tile_rows: int
    stage_counts: int
    stage_lanes: int


def _round4(n: int) -> int:
    return -(-n // 4) * 4


def _fire_smem_words(cells: int, tile_rows: int, ring: int, L: int, cols: int,
                     stage_counts: bool, stage_lanes: bool) -> int:
    """csrc/lane_kernels.cu ``fire_layout``: a tile's shared memory in
    32-bit words (the out rows, the selected cells, the rows' slots, the
    rows' used bytes by aligned words, the staged count rows, the staged
    lane rows with an odd stride)."""
    stride = ring * L + 3
    stride += 1 - stride % 2
    words = _round4(cells * cols)
    words += _round4(cells) if L else 0
    words += _round4(tile_rows) if L and stage_lanes else 0
    words += _round4((tile_rows + 6) // 4 + 1)
    words += _round4(tile_rows * ring + 3) if stage_counts else 0
    return words + (tile_rows * stride if L and stage_lanes else 0)


@functools.lru_cache(maxsize=256)
def _fire_plan(ring: int, W: int, L: int, cols: int) -> FirePlan:
    """The plan for ``ring`` columns, ``W`` windows, ``L`` lanes and
    ``cols`` out columns: the most cells a tile (a power of two, up to
    1024) whose count and lane rows fit the shared memory; else its count
    rows alone, the lanes read where they lie; else 1024 cells a tile
    with every row read where it lies."""
    for stage_lanes in ((1, 0) if L else (0,)):
        cells = _FIRE_CELLS
        while cells >= _FIRE_MIN_STAGED:
            tile_rows = (cells + W - 2) // W + 1
            if 4 * _fire_smem_words(cells, tile_rows, ring, L, cols, True,
                                    bool(stage_lanes)) <= _FIRE_SMEM:
                return FirePlan(cells, tile_rows, 1, stage_lanes)
            cells //= 2
    return FirePlan(_FIRE_CELLS, (_FIRE_CELLS + W - 2) // W + 1, 0, 0)


def _live_columns(end_panes: torch.Tensor, ring: int, pane_lo: int,
                 pane_hi: int, ppw: int) -> torch.Tensor:
    """(W, ring) bool: ring column c holds a pane of window w inside
    ``[pane_lo, pane_hi]`` (the reference fire's column mask)."""
    dev = end_panes.device
    want = end_panes[:, None] - ppw + torch.arange(
        ppw, dtype=torch.int64, device=dev)[None, :]                  # (W, ppw)
    live = (want >= int(pane_lo)) & (want <= int(pane_hi))
    onehot = torch.remainder(want, ring)[:, :, None] == torch.arange(
        ring, dtype=torch.int64, device=dev)[None, None, :]
    return (onehot & live[:, :, None]).any(dim=1)


def fire_pack_plain(counts, sums, maxs, mins, end_panes, w_valid, used_mask,
                    pane_lo, pane_hi, ppw, out_cap, packed2, row_offset=0):
    dev = counts.device
    rows, ring = counts.shape
    W = end_panes.numel()
    wc = wk.window_counts_plain(counts, end_panes, w_valid, pane_lo, pane_hi,
                                ppw)
    sel = (wc > 0) & used_mask[:, None] & w_valid[None, :]
    flat = torch.nonzero(sel.reshape(-1)).reshape(-1)              # row-major
    n = flat.numel()
    m = min(n, out_cap)
    flat = flat[:m]
    r, w = flat // W, flat % W
    delta = (end_panes[w] - int(pane_lo)).to(torch.int32)
    cnt = wc[r, w]
    r32 = r.to(torch.int32)
    buf = torch.zeros((out_cap + 1, 2 if packed2 else 3), dtype=torch.int32,
                      device=dev)
    buf[0, 0] = n
    if packed2:
        buf[1:m + 1, 0] = (r32 << 8) | delta
        buf[1:m + 1, 1] = cnt
    else:
        buf[1:m + 1] = torch.stack([r32 + int(row_offset), delta, cnt], dim=1)
    L = _width(sums) + _width(maxs) + _width(mins)
    if not L:
        return buf, None
    colmask = _live_columns(end_panes, ring, pane_lo, pane_hi, ppw)[w]  # (m, ring)
    lanes = torch.zeros((out_cap, L), dtype=torch.float32, device=dev)
    parts = []
    if sums is not None:
        bit = colmask.to(torch.float32)[:, :, None]
        acc = torch.zeros((m, sums.shape[2]), dtype=torch.float32, device=dev)
        for c in range(ring):
            acc = acc + sums[r, c] * bit[:, c]
        parts.append(acc)
    for lane, fill, maximum in ((maxs, -math.inf, True),
                                (mins, math.inf, False)):
        if lane is None:
            continue
        vals = torch.where(colmask[:, :, None], lane[r],
                           torch.full((), fill, device=dev))
        parts.append(_ieee_reduce(vals, 1, maximum))
    lanes[:m] = torch.cat(parts, dim=1)
    return buf, lanes


# -- L2 ------------------------------------------------------------------------

# csrc/lane_kernels.cu's constants (tests/test_torch_scatter_plan.py reads
# them from the source; the entry point rejects a plan that does not
# cover the batch): a sort tile, the widest digit, the most passes, the
# ctrl block's int32 words, a fold thread's sorted places, threads a block
_SORT_TILE = 4096
_MAX_DIGIT_BITS = 8
_MAX_PASSES = 4
_CTRL_INTS = 1088
_FOLD_SPAN = 16
_THREADS = 256
_MAX_BLOCKS = 132 * 8       # window_common.cuh kMaxBlocks
_MAX_RECORDS = (1 << 30) - 1  # a look-back word counts records in 30 bits
_ALIGN = 64                 # int32 words: each workspace region 256-byte aligned


class ScatterPlan(NamedTuple):
    """How ``scatter_lanes`` sorts and folds ``n`` records into
    ``n_cells`` cells: the launch shapes and the workspace (int32 words,
    each region 256-byte aligned). The fold reads each record's lanes
    from the caller's arrays by its index, so no lanes are staged."""
    key_bits: int       # bits of the largest cell index
    passes: int         # stable digit passes, least significant first
    digit_bits: int     # bits a pass (the last may have fewer)
    tiles: int          # tiles of _SORT_TILE records: a hist and a sort block each
    fold_blocks: int
    zero_ints: int      # ctrl block + passes * tiles << digit_bits words
    key_ints: int       # each of keys0, vals0, keys1, vals1: a pass's
                        # cells and record indices
    offsets: Tuple[int, ...]  # keys0, vals0, keys1, vals1
    total_ints: int


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


@functools.lru_cache(maxsize=64)
def _scatter_plan(n: int, n_cells: int) -> ScatterPlan:
    """The plan for ``n`` >= 1 records into ``n_cells`` >= 1 cells: as
    few digit passes of at most 8 bits as cover the cell index's bits,
    the bits spread evenly over them (21 bits: 3 passes of 7)."""
    if not 1 <= n <= _MAX_RECORDS:
        raise ValueError(f"scatter_lanes takes 1 to {_MAX_RECORDS} records "
                         f"a call, got {n}")
    key_bits = max(1, int(n_cells).bit_length())
    passes = -(-key_bits // _MAX_DIGIT_BITS)
    if passes > _MAX_PASSES:
        raise ValueError(f"{n_cells} cells need more than {_MAX_PASSES} "
                         "digit passes")
    digit_bits = -(-key_bits // passes)
    tiles = -(-n // _SORT_TILE)
    fold_blocks = min(-(-n // (_FOLD_SPAN * _THREADS)), _MAX_BLOCKS)
    zero_ints = _CTRL_INTS + passes * (tiles << digit_bits)
    offsets, at = [], _round_up(zero_ints, _ALIGN)
    for _ in range(4):
        offsets.append(at)
        at += _round_up(n, _ALIGN)
    return ScatterPlan(key_bits, passes, digit_bits, tiles, fold_blocks,
                       zero_ints, n, tuple(offsets), at)


# per (device, stream): the int32 workspace the last call needed, grown
# when a batch needs more; work queued on one stream runs in order, so
# calls on it can share one
_workspaces: Dict[Tuple[torch.device, int], torch.Tensor] = {}


def _workspace(dev: torch.device, stream: int, ints: int) -> torch.Tensor:
    key = (dev, stream)
    work = _workspaces.get(key)
    if work is None or work.numel() < ints:
        work = _workspaces[key] = torch.empty(ints, dtype=torch.int32,
                                              device=dev)
    return work


def scatter_lanes(counts: torch.Tensor, sums: Optional[torch.Tensor],
                  maxs: Optional[torch.Tensor], mins: Optional[torch.Tensor],
                  idx: torch.Tensor, s: torch.Tensor, mx: torch.Tensor,
                  mn: torch.Tensor, skip_negative: bool = False,
                  dump_row: Optional[int] = None) -> None:
    """Fold records into the pane state, in place: for record i at flat
    cell ``idx[i]`` (``row * ring + column``), the count adds 1, each sum
    lane adds ``s[i]`` (a cell's records in record order), each max lane
    takes the IEEE maximum with ``mx[i]`` and each min lane the minimum
    with ``mn[i]``. ``s``/``mx``/``mn`` are ``(B, width)`` f32 of the
    state's widths (zero-width where a lane family is None). ``idx`` is
    int32, or int64 for a state of 2^31 cells or more
    (``_scatter_lanes_by_rows``). An index outside the state raises (the kernel skips it and reports it through
    ``error_word``) — except, with ``skip_negative``, a negative index,
    which is an invalid record and touches nothing.

    ``idx`` may instead be the split upload's ``(B, 3)`` uint8 bytes
    (``window_kernels.split_cells``' form) with its ``dump_row``, decoded
    in the same launch by ``split_cells``' rule: exactly
    ``scatter_lanes(..., split_cells(idx, ring, dump_row), ...)``, a slot
    or column outside the state raising as ``split_cells`` does, with no
    cell array and no ``split_cells`` launch."""
    if idx.dtype is torch.int64:
        _check_lanes(counts, sums, maxs, mins)
        wk.check_tensor(idx, "idx", torch.int64, 1)
        return _scatter_lanes_by_rows(counts, sums, maxs, mins, idx, s, mx,
                                      mn, skip_negative)
    split = idx.dtype is torch.uint8
    index = wk.fast_index((counts, torch.int32, 2), (sums, torch.float32, 3),
                          (maxs, torch.float32, 3), (mins, torch.float32, 3),
                          (idx, torch.uint8, 2) if split
                          else (idx, torch.int32, 1), (s, torch.float32, 2),
                          (mx, torch.float32, 2), (mn, torch.float32, 2))
    _check_lanes(counts, sums, maxs, mins, index is not None)
    if split:
        _check_split(counts, idx, dump_row, index is None)
    elif index is None:
        wk.check_tensor(idx, "idx", torch.int32, 1)
    B = idx.shape[0]
    for name, t, lane in (("s", s, sums), ("mx", mx, maxs), ("mn", mn, mins)):
        if index is None:
            wk.check_tensor(t, name, torch.float32, 2)
        if t.shape != (B, _width(lane)):
            raise ValueError(f"{name} {tuple(t.shape)} must be ({B}, "
                             f"{_width(lane)})")
    if index is None:
        if not wk.on_cuda("scatter_lanes", counts, sums, maxs, mins, idx, s,
                          mx, mn):
            if split:
                idx = wk.split_cells_plain(idx, counts.shape[1], dump_row)
            return scatter_lanes_plain(counts, sums, maxs, mins, idx, s, mx,
                                       mn, skip_negative)
        index = counts.get_device()
    if B == 0:
        return None
    dev = counts.device
    sw, mw, nw = _width(sums), _width(maxs), _width(mins)
    plan = _scatter_plan(B, counts.numel())
    err, stream = wk.launch_context(index)
    work = _workspace(dev, stream, plan.total_ints)
    base = work.data_ptr()
    k0, v0, k1, v1 = (base + 4 * off for off in plan.offsets)
    _SCATTER_LANES(stream, counts.data_ptr(), _ptr(sums), sw,
                   _ptr(maxs), mw, _ptr(mins), nw, counts.numel(),
                   idx.data_ptr(), s.data_ptr(), mx.data_ptr(), mn.data_ptr(),
                   B, int(bool(skip_negative)), plan.passes, plan.digit_bits,
                   plan.tiles, plan.fold_blocks, base, plan.zero_ints, k0, v0,
                   k1, v1, err, counts.shape[1] if split else 0,
                   int(dump_row) if split else 0)
    return None


def _check_split(counts: torch.Tensor, idx: torch.Tensor,
                 dump_row: Optional[int], full: bool) -> None:
    """The split form's own checks (``full``: the tensor's dtype, rank and
    layout too): ``(B, 3)`` bytes and a dump row below the state's rows
    and 0xFFFF, over a ring of at most 256 columns."""
    if full:
        wk.check_tensor(idx, "idx", torch.uint8, 2)
    if idx.shape[1] != 3:
        raise ValueError(f"a split upload is (B, 3) bytes, got "
                         f"{tuple(idx.shape)}")
    rows, ring = counts.shape
    if dump_row is None or not 1 <= ring <= 256 \
            or not 0 <= dump_row < min(rows, wk.INVALID_SLOT_U16):
        raise ValueError(f"a split upload needs ring <= 256 and a dump_row "
                         f"below the rows and 0xFFFF, got ring {ring}, "
                         f"dump_row {dump_row}, rows {rows}")


# cells of the state block one launch addresses with int32 cells (an
# int64 upload goes through in blocks of rows below it)
CELL_BLOCK = 2 ** 31


def _scatter_lanes_by_rows(counts, sums, maxs, mins, idx, s, mx, mn,
                           skip_negative):
    """``scatter_lanes`` with int64 cells: the state in blocks of rows of
    fewer than ``CELL_BLOCK`` cells, each block's records as int32 cells
    of the block (-1, skipped, elsewhere), one call a block. A cell's
    records all fall in one block and keep their order, so every lane
    folds as in one call. An entry outside the state (or negative without
    ``skip_negative``) goes to the first block past its end, where it
    raises as it would in one call."""
    rows, ring = counts.shape
    per = max(1, (CELL_BLOCK - 1) // max(ring, 1))
    bad = idx >= rows * ring
    if not skip_negative:
        bad |= idx < 0
    for r0 in range(0, rows, per):
        r1 = min(rows, r0 + per)
        lo, hi = r0 * ring, r1 * ring
        local = torch.where((idx >= lo) & (idx < hi), idx - lo,
                            torch.full_like(idx, -1))
        if r0 == 0:
            local = torch.where(bad, torch.full_like(idx, _I32_MAX), local)
        scatter_lanes(counts[r0:r1], None if sums is None else sums[r0:r1],
                      None if maxs is None else maxs[r0:r1],
                      None if mins is None else mins[r0:r1],
                      local.to(torch.int32), s, mx, mn, skip_negative=True)
    return None


def scatter_lanes_plain(counts, sums, maxs, mins, idx, s, mx, mn,
                        skip_negative=False):
    if skip_negative:
        ok = idx >= 0
        idx, s, mx, mn = idx[ok], s[ok], mx[ok], mn[ok]
    if idx.numel() and (int(idx.min()) < 0 or int(idx.max()) >= counts.numel()):
        wk.raise_for_error_bits(8)
    ix = idx.long()
    counts.view(-1).index_add_(
        0, ix, torch.ones(ix.numel(), dtype=torch.int32, device=idx.device))
    cells = counts.numel()
    if sums is not None:
        # index_add_ on the CPU adds in index order: a cell's records in
        # record order
        sums.view(cells, -1).index_add_(0, ix, s)
    for lane, vals, maximum in ((maxs, mx, True), (mins, mn, False)):
        if lane is None:
            continue
        nan_key = _I32_MAX if maximum else _I32_MIN
        key = ordered_key(lane.view(cells, -1), nan_key)
        key.scatter_reduce_(0, ix[:, None].expand_as(vals),
                            ordered_key(vals, nan_key),
                            "amax" if maximum else "amin")
        lane.view(cells, -1).copy_(from_ordered_key(key))
    return None


# -- L3 ------------------------------------------------------------------------

def scatter_pair_lanes(counts: torch.Tensor, sums: Optional[torch.Tensor],
                       buf: torch.Tensor) -> None:
    """Fold host-combined pair rows into the state, in place. ``buf`` is
    ``(P, 2 + S)`` int32 rows ``[pair, count, f32 bits of each sum
    lane]`` (``flink_tpu``'s ``preagg_encode_i32`` layout) with pair =
    ``row * ring + column``, distinct within one call; pair < 0 marks
    padding. A pair outside the state raises (the kernel skips it and
    reports it through ``error_word``)."""
    cs, bs = counts.shape, buf.shape
    ss = sums.shape if sums is not None else (0, 0, 0)
    sw = ss[-1]
    index = counts.get_device()
    # the lean launch path: one combined test, the detailed checks (and
    # their messages) only when it fails
    if not (counts.dtype is torch.int32 and buf.dtype is torch.int32
            and len(cs) == 2 and len(bs) == 2 and bs[1] == 2 + sw
            and counts.is_contiguous() and buf.is_contiguous()
            and buf.get_device() == index
            and (sums is None or (
                sums.dtype is torch.float32 and len(ss) == 3
                and ss[0] == cs[0] and ss[1] == cs[1]
                and sums.is_contiguous() and sums.get_device() == index))):
        _pair_lanes_checks(counts, sums, buf, sw)
    if index < 0:
        wk.on_cuda("scatter_pair_lanes", counts, sums, buf)
        return scatter_pair_lanes_plain(counts, sums, buf)
    n_cells, P = cs[0] * cs[1], bs[0]
    if P == 0:
        return None
    if P >= 2 ** 31:
        raise ValueError("scatter_pair_lanes: 2^31 rows or more a call")
    err, stream = wk.launch_context(index)
    global _pair_fn
    if _pair_fn is None:
        _pair_fn = _lib().lk_scatter_pair_lanes
    rc = _pair_fn(_PAIR_ARGS.pack(
        counts.data_ptr(), sums.data_ptr() if sw else 0, sw, n_cells,
        buf.data_ptr(), P, 2 + sw, err), stream)
    if rc != 0:
        raise RuntimeError(f"scatter_pair_lanes: CUDA launch failed ({rc}: "
                           f"{_lib().lk_error_string(rc).decode()})")
    wk.LAUNCHES["scatter_pair_lanes"] += 1
    return None


def _pair_lanes_checks(counts, sums, buf, sw) -> None:
    """``scatter_pair_lanes``' checks one by one: raises with the first
    that fails."""
    wk.check_tensor(counts, "counts", torch.int32, 2)
    wk.check_tensor(buf, "buf", torch.int32, 2)
    if sums is not None:
        _check_lanes(counts, sums, None, None)
    if buf.shape[1] != 2 + sw:
        raise ValueError(f"buf has {buf.shape[1]} columns, expected {2 + sw}")
    wk.on_cuda("scatter_pair_lanes", counts, sums, buf)


def scatter_pair_lanes_plain(counts, sums, buf):
    ok = buf[:, 0] >= 0
    rows = buf[ok]
    pair = rows[:, 0].long()
    if pair.numel() and int(pair.max()) >= counts.numel():
        wk.raise_for_error_bits(16)
    counts.view(-1).index_add_(0, pair, rows[:, 1])
    if sums is not None:
        sums.view(counts.numel(), -1).index_add_(
            0, pair, rows[:, 2:].contiguous().view(torch.float32))
    return None
