"""Top-n fires over lane aggregates: a CUDA kernel each
(``csrc/topn_lanes_kernels.cu``) and a plain PyTorch version each, with
the same signature.

- ``window_lanes`` (TA): the sum / max / min lanes of every (row,
  window) cell of a fire — the lane half of the reference's
  ``fire_kernel`` over the whole grid.
- ``topn_select_lanes`` (TB): per window, the n-th largest value of a
  ranking grid (any result field), selection with ties, and the append
  of each winner with its result columns to the emit ring — the
  reference's ``_ring_append_topn_core`` + ``_topn_select_append`` for
  any aggregate.

- ``topn_candidates_lanes`` (TC) and ``topn_select_lanes_given`` (TD):
  the same over a device mesh (the reference's ``topn_shard`` for any
  result field): each block's top-k candidates a window, gathered
  across the blocks into one (W, blocks * k) buffer, then each block's
  selection against the k-th of its window's gathered row, appended to
  its own emit ring with its first global row as the offset.

The aggregate's finalize runs between the two, in torch, on the grid.
Count-only top-n is ``window_kernels.topn_select_append``, whose kernels
share TB's bodies (``csrc/topn_select.cuh``).

As in ``window_kernels.py``: a wrapper takes the plain version only for
tensors on the CPU and launches the kernel (or raises) for CUDA
tensors; ``window_kernels.LAUNCHES`` counts the launches.

Floats: a window's sum adds the ring columns in column order, each
times its 0/1 live bit (``fire_pack``'s order), so the kernel, the
plain version and ``fire_pack`` agree bit for bit; the reference's GEMM
may associate differently, a rounding or two. Max and min are IEEE
maximum / minimum (NaN wins, -0 < +0). The threshold ranks in IEEE
total order, as ``lax.top_k`` does (-NaN < -inf < -0 < +0 < +inf <
+NaN), and a candidate is selected when ``v >= threshold`` as an IEEE
comparison: a NaN threshold selects nothing, -0 and +0 tie.
"""
from __future__ import annotations

import ctypes
import functools
import math
import struct
from typing import NamedTuple, Optional, Tuple

import torch

from flink_tpu_torch.kernels import lane_kernels as lk
from flink_tpu_torch.kernels import window_kernels as wk

_SIGNATURES = {
    "tl_window_lanes": [ctypes.c_char_p, ctypes.c_void_p],
    "tl_error_string": [ctypes.c_int],
}


def _lib() -> ctypes.CDLL:
    return wk.load_library("topn_lanes_kernels", _SIGNATURES, "tl_error_string")


_TOPN_SELECT_LANES = wk.LeanEntry(_lib, "tl_topn_select_lanes",
                                  "topn_select_lanes", 18, "tl_error_string")
_TOPN_CANDIDATES_LANES = wk.LeanEntry(
    _lib, "tl_topn_candidates_lanes", "topn_candidates_lanes", 14,
    "tl_error_string")
_TOPN_SELECT_LANES_GIVEN = wk.LeanEntry(
    _lib, "tl_topn_select_lanes_given", "topn_select_lanes_given", 21,
    "tl_error_string")


def _check_fire_args(end_panes: torch.Tensor, w_valid: torch.Tensor) -> None:
    wk.check_tensor(end_panes, "end_panes", torch.int64, 1)
    wk.check_tensor(w_valid, "w_valid", torch.bool, 1)
    if w_valid.numel() != end_panes.numel():
        raise ValueError("w_valid and end_panes differ in length")


# -- TA ------------------------------------------------------------------------

# csrc/topn_lanes_kernels.cu's launch limits (tests/test_torch_topn_lanes.py
# reads them from the source; the entry point rejects a plan past them):
# outputs a block, windows a block, f32 words of the staged tile
_LANES_OUT = 256
_LANES_WINDOWS = 64
_LANES_SMEM_FLOATS = 11264
_LANES_TILE_ROWS = 128
# window_lanes' entry point, resolved at its first launch, and its
# argument block (csrc/topn_lanes_kernels.cu LanesArgs)
_lanes_fn = None
_LANES_ARGS = struct.Struct("<21q")


class LanesPlan(NamedTuple):
    """How ``window_lanes`` cuts its work into blocks. The staged-tile
    form (rings past 64 columns): rows a tile, windows and lanes a block
    (one output a thread), ring columns a staged chunk. The register
    form (up to 64 columns) reads only ``win_group``, the windows a
    block."""
    tile_rows: int
    win_group: int
    lane_group: int
    col_chunk: int


@functools.lru_cache(maxsize=256)
def _lanes_plan(ring: int, W: int, L: int) -> LanesPlan:
    """The plan for ``ring`` columns, ``W`` windows and ``L`` lanes: at
    most 64 windows and 256 outputs a block, as many rows a tile as that
    leaves (up to 128), and the whole ring staged at once when a tile of
    it fits in shared memory; else one row a tile and the ring in
    chunks."""
    win_group = min(W, _LANES_WINDOWS)
    lane_group = min(L, max(1, _LANES_OUT // win_group))
    tile_rows = max(1, min(_LANES_TILE_ROWS,
                           _LANES_OUT // (win_group * lane_group)))
    # a row of the staged tile: the chunk's columns of each group lane,
    # each family's stride made odd
    stride = ring * lane_group + 3
    if stride <= _LANES_SMEM_FLOATS:
        return LanesPlan(min(tile_rows, _LANES_SMEM_FLOATS // stride),
                         win_group, lane_group, ring)
    return LanesPlan(1, win_group, lane_group,
                     (_LANES_SMEM_FLOATS - 3) // lane_group)


def window_lanes(sums: Optional[torch.Tensor], maxs: Optional[torch.Tensor],
                 mins: Optional[torch.Tensor], end_panes: torch.Tensor,
                 w_valid: torch.Tensor, pane_lo: int, pane_hi: int, ppw: int,
                 rows: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Each (row, window) cell's lanes: ``(rows, W, S)`` sums over the
    window's live ring columns (added in column order, each times its
    0/1 live bit), ``(rows, W, M)`` IEEE maxes and ``(rows, W, N)`` IEEE
    mins over them (-inf / +inf when none). Column c is live for window
    w when it holds a pane of ``[end_w - ppw, end_w)`` ∩ ``[pane_lo,
    pane_hi]``; an invalid window gets 0 sums and the identities. A lane
    family that is None gives a zero-width result. On the card the three
    results are views of one allocation."""
    es, vs = end_panes.shape, w_valid.shape
    index = end_panes.get_device()
    ring, widths, ok = -1, [], (
        end_panes.dtype is torch.int64 and w_valid.dtype is torch.bool
        and len(es) == 1 and len(vs) == 1 and vs[0] == es[0]
        and end_panes.is_contiguous() and w_valid.is_contiguous()
        and w_valid.get_device() == index)
    for t in (sums, maxs, mins):
        if t is None:
            widths.append(0)
            continue
        ts = t.shape
        if not (t.dtype is torch.float32 and len(ts) == 3 and ts[0] == rows
                and (ring < 0 or ts[1] == ring) and t.is_contiguous()
                and t.get_device() == index):
            ok = False
            break
        ring = ts[1]
        widths.append(ts[2])
    # the lean launch path: one combined test, the detailed checks (and
    # their messages) only when it fails
    if not ok:
        _window_lanes_checks(sums, maxs, mins, end_panes, w_valid, rows)
    if index < 0:
        wk.on_cuda("window_lanes", sums, maxs, mins, end_panes, w_valid)
        return window_lanes_plain(sums, maxs, mins, end_panes, w_valid,
                                  pane_lo, pane_hi, ppw, rows)
    W = es[0]
    sw, mw, nw = widths
    L = sw + mw + nw
    buf = torch.empty(rows * W * L, dtype=torch.float32,
                      device=end_panes.device)
    n_s, n_x = rows * W * sw, rows * W * mw
    outs = (buf.as_strided((rows, W, sw), (W * sw, sw, 1), 0),
            buf.as_strided((rows, W, mw), (W * mw, mw, 1), n_s),
            buf.as_strided((rows, W, nw), (W * nw, nw, 1), n_s + n_x))
    if not (L and rows and W):
        return outs
    plan = _lanes_plan(ring, W, L)
    _, stream = wk.launch_context(index)
    global _lanes_fn
    if _lanes_fn is None:
        _lanes_fn = _lib().tl_window_lanes
    base = buf.data_ptr()
    rc = _lanes_fn(_LANES_ARGS.pack(
        sums.data_ptr() if sw else 0, maxs.data_ptr() if mw else 0,
        mins.data_ptr() if nw else 0, sw, mw, nw, rows, ring,
        end_panes.data_ptr(), w_valid.data_ptr(), W, int(pane_lo),
        int(pane_hi), int(ppw), base, base + 4 * n_s, base + 4 * (n_s + n_x),
        *plan), stream)
    if rc != 0:
        raise RuntimeError(f"window_lanes: CUDA launch failed ({rc}: "
                           f"{_lib().tl_error_string(rc).decode()})")
    wk.LAUNCHES["window_lanes"] += 1
    return outs


def _window_lanes_checks(sums, maxs, mins, end_panes, w_valid, rows) -> None:
    """``window_lanes``' checks one by one: raises with the first that
    fails."""
    for name, t in (("sums", sums), ("maxs", maxs), ("mins", mins)):
        if t is not None:
            wk.check_tensor(t, name, torch.float32, 3)
            if t.shape[0] != rows:
                raise ValueError(f"{name} has {t.shape[0]} rows, not {rows}")
    _check_fire_args(end_panes, w_valid)
    lanes = [t for t in (sums, maxs, mins) if t is not None]
    if len({t.shape[1] for t in lanes}) > 1:
        raise ValueError("sums/maxs/mins differ in ring size")
    wk.on_cuda("window_lanes", sums, maxs, mins, end_panes, w_valid)


def window_lanes_plain(sums, maxs, mins, end_panes, w_valid, pane_lo,
                       pane_hi, ppw, rows):
    dev = end_panes.device
    W = end_panes.numel()
    lanes = [t for t in (sums, maxs, mins) if t is not None]
    if not lanes:
        return tuple(torch.zeros((rows, W, 0), dtype=torch.float32, device=dev)
                     for _ in range(3))
    ring = lanes[0].shape[1]
    colmask = lk._live_columns(end_panes, ring, pane_lo, pane_hi, ppw) \
        & w_valid[:, None]                                        # (W, ring)
    out = []
    if sums is None:
        out.append(torch.zeros((rows, W, 0), dtype=torch.float32, device=dev))
    else:
        bit = colmask.to(torch.float32)[None, :, :, None]         # (1, W, ring, 1)
        acc = torch.zeros((rows, W, sums.shape[2]), dtype=torch.float32,
                          device=dev)
        for c in range(ring):
            acc = acc + sums[:, None, c, :] * bit[:, :, c]
        out.append(torch.where(w_valid[None, :, None], acc,
                               torch.zeros((), device=dev)))
    for lane, fill, maximum in ((maxs, -math.inf, True),
                                (mins, math.inf, False)):
        if lane is None:
            out.append(torch.zeros((rows, W, 0), dtype=torch.float32,
                                   device=dev))
            continue
        vals = torch.where(colmask[None, :, :, None], lane[:, None, :, :],
                           torch.full((), fill, device=dev))  # (rows, W, ring, ·)
        out.append(lk._ieee_reduce(vals, 2, maximum))
    return tuple(out)


# -- TB ------------------------------------------------------------------------

def total_order_key(x: torch.Tensor) -> torch.Tensor:
    """int32 keys of f32 values whose integer order is IEEE total order
    (-NaN < -inf < -0 < +0 < +inf < +NaN)."""
    b = x.contiguous().view(torch.int32)
    return torch.where(b >= 0, b, b ^ 0x7FFFFFFF)


def from_total_order_key(key: torch.Tensor) -> torch.Tensor:
    return torch.where(key >= 0, key, key ^ 0x7FFFFFFF).view(torch.float32)


def topn_select_lanes(wcounts: torch.Tensor, v: torch.Tensor,
                      cols: torch.Tensor, used_mask: torch.Tensor,
                      end_panes: torch.Tensor, w_valid: torch.Tensor,
                      anchor: int, n: int, sel_cap: int,
                      emit_ring: torch.Tensor) -> torch.Tensor:
    """Select each window's top-``n`` cells by the ranking grid ``v``
    and append them to ``emit_ring`` in row-major (row, window) order,
    in place.

    Candidates: ``wcounts > 0`` on a ``used_mask`` row of a valid
    window. A window's threshold is the k-th largest ``v`` of its column
    in IEEE total order, k = min(n, rows), non-candidates ranked as
    -inf (so a window with fewer than n candidates gets -inf); a
    candidate is selected when ``v >= threshold`` (IEEE). Appended rows
    are ``[row, end_pane - anchor, count, cols[row, w, :]...]`` (``cols``
    ``(rows, W, F)`` int32: int results as int32, float results as f32
    bits) at ``(total + i) % row_cap + 1`` for the first ``sel_cap``
    selected cells; then head ``[0, 0] += written`` and ``[0, 1] +=
    selected - written``. The last row of the ring is never written."""
    index = wk.fast_index((wcounts, torch.int32, 2), (v, torch.float32, 2),
                          (cols, torch.int32, 3), (used_mask, torch.bool, 1),
                          (end_panes, torch.int64, 1), (w_valid, torch.bool, 1),
                          (emit_ring, torch.int32, 2))
    if index is None:
        wk.check_tensor(wcounts, "wcounts", torch.int32, 2)
        wk.check_tensor(v, "v", torch.float32, 2)
        wk.check_tensor(cols, "cols", torch.int32, 3)
        wk.check_tensor(used_mask, "used_mask", torch.bool, 1)
        _check_fire_args(end_panes, w_valid)
        wk.check_tensor(emit_ring, "emit_ring", torch.int32, 2)
    elif w_valid.numel() != end_panes.numel():
        raise ValueError("w_valid and end_panes differ in length")
    rows, W = wcounts.shape
    F = cols.shape[2]
    if v.shape != wcounts.shape or cols.shape[:2] != wcounts.shape:
        raise ValueError("v/cols do not match wcounts")
    if used_mask.numel() != rows or end_panes.numel() != W:
        raise ValueError("used_mask/end_panes do not match wcounts")
    if emit_ring.shape[1] != 3 + F or emit_ring.shape[0] < 3:
        raise ValueError(f"emit_ring must be (row_cap + 2, {3 + F}), got "
                         f"{tuple(emit_ring.shape)}")
    if n < 1 or sel_cap < 1:
        raise ValueError("n and sel_cap must be >= 1")
    if index is None:
        if not wk.on_cuda("topn_select_lanes", wcounts, v, cols, used_mask,
                          end_panes, w_valid, emit_ring):
            return topn_select_lanes_plain(wcounts, v, cols, used_mask,
                                           end_panes, w_valid, anchor, n,
                                           sel_cap, emit_ring)
        index = wcounts.get_device()
    _, stream = wk.launch_context(index)
    work = wk.select_workspace("topn_select_lanes", index, stream, rows, W)
    try:
        _TOPN_SELECT_LANES(stream, wcounts.data_ptr(), v.data_ptr(),
                           cols.data_ptr(), F, rows, W, used_mask.data_ptr(),
                           end_panes.data_ptr(), w_valid.data_ptr(),
                           int(anchor), min(int(n), rows), int(sel_cap),
                           emit_ring.data_ptr(), emit_ring.shape[0],
                           emit_ring.shape[1], *work)
    except RuntimeError:
        wk.drop_workspace("topn_select_lanes", index, stream)
        raise
    return emit_ring


def topn_select_lanes_plain(wcounts, v, cols, used_mask, end_panes, w_valid,
                            anchor, n, sel_cap, emit_ring):
    rows, W = wcounts.shape
    dev = wcounts.device
    cand = (wcounts > 0) & used_mask[:, None] & w_valid[None, :]
    neg_inf = total_order_key(torch.full((1,), -math.inf, device=dev))
    key = torch.where(cand, total_order_key(v), neg_inf)
    k = min(n, rows)
    thresh = from_total_order_key(
        torch.topk(key.T, k, dim=1).values[:, k - 1].contiguous())   # (W,)
    flat = torch.nonzero((cand & (v >= thresh[None, :])).reshape(-1))
    flat = flat.reshape(-1)                                        # row-major
    total_sel = flat.numel()
    m = min(total_sel, sel_cap)
    r = flat[:m] // W
    w = flat[:m] % W
    row_cap = emit_ring.shape[0] - 2
    total = int(emit_ring[0, 0])
    pos = (total + torch.arange(m, device=dev)) % row_cap + 1
    emit_ring[pos] = torch.cat(
        [torch.stack([r.to(torch.int32),
                      (end_panes[w] - int(anchor)).to(torch.int32),
                      wcounts[r, w]], dim=1), cols[r, w]], dim=1)
    emit_ring[0, 0] = total + m
    emit_ring[0, 1] += total_sel - m
    return emit_ring


# -- TC / TD: the key-sharded top-n over lanes -----------------------------------

def _masked_keys(wcounts: torch.Tensor, v: torch.Tensor,
                 used_mask: torch.Tensor, w_valid: torch.Tensor) -> torch.Tensor:
    """(rows, W) total-order keys of the ranking grid, a non-candidate
    keyed as -inf (the reference's ``where(nz, v, -inf)``)."""
    cand = (wcounts > 0) & used_mask[:, None] & w_valid[None, :]
    return total_order_key(torch.where(
        cand, v, torch.full((), -math.inf, device=v.device)))


def topn_candidates_lanes(wcounts: torch.Tensor, v: torch.Tensor,
                          used_mask: torch.Tensor, w_valid: torch.Tensor,
                          k: int, out: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """(W, k) f32: each window's top ``k`` values of the ranking grid ``v``
    among its candidates (``wcounts > 0`` on a ``used_mask`` row of a
    valid window), descending in IEEE total order, each as often as it
    occurs; non-candidates rank as -inf, so -inf pads a window past its
    candidates (a -NaN candidate ranks below that padding, as
    ``lax.top_k`` ranks it). ``out``: as ``window_kernels.topn_candidates``'
    (a block's columns of the gathered buffer)."""
    index = wk.fast_index((wcounts, torch.int32, 2), (v, torch.float32, 2),
                          (used_mask, torch.bool, 1), (w_valid, torch.bool, 1))
    if index is None:
        wk.check_tensor(wcounts, "wcounts", torch.int32, 2)
        wk.check_tensor(v, "v", torch.float32, 2)
        wk.check_tensor(used_mask, "used_mask", torch.bool, 1)
        wk.check_tensor(w_valid, "w_valid", torch.bool, 1)
    rows, W = wcounts.shape
    if v.shape != wcounts.shape:
        raise ValueError("v does not match wcounts")
    if used_mask.numel() != rows or w_valid.numel() != W:
        raise ValueError("used_mask/w_valid do not match wcounts")
    if not 1 <= k <= rows:
        raise ValueError(f"topn_candidates_lanes needs 1 <= k <= rows, got {k}")
    if out is not None and (out.dtype is not torch.float32
                            or tuple(out.shape) != (W, k)
                            or out.stride(1) != 1 or out.stride(0) < k
                            or out.device != wcounts.device):
        raise ValueError(
            f"out must be a (W, k) = ({W}, {k}) float32 view with unit "
            f"column stride on {wcounts.device}, got {tuple(out.shape)} "
            f"{out.dtype} strides {out.stride()} on {out.device}")
    if index is None:
        if not wk.on_cuda("topn_candidates_lanes", wcounts, v, used_mask,
                          w_valid):
            cand = topn_candidates_lanes_plain(wcounts, v, used_mask,
                                               w_valid, k)
            return cand if out is None else out.copy_(cand)
        index = wcounts.get_device()
    cand = (torch.empty((W, k), dtype=torch.float32, device=wcounts.device)
            if out is None else out)
    _, stream = wk.launch_context(index)
    work = wk.select_workspace("topn_candidates_lanes", index, stream, rows, W)
    words = wk.candidates_plan(rows, W, k).list_words if k > 1 else 0
    _held, lst = wk.scratch(wcounts.device, words) if words else (None, 0)
    try:
        _TOPN_CANDIDATES_LANES(stream, wcounts.data_ptr(), v.data_ptr(), rows,
                               W, used_mask.data_ptr(), w_valid.data_ptr(),
                               int(k), cand.data_ptr(), cand.stride(0), lst,
                               words, *work)
    except RuntimeError:
        wk.drop_workspace("topn_candidates_lanes", index, stream)
        raise
    return cand


def topn_candidates_lanes_plain(wcounts, v, used_mask, w_valid, k):
    key = _masked_keys(wcounts, v, used_mask, w_valid)
    return from_total_order_key(torch.topk(key.T, k, dim=1).values)


def topn_select_lanes_given(wcounts: torch.Tensor, v: torch.Tensor,
                            cols: torch.Tensor, used_mask: torch.Tensor,
                            end_panes: torch.Tensor, w_valid: torch.Tensor,
                            anchor: int, cands: torch.Tensor, k: int,
                            row_offset: int, sel_cap: int,
                            emit_ring: torch.Tensor) -> torch.Tensor:
    """``topn_select_lanes`` against the gathered ``(W, M)`` candidates:
    window w's threshold is the ``k``-th largest of its row in IEEE total
    order, ties counted, worked out in the kernel's own launch; a
    candidate with ``v >= threshold`` (IEEE) is appended in row-major
    (row, window) order as ``[row + row_offset, end_pane - anchor, count,
    cols[row, w, :]...]``, the head moved as ``topn_select_lanes`` moves
    it. At most SEL_WIN_TABLE windows. In place; returns ``emit_ring``."""
    index = wk.fast_index((wcounts, torch.int32, 2), (v, torch.float32, 2),
                          (cols, torch.int32, 3), (used_mask, torch.bool, 1),
                          (end_panes, torch.int64, 1), (w_valid, torch.bool, 1),
                          (cands, torch.float32, 2),
                          (emit_ring, torch.int32, 2))
    if index is None:
        wk.check_tensor(wcounts, "wcounts", torch.int32, 2)
        wk.check_tensor(v, "v", torch.float32, 2)
        wk.check_tensor(cols, "cols", torch.int32, 3)
        wk.check_tensor(used_mask, "used_mask", torch.bool, 1)
        _check_fire_args(end_panes, w_valid)
        wk.check_tensor(cands, "cands", torch.float32, 2)
        wk.check_tensor(emit_ring, "emit_ring", torch.int32, 2)
    elif w_valid.numel() != end_panes.numel():
        raise ValueError("w_valid and end_panes differ in length")
    rows, W = wcounts.shape
    F = cols.shape[2]
    if v.shape != wcounts.shape or cols.shape[:2] != wcounts.shape:
        raise ValueError("v/cols do not match wcounts")
    if used_mask.numel() != rows or end_panes.numel() != W \
            or cands.shape[0] != W:
        raise ValueError("used_mask/end_panes/cands do not match wcounts")
    if W > wk.SEL_WIN_TABLE:
        raise ValueError(f"topn_select_lanes_given takes at most "
                         f"{wk.SEL_WIN_TABLE} windows (one selection tile's "
                         f"table), got {W}")
    if not 1 <= k <= cands.shape[1]:
        raise ValueError(f"topn_select_lanes_given needs 1 <= k <= "
                         f"{cands.shape[1]}, got {k}")
    if emit_ring.shape[1] != 3 + F or emit_ring.shape[0] < 3:
        raise ValueError(f"emit_ring must be (row_cap + 2, {3 + F}), got "
                         f"{tuple(emit_ring.shape)}")
    if sel_cap < 1 or row_offset < 0:
        raise ValueError("sel_cap must be >= 1 and row_offset >= 0")
    if index is None:
        if not wk.on_cuda("topn_select_lanes_given", wcounts, v, cols,
                          used_mask, end_panes, w_valid, cands, emit_ring):
            return topn_select_lanes_given_plain(
                wcounts, v, cols, used_mask, end_panes, w_valid, anchor,
                cands, k, row_offset, sel_cap, emit_ring)
        index = wcounts.get_device()
    _, stream = wk.launch_context(index)
    work = wk.select_workspace("topn_select_lanes_given", index, stream, rows,
                               W)
    try:
        _TOPN_SELECT_LANES_GIVEN(
            stream, wcounts.data_ptr(), v.data_ptr(), cols.data_ptr(), F,
            rows, W, used_mask.data_ptr(), end_panes.data_ptr(),
            w_valid.data_ptr(), int(anchor), int(k), int(sel_cap),
            emit_ring.data_ptr(), emit_ring.shape[0], emit_ring.shape[1],
            *work, cands.data_ptr(), cands.shape[1], int(row_offset))
    except RuntimeError:
        wk.drop_workspace("topn_select_lanes_given", index, stream)
        raise
    return emit_ring


def topn_select_lanes_given_plain(wcounts, v, cols, used_mask, end_panes,
                                  w_valid, anchor, cands, k, row_offset,
                                  sel_cap, emit_ring):
    thresh = from_total_order_key(
        torch.topk(total_order_key(cands), k, dim=1).values[:, k - 1]
        .contiguous())                                             # (W,)
    cand = (wcounts > 0) & used_mask[:, None] & w_valid[None, :]
    wk._ring_append(wcounts, cand & (v >= thresh[None, :]), end_panes,
                    anchor, row_offset, sel_cap, emit_ring, cols)
    return emit_ring
