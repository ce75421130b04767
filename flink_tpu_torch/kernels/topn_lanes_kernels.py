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

The aggregate's finalize runs between the two, in torch, on the grid.
Count-only top-n keeps ``window_kernels.topn_select_append``.

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
import math
from typing import Optional, Tuple

import torch

from flink_tpu_torch.kernels import lane_kernels as lk
from flink_tpu_torch.kernels import window_kernels as wk

_P = ctypes.c_void_p
_I32 = ctypes.c_int32
_I64 = ctypes.c_int64
_SIGNATURES = {
    "tl_window_lanes": [_P, _I32, _P, _I32, _P, _I32, _I64, _I32, _P, _P, _I32,
                        _I64, _I64, _I32, _P, _P, _P, _P],
    "tl_topn_select_lanes": [_P, _P, _P, _I32, _I64, _I32, _P, _P, _P, _I64,
                             _I32, _I32, _P, _I32, _I32, _P, _P, _P, _P],
    "tl_tile": [],
    "tl_error_string": [ctypes.c_int],
}


def _lib() -> ctypes.CDLL:
    return wk.load_library("topn_lanes_kernels", _SIGNATURES, "tl_error_string")


def _launch(name: str, fn: str, *args) -> None:
    wk.launch(_lib(), "tl_error_string", name, fn, *args)


def _check_fire_args(end_panes: torch.Tensor, w_valid: torch.Tensor) -> None:
    wk.check_tensor(end_panes, "end_panes", torch.int64, 1)
    wk.check_tensor(w_valid, "w_valid", torch.bool, 1)
    if w_valid.numel() != end_panes.numel():
        raise ValueError("w_valid and end_panes differ in length")


# -- TA ------------------------------------------------------------------------

def window_lanes(sums: Optional[torch.Tensor], maxs: Optional[torch.Tensor],
                 mins: Optional[torch.Tensor], end_panes: torch.Tensor,
                 w_valid: torch.Tensor, pane_lo: int, pane_hi: int, ppw: int,
                 rows: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Each (row, window) cell's lanes: ``(rows, W, S)`` sums over the
    window's live ring columns (added in column order, each times its
    0/1 live bit), ``(rows, W, M)`` IEEE maxes and ``(rows, W, N)`` IEEE
    mins over them (-inf / +inf when none). Column c is live for window
    w when it holds a pane of ``[end_w - ppw, end_w)`` ∩ ``[pane_lo,
    pane_hi]``; an invalid window gets the identities. A lane family
    that is None gives a zero-width result."""
    for name, t in (("sums", sums), ("maxs", maxs), ("mins", mins)):
        if t is not None:
            wk.check_tensor(t, name, torch.float32, 3)
            if t.shape[0] != rows:
                raise ValueError(f"{name} has {t.shape[0]} rows, not {rows}")
    _check_fire_args(end_panes, w_valid)
    lanes = [t for t in (sums, maxs, mins) if t is not None]
    if len({t.shape[1] for t in lanes}) > 1:
        raise ValueError("sums/maxs/mins differ in ring size")
    if not wk.on_cuda("window_lanes", sums, maxs, mins, end_panes, w_valid):
        return window_lanes_plain(sums, maxs, mins, end_panes, w_valid,
                                  pane_lo, pane_hi, ppw, rows)
    dev = end_panes.device
    W = end_panes.numel()
    outs = [torch.empty((rows, W, lk._width(t)), dtype=torch.float32,
                        device=dev) for t in (sums, maxs, mins)]
    if not lanes:
        return tuple(outs)
    ring = lanes[0].shape[1]
    _launch("window_lanes", "tl_window_lanes", lk._ptr(sums), lk._width(sums),
            lk._ptr(maxs), lk._width(maxs), lk._ptr(mins), lk._width(mins),
            rows, ring, end_panes.data_ptr(), w_valid.data_ptr(), W,
            int(pane_lo), int(pane_hi), int(ppw), outs[0].data_ptr(),
            outs[1].data_ptr(), outs[2].data_ptr(), wk.stream_of(end_panes))
    return tuple(outs)


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
    wk.check_tensor(wcounts, "wcounts", torch.int32, 2)
    wk.check_tensor(v, "v", torch.float32, 2)
    wk.check_tensor(cols, "cols", torch.int32, 3)
    wk.check_tensor(used_mask, "used_mask", torch.bool, 1)
    _check_fire_args(end_panes, w_valid)
    wk.check_tensor(emit_ring, "emit_ring", torch.int32, 2)
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
    if not wk.on_cuda("topn_select_lanes", wcounts, v, cols, used_mask,
                      end_panes, w_valid, emit_ring):
        return topn_select_lanes_plain(wcounts, v, cols, used_mask, end_panes,
                                       w_valid, anchor, n, sel_cap, emit_ring)
    dev = wcounts.device
    n_blocks = max(1, math.ceil(rows * W / _lib().tl_tile()))
    # scratch may be freed as soon as this returns: the caching allocator
    # hands it out again only to work queued later on the same stream
    thresh = torch.empty(W, dtype=torch.float32, device=dev)
    block_counts = torch.empty(n_blocks, dtype=torch.int32, device=dev)
    old_total = torch.empty(1, dtype=torch.int64, device=dev)
    _launch("topn_select_lanes", "tl_topn_select_lanes", wcounts.data_ptr(),
            v.data_ptr(), cols.data_ptr(), F, rows, W, used_mask.data_ptr(),
            end_panes.data_ptr(), w_valid.data_ptr(), int(anchor),
            min(int(n), rows), int(sel_cap), emit_ring.data_ptr(),
            emit_ring.shape[0], emit_ring.shape[1], thresh.data_ptr(),
            block_counts.data_ptr(), old_total.data_ptr(),
            wk.stream_of(wcounts))
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
