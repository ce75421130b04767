"""The count window's fire: a CUDA kernel (``csrc/count_window_kernels.cu``)
and a plain PyTorch version with the same signature.

``count_fire`` (C1) fires every key row whose count since its last fire
reached the window size, packs the fired rows in ascending row order
for the host — ``[row, count, f32 bits of the sums, maxs, mins]`` under
a ``[n, 0, ...]`` head, the reference's cumsum compaction — and then
resets them: a purging window clears every lane, a non-purging one
restarts only the trigger count. The aggregate's finalize runs on the
packed rows in torch afterwards.

As in ``window_kernels.py``: the wrapper takes the plain version only
for tensors on the CPU and launches the kernel (or raises) for CUDA
tensors; ``window_kernels.LAUNCHES`` counts the launches; a buffer too
small for the fired rows makes the plain version raise and the kernel
set a bit in the device's error word. The kernel is one launch (an
ordered compaction by decoupled look-back, over a clean workspace a
device and stream, ``window_kernels.clean_workspace``); it copies lanes
as bits and adds nothing, so it agrees with the plain version bit for
bit.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from flink_tpu_torch.kernels import window_kernels as wk
from flink_tpu_torch.kernels.lane_kernels import _ptr, _width

_SIGNATURES = {
    "cw_error_string": [ctypes.c_int],
}


# csrc/count_window_kernels.cu kFireTile: the rows a block takes (256
# threads times 2 rows a thread), which sizes the workspace
FIRE_TILE = 512


def _lib() -> ctypes.CDLL:
    return wk.load_library("count_window_kernels", _SIGNATURES,
                           "cw_error_string")


_COUNT_FIRE = wk.LeanEntry(_lib, "cw_count_fire", "count_fire", 15,
                           "cw_error_string")


def _fire_work_words(tiles: int) -> int:
    """count_fire's workspace in int64 words: the epoch, then from word
    ``LB_LINE`` a descriptor a tile, each on its own 128-byte line
    (csrc/lookback.cuh); the kernels leave it clean for the next call."""
    return wk.LB_LINE * (1 + tiles)


def count_fire(counts: torch.Tensor, base: Optional[torch.Tensor],
               sums: Optional[torch.Tensor], maxs: Optional[torch.Tensor],
               mins: Optional[torch.Tensor], size: int,
               out_cap: int) -> torch.Tensor:
    """Fire, pack and reset the rows whose trigger count reached
    ``size``, in place on the state.

    ``counts`` is ``(rows,)`` int32 (the last row is the dump row, which
    never fires); ``sums`` / ``maxs`` / ``mins`` are ``(rows, width)``
    f32 or None. The trigger count is ``counts - base``, or ``counts``
    with ``base`` None (a purging window). Returns the ``(out_cap + 1, 2
    + S + M + m)`` int32 buffer: row 0 = ``[n fired, 0, ...]``, rows
    1..min(n, out_cap) = ``[row, count, f32 bits of sums, maxs, mins]``
    in ascending row order. Each packed row is then reset: with ``base``
    None its counts to 0, sums to 0, maxs to -inf and mins to +inf;
    otherwise ``base[row] = counts[row]``. Rows past ``out_cap`` stay as
    they were (the plain version raises; the kernel sets a bit in the
    error word)."""
    index = wk.fast_index((counts, torch.int32, 1), (base, torch.int32, 1),
                          (sums, torch.float32, 2), (maxs, torch.float32, 2),
                          (mins, torch.float32, 2))
    if index is None:
        wk.check_tensor(counts, "counts", torch.int32, 1)
    rows = counts.shape[0]
    if base is not None:
        if index is None:
            wk.check_tensor(base, "base", torch.int32, 1)
        if base.shape[0] != rows:
            raise ValueError("base does not match counts")
    for name, t in (("sums", sums), ("maxs", maxs), ("mins", mins)):
        if t is None:
            continue
        if index is None:
            wk.check_tensor(t, name, torch.float32, 2)
        if t.shape[0] != rows:
            raise ValueError(f"{name} {tuple(t.shape)} does not match counts "
                             f"({rows},)")
    if size < 1 or out_cap < 1:
        raise ValueError("size and out_cap must be >= 1")
    if index is None:
        if not wk.on_cuda("count_fire", counts, base, sums, maxs, mins):
            return count_fire_plain(counts, base, sums, maxs, mins, size,
                                    out_cap)
        index = counts.get_device()
    dev = counts.device
    cols = 2 + _width(sums) + _width(maxs) + _width(mins)
    out = torch.empty((out_cap + 1, cols), dtype=torch.int32, device=dev)
    err, stream = wk.launch_context(index)
    work, (cap_tiles,) = wk.clean_workspace(
        "count_fire", index, stream, (max(1, -(-rows // FIRE_TILE)),),
        _fire_work_words)
    try:
        _COUNT_FIRE(stream, counts.data_ptr(), _ptr(base), rows,
                    _ptr(sums), _width(sums), _ptr(maxs), _width(maxs),
                    _ptr(mins), _width(mins), int(size), out.data_ptr(),
                    int(out_cap), work, _fire_work_words(cap_tiles), err)
    except RuntimeError:
        wk.drop_workspace("count_fire", index, stream)
        raise
    return out


def count_fire_plain(counts, base, sums, maxs, mins, size, out_cap):
    rows = counts.shape[0]
    since = counts - base if base is not None else counts
    fired = since >= size
    fired[rows - 1] = False
    r = torch.nonzero(fired).reshape(-1)
    n = r.numel()
    if n > out_cap:
        wk.raise_for_error_bits(128)
    lanes = [t[r] for t in (sums, maxs, mins) if t is not None]
    cols = 2 + sum(t.shape[1] for t in lanes)
    out = torch.zeros((out_cap + 1, cols), dtype=torch.int32,
                      device=counts.device)
    out[0, 0] = n
    out[1:n + 1, 0] = r.to(torch.int32)
    out[1:n + 1, 1] = counts[r]
    if lanes:
        out[1:n + 1, 2:] = torch.cat(lanes, dim=1).view(torch.int32)
    if base is not None:
        base[r] = counts[r]
        return out
    counts[r] = 0
    for t, fill in ((sums, 0.0), (maxs, -math.inf), (mins, math.inf)):
        if t is not None:
            t[r] = fill
    return out
