"""The element path's reduction: a CUDA kernel (``csrc/element_kernels.cu``)
and a plain PyTorch version with the same signature.

``segment_lanes`` (E1) reduces the lifted lanes of every window fired
on the element path (``ops/evicting_window.py``) in one launch: segment
``w`` is the surviving elements ``[offsets[w], offsets[w + 1])`` of one
(key, window), and it gets the sum of each sum lane, the maximum of each
max lane, the minimum of each min lane and its length. The JAX package
reduces one window at a time (``flink_tpu/api/datastream.py:443``
``_element_window_fn``: ``jnp.sum`` / ``jnp.max`` / ``jnp.min`` over the
element axis), on its default device.

Floats: each sum starts at +0 and adds in element order, in the kernel
and in the plain version alike, so the two agree bit for bit; XLA's
reduction associates otherwise, so sums agree with the reference to an
ordering bound. Max and min follow IEEE 754-2019 maximum / minimum (-0 <
+0) and pass a NaN on with its bits: the max keeps the segment's last
NaN, the min its first (XLA's CPU reduction gives that NaN where a
column has one). The plain version walks every segment in the same
element order, one position per step, over all segments at once.

As in ``window_kernels.py``: the wrapper takes the plain version only
for tensors on the CPU and launches the kernel (or raises) for CUDA
tensors; ``window_kernels.LAUNCHES`` counts the launches; an offset
table that is not a non-decreasing run inside the lanes makes the plain
version raise and the kernel set a bit in the device's error word.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from flink_tpu_torch.kernels import window_kernels as wk
from flink_tpu_torch.kernels.lane_kernels import _width

_SIGNATURES = {
    "ek_error_string": [ctypes.c_int],
}

Lanes = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def _lib() -> ctypes.CDLL:
    return wk.load_library("element_kernels", _SIGNATURES, "ek_error_string")


_SEGMENT_LANES = wk.LeanEntry(_lib, "ek_segment_lanes", "segment_lanes", 15,
                              "ek_error_string")

# csrc/element_kernels.cu's staging (the tests read it from the source):
# the floats of a warp's stage, split between the segments it takes at
# once
SEGMENT_STAGE = 512
# a warp a segment where the drain's mean segment is longer than this many
# elements (its stage then folds for longer than the next one takes to
# arrive), else 8 lanes a segment, four a warp sharing the add chain's
# instructions; a long mean (job E2's prefixes of thousands) or a short one
# (job E's 10,000 windows of up to 100 elements) decides it
SEGMENT_WARP_MEAN = 256


def segment_group(n_seg: int, n_elem: int, cols: int) -> int:
    """Lanes of the kernel's group a segment: 8 for short segments, 32
    (a warp) for long ones or for rows too wide for a group's share of a
    stage. Raises for rows too wide for a warp's."""
    if cols > SEGMENT_STAGE:
        raise ValueError(f"segment_lanes takes at most {SEGMENT_STAGE} lane "
                         f"columns in all, got {cols}")
    if cols > SEGMENT_STAGE // 4 or n_elem > SEGMENT_WARP_MEAN * n_seg:
        return 32
    return 8


def _check(offsets: torch.Tensor, sums: torch.Tensor, maxs: torch.Tensor,
           mins: torch.Tensor) -> None:
    wk.check_tensor(offsets, "offsets", torch.int64, 1)
    if offsets.numel() < 1:
        raise ValueError("offsets needs W + 1 >= 1 entries")
    for name, t in (("sums", sums), ("maxs", maxs), ("mins", mins)):
        wk.check_tensor(t, name, torch.float32, 2)
        if t.shape[0] != sums.shape[0]:
            raise ValueError(f"{name} {tuple(t.shape)} does not match sums "
                             f"{tuple(sums.shape)}")


def segment_lanes(offsets: torch.Tensor, sums: torch.Tensor,
                  maxs: torch.Tensor, mins: torch.Tensor) -> Lanes:
    """Reduce each segment ``[offsets[w], offsets[w + 1])`` of the lifted
    lanes ``sums (E, S)``, ``maxs (E, M)``, ``mins (E, N)`` (f32, any
    width 0). Returns ``(sums (W, S), maxs (W, M), mins (W, N), counts
    (W,) int32)``."""
    index = wk.fast_index((offsets, torch.int64, 1), (sums, torch.float32, 2),
                          (maxs, torch.float32, 2), (mins, torch.float32, 2))
    n_elem = sums.shape[0]
    if index is None or offsets.numel() < 1 or maxs.shape[0] != n_elem \
            or mins.shape[0] != n_elem:
        _check(offsets, sums, maxs, mins)
        if not wk.on_cuda("segment_lanes", offsets, sums, maxs, mins):
            return segment_lanes_plain(offsets, sums, maxs, mins)
        index = offsets.get_device()
    dev = offsets.device
    n_seg = offsets.numel() - 1
    sw, mw, nw = sums.shape[1], maxs.shape[1], mins.shape[1]
    # the four outputs in one allocation: the lanes as f32, then counts
    buf = torch.empty(n_seg * (sw + mw + nw + 1), dtype=torch.float32,
                      device=dev)
    a, b, c = n_seg * sw, n_seg * (sw + mw), n_seg * (sw + mw + nw)
    out_s = buf.as_strided((n_seg, sw), (sw, 1), 0)
    out_m = buf.as_strided((n_seg, mw), (mw, 1), a)
    out_n = buf.as_strided((n_seg, nw), (nw, 1), b)
    counts = buf[c:].view(torch.int32)
    if n_elem >= 2 ** 31:
        raise ValueError(f"segment_lanes takes fewer than 2^31 elements, got "
                         f"{n_elem}")
    group = segment_group(n_seg, n_elem, sw + mw + nw)
    err, stream = wk.launch_context(index)
    _SEGMENT_LANES(stream, offsets.data_ptr(), n_seg, n_elem, sums.data_ptr(),
                   sw, maxs.data_ptr(), mw, mins.data_ptr(), nw,
                   out_s.data_ptr(), out_m.data_ptr(), out_n.data_ptr(),
                   counts.data_ptr(), err, group)
    return out_s, out_m, out_n, counts


def segment_lanes_plain(offsets, sums, maxs, mins) -> Lanes:
    dev = offsets.device
    n_seg = offsets.numel() - 1
    lo = offsets[:-1]
    length = offsets[1:] - lo
    if n_seg and (bool((lo < 0).any()) or bool((length < 0).any())
                  or int(offsets[-1]) > sums.shape[0]):
        wk.raise_for_error_bits(256)
    # the accumulators in order of segment length, longest first: step j
    # updates the prefix of segments longer than j, so every element is
    # read once and each segment in element order
    order = torch.argsort(length, descending=True, stable=True)
    lo_o = lo[order]
    len_o = length[order].tolist()
    acc_s = torch.zeros((n_seg, _width(sums)), dtype=torch.float32, device=dev)
    acc_m = torch.full((n_seg, _width(maxs)), float("-inf"),
                       dtype=torch.float32, device=dev)
    acc_n = torch.full((n_seg, _width(mins)), float("inf"),
                       dtype=torch.float32, device=dev)
    n_live = n_seg
    for j in range(len_o[0] if n_seg else 0):
        while len_o[n_live - 1] <= j:
            n_live -= 1
        e = lo_o[:n_live] + j
        if acc_s.shape[1]:
            acc_s[:n_live] += sums[e]
        if acc_m.shape[1]:
            acc, x = acc_m[:n_live], maxs[e]
            take = torch.isnan(x) | (~torch.isnan(acc) & (
                (x > acc) | ((x == acc) & ~torch.signbit(x))))
            acc_m[:n_live] = torch.where(take, x, acc)
        if acc_n.shape[1]:
            acc, x = acc_n[:n_live], mins[e]
            take = ~torch.isnan(acc) & (torch.isnan(x) | (x < acc) | (
                (x == acc) & torch.signbit(x)))
            acc_n[:n_live] = torch.where(take, x, acc)
    outs = []
    for acc in (acc_s, acc_m, acc_n):
        out = torch.empty_like(acc)
        out[order] = acc
        outs.append(out)
    return outs[0], outs[1], outs[2], length.to(torch.int32)
