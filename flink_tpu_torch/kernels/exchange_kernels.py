"""The key-sharded window operator's two exchange-side device functions:
a CUDA kernel each (``csrc/exchange_kernels.cu``) and a plain PyTorch
version each, with the same signature.

- ``bucket_records`` (X1): one source block's records into padded
  ``(n_dest, capacity)`` buckets by owner block, each record's cell
  rebased to its owner's block, in arrival order within a bucket, with
  the overflow per destination; ``bucket_records_into`` is the same
  launch writing each bucket straight into its owner's receive row
  (the exchange on blocks of one device, with no copy). Both take the
  records as flat cells or as the split upload's 3 bytes, decoded in the
  same launch by ``split_cells``' rule.
- ``hash_keys`` (X2): the splitmix64 key mix that routes keys to key
  shards, bit-identical to ``records.hash_keys_numpy``.

As in ``window_kernels.py``: a wrapper takes the plain version only for
tensors on the CPU and launches the kernel (or raises) for CUDA
tensors; ``window_kernels.LAUNCHES`` counts the launches. Both are
integer work or copies: kernel, plain version and JAX reference agree
bit for bit.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from flink_tpu_torch.kernels import devgen_kernels as dk
from flink_tpu_torch.kernels import window_kernels as wk

_SIGNATURES = {
    "xk_error_string": [ctypes.c_int],
}
# the largest destination count one bucket_records launch takes (the
# kernel's shared-memory tables, csrc kMaxDest)
MAX_DEST = 64


def _lib() -> ctypes.CDLL:
    return wk.load_library("exchange_kernels", _SIGNATURES, "xk_error_string")


def _entry(fn: str, name: str, n_words: int) -> wk.LeanEntry:
    return wk.LeanEntry(_lib, fn, name, n_words, "xk_error_string")


_BUCKET_RECORDS = _entry("xk_bucket_records", "bucket_records", 17)
_HASH_KEYS = _entry("xk_hash_keys", "hash_keys", 3)
# csrc/window_common.cuh kTile: the records of a bucketing tile
BUCKET_TILE = 1024


def bucket_work_words(tiles: int, n_dest: int) -> int:
    """csrc/exchange_kernels.cu's workspace of one ``bucket_records``
    launch over ``tiles`` tiles of BUCKET_TILE records, in int64 words:
    the epoch on its own 128-byte line, then a look-back descriptor a
    (tile, destination), each tile's on whole 128-byte lines."""
    line = wk.LB_LINE
    return line + tiles * (-(-n_dest // line) * line)


# -- X1 ------------------------------------------------------------------------

def bucket_cell_dtype(cells: torch.Tensor) -> torch.dtype:
    """The dtype of the bucketed cells of ``cells``: int32 for the split
    upload's bytes, else the cells' own."""
    return torch.int32 if cells.dtype is torch.uint8 else cells.dtype


def _check_bucket(cells, payload, n_dest, capacity, spd, ring):
    """One pass of ``bucket_records``' checks: the CUDA device index (or
    None for CPU tensors, after the checks that raise) and C."""
    split = cells.dtype is torch.uint8
    dtype, ndim = ((torch.uint8, 2) if split else
                   (torch.int64 if cells.dtype is torch.int64
                    else torch.int32, 1))
    index = wk.fast_index((cells, dtype, ndim))
    if index is None:
        wk.check_tensor(cells, "cells", dtype, ndim)
    B = cells.shape[0]
    C = 0
    if payload is not None:
        if payload.dim() != 2 or payload.shape[0] != B \
                or payload.element_size() != 4 or not payload.is_contiguous():
            raise ValueError(
                f"payload must be a contiguous (B, C) tensor of a 4-byte "
                f"dtype, got {tuple(payload.shape)} {payload.dtype}")
        C = payload.shape[1]
    if not 1 <= n_dest <= MAX_DEST:
        raise ValueError(f"bucket_records takes 1..{MAX_DEST} destinations, "
                         f"got {n_dest}")
    if capacity < 1 or spd < 1 or ring < 1:
        raise ValueError("capacity, spd and ring must be >= 1")
    if capacity >= 2 ** 31:
        raise ValueError("bucket_records: a bucket of 2^31 records or more")
    if split and (cells.shape[1] != 3 or ring > 256
                  or n_dest * spd >= wk.INVALID_SLOT_U16):
        raise ValueError(
            f"a split upload is (B, 3) bytes over a ring of at most 256 "
            f"columns with n_dest * spd below 0xFFFF, got "
            f"{tuple(cells.shape)}, ring {ring}, {n_dest} x {spd} slots")
    if index is None or (payload is not None
                         and payload.get_device() != index):
        if not wk.on_cuda("bucket_records", cells, payload):
            return None, C
        index = cells.get_device()
    return index, C


def _launch_bucket(index, cells, payload, C, n_dest, capacity, spd, ring,
                   out_cells, out_payload, valid, overflow, dstride):
    err, stream = wk.launch_context(index)
    B = cells.shape[0]
    need = bucket_work_words(max(1, -(-B // BUCKET_TILE)), n_dest)
    work, (words,) = wk.clean_workspace("bucket_records", index, stream,
                                        (need,), int)
    try:
        _BUCKET_RECORDS(stream, cells.data_ptr(),
                        3 if cells.dtype is torch.uint8
                        else cells.element_size(),
                        payload.data_ptr() if C else 0, B, C,
                        int(n_dest), int(capacity), int(ring), int(spd), work,
                        words, out_cells, out_payload if C else 0, valid,
                        overflow.data_ptr(), int(dstride), err)
    except RuntimeError:
        wk.drop_workspace("bucket_records", index, stream)
        raise


def bucket_records(cells: torch.Tensor, payload: Optional[torch.Tensor],
                   n_dest: int, capacity: int, spd: int, ring: int
                   ) -> Tuple[torch.Tensor, Optional[torch.Tensor],
                              torch.Tensor, torch.Tensor]:
    """Bucket one source block's records by owner block.

    ``cells`` is ``(B,)`` int32 (int64 once the mesh's cells reach
    2^31), each ``slot * ring + col`` over the mesh's global slots; a cell outside ``[0, n_dest * spd * ring)``
    (``-1``) is an invalid record and goes nowhere. ``cells`` may instead
    be the split upload's ``(B, 3)`` uint8 bytes, decoded in the same
    launch as ``split_cells(cells, ring, n_dest * spd)`` decodes them:
    slot 0xFFFF and slot ``n_dest * spd`` go nowhere, a slot past that or
    a column past the ring raises as ``split_cells`` does (the kernel sets
    its bit in ``error_word``), and the bucketed cells are int32.
    ``payload`` is ``(B,
    C)`` of a 4-byte dtype (the records' lifted lanes) or None. Record i
    goes to block ``d = slot // spd`` at the next free position of its
    bucket, in arrival order, as the cell ``(slot - d * spd) * ring +
    col`` of d's block. Returns ``(cells (n_dest, capacity) of
    ``bucket_cell_dtype(cells)``, payload
    (n_dest, capacity, C) or None, valid (n_dest, capacity) bool, overflow
    (n_dest,) int32)``: positions past a bucket's records hold cell -1, a
    zero payload and valid False; ``overflow[d] = max(count_d - capacity,
    0)`` records past the capacity are dropped."""
    index, C = _check_bucket(cells, payload, n_dest, capacity, spd, ring)
    if index is None:
        return bucket_records_plain(cells, payload, n_dest, capacity, spd,
                                    ring)
    dev = cells.device
    out_cells = torch.empty((n_dest, capacity), dtype=bucket_cell_dtype(cells),
                            device=dev)
    out_payload = (torch.empty((n_dest, capacity, C), dtype=payload.dtype,
                               device=dev) if payload is not None else None)
    valid = torch.empty((n_dest, capacity), dtype=torch.bool, device=dev)
    overflow = torch.empty(n_dest, dtype=torch.int32, device=dev)
    _launch_bucket(index, cells, payload, C, n_dest, capacity, spd, ring,
                   out_cells.data_ptr(),
                   out_payload.data_ptr() if C else 0, valid.data_ptr(),
                   overflow, capacity)
    return out_cells, out_payload, valid, overflow


def bucket_records_into(cells: torch.Tensor, payload: Optional[torch.Tensor],
                        n_dest: int, capacity: int, spd: int, ring: int,
                        recv: Tuple[torch.Tensor, Optional[torch.Tensor],
                                    torch.Tensor], j: int) -> torch.Tensor:
    """``bucket_records`` of source block ``j`` written straight into its
    owners' receive rows: ``recv`` is ``(cells (n_dest, n_src, capacity),
    payload (n_dest, n_src, capacity, C) or None, valid (n_dest, n_src,
    capacity))`` on the source's device, owner d's received block being
    ``recv[...][d]``; row ``j`` of each owner's block gets what bucket d
    would hold. Returns the overflow per destination, as
    ``bucket_records``. On blocks of one device the exchange is then one
    launch a source block and no copy."""
    index, C = _check_bucket(cells, payload, n_dest, capacity, spd, ring)
    r_cells, r_payload, r_valid = recv
    n_src = r_cells.shape[1] if r_cells.dim() == 3 else 0
    if (r_cells.dtype != bucket_cell_dtype(cells)
            or r_valid.dtype != torch.bool
            or tuple(r_cells.shape) != (n_dest, n_src, capacity)
            or tuple(r_valid.shape) != (n_dest, n_src, capacity)
            or (payload is None) != (r_payload is None)
            or (r_payload is not None and (
                r_payload.dtype != payload.dtype
                or tuple(r_payload.shape) != (n_dest, n_src, capacity, C)))
            or not all(t.is_contiguous() for t in recv if t is not None)):
        raise ValueError(
            "recv must be contiguous (n_dest, n_src, capacity) cells of the "
            "bucketed cells' dtype and valid (and payload (..., C)) of the "
            "records' dtypes")
    if not 0 <= j < n_src:
        raise ValueError(f"source block {j} outside 0..{n_src - 1}")
    if index is None:
        if any(t.device != cells.device for t in recv if t is not None):
            raise ValueError("bucket_records_into: tensors on different "
                             "devices")
        return bucket_records_into_plain(cells, payload, n_dest, capacity,
                                         spd, ring, recv, j)
    if any(t.get_device() != index for t in recv if t is not None):
        raise ValueError("bucket_records_into: tensors on different devices")
    overflow = torch.empty(n_dest, dtype=torch.int32, device=cells.device)
    row = j * capacity
    _launch_bucket(index, cells, payload, C, n_dest, capacity, spd, ring,
                   r_cells.data_ptr() + row * r_cells.element_size(),
                   r_payload.data_ptr() + row * C * 4 if C else 0,
                   r_valid.data_ptr() + row, overflow, n_src * capacity)
    return overflow


def bucket_records_into_plain(cells, payload, n_dest, capacity, spd, ring,
                              recv, j):
    b_cells, b_payload, b_valid, overflow = bucket_records_plain(
        cells, payload, n_dest, capacity, spd, ring)
    for dst, src in zip(recv, (b_cells, b_payload, b_valid)):
        if dst is not None:
            dst[:, j] = src
    return overflow


def bucket_records_plain(cells, payload, n_dest, capacity, spd, ring):
    if cells.dtype is torch.uint8:
        cells = wk.split_cells_plain(cells, ring, n_dest * spd)
    dev = cells.device
    B = cells.numel()
    c = cells.long()
    ok = (c >= 0) & (c < n_dest * spd * ring)
    slot = torch.where(ok, c // ring, torch.zeros_like(c))
    dest = torch.where(ok, slot // spd, torch.full_like(c, n_dest))
    order = torch.argsort(dest, stable=True)
    sorted_dest = dest[order]
    counts = torch.bincount(dest, minlength=n_dest + 1)
    starts = torch.cumsum(counts, 0) - counts
    within = torch.arange(B, device=dev) - starts[sorted_dest]
    keep = (sorted_dest < n_dest) & (within < capacity)
    flat = torch.where(keep, sorted_dest * capacity + within,
                       torch.full_like(within, n_dest * capacity))
    local = (slot - dest.clamp(max=n_dest - 1) * spd) * ring + c % ring
    out_cells = torch.full((n_dest * capacity + 1,), -1, dtype=cells.dtype,
                           device=dev)
    out_cells[flat] = torch.where(keep, local[order],
                                  torch.full_like(within, -1)).to(cells.dtype)
    valid = torch.zeros(n_dest * capacity + 1, dtype=torch.bool, device=dev)
    valid[flat] = keep
    out_payload = None
    if payload is not None:
        C = payload.shape[1]
        out_payload = torch.zeros((n_dest * capacity + 1, C),
                                  dtype=payload.dtype, device=dev)
        out_payload[flat] = torch.where(keep[:, None], payload[order],
                                        torch.zeros_like(payload[order]))
        out_payload = out_payload[:-1].reshape(n_dest, capacity, C)
    overflow = (counts[:n_dest] - capacity).clamp(min=0).to(torch.int32)
    return (out_cells[:-1].reshape(n_dest, capacity), out_payload,
            valid[:-1].reshape(n_dest, capacity), overflow)


# -- X2 ------------------------------------------------------------------------

def hash_keys(keys: torch.Tensor) -> torch.Tensor:
    """(n,) int64 keys → (n,) int64 splitmix64 mixes masked to 63 bits
    (non-negative), bit-identical to ``records.hash_keys_numpy``."""
    index = wk.fast_index((keys, torch.int64, 1))
    if index is None:
        wk.check_tensor(keys, "keys", torch.int64, 1)
        if not wk.on_cuda("hash_keys", keys):
            return hash_keys_plain(keys)
        index = keys.get_device()
    out = torch.empty_like(keys)
    _, stream = wk.launch_context(index)
    _HASH_KEYS(stream, keys.data_ptr(), keys.numel(), out.data_ptr())
    return out


def hash_keys_plain(keys):
    # splitmix64's finalizer on int64 bits (devgen's helpers: a logical
    # shift, the constants as signed int64)
    x = keys.clone()
    x = (x ^ dk._shr(x, 30)) * dk._i64(dk._MUL1)
    x = (x ^ dk._shr(x, 27)) * dk._i64(dk._MUL2)
    x = x ^ dk._shr(x, 31)
    return x & 0x7FFFFFFFFFFFFFFF
