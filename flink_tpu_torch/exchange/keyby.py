"""The keyBy exchange of a key-sharded operator: each device block's
records to the block that owns their key.

The reference repartitions a microbatch with one ``lax.all_to_all``
inside its compiled step: each device buckets its records by destination
into padded ``(n_dest, capacity)`` buckets, the collective transposes
them, and each device flattens what it received. The port is
single-controller (``parallel/mesh.py``), so the same three steps run
over a list of blocks:

1. ``bucket_by_destination``: the ``bucket_records`` kernel on each
   source block (records in arrival order within a bucket, each cell
   already rebased to its owner's block, overflow counted; the records
   as flat cells or as the split upload's 3 bytes, decoded where the
   kernel reads them);
2. ``all_to_all_records``: block copies, ``recv[d][j] = buckets[j][d]``
   (``Tensor.copy_``: a peer copy between cards), so row j of what block
   d receives came from block j; it counts the bytes it copied between
   distinct blocks (the operator's ``exchange_bytes``);
3. the flatten: block d's received cells, payload and valid mask as one
   ``(n_src * capacity,)`` run each.

Where every block lies on one device, ``keyby_exchange`` fuses 1 and 2:
each source block's ``bucket_records_into`` launch writes its buckets
straight into row j of the owners' receive blocks (one allocation for
all of them), so the exchange is one launch a source block and no copy,
with the same received layout and the same byte count.

A record past its bucket's capacity is dropped and counted, never
silently; the operator splits a batch on the host so that no bucket
overflows (``WindowOperator._split_for_exchange``).
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from flink_tpu_torch.device import on_device
from flink_tpu_torch.kernels import exchange_kernels as ek

# one block's buckets or received records: cells, payload (or None), valid
Block = Tuple[torch.Tensor, Optional[torch.Tensor], torch.Tensor]


def bucket_by_destination(cells: torch.Tensor, payload: Optional[torch.Tensor],
                          *, n_dest: int, capacity: int, spd: int, ring: int
                          ) -> Tuple[Block, torch.Tensor]:
    """One source block's records (flat cells, or the split upload's
    bytes) into ``(n_dest, capacity)`` buckets of flat cells:
    ``((cells, payload, valid), overflow)`` (see
    ``exchange_kernels.bucket_records``)."""
    b_cells, b_payload, valid, overflow = ek.bucket_records(
        cells, payload, n_dest, capacity, spd, ring)
    return (b_cells, b_payload, valid), overflow


def _receive_buffers(like: Block, n_src: int, capacity: int,
                     device: torch.device) -> Block:
    cells, payload, valid = like
    return (torch.empty((n_src, capacity), dtype=cells.dtype, device=device),
            None if payload is None else torch.empty(
                (n_src, capacity) + payload.shape[2:], dtype=payload.dtype,
                device=device),
            torch.empty((n_src, capacity), dtype=valid.dtype, device=device))


def _flatten(block: Block) -> Block:
    cells, payload, valid = block
    return (cells.reshape(-1),
            None if payload is None else payload.reshape(
                (-1,) + payload.shape[2:]),
            valid.reshape(-1))


def _copy_row(dst: Block, j: int, src: Block, d: int) -> int:
    """Row j of a receive buffer from row d of a source's buckets;
    returns the bytes copied."""
    moved = 0
    for a, b in zip(dst, src):
        if a is not None:
            a[j].copy_(b[d], non_blocking=True)
            moved += a[j].numel() * a.element_size()
    return moved


def all_to_all_records(buckets: Sequence[Block],
                       devices: Sequence[torch.device]
                       ) -> Tuple[List[Block], int]:
    """The all-to-all transpose as block copies: block d receives
    ``(n_src * capacity,)`` records whose row j came from source block j
    (its bucket d). Returns (the received blocks, the bytes copied
    between distinct blocks)."""
    n = len(devices)
    capacity = buckets[0][0].shape[1]
    out, moved = [], 0
    for d in range(n):
        recv = _receive_buffers(buckets[0], n, capacity, devices[d])
        for j in range(n):
            copied = _copy_row(recv, j, buckets[j], d)
            if j != d:
                moved += copied
        out.append(_flatten(recv))
    return out, moved


def keyby_exchange(cells: Sequence[torch.Tensor],
                   payload: Sequence[Optional[torch.Tensor]], *,
                   devices: Sequence[torch.device], capacity: int, spd: int,
                   ring: int
                   ) -> Tuple[List[Block], List[torch.Tensor], int]:
    """bucket → all-to-all → flatten (on blocks of one device, bucket
    straight into the owners' receive rows). ``cells[j]`` / ``payload[j]``
    are source block j's records on ``devices[j]``. Returns (per block, its
    received ``(cells, payload, valid)``; per source block, its overflow
    per destination; the bytes copied between distinct blocks)."""
    n = len(devices)
    if len({torch.device(d) for d in devices}) == 1:
        return _exchange_one_device(cells, payload, torch.device(devices[0]),
                                    capacity, spd, ring)
    buckets, overflow = [], []
    for j in range(n):
        with on_device(devices[j]):
            b, ov = bucket_by_destination(cells[j], payload[j], n_dest=n,
                                          capacity=capacity, spd=spd,
                                          ring=ring)
        buckets.append(b)
        overflow.append(ov)
    recv, moved = all_to_all_records(buckets, devices)
    return recv, overflow, moved


def _exchange_one_device(cells, payload, device, capacity, spd, ring):
    """``keyby_exchange`` over blocks of one device: each source block's
    buckets written by its ``bucket_records_into`` launch straight into
    row j of every owner's receive block. The bytes counted are those
    that crossed between distinct blocks, as the copies would have
    moved: row j of block d for every j != d."""
    n = len(cells)
    pay = payload[0]
    with on_device(device):
        # the received cells are flat, whatever form the records came in
        r_cells = torch.empty((n, n, capacity),
                              dtype=ek.bucket_cell_dtype(cells[0]),
                              device=device)
        r_payload = None if pay is None else torch.empty(
            (n, n, capacity) + pay.shape[1:], dtype=pay.dtype, device=device)
        r_valid = torch.empty((n, n, capacity), dtype=torch.bool,
                              device=device)
        recv = (r_cells, r_payload, r_valid)
        overflow = [ek.bucket_records_into(cells[j], payload[j], n, capacity,
                                           spd, ring, recv, j)
                    for j in range(n)]
    row = sum(t[0, 0].numel() * t.element_size() for t in recv
              if t is not None)
    return ([_flatten(tuple(None if t is None else t[d] for t in recv))
             for d in range(n)], overflow, n * (n - 1) * row)


def intra_slice_exchange(*args, **kwargs):
    """The ICI leg of the hybrid ICI×DCN topology: still to port."""
    raise NotImplementedError(
        "intra_slice_exchange belongs to the hybrid mesh across processes "
        "(cluster.num-processes > 1), still to port: ROADMAP.md queue 1 "
        "item 9")
