"""Shuffle SPI: pluggable keyed-exchange implementations.

- ``all-to-all`` (default): every block's buckets straight to their
  owners (``keyby.all_to_all_records``).
- ``ring``: N hops around the ring of blocks: at hop s each block holds
  the buckets that started at block ``(my - s) % N``, keeps the row
  addressed to it, and passes the whole bucket block on to the next
  block. After N hops every (source, me) bucket has been captured, laid
  out row per source: the received layout of ``all-to-all``, so the
  consumer does not know which ran.

Both take and return what ``keyby.keyby_exchange`` does: the received
blocks, the overflow per source block, and the bytes the implementation
copied between distinct blocks (a ring hop moves a whole bucket block,
so ``ring`` copies ``n`` times what ``all-to-all`` does). A source
block's records come as int32 (int64) flat global cells, or, for the
built-ins, as the split upload's ``(B, 3)`` uint8 bytes, which their
``bucket_records`` launch decodes where it reads them
(``takes_split_bytes``); either way the received cells are int32 (int64)
flat cells of the owner's block. Third-party implementations register
with ``register_shuffle`` and receive flat cells: the operator decodes a
split upload for them with ``split_cells``.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from flink_tpu_torch.device import on_device
from flink_tpu_torch.exchange.keyby import (
    Block, _copy_row, _flatten, _receive_buffers, bucket_by_destination,
    keyby_exchange)

ShuffleFn = Callable[..., Tuple[List[Block], List[torch.Tensor], int]]


def all_to_all_shuffle(cells, payload, *, devices, capacity, spd, ring):
    return keyby_exchange(cells, payload, devices=devices, capacity=capacity,
                          spd=spd, ring=ring)


def _hop(block: Block, device: torch.device) -> Tuple[Block, int]:
    """A whole bucket block copied to the next block's device, and the
    bytes copied."""
    moved = sum(t.numel() * t.element_size() for t in block if t is not None)
    return tuple(None if t is None else
                 torch.empty_like(t, device=device).copy_(t, non_blocking=True)
                 for t in block), moved


def ring_shuffle(cells: Sequence[torch.Tensor],
                 payload: Sequence[Optional[torch.Tensor]], *,
                 devices: Sequence[torch.device], capacity: int, spd: int,
                 ring: int) -> Tuple[List[Block], List[torch.Tensor], int]:
    """bucket → N hops around the ring → flatten."""
    n = len(devices)
    cur, overflow, moved = [], [], 0
    for j in range(n):
        with on_device(devices[j]):
            b, ov = bucket_by_destination(cells[j], payload[j], n_dest=n,
                                          capacity=capacity, spd=spd,
                                          ring=ring)
        cur.append(b)
        overflow.append(ov)
    recv = [_receive_buffers(cur[0], n, capacity, devices[d])
            for d in range(n)]
    for s in range(n):
        for my in range(n):
            # the block held here started at block (my - s) % n
            # (a copy within block my: not counted as exchanged)
            _copy_row(recv[my], (my - s) % n, cur[my], my)
        if s < n - 1:  # the last hop's blocks would not be read
            hops = [_hop(cur[(i - 1) % n], devices[i]) for i in range(n)]
            cur = [b for b, _ in hops]
            moved += sum(m for _, m in hops)
    return [_flatten(r) for r in recv], overflow, moved


_IMPLS: Dict[str, ShuffleFn] = {
    "all-to-all": all_to_all_shuffle,
    "ring": ring_shuffle,
}


def takes_split_bytes(fn: ShuffleFn) -> bool:
    """Whether ``fn`` takes a source block's split upload bytes as they
    are (the built-ins); a registered shuffle takes flat cells."""
    return fn in (all_to_all_shuffle, ring_shuffle)


def get_shuffle(name: str) -> ShuffleFn:
    if name not in _IMPLS:
        raise ValueError(
            f"unknown exchange implementation {name!r}; "
            f"available: {sorted(_IMPLS)}")
    return _IMPLS[name]


def register_shuffle(name: str, fn: ShuffleFn) -> None:
    """The SPI hook: another exchange implementation registers here. It
    takes what ``all_to_all_shuffle`` takes, with each source block's
    records as flat cells."""
    _IMPLS[name] = fn
