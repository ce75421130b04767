"""Device mesh planning: which device block owns which key shards.

A key-sharded window operator runs over an ordered list of devices, one
"subtask" each. Device block ``d`` owns the contiguous key shards
``[d * shards_per_device, (d + 1) * shards_per_device)`` (its key-group
range) and holds their pane state as ``rows_per_device`` rows: its
``slots_per_device`` key slots plus one dump row. Records move to the
block that owns their key through the keyBy exchange
(``exchange/keyby.py``).

The plan is single-controller, as the reference's is (one process over
``jax.devices()``): it holds ``torch.device``s, and one device may stand
in the list several times. On the CPU the tests build their mesh that
way, as the reference's tests force eight virtual CPU devices; one card
can hold a mesh of several blocks the same way. The hybrid plan across
processes (the DCN tier) is still to port.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class MeshPlan:
    """Static plan binding key shards to device blocks. ``num_shards``
    is the fixed hash space (maxParallelism); each block owns
    ``shards_per_device`` contiguous shards."""

    devices: Tuple[torch.device, ...]
    num_shards: int
    slots_per_shard: int

    @property
    def n_devices(self) -> int:
        return len(self.devices)

    @property
    def shards_per_device(self) -> int:
        return self.num_shards // self.n_devices

    @property
    def slots_per_device(self) -> int:
        return self.shards_per_device * self.slots_per_shard

    @property
    def total_slots(self) -> int:
        return self.num_shards * self.slots_per_shard

    @property
    def rows_per_device(self) -> int:
        return self.slots_per_device + 1  # + the block's dump row

    def shard_range(self, device_index: int) -> Tuple[int, int]:
        s = self.shards_per_device
        return (device_index * s, (device_index + 1) * s)

    def device_of_slot(self, global_slots: np.ndarray) -> np.ndarray:
        return global_slots // self.slots_per_device

    def global_slot_to_row(self, global_slots: np.ndarray) -> np.ndarray:
        return slot_to_row(global_slots, self.slots_per_device)


def slot_to_row(global_slots: np.ndarray, slots_per_block: int) -> np.ndarray:
    """Global slot id → row in the blocks laid end to end (each block
    carries one dump row after its slots). With one block it is the
    identity."""
    return global_slots + global_slots // slots_per_block


def row_to_slot(rows: np.ndarray, rows_per_block: int) -> np.ndarray:
    """The inverse of ``slot_to_row``; a block's dump row maps to the
    first slot of the next block."""
    return rows - rows // rows_per_block


def make_mesh_plan(num_shards: int, slots_per_shard: int,
                   devices: Sequence["str | torch.device"]) -> MeshPlan:
    """A plan over ``devices`` (in order; a device may repeat).
    ``num_shards`` must be a multiple of their count."""
    devs = tuple(torch.device(d) for d in devices)
    n = len(devs)
    if n < 1:
        raise ValueError("a mesh needs at least one device")
    if num_shards % n != 0:
        raise ValueError(
            f"state.num-key-shards ({num_shards}) must be a multiple of the "
            f"device count ({n}) — the key-group/maxParallelism contract")
    return MeshPlan(devices=devs, num_shards=num_shards,
                    slots_per_shard=slots_per_shard)


class HybridMeshPlan(MeshPlan):
    """The ICI×DCN plan of one process of a cross-host job: still to
    port."""

    def __init__(self, *args, **kwargs) -> None:
        raise NotImplementedError(
            "the hybrid mesh across processes (cluster.num-processes > 1) "
            "is still to port: ROADMAP.md queue 1 item 9 (exchange/dcn.py)")


def make_hybrid_mesh_plan(global_num_shards: int, slots_per_shard: int,
                          n_processes: int, process_id: int,
                          devices=None) -> HybridMeshPlan:
    raise NotImplementedError(
        "the hybrid mesh across processes (cluster.num-processes > 1) is "
        "still to port: ROADMAP.md queue 1 item 9 (exchange/dcn.py)")
