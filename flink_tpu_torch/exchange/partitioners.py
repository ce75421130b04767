"""Stream partitioners: which parallel subtask each record of a batch
goes to, and the keyed (hash) routing of a job that spans processes.

The reference picks an output channel per record inside its
RecordWriter (RebalancePartitioner, RescalePartitioner,
ShufflePartitioner, BroadcastPartitioner, GlobalPartitioner,
KeyGroupStreamPartitioner). Here channel selection is a vectorized
function from a batch to a (B,) subtask-index array, or a replication
marker. With one local driver every non-keyed strategy is a
pass-through (parallelism 1, as the reference behaves at parallelism 1);
the driver still advances each partitioner's cursor or random stream,
and that state rides the checkpoint. The keyed strategy is
``hybrid_route`` below: the one routing truth of the cross-process
exchange (coordinate 0, ``exchange/dcn.py``) and of the local blocks'
keyBy exchange (coordinate 1, ``exchange/keyby.py``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from flink_tpu_torch.records import hash_keys_numpy


class Partitioner:
    """Assign each record of a batch to one subtask in [0, n)."""

    #: True when every record goes to every subtask (fan-out replication)
    broadcast = False

    def assign(self, b: int, n: int) -> np.ndarray:
        """(B,) int32 subtask ids for a ``b``-record batch over ``n``
        subtasks. Stateful strategies (round-robin cursors) persist
        across calls and are part of the driver's snapshot."""
        raise NotImplementedError

    def advance(self, b: int, n: int) -> None:
        """Advance the routing state without materializing the
        assignment (the parallelism-1 path)."""
        self.assign(b, n)

    def snapshot(self) -> dict:
        return {}

    def restore(self, snap: dict) -> None:
        pass


class RebalancePartitioner(Partitioner):
    """Global round-robin: an exact equal spread whatever the batch
    sizes, the cursor carried across batches."""

    def __init__(self) -> None:
        self.cursor = 0

    def assign(self, b: int, n: int) -> np.ndarray:
        out = ((self.cursor + np.arange(b)) % n).astype(np.int32)
        self.cursor = int((self.cursor + b) % n)
        return out

    def advance(self, b: int, n: int) -> None:
        self.cursor = int((self.cursor + b) % n)

    def snapshot(self) -> dict:
        return {"cursor": self.cursor}

    def restore(self, snap: dict) -> None:
        self.cursor = int(snap["cursor"])


class RescalePartitioner(RebalancePartitioner):
    """Round-robin within the local group only: ``group`` narrows
    [lo, hi) out of n."""

    def __init__(self, group: Optional[tuple] = None) -> None:
        super().__init__()
        self.group = group

    def assign(self, b: int, n: int) -> np.ndarray:
        lo, hi = self.group if self.group is not None else (0, n)
        width = max(hi - lo, 1)
        out = (lo + (self.cursor + np.arange(b)) % width).astype(np.int32)
        self.cursor = int((self.cursor + b) % width)
        return out

    def advance(self, b: int, n: int) -> None:
        lo, hi = self.group if self.group is not None else (0, n)
        self.cursor = int((self.cursor + b) % max(hi - lo, 1))


class ShufflePartitioner(Partitioner):
    """Uniform random, counter-based: each call draws from a generator
    seeded by (seed, call index), so the routing is a function of the
    position in the stream and a replay after recovery reproduces it."""

    def __init__(self, seed: int = 0) -> None:
        self._seed = seed
        self._calls = 0

    def assign(self, b: int, n: int) -> np.ndarray:
        rng = np.random.default_rng((self._seed, self._calls))
        self._calls += 1
        return rng.integers(0, n, b).astype(np.int32)

    def advance(self, b: int, n: int) -> None:
        self._calls += 1

    def snapshot(self) -> dict:
        return {"seed": self._seed, "calls": self._calls}

    def restore(self, snap: dict) -> None:
        self._seed = int(snap["seed"])
        self._calls = int(snap.get("calls", snap.get("draws", 0)))


class BroadcastPartitioner(Partitioner):
    """Every record to every subtask."""

    broadcast = True

    def assign(self, b: int, n: int) -> np.ndarray:
        raise RuntimeError(
            "broadcast replicates; consumers check .broadcast instead "
            "of calling assign()")


class GlobalPartitioner(Partitioner):
    """Everything to subtask 0."""

    def assign(self, b: int, n: int) -> np.ndarray:
        return np.zeros(b, np.int32)


@dataclasses.dataclass(frozen=True)
class ForwardPartitioner(Partitioner):
    """Stay on the local subtask: the implicit strategy of a chained
    edge."""

    def assign(self, b: int, n: int) -> np.ndarray:
        return np.zeros(b, np.int32)


# -- the keyed assignment of a job across processes ---------------------------
# key -> key shard (the key group) -> (process, local device block). The
# process owns a contiguous span of shards and is reached through the
# cross-process exchange; the device block within it owns a contiguous
# span of that span and is reached through the local keyBy exchange. A
# record's owner is decided once, and records of this process never
# touch the wire.

def hash_shards(keys: np.ndarray, num_shards: int) -> np.ndarray:
    """(B,) int64 keys → global shard ids (the key-group hash)."""
    return hash_keys_numpy(np.asarray(keys, np.int64)) % num_shards


def hybrid_route(keys: np.ndarray, num_shards: int, n_processes: int,
                 local_devices: int = 1):
    """(B,) keys → (process_dest, local_device_dest) int32 arrays.

    Shards are contiguous per process (process p owns [p * spp,
    (p + 1) * spp)) and contiguous per device block within the process's
    span, so a rescale moves whole shard ranges. ``num_shards`` must
    divide by ``n_processes`` and the span by ``local_devices``."""
    shard = hash_shards(keys, num_shards)
    spp = num_shards // n_processes
    if spp * n_processes != num_shards:
        raise ValueError(
            f"num_shards ({num_shards}) must divide by n_processes "
            f"({n_processes}) — shards are the rescale unit")
    proc = shard // spp
    spd = spp // max(local_devices, 1)
    if local_devices > 1 and spd * local_devices != spp:
        raise ValueError(
            f"per-process shard span ({spp}) must divide by the local "
            f"device count ({local_devices})")
    local = (shard - proc * spp) // max(spd, 1)
    return proc.astype(np.int32), local.astype(np.int32)


def cross_slice_fraction(process_dest: np.ndarray,
                         process_id: int) -> float:
    """The share of a routed batch that leaves this process through the
    cross-process exchange (1 - 1/N for a uniform key hash)."""
    n = len(process_dest)
    if n == 0:
        return 0.0
    return float(np.count_nonzero(process_dest != process_id)) / n


def make_partitioner(strategy: str, seed: int = 0) -> Partitioner:
    """``seed`` decorrelates stacked shuffles (the driver passes the plan
    node's id); the other strategies ignore it."""
    if strategy == "shuffle":
        return ShufflePartitioner(seed=seed)
    return {
        "rebalance": RebalancePartitioner,
        "rescale": RescalePartitioner,
        "broadcast": BroadcastPartitioner,
        "global": GlobalPartitioner,
        "forward": ForwardPartitioner,
    }[strategy]()
